"""PyTorch port, training data and launcher vs the JAX package.

The port's ``TokenShardLoader`` on its NumPy path gives the JAX loader's
NumPy-path batches (shuffled, across an epoch boundary), and
``synthetic_shard`` writes the same bytes.  The launcher trains
``llama_tiny`` on the CPU when asked, raises without a card otherwise, and
refuses the flags whose features are not ported yet.
"""

import re

import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from kuberay_tpu.train import data as jdata
from kuberay_tpu_torch.train import data as tdata
from kuberay_tpu_torch.train import launcher

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_metrics_port(monkeypatch):
    """The launcher's /metrics would bind a fixed port: off here."""
    monkeypatch.setenv("TPU_TRAIN_METRICS_PORT", "0")


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax(tmp_path, shuffle):
    path = str(tmp_path / "shard.bin")
    tdata.synthetic_shard(path, 17 * 10 + 5, vocab=1000, seed=4)
    ours = tdata.TokenShardLoader(path, seq_len=16, batch=4, seed=7,
                                  shuffle=shuffle, prefer_native=False)
    ref = jdata.TokenShardLoader(path, seq_len=16, batch=4, seed=7,
                                 shuffle=shuffle, prefer_native=False)
    assert ours.backend == ref.backend == "numpy"
    assert ours.num_windows == ref.num_windows == 10
    for _ in range(3):                   # 12 windows: crosses an epoch
        a, b = ours.next(), ref.next()
        for k in ("tokens", "targets"):
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    ours.close()
    ref.close()


def test_synthetic_shard_is_byte_identical(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    tdata.synthetic_shard(str(a), 5000, vocab=32768, seed=3)
    jdata.synthetic_shard(str(b), 5000, vocab=32768, seed=3)
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(ValueError, match="smaller than one window"):
        tdata.TokenShardLoader(str(a), seq_len=5000, batch=1)


def test_launcher_trains_llama_tiny_on_cpu(capsys):
    rc = launcher.main(["--model", "llama_tiny", "--steps", "3", "--batch",
                        "2", "--seq-len", "16", "--log-every", "1",
                        "--device", "cpu"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3
    for i, ln in enumerate(lines):
        m = re.fullmatch(r"step (\d+) loss ([\d.]+) tok/s (\d+)", ln)
        assert m and int(m.group(1)) == i + 1
        assert np.isfinite(float(m.group(2)))


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--model", "llama_tiny", "--steps", "1", "--batch",
                       "1", "--seq-len", "8"])


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--tp", "2"], "1 devices not divisible by fixed axes 2",
                 id="flags0-A8"),
    pytest.param(["--sp", "2"], "1 devices not divisible by fixed axes 2",
                 id="flags1-A8"),
])
def test_launcher_refuses_flags_not_ported(flags, item):
    """--tp/--sp > 1 are ported (ROADMAP A8): one process is refused with
    the mesh's own error, as a JAX mesh of 2 on 1 device would be."""
    with pytest.raises(ValueError, match=item):
        launcher.main(["--model", "llama_tiny", "--steps", "1",
                       "--device", "cpu", *flags])


def test_launcher_rejects_a_non_floating_dtype():
    with pytest.raises(SystemExit):
        launcher.main(["--model", "llama_tiny", "--param-dtype", "int32",
                       "--device", "cpu"])
