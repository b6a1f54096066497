"""PyTorch port, checkpointing (``kuberay_tpu_torch/train/checkpoint.py``)
vs the JAX package's Orbax checkpoints, on ``llama_tiny``.

The port's state round-trips bit for bit, its integer leaves included; a
step saved with ``save_async`` holds that step's values whatever later
steps and in-place writes do; a background failure is sticky; retention
keeps the newest three steps; an uncommitted step directory is never
picked; and ``load_params_for_serving`` gives the JAX package's leaves
bit for bit on the same state.  All comparisons are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.train import checkpoint as jckpt
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import state_from_jax
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train import train_step as tts

torch.set_num_threads(2)

CFG = tllama.CONFIGS["llama_tiny"]


def _state_and_step(seed=0, mu_dtype=""):
    tc = tts.TrainConfig(warmup_steps=2, decay_steps=10, mu_dtype=mu_dtype)
    opt = tts.make_optimizer(tc)
    state = tts.init_train_state(
        CFG, opt, torch.Generator().manual_seed(seed), tc.param_dtype, "cpu")
    return state, tts.make_train_step(CFG, tc, opt), opt, tc


def _batch(seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, CFG.vocab_size, (2, 17)).astype(np.int32)
    return {"tokens": torch.from_numpy(raw[:, :-1]),
            "targets": torch.from_numpy(raw[:, 1:])}


def _template(seed=1, mu_dtype=""):
    """A freshly initialised state of another seed: the restore target."""
    return _state_and_step(seed, mu_dtype)[0]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(_bits(a), _bits(b)), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("mu_dtype", ["", "bfloat16"])
def test_round_trip_is_bit_for_bit(tmp_path, mu_dtype):
    state, step, _, _ = _state_and_step(mu_dtype=mu_dtype)
    for i in range(2):
        state, _ = step(state, _batch(i))
    d = str(tmp_path / "ck")
    ckpt.save(d, state, 2)
    assert ckpt.latest_step(d) == 2
    restored = ckpt.restore_latest(d, _template(mu_dtype=mu_dtype))
    _assert_same(restored, state)
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 2
    # Training goes on from the restored state exactly as from the saved.
    a, ma = step(state, _batch(5))
    b, mb = step(restored, _batch(5))
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_same(a, b)


def test_restore_refuses_a_template_of_other_dtypes(tmp_path):
    state, _, _, _ = _state_and_step()
    d = str(tmp_path / "ck")
    ckpt.save(d, state, 0)
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(d, 0, _template(mu_dtype="bfloat16"))


def test_async_save_survives_later_steps_and_in_place_writes(tmp_path):
    state, step, _, _ = _state_and_step()
    d = str(tmp_path / "ck")
    with ckpt.CheckpointWriter(d, keep=3) as w:
        for i in range(4):
            state, _ = step(state, _batch(i))
            if i == 1:
                want2 = _clone(state)
                w.save_async(state, 2)
                # In place, on every leaf the save was handed: nothing of
                # it may reach step 2's checkpoint.
                for leaf in ckpt._tensors(state):
                    leaf.mul_(3.0)
            if i == 3:
                want4 = _clone(state)
                w.save_async(state, 4)
    assert ckpt.latest_step(d) == 4
    _assert_same(ckpt.restore(d, 2, _template()), want2)
    _assert_same(ckpt.restore(d, 4, _template()), want4)


def test_background_failure_is_sticky(tmp_path, monkeypatch):
    state, _, _, _ = _state_and_step()
    calls = []

    def failing_commit(directory, host, step, keep):
        calls.append(step)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_commit", failing_commit)
    w = ckpt.CheckpointWriter(str(tmp_path / "ck"))
    w.save_async(state, 1)              # returns; the write fails behind
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    with pytest.raises(OSError, match="disk full"):
        w.save_async(state, 2)          # refuses to start a new save
    with pytest.raises(OSError, match="disk full"):
        w.close()                       # drains, then re-raises
    assert calls == [1]
    assert w._thread is None
    assert ckpt.latest_step(str(tmp_path / "ck")) is None


def test_keep_three_newest_steps(tmp_path):
    state, _, _, _ = _state_and_step()
    d = str(tmp_path / "ck")
    with ckpt.CheckpointWriter(d) as w:
        for s in (1, 2, 3, 4, 5):
            w.save_async(state, s)
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    ckpt.save(d, state, 6, keep=2)
    assert sorted(os.listdir(d)) == ["5", "6"]


def test_uncommitted_steps_are_ignored(tmp_path, monkeypatch):
    state, _, _, _ = _state_and_step()
    d = tmp_path / "ck"
    ckpt.save(str(d), state, 3)
    # A write cut off by a crash (under its temporary name), and a step
    # directory without the checkpoint's metadata.
    real_save = ckpt.dcp.save

    def crash(sd, storage_writer, no_dist):
        os.makedirs(storage_writer.path, exist_ok=True)
        with open(os.path.join(storage_writer.path, "__0_0.distcp"),
                  "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.dcp, "save", crash)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(str(d), state, 7)
    monkeypatch.setattr(ckpt.dcp, "save", real_save)
    (d / "9").mkdir()
    assert sorted(os.listdir(d)) == ["3", "7.tmp", "9"]
    assert ckpt.latest_step(str(d)) == 3
    assert ckpt.restore_latest(str(d), _template())["step"] == 0
    # The next save of that step replaces the leftover.
    ckpt.save(str(d), state, 7)
    assert ckpt.latest_step(str(d)) == 7
    assert "7.tmp" not in os.listdir(d)


def test_load_params_for_serving_none_cases(tmp_path):
    state, _, _, _ = _state_and_step()
    missing = tmp_path / "none"
    assert ckpt.load_params_for_serving(str(missing), device="cpu") is None
    assert not missing.exists()
    (tmp_path / "empty").mkdir()
    assert ckpt.load_params_for_serving(str(tmp_path / "empty"),
                                        device="cpu") is None
    d = str(tmp_path / "ck")
    ckpt.save(d, state, 0)
    assert ckpt.load_params_for_serving(d, step=999, device="cpu") is None
    got = ckpt.load_params_for_serving(d, step=0, device="cpu")
    _assert_same(got, state["params"])


def test_load_params_for_serving_matches_jax_bit_for_bit(tmp_path):
    """One JAX step with float32 masters, then the JAX package's Orbax
    save and load (cast to bfloat16 on the host) against the port's save
    and load of the same state through ``state_from_jax``."""
    jcfg = jllama.CONFIGS["llama_tiny"]
    tc = jts.TrainConfig(warmup_steps=2, decay_steps=10)
    opt = jts.make_optimizer(tc)
    jstate = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(0))
    jstep = jts.make_train_step(jcfg, tc, opt)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                jcfg.vocab_size)
    jstate, _ = jstep(jstate, {"tokens": tokens,
                               "targets": jnp.roll(tokens, -1, 1)})
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, jstate, 1)
    want = jckpt.load_params_for_serving(jd, dtype=jnp.bfloat16)

    tstate = state_from_jax(CFG, jax.tree.map(np.asarray, jstate), "cpu")
    assert tstate["step"] == 1 and tstate["opt_state"]["count"] == 1
    ckpt.save(td, tstate, 1)
    got = ckpt.load_params_for_serving(td, dtype=torch.bfloat16, device="cpu")

    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(list(ckpt._tensors(got)))
    for path, leaf in flat_want:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16
        ref = np.asarray(leaf)
        assert ref.dtype.name == "bfloat16"
        np.testing.assert_array_equal(
            node.view(torch.int16).numpy(), ref.view(np.int16))
