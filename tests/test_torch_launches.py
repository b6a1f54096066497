"""PyTorch port: the kernel launch registry (``ops/launches.py``).

A snapshot, then a captured delta added again and again (what a CUDA
graph replay does), keeps every name's count exact, whatever the names;
clearing brings every count back to 0.  On the CPU a wrapper takes its
plain version and counts nothing."""

import pytest
import torch

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops import rmsnorm as trn


@pytest.fixture(autouse=True)
def _restore():
    saved = launches.snapshot()
    yield
    launches.clear()
    launches.add(saved)


@pytest.mark.parametrize("names", [("rmsnorm",),
                                   ("paged_decode_attention", "flash_fwd"),
                                   launches.NAMES],
                         ids=["one", "two", "every"])
def test_captured_delta_added_twice_is_exact(names):
    """Bumps between two snapshots give the delta; adding it twice counts
    the captured calls three times in all, and leaves other names alone."""
    before = launches.snapshot()
    for i, n in enumerate(names):
        for _ in range(i + 1):
            launches.bump(n)
    after = launches.snapshot()
    delta = {n: k - before[n] for n, k in after.items() if k != before[n]}
    assert delta == {n: i + 1 for i, n in enumerate(names)}
    launches.add(delta)
    launches.add(delta)
    assert launches.snapshot() == {
        n: before[n] + 3 * delta.get(n, 0) for n in launches.NAMES}
    assert launches.snapshot(*names) == {n: before[n] + 3 * (i + 1)
                                         for i, n in enumerate(names)}


def test_clear_restores_zero():
    for n in launches.NAMES:
        launches.bump(n)
    launches.clear()
    assert launches.snapshot() == dict.fromkeys(launches.NAMES, 0)


def test_unknown_name_is_refused():
    with pytest.raises(KeyError):
        launches.bump("flash")
    with pytest.raises(KeyError):
        launches.snapshot("flash")


def test_cpu_tensors_count_nothing():
    before = launches.snapshot()
    x = torch.randn(3, 16)
    trn.rmsnorm(x, torch.ones(16))
    trn.rmsnorm_bwd(x, torch.ones(16), torch.randn(3, 16))
    assert launches.snapshot() == before
