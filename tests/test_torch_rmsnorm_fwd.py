"""PyTorch port, RMSNorm's forward kernel (``csrc/rmsnorm.cu``): its launch
plan on the CPU, the wrapper's CPU path, and the kernel against its plain
version on the card.

The plan (``ops/rmsnorm.py::fwd_plan``) is a pure function of (rows, d,
the SM count, x's itemsize, alignment); ``thread_units`` and
``cluster_rows`` model how the kernel maps it onto rows and columns.  The
parity of the forward with the JAX package's RMSNorm is held in
``tests/test_torch_ops.py``.  The kernel's check on the card holds it to
``rmsnorm_ref`` at chip_smoke.py's RMS_ATOL (1.6e-2: one bf16 ulp for
|y| < 4; both sides round float32 results that differ in the order of
the row's sum) and to itself bit for bit across calls.
"""

import re
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops import rmsnorm as trn

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "kuberay_tpu_torch" / "csrc"
RMS_ATOL = 1.6e-2
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _covered(plan, d):
    """Each unit's count over a CTA's threads, for one plan."""
    seen = [0] * (d // plan.vec)
    for tid in range(plan.threads):
        for u in trn.thread_units(plan, d, tid):
            seen[u] += 1
    return seen


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, 20000), itemsize=st.sampled_from([2, 4]),
       aligned=st.booleans(), units=st.sampled_from([1, 2, 4]))
def test_plan_covers_every_column_once(d, itemsize, aligned, units):
    """The launch plan as a pure function of (d, itemsize, alignment) at
    every setting of UNITS_A_THREAD the probe sweeps: threads a power of
    two from 32 to 512, whole 16-byte units wherever alignment allows (else
    one value), and each column of a row in exactly one thread's units
    (one CTA a row, so each row once)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(trn, "UNITS_A_THREAD", units)
        plan = trn.fwd_plan(d, itemsize, aligned)
    assert 32 <= plan.threads <= trn.MAX_THREADS <= 1024
    assert plan.threads & (plan.threads - 1) == 0
    full = 16 // itemsize
    assert plan.vec == (full if aligned and d % full == 0 else 1)
    assert d % plan.vec == 0 and plan.nv >= 1
    assert _covered(plan, d) == [1] * (d // plan.vec)
    # The fewest units a thread that cover the row at that thread count,
    # and no more threads than the row's units need (but one warp).
    cu = d // plan.vec
    assert plan.nv == -(-cu // plan.threads)
    assert plan.threads == 32 or plan.threads < 2 * -(-cu // units)


@settings(max_examples=100, deadline=None)
@given(d=st.integers(1, 1024).map(lambda k: 8 * k))
def test_plan_keeps_rows_to_8192_in_registers(d):
    """Aligned bf16 rows up to llama3_70b's d 8192 take the register path
    (at most MAX_NV units a thread)."""
    plan = trn.fwd_plan(d)
    assert plan.vec == 8 and plan.nv <= trn.MAX_NV


@pytest.mark.parametrize("d,threads,nv", [
    (4096, 256, 2),     # llama3_8b (the decode step, prefill chunks)
    (2048, 128, 2),     # llama_1b (the training step)
    (8192, 512, 2),     # llama3_70b
    (1000, 64, 2),      # 125 units
])
def test_plan_at_the_main_widths(d, threads, nv):
    assert trn.fwd_plan(d) == (8, threads, nv)


def test_plan_constants_mirror_the_source():
    text = (CSRC / "rmsnorm.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["MAX_THREADS"]) == trn.MAX_THREADS
    assert int(consts["MAX_NV"]) == trn.MAX_NV
    for dtype, code in trn._DTYPES.items():
        name = {torch.bfloat16: "__nv_bfloat16", torch.float16: "__half",
                torch.float32: "float"}[dtype]
        assert f"struct Type<{code}> {{ using T = {name}; }}" in text


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("wdt", DTYPES)
def test_wrapper_takes_the_plain_version_on_cpu(xdt, wdt, monkeypatch):
    """CPU tensors take ``rmsnorm_ref`` bit for bit, in x's dtype; the
    kernel is never loaded and nothing is counted."""
    def refuse(name):
        raise AssertionError("the CUDA kernel reached on a CPU tensor")

    monkeypatch.setattr(trn, "_fn", refuse)
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(3, 5, 40, generator=g) * 2 - 1).to(xdt)
    w = (torch.rand(40, generator=g) + 0.5).to(wdt)
    before = launches.snapshot()["rmsnorm"]
    got = trn.rmsnorm_fwd(x, w)
    assert launches.snapshot()["rmsnorm"] == before
    assert got.dtype == xdt and got.shape == x.shape
    assert torch.equal(got, trn.rmsnorm_ref(x, w))
    assert torch.equal(trn.rmsnorm(x, w), got)


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        trn.rmsnorm_fwd(x, torch.empty(8, device="meta"))


def test_unaligned_starts_take_one_value_a_unit():
    """x, out or w off their unit's boundary take one value a unit: a
    float32 weight must start on 32 bytes for a bf16 unit (8 values), a
    bf16 one on 16."""
    for wdt, walign in ((torch.float32, 32), (torch.bfloat16, 16)):
        entry = trn.fwd_entry(8, 4096, torch.bfloat16, wdt)
        assert entry[:3] == (8, 4096, walign)
        full, one = entry.full, entry.one
        assert full[2] == 8 and one[2] == 1
        assert trn.launch_args(entry, 0, 0, 0) == full
        assert trn.launch_args(entry, 0, walign // 2, 0) == one
        assert trn.launch_args(entry, 6, 0, 0) == one
        assert trn.launch_args(entry, 0, 0, 8) == one
        assert trn.launch_args(entry, 32, 2 * walign, 64) == full


def test_entry_checks_before_caching():
    """The checks run before an entry is cached: a wrong weight shape or
    dtype raises, and nothing is kept for it."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        trn._fwd_entry(x, torch.zeros(8))          # a CPU x
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        trn._fwd_entry(meta, torch.empty(8, device="meta"))
    before = trn.plans()
    with pytest.raises(ValueError):
        trn.rmsnorm_fwd(meta, torch.empty(8, device="meta"))
    assert trn.plans() == before


def _card_cases():
    """(name, rows, d, x dtype, w dtype, offset): chip_smoke.py's shapes and
    the odd ones (row counts 0 and 1, d 4100 and 1000, f16, f32, a weight
    dtype unlike x's, a view at an offset)."""
    bf = torch.bfloat16
    main = [(f"{r}x{d}", r, d, bf, bf, 0) for r, d in (
        (1, 4096), (8, 4096), (300, 4096), (2048, 4096), (512, 2048),
        (2048, 2048), (4096, 2048), (8192, 2048), (64, 8192))]
    return main + [
        ("rows0", 0, 4096, bf, bf, 0), ("d4100", 8, 4100, bf, bf, 0),
        ("d1000", 300, 1000, bf, bf, 0), ("f16", 8, 4096, torch.float16,
                                          torch.float16, 0),
        ("f32", 300, 2048, torch.float32, torch.float32, 0),
        ("w_f32", 8, 4096, bf, torch.float32, 0),
        ("x_f32_w_bf16", 64, 2048, torch.float32, bf, 0),
        ("offset", 8, 4096, bf, bf, 3), ("d40000", 2, 40000, bf, bf, 0)]


@pytest.mark.gpu
def test_fwd_kernel_matches_plain_on_card():
    """On the card: the kernel against ``rmsnorm_ref`` within RMS_ATOL at
    every case of ``_card_cases``, a launch counted for every call with
    rows, two calls bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, rows, d, xdt, wdt, off in _card_cases():
        base = torch.rand(rows * d + off, generator=gen, device="cuda")
        x = (base * 2 - 1).to(xdt)[off:].view(rows, d)
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(wdt)
        before = launches.snapshot()["rmsnorm"]
        got = trn.rmsnorm_fwd(x, w)
        assert launches.snapshot()["rmsnorm"] == before + bool(rows), name
        want = trn.rmsnorm_ref(x, w)
        assert got.dtype == xdt and got.shape == x.shape, name
        if rows:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= RMS_ATOL, (name, err)
        assert torch.equal(got, trn.rmsnorm_fwd(x, w)), name


def test_probe_needs_a_card(tmp_path):
    """The forward's probe measures on the card only: without one it exits
    before measuring anything."""
    from kuberay_tpu_torch.tools import rmsnorm_fwd_probe
    out = tmp_path / "out.json"
    with pytest.raises(SystemExit, match="no CUDA device"):
        rmsnorm_fwd_probe.main(["--out", str(out), "--parent",
                                str(tmp_path)])
    assert not out.exists()


def test_profiles_count_the_forward_as_the_ports():
    """The train-step A/B's profile counts the forward kernel, by its
    name in a trace, among the port's kernels."""
    from kuberay_tpu_torch.tools import train_ab
    assert train_ab.kind_of("void rmsnorm_fwd_kernel<0, 0, 8, 1>(const "
                            "__nv_bfloat16*, const __nv_bfloat16*, "
                            "__nv_bfloat16*, int, int, int, int, int, "
                            "float)") == "port"
