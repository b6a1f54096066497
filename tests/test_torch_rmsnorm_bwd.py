"""PyTorch port, RMSNorm's gradient vs the JAX package's.

The JAX package's gradient is ``jax.vjp`` of ``kuberay_tpu.ops.rmsnorm.
rmsnorm`` (its ``custom_vjp``, whose backward takes the vjp of
``rmsnorm_xla``).  The port's is the closed form ``rmsnorm_bwd_ref`` on
CPU tensors and the Triton kernels of ``rmsnorm_bwd`` on CUDA tensors;
inputs come from numpy with a fixed seed and go to both packages.  The
kernels themselves are checked by the ``gpu`` test below and by
chip_smoke.py.

Tolerances.  float32: 1e-5 of the element's size plus 1e-5 of its row's
RMS (the sums run in other orders, and dx = r (gw - x^ c) cancels where
gw and x^ c agree).  bf16: chip_smoke.py's ``local_err`` limits, one bf16
ulp of the element (2^-7 |r|) plus 2^-5 of its row's RMS plus 2^-12 of
the tensor's RMS, and 2^-7 of the reference's norm: both sides round the
same float32 results to bf16, so they differ by at most one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops import rmsnorm as trn

torch.set_num_threads(2)

EPS = 1e-5
F32_RTOL = 1e-5
RTOL, ROW_TOL, FLOOR, NORM_TOL = 2 ** -7, 2 ** -5, 2 ** -12, 2 ** -7


def _inputs(shape, seed):
    """x uniform in [-1, 1], w in [0.5, 1.5], g normal (numpy, float32)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1:]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, w, g


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax_grads(x, w, g, dtype):
    """(dx, dw) of the JAX package's rmsnorm, as float32 numpy."""
    jx, jw, jg = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b, EPS), jx, jw)
    dx, dw = vjp(jg)
    assert dx.dtype == jx.dtype and dw.dtype == jw.dtype
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _close(got, want, dtype):
    """got within the dtype's limits of want (float32 numpy arrays)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    row_rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
    if dtype == "float32":
        limit = F32_RTOL * (np.abs(want) + row_rms)
        assert (diff <= limit).all(), (diff / limit).max()
        return
    rms = np.sqrt(np.mean(want ** 2))
    limit = RTOL * np.abs(want) + ROW_TOL * row_rms + FLOOR * rms
    assert (diff <= limit).all(), (diff / limit).max()
    assert np.linalg.norm(got - want) <= NORM_TOL * np.linalg.norm(want)


def _np(t):
    return t.detach().float().numpy()


SHAPES = [(rows, d) for rows in (1, 5, 300) for d in (64, 96, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_bwd_ref_matches_jax_vjp(dtype, rows, d):
    x, w, g = _inputs((rows, d), rows * 7 + d)
    want_dx, want_dw = _jax_grads(x, w, g, dtype)
    dx, dw = trn.rmsnorm_bwd_ref(*(_torch(a, dtype) for a in (x, w, g)),
                                 EPS)
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    _close(_np(dx), want_dx, dtype)
    _close(_np(dw), want_dw, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_autograd_through_rmsnorm_matches_jax_vjp(dtype, rows, d):
    x, w, g = _inputs((rows, d), rows * 11 + d)
    want_dx, want_dw = _jax_grads(x, w, g, dtype)
    tx, tw = (_torch(a, dtype).requires_grad_() for a in (x, w))
    dx, dw = torch.autograd.grad(trn.rmsnorm(tx, tw, EPS), (tx, tw),
                                 _torch(g, dtype))
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    _close(_np(dx), want_dx, dtype)
    _close(_np(dw), want_dw, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leading_axes_match_jax_vjp(dtype):
    """x [B, S, d]: dx keeps the axes, dw sums over B and S."""
    x, w, g = _inputs((2, 3, 96), 5)
    want_dx, want_dw = _jax_grads(x, w, g, dtype)
    tx, tw = (_torch(a, dtype).requires_grad_() for a in (x, w))
    dx, dw = torch.autograd.grad(trn.rmsnorm(tx, tw, EPS), (tx, tw),
                                 _torch(g, dtype))
    assert dx.shape == (2, 3, 96) and dw.shape == (96,)
    _close(_np(dx), want_dx, dtype)
    _close(_np(dw), want_dw, dtype)
    rx, rw = trn.rmsnorm_bwd_ref(*(_torch(a, dtype) for a in (x, w, g)),
                                 EPS)
    assert torch.equal(dx, rx) and torch.equal(dw, rw)


@pytest.mark.parametrize("wants", ["x", "w", "both"])
def test_needs_input_grad(wants):
    """Only the inputs that ask for a gradient get one, the JAX package's
    for each; ``rmsnorm_bwd`` computes only what is asked."""
    x, w, g = _inputs((5, 64), 3)
    want_dx, want_dw = _jax_grads(x, w, g, "float32")
    tx = _torch(x, "float32").requires_grad_(wants in ("x", "both"))
    tw = _torch(w, "float32").requires_grad_(wants in ("w", "both"))
    trn.rmsnorm(tx, tw, EPS).backward(_torch(g, "float32"))
    assert (tx.grad is None) == (wants == "w")
    assert (tw.grad is None) == (wants == "x")
    if tx.grad is not None:
        _close(_np(tx.grad), want_dx, "float32")
    if tw.grad is not None:
        _close(_np(tw.grad), want_dw, "float32")
    dx, dw = trn.rmsnorm_bwd(tx.detach(), tw.detach(), _torch(g, "float32"),
                             EPS, need_dx=tx.requires_grad,
                             need_dw=tw.requires_grad)
    assert (dx is None) == (wants == "w") and (dw is None) == (wants == "x")


@pytest.mark.parametrize("rows,d", [(1, 64), (300, 96), (64, 2048)])
def test_closed_form_equals_autograd_chain(rows, d):
    """In float32 the closed form is the autograd chain through
    ``rmsnorm_ref`` (the port's backward before its kernel) within float32
    rounding."""
    x, w, g = _inputs((rows, d), d)
    tx, tw, tg = (_torch(a, "float32") for a in (x, w, g))
    xx, ww = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    chain = torch.autograd.grad(trn.rmsnorm_ref(xx, ww, EPS), (xx, ww), tg)
    closed = trn.rmsnorm_bwd_ref(tx, tw, tg, EPS)
    for got, want in zip(closed, chain):
        _close(_np(got), _np(want), "float32")


def test_cpu_backward_takes_the_closed_form(monkeypatch):
    """The backward runs ``rmsnorm_bwd_ref``, never the recompute through
    ``rmsnorm_ref`` under autograd."""
    x, w, g = _inputs((5, 64), 9)
    tx, tw = (_torch(a, "float32").requires_grad_() for a in (x, w))
    y = trn.rmsnorm(tx, tw, EPS)

    def refuse(*args, **kwargs):
        raise AssertionError("rmsnorm_ref reached in the backward")

    monkeypatch.setattr(trn, "rmsnorm_ref", refuse)
    y.backward(_torch(g, "float32"))
    want = trn.rmsnorm_bwd_ref(tx.detach(), tw.detach(), _torch(g, "float32"),
                               EPS)
    assert torch.equal(tx.grad, want[0]) and torch.equal(tw.grad, want[1])


def test_g_layouts_read_through_strides():
    """A gradient that views as [rows, d] (rows of a wider buffer, a row
    expanded with stride 0) is read in place; only one that does not (its
    leading axes transposed) is copied, and counted."""
    g = torch.randn(4, 6, 2 * 32)[..., :32]
    before = launches.snapshot()["rmsnorm_bwd_g_copies"]
    assert trn._as_rows(g, 24, 32).data_ptr() == g.data_ptr()
    e = torch.randn(1, 1, 32).expand(4, 6, 32)
    assert trn._as_rows(e, 24, 32).stride() == (0, 1)
    assert launches.snapshot()["rmsnorm_bwd_g_copies"] == before
    t = torch.randn(6, 4, 32).transpose(0, 1)
    got = trn._as_rows(t, 24, 32)
    assert launches.snapshot()["rmsnorm_bwd_g_copies"] == before + 1
    assert torch.equal(got, t.reshape(24, 32))


def test_dw_sum_plain_version_on_cpu():
    """The partials sum's plain version: each column's sum, in the
    weight's dtype; the row-kernel partials of a split of the rows sum to
    the closed form's dw."""
    x, w, g = _inputs((12, 64), 4)
    tx, tw, tg = (_torch(a, "float32") for a in (x, w, g))
    r = torch.rsqrt((tx * tx).mean(-1, keepdim=True) + EPS)
    parts = (tg * tx * r).reshape(3, 4, 64).sum(1)
    dw = trn.rmsnorm_dw_sum(parts, torch.bfloat16)
    assert dw.dtype == torch.bfloat16
    assert torch.equal(dw, parts.sum(0).bfloat16())
    _close(_np(dw), _np(trn.rmsnorm_bwd_ref(tx, tw, tg, EPS)[1]), "bfloat16")


def test_bwd_refuses_devices_other_than_cpu_and_cuda():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        trn.rmsnorm_bwd(x, torch.empty(8, device="meta"), x)
    with pytest.raises(ValueError):
        trn.rmsnorm_dw_sum(torch.empty(4, 8, device="meta"), torch.float32)


@pytest.mark.gpu
def test_bwd_kernel_matches_plain_on_card(monkeypatch):
    """On the card: the Triton backward against ``rmsnorm_bwd_ref`` at a
    ragged shape and at llama_1b's training shape, in ``local_err``'s
    limits; two calls bit for bit; a strided g read in place; the
    autograd path launches the kernels and never reaches ``rmsnorm_ref``
    in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, d in ((300, 1000), (8192, 2048)):
        x = (torch.rand(rows, d, generator=gen, device="cuda") * 2 - 1
             ).bfloat16()
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).bfloat16()
        g = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
        before = launches.snapshot("rmsnorm_bwd", "rmsnorm_bwd_dw")
        dx, dw = trn.rmsnorm_bwd(x, w, g)
        assert launches.snapshot(*before) == {k: c + 1
                                              for k, c in before.items()}
        rx, rw = trn.rmsnorm_bwd_ref(x, w, g)
        _close(_np(dx.cpu()), _np(rx.cpu()), "bfloat16")
        _close(_np(dw.cpu()), _np(rw.cpu()), "bfloat16")
        again = trn.rmsnorm_bwd(x, w, g)
        assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
        wide = torch.zeros(rows, 2 * d, dtype=g.dtype, device="cuda")
        wide[:, :d] = g
        copies = launches.snapshot()["rmsnorm_bwd_g_copies"]
        sx, sw = trn.rmsnorm_bwd(x, w, wide[:, :d])
        assert launches.snapshot()["rmsnorm_bwd_g_copies"] == copies
        assert torch.equal(sx, dx) and torch.equal(sw, dw)
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = trn.rmsnorm(xx, ww)

        def refuse(*args, **kwargs):
            raise AssertionError("rmsnorm_ref reached on a CUDA tensor")

        with monkeypatch.context() as m:
            m.setattr(trn, "rmsnorm_ref", refuse)
            m.setattr(trn, "rmsnorm_bwd_ref", refuse)
            y.backward(g)
        assert torch.equal(xx.grad, dx) and torch.equal(ww.grad, dw)


@pytest.mark.parametrize("tool", ["rmsnorm_bwd_probe", "train_ab"])
def test_tools_need_a_card(tool, tmp_path):
    """The backward's probe and the train-step A/B measure on the card
    only: without one they exit before measuring anything."""
    import importlib
    mod = importlib.import_module(f"kuberay_tpu_torch.tools.{tool}")
    out = tmp_path / "out.json"
    args = ["--out", str(out)] + (["--parent", str(tmp_path)]
                                  if tool == "train_ab" else [])
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(args)
    assert not out.exists()


@pytest.mark.parametrize("name,kind", [
    ("_rmsnorm_bwd_body", "port"), ("_rmsnorm_dw_body", "port"),
    ("void flash_bwd_dq_kernel<128>(Params)", "port"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "aten_reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>", "aten_copy_fill"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "aten_elementwise"),
    ("Memcpy DtoD (Device -> Device)", "aten_copy_fill")])
def test_train_ab_kernel_kinds(name, kind):
    """The A/B's profile sorts kernels by kind from their names."""
    from kuberay_tpu_torch.tools import train_ab
    assert train_ab.kind_of(name) == kind
