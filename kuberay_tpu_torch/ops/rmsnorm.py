"""Fused RMSNorm: a CUDA forward and Triton backward kernels for CUDA
tensors, plain torch on the CPU.

Forward.  Replaces ``kuberay_tpu/ops/rmsnorm.py::_rmsnorm_kernel`` (via
``rmsnorm_pallas``) with the hand-written kernel of ``csrc/rmsnorm.cu``
(built by ``ops/_build.py``, called through ctypes).  Bound on an H100:
bytes at the training shape (x read and y written once, 2 * rows * d * 2 B
for bf16: 67 MB at llama_1b's 8192 x 2048, 0.020 ms at 3.35 TB/s); at the
8B decode shape (8 rows, d = 4096, 131 KB) the launch and one memory round
trip, not bytes.  Design (the source's header has the details, and
``tools/rmsnorm_fwd_probe.py`` the measurements that chose it): one CTA a
row, each row cut in 16-byte units, about UNITS_A_THREAD of them a
thread, launched with programmatic dependent launch.  ``fwd_plan``
computes the launch from d and x's dtype; the checks and the plan are
cached by shapes, dtypes and devices, so a repeated call costs the host
little more than the launch.  The row's sum runs in one fixed order, so a
call repeats bit for bit.  Any row count and any d take the kernel: where
x, out or w is not aligned for a unit, or d is not a multiple of one, the
same kernel reads one value at a time (the TPU kernel instead fell back
to XLA for row counts its block did not divide).

Backward.  The JAX package takes the vjp of ``rmsnorm_xla`` inside its
``custom_vjp`` (``_rmsnorm_bwd``), which XLA fuses; the port computes that
vjp in closed form, all in float32, per row:

    r = rsqrt(mean(x^2) + eps),  x^ = x r,  gw = g w,  c = mean(gw x^)
    dx = r (gw - x^ c)                      (in x.dtype)
    dw = sum over rows of g x^              (in weight.dtype)

``rmsnorm_bwd_ref`` is that in plain torch; ``rmsnorm_bwd`` launches two
Triton kernels.  Bound: bytes, x and g read and dx written once (3 * rows
* d * 2 B for bf16) plus w and dw; 100.7 MB at llama_1b's 8192 x 2048,
0.030 ms at 3.35 TB/s.  Design: P programs (a few per SM) each walk a
fixed run of rows with w in registers, write each row's dx and add g x^
into a float32 [d] accumulator held in registers, then store it as their
row of a [P, d] float32 partials buffer; a second launch sums the P
partials per column in a fixed order.  No floating-point atomics, so dw is
the same bits from call to call (the order depends on the shape and the
card's SM count alone).  The gradient g may arrive strided (tp's
``copy_to``, a pipeline hop, an expanded ``sum()`` gradient): any layout
that views as [rows, d] is read through its strides, and only one that
does not is copied (``rmsnorm_bwd_g_copies`` in ``ops/launches.py``).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind

# Backward programs per SM: each keeps w and its accumulator in registers,
# so a few resident programs an SM keep enough row loads in flight.
PROGRAMS_PER_SM = 4
# The partials sum loads one [P, DW_TILE / P] tile a program (P rounded up
# to a power of two) and reduces it down the column.
DW_TILE = 8192

# The forward's launch plan (``fwd_plan``; tools/rmsnorm_fwd_probe.py sweeps
# it): a thread takes about UNITS_A_THREAD 16-byte units of a row, one CTA
# a row.  PDL: launch with programmatic dependent launch.
UNITS_A_THREAD = 2
PDL = True
MAX_THREADS = 512      # csrc/rmsnorm.cu's MAX_THREADS and MAX_NV
MAX_NV = 2             # units a thread holds in registers (more: a loop)

# The C entry point of csrc/<LIBRARY>.cu and its ctypes argtypes
# (tests/test_torch_abi.py holds them to the C signature).
LIBRARY = "rmsnorm"
ARGTYPES = {
    # x, w, out; rows, d, x dtype, w dtype, vec, threads, nv, pdl; eps;
    # the stream
    "rmsnorm_fwd": [PTR] * 3 + [INT] * 8 + [FLOAT, PTR],
    # the stream (an empty kernel: the launch floor)
    "rmsnorm_empty": [PTR],
}
_fn = bind(LIBRARY, ARGTYPES)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_lock = threading.Lock()
_jitted = {}
_sm_counts = {}
_compiled = {}         # variant name -> Triton's compiled kernel
_plans = {}            # shapes, dtypes, devices -> ``fwd_entry``
_launch = None         # the C entry point, once loaded


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: float32 math, output in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5):
    """Plain PyTorch version of the backward, the closed form above:
    (dx in ``x.dtype``, dw in ``weight.dtype``)."""
    d = x.shape[-1]
    xf, gf = x.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gw = gf * weight.float()
    c = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (gw - xhat * c)).to(x.dtype)
    dw = (gf * xhat).reshape(-1, d).sum(dim=0).to(weight.dtype)
    return dx, dw


def _rmsnorm_bwd_body(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, n_rows, n_cols,
                      g_stride_row, g_stride_col, rows_per, eps,
                      BLOCK: tl.constexpr, WRITE_DX: tl.constexpr,  # noqa
                      ACC_DW: tl.constexpr):  # noqa: F821
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    acc = tl.zeros((BLOCK,), dtype=tl.float32)
    first = pid.to(tl.int64) * rows_per
    for i in range(0, tl.minimum(rows_per, n_rows - first)):
        row = first + i
        x = tl.load(x_ptr + row * n_cols + cols, mask=mask,
                    other=0.0).to(tl.float32)
        g = tl.load(g_ptr + row * g_stride_row + cols * g_stride_col,
                    mask=mask, other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=0) / n_cols + eps)
        xhat = x * r
        if WRITE_DX:
            gw = g * w
            c = tl.sum(gw * xhat, axis=0) / n_cols
            tl.store(dx_ptr + row * n_cols + cols,
                     (r * (gw - xhat * c)).to(dx_ptr.dtype.element_ty),
                     mask=mask)
        if ACC_DW:
            acc += g * xhat
    if ACC_DW:
        tl.store(part_ptr + pid.to(tl.int64) * n_cols + cols, acc,
                 mask=mask)


def _rmsnorm_dw_body(part_ptr, dw_ptr, n_parts, n_cols,
                     PARTS: tl.constexpr, COLS: tl.constexpr):  # noqa: F821
    cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
    parts = tl.arange(0, PARTS)
    mask = (parts[:, None] < n_parts) & (cols[None, :] < n_cols)
    p = tl.load(part_ptr + parts[:, None] * n_cols + cols[None, :],
                mask=mask, other=0.0)
    tl.store(dw_ptr + cols, tl.sum(p, axis=0).to(dw_ptr.dtype.element_ty),
             mask=cols < n_cols)


def _jit(body):
    """JIT-wrap a kernel body on its first launch.  ``triton`` is imported
    here, never at module import (the CPU tests import this module without
    it); the bodies resolve ``tl`` from this module's globals."""
    global tl
    with _lock:
        if body not in _jitted:
            import triton
            import triton.language as tl  # noqa: F811
            _jitted[body] = triton.jit(body)
        return _jitted[body]


def resources() -> dict:
    """Registers a thread and spills of every kernel variant launched so
    far, by variant name, from Triton's compiled kernels."""
    return {name: {"registers": getattr(k, "n_regs", None),
                   "spills": getattr(k, "n_spills", None)}
            for name, k in sorted(_compiled.items())}


def _check(x: torch.Tensor, weight: torch.Tensor, what: str) -> int:
    """d, after the wrappers' device, shape and dtype checks."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, weight on "
                         f"{weight.device}; both must be on one CUDA device")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"{what}: weight shape {tuple(weight.shape)} "
                         f"!= ({d},)")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    return d


class FwdPlan(NamedTuple):
    """The forward's launch, one CTA a row: ``vec`` values a unit (16 bytes
    of x, or 1), ``threads`` a CTA, ``nv`` units a thread."""
    vec: int
    threads: int
    nv: int


def fwd_plan(d: int, itemsize: int = 2, aligned: bool = True) -> FwdPlan:
    """The forward's launch for rows of d >= 1 ``itemsize``-byte values.
    ``aligned``: x, out and w start on 16-byte (for w, a whole unit's)
    boundaries; with d a multiple of 16 / itemsize a unit is 16 bytes of
    x, else one value.  Threads: the power of two (32-512) at or above a
    row's units over UNITS_A_THREAD."""
    full = 16 // itemsize
    vec = full if aligned and d % full == 0 else 1
    units = d // vec
    want = -(-units // UNITS_A_THREAD)
    threads = min(MAX_THREADS, max(32, 1 << (want - 1).bit_length()))
    return FwdPlan(vec, threads, -(-units // threads))


def thread_units(plan: FwdPlan, d: int, tid: int) -> list:
    """The units of its row that thread ``tid`` loads and stores, as
    ``csrc/rmsnorm.cu`` maps them (past MAX_NV units a thread its loop
    takes the same units)."""
    units = d // plan.vec
    return [u for j in range(plan.nv)
            if (u := tid + j * plan.threads) < units]


class FwdEntry(NamedTuple):
    """What a forward call needs beyond its pointers: ``rows`` and ``d``,
    ``walign`` (the bytes w's start must be a multiple of for full units),
    and the C entry point's plan arguments (x dtype code to pdl) for
    aligned starts (``full``) and for others (``one``); None where d is 0.
    """
    rows: int
    d: int
    walign: int
    full: tuple
    one: tuple


def fwd_entry(rows: int, d: int, x_dtype: torch.dtype,
              w_dtype: torch.dtype) -> FwdEntry:
    """The forward's entry for x [rows, d] in x_dtype and w in w_dtype."""
    if not d:
        return FwdEntry(rows, d, 16, None, None)
    head = (_DTYPES[x_dtype], _DTYPES[w_dtype])
    full, one = (fwd_plan(d, x_dtype.itemsize, aligned)
                 for aligned in (True, False))
    return FwdEntry(rows, d, max(16, full.vec * w_dtype.itemsize),
                    head + (*full, int(PDL)), head + (*one, int(PDL)))


def _fwd_entry(x: torch.Tensor, weight: torch.Tensor) -> FwdEntry:
    """``fwd_entry`` for x and weight, after the wrapper's checks."""
    d = _check(x, weight, "rmsnorm")
    if weight.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported weight dtype {weight.dtype}")
    return fwd_entry(x.numel() // d if d else 0, d, x.dtype, weight.dtype)


def launch_args(entry: FwdEntry, xp: int, wp: int, op: int) -> tuple:
    """The entry's plan arguments for x, w and out starting at xp, wp and
    op."""
    return entry.one if (xp | op) & 15 or wp % entry.walign else entry.full


def plans() -> dict:
    """Every entry the wrapper holds, by (x shape, x dtype, w shape, w
    dtype, x device, w device)."""
    return dict(_plans)


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The forward alone.  CPU tensors take ``rmsnorm_ref``; CUDA tensors
    launch the kernel of ``csrc/rmsnorm.cu`` or raise.  The checks and the
    plan are cached by shapes, dtypes and devices, so a repeated call costs
    the host little more than the launch."""
    global _launch
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_ref(x, weight, eps)
    key = (x.shape, x.dtype, weight.shape, weight.dtype, dev, weight.device)
    entry = _plans.get(key)
    if entry is None:
        entry = _plans[key] = _fwd_entry(x, weight)
    if not x.is_contiguous():
        x2 = x.reshape(-1, entry.d)
        if not x2.is_contiguous():
            raise ValueError("rmsnorm: x must be contiguous")
        return rmsnorm_fwd(x2, weight, eps).reshape(x.shape)
    if not weight.is_contiguous():
        weight = weight.contiguous()
    out = torch.empty_like(x)
    if entry.rows:
        xp, wp, op = x.data_ptr(), weight.data_ptr(), out.data_ptr()
        if _launch is None:
            _launch = _fn("rmsnorm_fwd")
        err = _launch(xp, wp, op, entry.rows, entry.d,
                      *launch_args(entry, xp, wp, op), eps,
                      torch._C._cuda_getCurrentRawStream(dev.index))
        if err:
            raise RuntimeError(f"rmsnorm kernel launch failed: cudaError "
                               f"{err} (entry {entry})")
        launches.bump("rmsnorm")
    return out


def bwd_plan(rows: int, device: torch.device) -> tuple:
    """(programs, rows a program) of the backward's row kernel: about
    PROGRAMS_PER_SM programs an SM, each a contiguous run of rows."""
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    per = max(1, -(-rows // (PROGRAMS_PER_SM * _sm_counts[device.index])))
    return -(-rows // per), per


def bwd_warps(block: int) -> int:
    """Warps of the backward's row kernel for a row block of ``block``
    columns: at most 16 values of each row tensor a thread, spill-free up
    to 8192 columns (``tools/rmsnorm_bwd_probe.py`` reads the registers
    and spills of each variant and times the alternatives)."""
    return 16 if block >= 8192 else 8 if block >= 2048 else 4


def _as_rows(g: torch.Tensor, rows: int, d: int) -> torch.Tensor:
    """g as [rows, d], through its strides where it views so, else a
    contiguous copy (counted as ``rmsnorm_bwd_g_copies``)."""
    g2 = g.reshape(rows, d)
    if g2.data_ptr() != g.data_ptr():
        launches.bump("rmsnorm_bwd_g_copies")
    return g2


def rmsnorm_dw_sum(partials: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dw from the row kernel's [P, d] float32 partials: each column's P
    values summed in one fixed order, in ``dtype``."""
    if partials.device.type == "cpu":
        return partials.sum(dim=0).to(dtype)
    if partials.device.type != "cuda" or partials.dtype != torch.float32 \
            or partials.dim() != 2 or not partials.is_contiguous():
        raise ValueError(f"rmsnorm_dw_sum: partials {partials.dtype} "
                         f"{tuple(partials.shape)} on {partials.device}")
    import triton
    n_parts, d = partials.shape
    parts = triton.next_power_of_2(n_parts)
    if parts > DW_TILE:
        raise ValueError(f"rmsnorm_dw_sum: {n_parts} partials > {DW_TILE}")
    dw = torch.empty(d, dtype=dtype, device=partials.device)
    cols = min(triton.next_power_of_2(d), DW_TILE // parts)
    _compiled[f"rmsnorm_dw_sum PARTS={parts} COLS={cols}"] = \
        _jit(_rmsnorm_dw_body)[(triton.cdiv(d, cols),)](
            partials, dw, n_parts, d, PARTS=parts, COLS=cols, num_warps=8)
    launches.bump("rmsnorm_bwd_dw")
    return dw


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5, need_dx: bool = True,
                need_dw: bool = True):
    """(dx, dw) of ``rmsnorm`` at x for the output gradient g, each None
    where not needed.  CPU tensors take ``rmsnorm_bwd_ref``; CUDA tensors
    launch the Triton kernels or raise."""
    if x.device.type == "cpu":
        dx, dw = rmsnorm_bwd_ref(x, weight, g, eps)
        return dx if need_dx else None, dw if need_dw else None
    d = _check(x, weight, "rmsnorm_bwd")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} on {g.device}, "
                         f"x {tuple(x.shape)} on {x.device}")
    rows = x.numel() // d if d else 0
    x2 = x.reshape(rows, d).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
        if need_dx else None
    if not need_dw:
        dw = None
    elif not rows:
        dw = torch.zeros_like(weight)
    if rows and (need_dx or need_dw):
        import triton
        g2 = _as_rows(g, rows, d)
        programs, per = bwd_plan(rows, x.device)
        part = torch.empty(programs if need_dw else 1, d,
                           dtype=torch.float32, device=x.device)
        block = triton.next_power_of_2(d)
        warps = bwd_warps(block)
        _compiled[f"rmsnorm_bwd BLOCK={block} dx={int(need_dx)} "
                  f"dw={int(need_dw)} warps={warps}"] = \
            _jit(_rmsnorm_bwd_body)[(programs,)](
                x2, weight.contiguous(), g2, x2 if dx is None else dx, part,
                rows, d, g2.stride(0), g2.stride(1), per, eps, BLOCK=block,
                WRITE_DX=need_dx, ACC_DW=need_dw, num_warps=warps)
        launches.bump("rmsnorm_bwd")
        if need_dw:
            dw = rmsnorm_dw_sum(part, weight.dtype)
    return dx, dw


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, g, ctx.eps,
                             need_dx=ctx.needs_input_grad[0],
                             need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis.  x: [..., d]; weight: [d].

    CPU tensors take ``rmsnorm_ref``; CUDA tensors launch the CUDA
    kernel or raise.  Differentiable in x and weight (the backward:
    ``rmsnorm_bwd``); without a gradient to record (the serving path) it
    calls the forward directly."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return rmsnorm_fwd(x, weight, eps)
