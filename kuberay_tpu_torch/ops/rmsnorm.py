"""Fused RMSNorm: a Triton kernel for CUDA tensors, plain torch on the CPU.

Replaces ``kuberay_tpu/ops/rmsnorm.py::_rmsnorm_kernel`` (via
``rmsnorm_pallas``).  ``rmsnorm`` is differentiable: its forward is the
kernel, and its backward recomputes through ``rmsnorm_ref`` under autograd,
as the JAX package takes the vjp of ``rmsnorm_xla`` (``_rmsnorm_bwd``); the
JAX package has no backward kernel, so neither has the port.

Bound on an H100: bytes.  The kernel reads x and the weight once and writes
y once (2 * rows * d * 2 B + d * 2 B for bf16); at the 8B decode shape
(8 rows, d = 4096) that is 131 KB, about 0.04 us at 3.35 TB/s, so a launch
costs far more than the work.  Design: one program per row holds the whole
row in registers (d = 4096 at 8 warps is 16 values a thread), reduces the
mean square in float32 and writes the scaled row in one pass; the column
block is the next power of two and masked, so any row count and any d
take the kernel (the TPU kernel instead fell back to XLA for row counts
its block did not divide).
"""

from __future__ import annotations

import threading

import torch

launches = 0           # kernel launches on CUDA tensors, for run-time checks

_lock = threading.Lock()
_kernel = None


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: float32 math, output in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _rmsnorm_kernel_body(x_ptr, w_ptr, o_ptr, n_cols, eps,
                         BLOCK: tl.constexpr):  # noqa: F821
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    y = x * tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + row * n_cols + cols,
             (y * w).to(o_ptr.dtype.element_ty), mask=mask)


def _get_kernel():
    """JIT-wrap the kernel on first launch.  ``triton`` is imported here,
    never at module import (the CPU tests import this module without it);
    the kernel body resolves ``tl`` from this module's globals."""
    global _kernel, tl
    with _lock:
        if _kernel is None:
            import triton
            import triton.language as tl  # noqa: F811
            _kernel = triton.jit(_rmsnorm_kernel_body)
        return _kernel


def rmsnorm_fwd(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The forward alone.  CPU tensors take ``rmsnorm_ref``; CUDA tensors
    launch the Triton kernel or raise."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on "
                         f"{weight.device}; both must be on one CUDA device")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight shape {tuple(weight.shape)} "
                         f"!= ({d},)")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    w = weight.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        import triton
        block = triton.next_power_of_2(d)
        _get_kernel()[(rows,)](x2, w, out, d, eps, BLOCK=block,
                               num_warps=8 if block >= 2048 else 4)
        launches += 1
    return out.reshape(x.shape)


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(ctx.needs_input_grad[0])
            ww = weight.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rmsnorm_ref(xx, ww, ctx.eps)
            wanted = [t for t in (xx, ww) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (next(grads) if xx.requires_grad else None,
                next(grads) if ww.requires_grad else None, None)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis.  x: [..., d]; weight: [d].

    CPU tensors take ``rmsnorm_ref``; CUDA tensors launch the Triton
    kernel or raise.  Differentiable in x and weight; without a gradient
    to record (the serving path) it calls the forward directly."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return rmsnorm_fwd(x, weight, eps)
