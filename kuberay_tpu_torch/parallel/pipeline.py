"""Pipeline parallelism: GPipe-style stage pipelining over the ``pp`` axis.

Port of ``kuberay_tpu/parallel/pipeline.py``.  One process a stage: the
``pp`` axis of a ``DeviceMesh`` (``MeshSpec(pp=...).build``) or of its
``spmd.Layout``.

- Stages are contiguous layer blocks: ``stacked_params`` is the whole
  ``[n_layers, ...]`` stack on every rank, and stage ``s`` uses a view of
  its block ``[s * L/P, (s + 1) * L/P)``.
- Microbatches stream through the stages on the GPipe schedule:
  ``n_micro + n_stages - 1`` ticks; at tick ``t`` stage ``s`` works on
  microbatch ``t - s`` (stage 0 takes it from ``x``, every other stage
  from what the previous stage sent it at tick ``t - 1``) and the last
  stage banks its outputs.  An inactive tick computes nothing and sends
  zeros, so every tick exchanges the same messages.
- Each tick's activation hop (``_Hop``) sends to stage ``s + 1`` and
  receives from ``s - 1`` (``isend``/``irecv`` posted together, so no rank
  waits on another's send); its backward sends the gradient the other
  way.  JAX's ``ppermute`` ring also sends the last stage's output to
  stage 0, which never reads it; that hop is skipped.
- The last stage's outputs are shared with every stage by JAX's masked
  ``psum``: an all-reduce whose backward is the identity (``_Share``), as
  every rank back-propagates its own copy of the output.  The gradient
  reaches the earlier stages only through the hops.

Autograd runs a node's backward only where its output reaches the loss.
A stage's hops feed its next tick, and the last tick's reach nothing, so
every hop also carries a scalar token from tick to tick into the share:
each rank then runs every hop's backward, in reverse tick order, and the
ranks' backward exchanges pair up.

CUDA tensors over a gloo group go through pinned host memory
(``Layout.host_staged``), as the layout's collectives do.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from kuberay_tpu_torch.parallel import spmd


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _exchange(send: Optional[torch.Tensor], dst: Optional[int],
              recv: Optional[torch.Tensor], src: Optional[int],
              layout: spmd.Layout, group) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive ``recv``'s shape
    from ``src`` (either may be None), posted together; the received
    tensor on ``recv``'s device."""
    staged = layout.host_staged
    ops, out = [], None
    if dst is not None:
        x = send.contiguous()
        if staged and x.is_cuda:
            x = x.to("cpu").pin_memory()
        ops.append(dist.P2POp(dist.isend, x, dst, group))
    if src is not None:
        out = torch.empty(recv.shape, dtype=recv.dtype,
                          device="cpu" if staged else recv.device,
                          pin_memory=staged and recv.is_cuda)
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if out is not None and out.device != recv.device:
        out = out.to(recv.device)
    return out


class _Hop(torch.autograd.Function):
    """One tick's activation hop: ``y`` to the next stage, the previous
    stage's into the result (zeros on stage 0).  ``tok`` is the tick's
    token (module docstring); it passes through unchanged."""

    @staticmethod
    def forward(ctx, y, tok, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        s, n = layout.index(axis), layout.size(axis)
        g = layout.groups[axis]
        nxt = dist.get_global_rank(g, s + 1) if s + 1 < n else None
        prv = dist.get_global_rank(g, s - 1) if s > 0 else None
        ctx.nxt, ctx.prv = nxt, prv
        got = _exchange(y, nxt, y, prv, layout, g)
        return (got if got is not None else torch.zeros_like(y)), tok.clone()

    @staticmethod
    def backward(ctx, g_recv, g_tok):
        # The gradient of what this stage received goes back to the
        # previous stage; the next stage's gradient of what it received
        # is the gradient of ``y``.
        g = ctx.layout.groups[ctx.axis]
        g_y = _exchange(g_recv, ctx.prv, g_recv, ctx.nxt, ctx.layout, g)
        if g_y is None:
            g_y = torch.zeros_like(g_recv)
        return g_y, g_tok, None, None


class _Share(torch.autograd.Function):
    """The masked ``psum``: the sum over ``axis`` (only the last stage's
    operand is non-zero), identity backward; ``tok`` gets a zero gradient,
    which starts every hop's backward."""

    @staticmethod
    def forward(ctx, outputs, tok, layout, axis):
        return layout.all_reduce(outputs.clone(), (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(()), None, None


def _pipeline_sharded(stage_params, x_micro: torch.Tensor, *,
                      layer_fn: Callable, layout: spmd.Layout,
                      axis_name: str, n_stages: int) -> torch.Tensor:
    """This rank's part of the schedule.

    stage_params: this stage's layer stack [L/P, ...].
    x_micro: [n_micro, mb, ...], the whole microbatch set (the same on
    every rank).  Returns [n_micro, mb, ...], the same on every rank."""
    stage = layout.index(axis_name)
    n_micro = x_micro.shape[0]
    n_local = _leaves(stage_params)[0].shape[0]

    def apply_stage(h):
        for i in range(n_local):
            h = layer_fn(h, _map(lambda t: t[i], stage_params))
        return h

    zero = torch.zeros_like(x_micro[0])
    tok = torch.zeros((), device=x_micro.device,
                      requires_grad=torch.is_grad_enabled())
    recv = zero
    banked = [zero] * n_micro
    for t in range(n_micro + n_stages - 1):
        x_in = x_micro[min(t, n_micro - 1)] if stage == 0 else recv
        active = 0 <= t - stage < n_micro
        y = apply_stage(x_in) if active else zero
        if active and stage == n_stages - 1:
            banked[t - (n_stages - 1)] = y
        if n_stages > 1:
            recv, tok = _Hop.apply(y, tok, layout, axis_name)
    outputs = torch.stack(banked)
    if n_stages == 1:
        return outputs
    return _Share.apply(outputs, tok, layout, axis_name)


def pipeline_apply(layer_fn: Callable, stacked_params: Any,
                   x: torch.Tensor, mesh, axis_name: str = "pp",
                   n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Apply a stack of layers as a pipeline over ``axis_name``.

    layer_fn(h, layer_params) -> h (one layer).  stacked_params: a tree of
    tensors with a leading [n_layers] dim, n_layers divisible by the pp
    axis size (the whole stack; each rank uses its stage's block).  x:
    [batch, ...] activations, the same on every rank; batch divisible by
    n_microbatches (default: the number of stages).  ``mesh``: a
    ``DeviceMesh`` with the axis, or its ``spmd.Layout``.  Returns the
    output on every rank; differentiable in ``stacked_params`` (each rank
    gets its stage's gradients) and in ``x`` (on stage 0)."""
    layout = mesh if isinstance(mesh, spmd.Layout) else spmd.layout_of(mesh)
    n_stages = layout.size(axis_name)
    n_layers = _leaves(stacked_params)[0].shape[0]
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    n_micro = n_microbatches or n_stages
    batch = x.shape[0]
    if batch % n_micro != 0:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{n_micro} microbatches")
    x_micro = x.reshape(n_micro, batch // n_micro, *x.shape[1:])
    per = n_layers // n_stages
    s = layout.index(axis_name)
    stage_params = _map(lambda t: t[s * per:(s + 1) * per], stacked_params)
    out = _pipeline_sharded(stage_params, x_micro, layer_fn=layer_fn,
                            layout=layout, axis_name=axis_name,
                            n_stages=n_stages)
    return out.reshape(batch, *x.shape[1:])
