"""A paged engine's forwards as CUDA graph replays, one graph a call shape.

An eager forward queues every kernel from the host, one Python call at a
time: at 7B width that is about 1,440 launches, and the host's work to
queue them outlasts the device's work to run them.  Here a forward of the
engine is captured once as a CUDA graph over static device inputs, one
graph for each forward and shape of its host arrays; each call copies the
host's arrays into that graph's inputs and replays it, which writes the
output (float32 logits) into a static tensor.  The same kernels run on the
same data, so the logits and the pool are the eager forward's, bit for
bit.  Sampling stays eager, after the replay.

The paged engine replays two forwards (``serve/paged_engine.py``):

- a decode step: tokens [S, 1], lengths [S], the slot mask [S] and the
  block tables [S, max_blocks], one graph;
- a prefill from cache position 0: tokens [1, T], the slot's table [1,
  max_blocks] and the real length [1], one graph a prompt bucket T.

A shape's graph is captured at its first call, after one eager warm-up
call on a side stream (lazy initialisation must not happen inside a
capture): the warm-up runs that call's forward for real, and the replay
that follows writes the same values again.  The graphs hold the addresses
of the params and the pool, so they are keyed on their storages, and all
are dropped and captured again, each at its next call, when either is
rebound; a write into them in place (a tier promotion, an import) is read
by the next replay as by an eager call.  The graphs share one memory pool:
their replays run one at a time on one stream, and the engine reads each
replay's output before its next call, which may overwrite it.

Replays keep the launch counts of ``ops/launches.py`` exact: the wrappers
count when Python calls them, which a replay skips, so each replay adds
what its graph's capture counted, and neither the warm-up nor the capture
counts.

Which engines replay is decided once, by ``eligible`` from the engine's
settings; every other engine, every step with more than one token a slot
(verify steps) and every prefill past a cached prefix run the eager
forward as before.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.serve.kv_cache import base_forward_for


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def eligible(device, kv_quant: str, weight_quant: str, layout, cfg) -> bool:
    """Whether a paged engine of these settings replays its forwards as
    graphs: on a CUDA device, over a bf16 pool (``kv_quant`` "none" and
    ``cfg.dtype`` bf16), in one process (no tp ``layout``: its steps run
    collectives), with the dense FFN (Mixtral's grouped FFN reads its
    routing on the host) and unquantised weights (the int8 tree's view
    dequantises each layer in every forward).  The int8 pool is excluded
    too: its decode gathers per-step copies of every slot's blocks."""
    return (torch.device(device).type == "cuda" and kv_quant == "none"
            and cfg.dtype == torch.bfloat16 and weight_quant == "none"
            and layout is None and base_forward_for(cfg) is None)


def _storage_key(trees) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in _tensors(trees))


def _warm_up(forward: Callable, inputs: Tuple, device) -> None:
    """One eager call on a side stream, ordered after the current stream's
    work and before its next."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        forward(*inputs)
    main.wait_stream(side)


def _record(forward: Callable, inputs: Tuple, pool):
    """(a CUDA graph of ``forward(*inputs)`` in memory pool ``pool``, or a
    pool of its own where None; its output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = forward(*inputs)
    return graph, out


class _Graph:
    """One captured call: its static inputs, graph, output, and the
    launches a replay adds."""

    def __init__(self, inputs: Tuple[torch.Tensor, ...]):
        self.inputs = inputs
        self.graph = None
        self.out = None
        self.per_call: Dict[str, int] = {}


class ForwardGraphs:
    """An engine's forwards over static inputs, as CUDA graphs.

    ``replay(forward, trees, *arrays)`` copies the call's host arrays into
    the static inputs of the graph of ``forward`` (by its qualified name)
    and the arrays' shapes and dtypes, made at the first such call;
    captures ``forward(*inputs)`` first where that graph is not captured
    over the storages of ``trees`` (the params and the pool); replays; and
    returns (the static output, whether it captured).  The output is
    overwritten by the next replay of any graph."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.key = None               # the storages the graphs hold
        self._graphs: Dict[Tuple, _Graph] = {}

    def replay(self, forward: Callable, trees, *arrays: np.ndarray):
        key = _storage_key(trees)
        if key != self.key:
            self._graphs.clear()      # the old graphs' memory first
            self.key = key
        shape = (forward.__qualname__,) + tuple(
            (a.shape, a.dtype.str) for a in arrays)
        g = self._graphs.get(shape)
        if g is None:
            g = self._graphs[shape] = _Graph(tuple(
                torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                            device=self.device) for a in arrays))
        # Pageable sources are staged when the copy is queued, so the host
        # arrays may change as soon as these return.
        for dst, src in zip(g.inputs, arrays):
            dst.copy_(torch.from_numpy(src), non_blocking=True)
        captured = g.graph is None
        if captured:
            self._capture(forward, g)
        g.graph.replay()
        launches.add(g.per_call)
        return g.out, captured

    def _capture(self, forward: Callable, g: _Graph) -> None:
        before = launches.snapshot()
        _warm_up(forward, g.inputs, self.device)
        # Every graph of one set of storages shares the first one's pool.
        pool = next((o.graph.pool() for o in self._graphs.values()
                     if o.graph is not None), None)
        start = launches.snapshot()
        g.graph, g.out = _record(forward, g.inputs, pool)
        after = launches.snapshot()
        g.per_call = {n: k - start[n] for n, k in after.items()
                      if k != start[n]}
        launches.clear()
        launches.add(before)
