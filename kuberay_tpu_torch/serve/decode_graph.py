"""A paged engine's decode step as one CUDA graph replay.

An eager decode step queues every kernel of the forward from the host, one
Python call at a time: at 7B width that is about 1,440 launches, and the
host's work to queue them outlasts the device's work to run them.  Here the
engine's own decode forward is captured once as a CUDA graph over static
device inputs (tokens [S, 1], lengths [S], the slot mask [S], the block
tables [S, max_blocks]); each step copies the host's arrays into them and
replays the graph, which writes the float32 logits [S, 1, V] into a static
output.  The same kernels run on the same data, so the logits and the pool
are the eager forward's, bit for bit.  Sampling stays eager, after the
replay.

The capture comes at the first decode step, after one eager warm-up call
on a side stream (lazy initialisation must not happen inside a capture):
the warm-up runs that step's forward for real, and the replay that follows
writes the same values again.  The graph holds the addresses of the params
and the pool, so it is keyed on their storages and captured again when
either is rebound; a write into them in place (a tier promotion, an
import) is read by the next replay as by an eager step.

Replays keep the launch counts of ``ops/launches.py`` exact: the wrappers
count when Python calls them, which a replay skips, so each replay adds
what the captured call counted, and neither the warm-up nor the capture
counts.

Which engines replay is decided once, by ``eligible`` from the engine's
settings; every other engine, and every step with more than one token a
slot (verify steps), runs the eager forward as before.
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
    """Whether a paged engine of these settings replays its decode steps
    as a graph: on a CUDA device, over a bf16 pool (``kv_quant`` "none"
    and ``cfg.dtype`` bf16), in one process (no tp ``layout``: its steps
    run collectives), with the dense FFN (Mixtral's grouped FFN reads its
    routing on the host) and unquantised weights (the int8 tree's view
    dequantises each layer in every forward).  The int8 pool is excluded
    too: its decode gathers per-step copies of every slot's blocks."""
    return (torch.device(device).type == "cuda" and kv_quant == "none"
            and cfg.dtype == torch.bfloat16 and weight_quant == "none"
            and layout is None and base_forward_for(cfg) is None)


def _storage_key(trees) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in _tensors(trees))


class DecodeGraph:
    """One engine's decode forward over static inputs, as a CUDA graph.

    ``replay(forward, trees, last, lens, mask, tables)`` copies the step's
    host arrays into the static inputs, captures ``forward(tokens, lens,
    mask, tables)`` first where the storages of ``trees`` (the params and
    the pool) are not those of the last capture, replays, and returns
    (the static logits, whether it captured).  The logits are overwritten
    by the next replay."""

    def __init__(self, slots: int, max_blocks: int, device):
        dev = torch.device(device)
        self.device = dev
        self.tokens = torch.zeros(slots, 1, dtype=torch.long, device=dev)
        self.lens = torch.zeros(slots, dtype=torch.int32, device=dev)
        self.mask = torch.zeros(slots, dtype=torch.float32, device=dev)
        self.tables = torch.zeros(slots, max_blocks, dtype=torch.int32,
                                  device=dev)
        self.graph = None
        self.logits = None
        self.key = None
        self.per_call: Dict = {}      # kernel name -> launches a replay adds

    def replay(self, forward: Callable, trees, last: np.ndarray,
               lens: np.ndarray, mask: np.ndarray, tables: np.ndarray):
        # Pageable sources are staged when the copy is queued, so the host
        # arrays may change as soon as these return.
        for dst, src in ((self.tokens.view(-1), last), (self.lens, lens),
                         (self.mask, mask), (self.tables, tables)):
            dst.copy_(torch.from_numpy(src), non_blocking=True)
        key = _storage_key(trees)
        captured = key != self.key
        if captured:
            self._capture(forward, key)
        self.graph.replay()
        launches.add(self.per_call)
        return self.logits, captured

    def _capture(self, forward: Callable, key: Tuple) -> None:
        self.graph = self.logits = None       # the old graph's memory first
        before = launches.snapshot()
        args = (self.tokens, self.lens, self.mask, self.tables)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            forward(*args)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        start = launches.snapshot()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            logits = forward(*args)
        after = launches.snapshot()
        self.per_call = {n: k - start[n] for n, k in after.items()
                         if k != start[n]}
        launches.clear()
        launches.add(before)
        self.graph, self.logits, self.key = graph, logits, key
