"""Serving cells: the port's ``PagedServeEngine`` behind ``ServeFrontend``,
offered an open loop in process.

The frontend is the object ``serve/server.py::main`` builds and its HTTP
handler calls; every request goes through ``submit_stream``, one client
thread a request as the HTTP server has one handler thread a connection,
and each token is stamped when it reaches that stream.

The cell's ``engine`` group is passed to ``PagedServeEngine`` as keyword
arguments and its ``frontend`` group to ``ServeFrontend`` (an option the
port lacks fails there, before any request); the model comes from the
configuration's family (``families/``), the requests from the mix's
traffic kind (``traffic/``).  A later turn of a session (``Planned.after``)
is sent its think time after the turn before it finished, with that
turn's prompt and reply in front of its own tokens; its due time is then.

A run's timeline (one ``time.perf_counter`` clock):

- set-up: weights from the seed on the card, the engine, one warm-up
  prefill at every prompt bucket the traffic can need and a decode step,
  the mix's documents prefilled once (so the pool holds them), then
  ``ramp_s`` of the open loop so that the window starts in steady state;
  ``setup_s`` ends where the window starts;
- the window, ``--seconds`` long: the requests due in it are the ones
  measured;
- after it, arrivals go on (the load stays) until every request due in
  the window has its first token, ``drain_s`` at most; then the frontend
  fails what is still pending and stops.

With ``--trace 1`` the engine gets a ``Tracer`` and every request a trace
context (the engine's ``engine-queue``, ``kv-alloc``, ``prefill`` and
``decode`` spans), the engine's prefill and decode calls are timed from
outside with their shapes, and ``torch.profiler`` captures ``profile_s``
in the middle of the window, started and stopped on the engine's thread
between two steps.

After the run the memory peak is read, and beside it the KV pool's blocks
and how many of them the run ever wrote; the engine is freed, and the
reference checks a sample of the finished greedy requests (``check.py``).
"""

from __future__ import annotations

import collections
import gc
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, harness, profiling
from portbench.traffic import generate

CELL_KEYS = ("engine", "frontend", "ramp_s", "drain_s", "profile_s",
             "check")
CHECK_KEYS = {"min_served_tokens", "max_requests", "limits"}


class Client:
    """One request of the open loop, as its stream saw it."""

    def __init__(self, plan: generate.Planned, due: Optional[float]):
        self.plan = plan
        self.due = due
        self.prompt = plan.prompt
        self.sent: Optional[float] = None
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.finish: Optional[str] = None
        self.end: Optional[float] = None
        self.trace_id: Optional[str] = None
        self.done = threading.Event()

    def consume(self, frontend, deadline: float, tracer) -> None:
        ctx = tracer.start_request("request") if tracer else None
        self.trace_id = ctx.trace_id if ctx else None
        try:
            for item in frontend.submit_stream(
                    self.prompt, max_tokens=self.plan.max_tokens,
                    temperature=self.plan.temperature,
                    timeout=max(1.0, deadline - time.perf_counter()),
                    trace=ctx):
                now = time.perf_counter()
                if item is None:
                    break
                if isinstance(item, list):
                    self.times.extend([now] * len(item))
                    self.tokens.extend(item)
                else:
                    self.finish = item.finish_reason
        except Exception:                  # a client never takes the run down
            traceback.print_exc(file=sys.stderr)
        finally:
            self.end = time.perf_counter()
            if tracer:
                tracer.finish_request(ctx)
            self.done.set()


class Recorder:
    """Times the engine's prefill and decode calls, with their shapes
    (traced runs only)."""

    def __init__(self, engine):
        self.prefills: List[Dict] = []
        self.decodes: List[Dict] = []
        prefill, decode = engine._prefill, engine._decode_call

        def timed_prefill(padded, slot, real_len, samp, start_pos=0):
            t0 = time.perf_counter()
            tok = prefill(padded, slot, real_len, samp, start_pos)
            self.prefills.append({"t0": t0, "t1": time.perf_counter(),
                                  "new": int(real_len),
                                  "start": int(start_pos),
                                  "bucket": int(len(padded))})
            return tok

        def timed_decode(last, temps, mask):
            lens = engine.lens.copy()
            s0 = engine.decode_s
            toks = decode(last, temps, mask)
            self.decodes.append({
                "step": engine.decode_steps,
                "t": time.perf_counter(),
                "dt": engine.decode_s - s0,
                "active": [int(n) + 1 for n, m in zip(lens, mask) if m > 0],
                "rows": [int(n) + 1 for n in lens]})
            return toks

        engine._prefill = timed_prefill
        engine._decode_call = timed_decode


def _warm_up(engine, plans, shared, vocab: int, seed: int, max_len: int):
    from kuberay_tpu_torch.serve.engine import Request

    rng = np.random.default_rng([abs(int(seed)), 99])
    for b in generate.prefill_buckets(plans, max_len):
        n = min(b, max_len - 1)
        engine.add_request(Request(f"warm-{b}", rng.integers(
            0, vocab, n).tolist(), max_new_tokens=2))
        engine.run()
    for i, prefix in enumerate(shared):
        engine.add_request(Request(f"shared-{i}", list(prefix),
                                   max_new_tokens=1))
        engine.run()


def kv_blocks_written(allocator) -> int:
    """Blocks of the pool that the run ever wrote.  The allocator hands
    out never-used blocks in id order from the front of its free list and
    puts freed ones behind them, so while any is left the never-used ones
    are the ids ``k .. num_blocks - 1`` at the front, and ``k`` were
    written."""
    n = allocator.num_blocks
    free = list(allocator._free_uncached)
    k = free[0] if free else n
    return k if free[:n - k] == list(range(k, n)) else n


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _snapshot(frontend) -> Dict:
    return frontend.call_engine(lambda e: dict(e.stats), timeout=120.0)


def _until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run(ctx) -> Dict:
    from kuberay_tpu_torch.obs.trace import Tracer
    from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
    from kuberay_tpu_torch.serve.server import ServeFrontend

    cell, config, mix = ctx.cell, ctx.config, ctx.mix
    extra = set(cell["check"]) - CHECK_KEYS
    if extra:
        raise ValueError(f"check keys {sorted(extra)} are read by nothing")
    eng = {**cell["engine"], **ctx.options.get("engine", {})}
    fam = harness.family(config)
    dims = fam.dims(config)
    cuda = ctx.device == "cuda"
    ramp, drain = float(cell["ramp_s"]), float(cell["drain_s"])
    horizon = ramp + ctx.seconds + drain
    plans = generate.schedule(mix, dims.vocab, ctx.seed, horizon)
    shared = generate.shared_prefixes(mix, dims.vocab, ctx.seed)

    phases = {"imports": time.perf_counter() - ctx.t_start}
    t = time.perf_counter()
    params = fam.make_params(config, ctx.seed, ctx.device, fam.dtype(config))
    phases["weights"] = time.perf_counter() - t
    tracer = Tracer(max_spans=1 << 20) if ctx.trace else None
    engine = PagedServeEngine(
        fam.port_config(config), params, rng_seed=abs(ctx.seed) % (2 ** 63),
        device=ctx.device, tracer=tracer,
        donate_params=eng.get("weight_quant", "none") != "none", **eng)
    del params
    t = time.perf_counter()
    _warm_up(engine, plans, shared, dims.vocab, ctx.seed, engine.max_len)
    phases["warm_up"] = time.perf_counter() - t
    for hook in ctx.options.get("engine_hooks", ()):
        hook(engine)
    rec = Recorder(engine) if ctx.trace else None
    cap = profiling.Capture(cuda) if ctx.trace else None
    if cap is not None:
        cap.prime()
    if cuda:
        torch.cuda.synchronize()
    frontend = ServeFrontend(engine, **cell["frontend"])

    base = time.perf_counter() + 0.05
    w0 = base + ramp
    w1 = w0 + ctx.seconds
    stop_at = w1 + drain
    clients = [Client(p, base + p.due_s if p.after is None else None)
               for p in plans]
    followers = collections.defaultdict(list)
    for c in clients:
        if c.plan.after is not None:
            followers[c.plan.after].append(c)
    threads: List[threading.Thread] = []
    halt = threading.Event()

    def send(c: Client) -> None:
        """Send ``c``, then, on this thread, the turns that follow it."""
        c.sent = time.perf_counter()
        c.consume(frontend, stop_at + 5.0, tracer)
        for f in followers.get(c.plan.index, ()):
            if c.finish != "length":
                continue
            f.prompt = c.prompt + c.tokens + f.plan.prompt
            f.due = time.perf_counter() + f.plan.think_s
            if not halt.wait(max(0.0, f.due - time.perf_counter())):
                send(f)

    def dispatch():
        for c in clients:
            if c.due is None:
                continue
            if halt.wait(max(0.0, c.due - time.perf_counter())):
                return
            th = threading.Thread(target=send, args=(c,), daemon=True)
            th.start()
            threads.append(th)

    feeder = threading.Thread(target=dispatch, daemon=True)
    feeder.start()
    _until(w0)
    setup_s = w0 - ctx.t_start
    stats0 = _snapshot(frontend)
    cap_steps = {}
    if ctx.trace:
        prof_s = min(float(cell["profile_s"]), ctx.seconds / 2)
        _until(w0 + (ctx.seconds - prof_s) / 2)

        def start(e):
            cap.start()
            cap_steps["first"] = e.decode_steps

        def stop(e):
            cap.stop()
            cap_steps["last"] = e.decode_steps

        frontend.call_engine(start, timeout=120.0)
        _until(cap.t0 + prof_s)
        frontend.call_engine(stop, timeout=120.0)
    _until(w1)
    stats1 = _snapshot(frontend)
    window = [c for c in clients if c.due is not None and w0 <= c.due < w1]
    while time.perf_counter() < stop_at and not all(
            c.times or c.done.is_set() for c in window):
        time.sleep(0.05)
    halt.set()
    feeder.join(timeout=30.0)
    frontend._handle_degraded("benchmark window closed")
    frontend.close(timeout=30.0)
    for th in threads:
        th.join(timeout=30.0)
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    block_size = engine.block_size
    kv = {"pool_blocks": engine.allocator.num_blocks,
          "written_blocks": kv_blocks_written(engine.allocator),
          "block_bytes": _nbytes(engine.cache) // engine.allocator.num_blocks}

    finished = [(c.prompt, c.tokens) for c in clients
                if c.finish == "length" and c.tokens
                and c.plan.temperature == 0.0]
    spans = tracer.export() if tracer else []
    del frontend, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record: Dict = {
        "kind": "serve", "setup_s": setup_s, "window": [w0, w1],
        "dims": dims, "block_size": block_size, "kv": kv,
        "device_name": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "memory_peak_bytes": memory_peak,
        "stats0": stats0, "stats1": stats1,
        "requests": [{"due": c.due, "sent": c.sent, "times": c.times,
                      "failed": not c.times, "end": c.end,
                      "in_window": w0 <= c.due < w1,
                      "trace_id": c.trace_id} for c in clients
                     if c.sent is not None],
        "attempted": len(window),
        "failed": sum(1 for c in window if not c.times),
        "finished": len(finished), "phases": phases}
    if ctx.options.get("skip_check"):
        record.update(correct=None, checked={}, numbers={})
        return record
    if ctx.trace:
        record["profile"] = profiling.summarize(
            cap.events(), cap.t1 - cap.t0, cap.thread)
        record["profile_steps"] = [cap_steps["first"], cap_steps["last"]]
        record["prefills"] = rec.prefills
        record["decodes"] = rec.decodes
        record["spans"] = spans

    t = time.perf_counter()
    pick = check.sample_requests(finished, ctx.seed,
                                 cell["check"]["min_served_tokens"],
                                 cell["check"]["max_requests"])
    ref_params = fam.make_params(config, ctx.seed, ctx.device,
                                 fam.dtype(config))
    numbers = check.serve_numbers(fam, ref_params, config,
                                  [finished[i] for i in pick])
    del ref_params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers["sampled_requests"] = len(pick)
    if ctx.options.get("keep_samples"):
        record["samples"] = [finished[i] for i in pick]
    phases["reference"] = time.perf_counter() - t
    record["phases"] = phases
    ok, checked = check.verdict(numbers, cell["check"]["limits"])
    record.update(correct=ok and bool(pick), checked=checked,
                  numbers=numbers)
    return record
