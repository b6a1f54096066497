"""The program's ranges in a ``torch.profiler`` capture: idle and device
time by program phase.

The port's tracer (``kuberay_tpu_torch/obs/trace.py``) enters
``record_function(name)`` for every span while a capture runs, so the
capture holds the engine's step spans and the train step's phases as
``user_annotation`` events on the device trace's clock.  ``summarize``
reads them against the device operations (``profiling.DEVICE_CATS``):

- idle by range: the device's idle time inside each range (its time
  minus the union of device operations over it), both inclusive (over
  the union of a name's ranges, children included) and self (where the
  name is the innermost range), from the ranges on the capturing
  thread;
- device time by range: each operation is charged to the innermost range
  on the capturing thread that holds its launch, the ``cuda_runtime`` or
  ``cuda_driver`` event with the same ``args.correlation`` on any thread
  (autograd launches the backward from a thread of its own, inside the
  capturing thread's ``train-backward``).  A launch outside every range
  is charged to ``OUTSIDE``; an operation whose launch is not in the
  capture is ``unattributed_s``.

Times are seconds.  Nothing here needs a card: tests feed it events.

``window_spans`` picks the program's own spans (the serving record's
``spans``) that the host-side readers average.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.profiling import DEVICE_CATS

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside)"

Interval = Tuple[float, float]


def _span(e: Dict) -> Interval:
    a = float(e["ts"])
    return a, a + float(e.get("dur", 0.0))


def _union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(union: List[Interval], starts: List[float], a: float,
             b: float) -> float:
    """Length of [a, b] covered by the sorted, disjoint ``union``."""
    got = 0.0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(union) and union[i][0] < b:
        got += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return got


def _innermost(ranges: List[Dict]) -> List[Tuple[float, float, str]]:
    """The ranges of one thread as disjoint segments, each labelled by
    the innermost range over it (ranges on one thread nest)."""
    items = sorted(((*_span(e), e["name"]) for e in ranges),
                   key=lambda r: (r[0], -r[1]))
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    t = None

    def emit(upto: float) -> None:
        if stack and t is not None and upto > t:
            segs.append((t, upto, stack[-1][2]))

    for a, b, name in items:
        while stack and stack[-1][1] <= a:
            emit(stack[-1][1])
            t = stack[-1][1]
            stack.pop()
        emit(a)
        t = a
        stack.append((a, b, name))
    while stack:
        emit(stack[-1][1])
        t = stack[-1][1]
        stack.pop()
    return segs


def summarize(events: List[Dict], thread: Optional[int] = None) -> Dict:
    """``ranges``: for each range name its ``count``, ``time_s`` (the
    union of its ranges), ``idle_s`` (inclusive), ``self_s`` and
    ``self_idle_s`` (where innermost), ``device_s`` and ``launches``
    (operations launched where it is innermost); ``OUTSIDE`` holds what
    no range covers.  Also the totals ``device_s`` and ``unattributed_s``,
    and ``thread``, the thread whose ranges were read (the capturing
    thread where it has any, else every thread)."""
    xs = [e for e in events if e.get("ph") == "X"]
    annotations = [e for e in xs if e.get("cat") == "user_annotation"]
    mine = [e for e in annotations if e.get("tid") == thread]
    ranges = mine or annotations
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    busy = _union(_span(e) for e in dev)
    busy_starts = [a for a, _ in busy]

    out: Dict[str, Dict] = {}

    def entry(name: str) -> Dict:
        return out.setdefault(name, {
            "count": 0, "time_s": 0.0, "idle_s": 0.0, "self_s": 0.0,
            "self_idle_s": 0.0, "device_s": 0.0, "launches": 0})

    by_name: Dict[str, List[Interval]] = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(_span(e))
    for name, spans in by_name.items():
        u = _union(spans)
        time_us = sum(b - a for a, b in u)
        busy_us = sum(_overlap(busy, busy_starts, a, b) for a, b in u)
        ent = entry(name)
        ent["count"] = len(spans)
        ent["time_s"] = time_us / 1e6
        ent["idle_s"] = (time_us - busy_us) / 1e6
    segs = _innermost(ranges)
    for a, b, name in segs:
        ent = entry(name)
        ent["self_s"] += (b - a) / 1e6
        ent["self_idle_s"] += (b - a - _overlap(busy, busy_starts, a,
                                                b)) / 1e6

    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    seg_starts = [a for a, _, _ in segs]
    device = unattributed = 0.0
    for e in dev:
        s = float(e.get("dur", 0.0)) / 1e6
        device += s
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            unattributed += s
            continue
        i = bisect.bisect_right(seg_starts, ts) - 1
        name = segs[i][2] if i >= 0 and ts <= segs[i][1] else OUTSIDE
        ent = entry(name)
        ent["device_s"] += s
        ent["launches"] += 1
    return {"ranges": out, "device_s": device,
            "unattributed_s": unattributed,
            "thread": thread if mine else None}


def phase_ms(record: Dict, name: str) -> Optional[float]:
    """Device milliseconds a profiled train step launched inside range
    ``name`` (the train readers); None where the record has no ranges,
    none of that name or a capture with no device operation."""
    prof = record.get("profile")
    rng = (record.get("profile_ranges") or {}).get("ranges", {})
    if record["kind"] != "train" or prof is None or prof["busy_s"] <= 0 \
            or name not in rng:
        return None
    return 1e3 * rng[name]["device_s"] / record["profile_steps"]


def window_spans(record: Dict, names: Iterable[str]) -> List[Dict]:
    """A serving record's spans named in ``names`` that start in the
    window, less the engine steps the ``torch.profiler`` capture ran in
    (``profile_steps``: the decode steps done when it started and when it
    stopped), whose host time the capture itself raises.  A step's spans
    share its ``engine-step`` trace, and its ``decode-enqueue`` carries
    ``step``, the decode step's index."""
    if record["kind"] != "serve":
        return []
    w0, w1 = record["window"]
    spans = record.get("spans", ())
    first, last = record.get("profile_steps") or (0, 0)
    captured = {s["trace_id"] for s in spans
                if s["name"] == "decode-enqueue"
                and first < s["attrs"].get("step", 0) <= last}
    names = set(names)
    return [s for s in spans if s["name"] in names
            and w0 <= s["start"] < w1 and s["trace_id"] not in captured]
