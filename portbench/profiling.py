"""Device time from a ``torch.profiler`` capture of a steady stretch.

The capture's Chrome trace is written to ``TMPDIR``, read and deleted.
Device operations are its ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events.  ``busy_s`` is the union of their intervals (the busy-interval
sweep of ``chip_smoke.py``'s profile phase and ``tools/train_ab.py``);
``window_s`` the host's time from the capture's start to its stop.  An
idle gap is a stretch between device operations; each is named by the
host operation on the capturing thread that overlaps most of it (what the
host was doing while the device waited), and gaps are summed by that
name.  ``KINDS`` is copied from ``kuberay_tpu_torch/tools/train_ab.py``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

KINDS = (
    ("port", re.compile(r"rmsnorm|flash_|ring_fwd|decode_kernel|"
                        r"_kernel_body")),
    ("matmul", re.compile(r"gemm|nvjet|sm90_xmma|cutlass|cublas", re.I)),
    ("aten_reduce", re.compile(r"reduce_kernel|Reduce", re.I)),
    ("aten_copy_fill", re.compile(r"copy|fill|Memcpy|Memset|cat_", re.I)),
    ("aten_elementwise", re.compile(r"elementwise|vectorized|unrolled",
                                    re.I)),
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kind_of(name: str) -> str:
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


class Capture:
    """Start and stop a capture; ``events`` reads it back."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._cuda = cuda
        self._torch = torch
        self.t0 = self.t1 = None
        self.thread = None

    def prime(self) -> None:
        """An empty capture on the calling thread: the profiler registers
        with this thread, so a later capture may start on another one."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._cuda else [])
        with profile(activities=acts):
            pass

    def start(self) -> None:
        self.thread = threading.get_native_id()
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()

    def events(self) -> List[Dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)


def summarize(events: List[Dict], window_s: float, thread: Optional[int] = None,
              top: int = 10) -> Dict:
    """busy_s, window_s, device seconds and counts by name and kind, and
    the ``breakdown`` lists (the longest device operations by name, the
    idle gaps by what the host was doing on ``thread``, the capturing
    thread's native id, where the trace names it)."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "cpu_op"]
    mine = [e for e in host if e.get("tid") == thread]
    host = sorted(mine or host, key=lambda e: e["ts"])
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    busy, end = 0.0, None
    gaps: List[Tuple[float, float]] = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        s = (b - a) / 1e6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + s
        count[e["name"]] = count.get(e["name"], 0) + 1
        k = kind_of(e["name"])
        by_kind[k] = by_kind.get(k, 0.0) + s
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    idle: Dict[str, float] = {}
    starts = [float(e["ts"]) for e in host]
    for a, b in gaps:
        label = _host_label(host, starts, a, b)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "device_s_by_name": by_name, "launches_by_name": count,
            "device_s_by_kind": by_kind,
            "breakdown": {
                "device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:top]]}}


def _host_label(host: List[Dict], starts: List[float], a: float,
                b: float, before: int = 64) -> str:
    """The host operation overlapping most of [a, b] (the innermost of
    equal overlaps), or ``host:python`` where none does.  ``host`` is
    sorted by start; only operations starting inside the gap and the
    ``before`` ones started last before it are looked at."""
    lo = bisect.bisect_left(starts, a)
    hi = bisect.bisect_right(starts, b)
    best: Optional[Tuple[float, float, str]] = None
    for e in host[max(0, lo - before):hi]:
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        ov = min(b, t) - max(a, s)
        if ov <= 0:
            continue
        key = (ov, -(t - s), e["name"])
        if best is None or key > best:
            best = key
    return f"host:{best[2][:80]}" if best else "host:python"


def device_seconds(summary: Dict, pattern: str) -> Tuple[float, int]:
    """Device seconds and launches of operations whose name matches."""
    pat = re.compile(pattern)
    s = n = 0
    for name, sec in summary["device_s_by_name"].items():
        if pat.search(name):
            s += sec
            n += summary["launches_by_name"][name]
    return s, n
