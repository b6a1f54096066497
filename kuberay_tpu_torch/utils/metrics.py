"""Prometheus text exposition, no client library (a copy of the counter,
gauge and histogram parts of ``kuberay_tpu/utils/metrics.py``: the serving
engine observes the request-phase histogram and its KV tier store counts
demotions, promotions and hits, the training launcher sets its
``tpu_train_*`` gauges, and their HTTP servers render them)."""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

_BUCKETS = (0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600, 1800, float("inf"))

# Serving TTFT: milliseconds when healthy, seconds when overloaded.
SERVE_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                         1, 2.5, 5, 10, 30, 60, float("inf"))


class Histogram:
    def __init__(self, buckets=_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        # exemplars[i]: the latest (trace_id, value, ts) observed into
        # bucket i (rendered as an OpenMetrics exemplar where set).
        self.exemplars: List[Optional[Tuple[str, float, float]]] = \
            [None] * len(buckets)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float, exemplar: Optional[str] = None,
                exemplar_ts: Optional[float] = None):
        self.n += 1
        self.total += v
        # counts[i] holds bucket i's observations alone; render() sums
        # them into the cumulative le-series.
        i = bisect.bisect_left(self.buckets, v)
        if i < len(self.counts):
            self.counts[i] += 1
            if exemplar is not None:
                self.exemplars[i] = (exemplar, v, exemplar_ts)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], Histogram] = {}
        self._help: Dict[str, str] = {}

    @staticmethod
    def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple:
        return tuple(sorted((labels or {}).items()))

    def describe(self, name: str, help_text: str):
        self._help[name] = help_text

    def inc(self, name: str, labels: Optional[Dict[str, str]] = None,
            value: float = 1.0):
        with self._lock:
            key = (name, self._labels_key(labels))
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._gauges[(name, self._labels_key(labels))] = value

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Tuple] = None,
                exemplar: Optional[str] = None,
                exemplar_ts: Optional[float] = None):
        """``buckets`` applies on a series' first observation only.
        ``exemplar`` is a trace id attached to the bucket this
        observation lands in."""
        with self._lock:
            key = (name, self._labels_key(labels))
            if key not in self._hists:
                self._hists[key] = Histogram(buckets or _BUCKETS)
            if exemplar is not None and exemplar_ts is None:
                exemplar_ts = time.time()
            self._hists[key].observe(value, exemplar=exemplar,
                                     exemplar_ts=exemplar_ts)

    # -- exposition --------------------------------------------------------

    @staticmethod
    def _escape_label_value(value) -> str:
        """Backslash first, then double quote and newline."""
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _escape_help(text: str) -> str:
        return str(text).replace("\\", "\\\\").replace("\n", "\\n")

    @staticmethod
    def _fmt_labels(label_items: Tuple, extra: str = "") -> str:
        parts = [f'{k}="{MetricsRegistry._escape_label_value(v)}"'
                 for k, v in label_items]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            seen = set()

            def header(name, mtype):
                if name not in seen:
                    seen.add(name)
                    if name in self._help:
                        lines.append(
                            f"# HELP {name} "
                            f"{self._escape_help(self._help[name])}")
                    lines.append(f"# TYPE {name} {mtype}")

            for (name, labels), v in sorted(self._counters.items()):
                header(name, "counter")
                lines.append(f"{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                header(name, "gauge")
                lines.append(f"{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                header(name, "histogram")
                cum = 0
                for i, (b, c) in enumerate(zip(h.buckets, h.counts)):
                    cum += c
                    le = "+Inf" if b == float("inf") else str(b)
                    le_label = 'le="%s"' % le
                    line = (f"{name}_bucket"
                            f"{self._fmt_labels(labels, le_label)} {cum}")
                    ex = h.exemplars[i]
                    if ex is not None:
                        tid, val, ts = ex
                        line += (' # {trace_id="%s"} %s %s'
                                 % (self._escape_label_value(tid), val, ts))
                    lines.append(line)
                lines.append(f"{name}_sum{self._fmt_labels(labels)} {h.total}")
                lines.append(f"{name}_count{self._fmt_labels(labels)} {h.n}")
        return "\n".join(lines) + "\n"
