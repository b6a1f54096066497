"""Per-request tracing (a copy of the parts of ``kuberay_tpu/obs/trace.py``
the port calls).

- ``TraceContext`` parses and renders the W3C-style ``traceparent`` header
  the server adopts and echoes.
- ``NoopTracer`` is the engines' default tracer, which records nothing.
- ``Tracer`` records spans under explicit contexts: ``start_request``
  opens a trace's root span, ``record_span`` adds a finished child (the
  engines' engine-queue, prefill, kv-alloc, decode and tier-fetch spans;
  the bench's dispatch and host-fetch), ``finish_request`` closes the
  root, ``export`` gives the span dicts ``obs/profile.py`` reads.  Ids
  are counters (``t000001``, ``s000002``), so a run under a fixed clock
  exports the same spans every time.  ``SpanStore`` bounds what is kept,
  dropping fast successful spans first; ``span_tree`` nests an export by
  parent link.

The JAX tracer's reconcile chains (``context_for``, ``queued``,
``reconcile``, ``span``) trace the control plane, which the port does not
run; they are not copied.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional


class TraceContext:
    """Which trace, and which span to parent new children under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id}, {self.span_id})"

    def to_traceparent(self) -> str:
        """traceparent header: version 00, sampled flag 01."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    #: A real traceparent is ~55 bytes; anything past this is garbage.
    _MAX_HEADER_LEN = 200

    @classmethod
    def from_traceparent(cls, header: Optional[str]
                         ) -> Optional["TraceContext"]:
        """Parse a traceparent header; malformed or absent headers give
        None (the request runs untraced: propagation never fails a
        request).  Exactly 4 fields, version ``00``, bounded length, ids
        of 1-64 lowercase alphanumerics."""
        if not header:
            return None
        text = str(header).strip()
        if len(text) > cls._MAX_HEADER_LEN:
            return None
        parts = text.split("-")
        if len(parts) != 4 or parts[0] != "00":
            return None
        _, trace_id, span_id, _flags = parts
        for field in (trace_id, span_id):
            if not 1 <= len(field) <= 64:
                return None
            if not all(c.isascii() and (c.isdigit() or c.islower())
                       for c in field):
                return None
        return cls(trace_id, span_id)


class NoopTracer:
    """The default tracer: the engine's span hooks cost one call."""

    enabled = False

    def record_span(self, ctx: Optional[TraceContext], name: str,
                    start: float, end: float, parent_id: str = "",
                    status: str = "ok", error: str = "",
                    **attrs) -> None:
        pass


NOOP_TRACER = NoopTracer()


class Span:
    """One timed operation; ``end is None`` while a root is open."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "start", "end", "attrs", "status", "error")

    def __init__(self, trace_id: str, span_id: str, parent_id: str,
                 name: str, start: float, end: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 status: str = "ok", error: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end = end
        self.attrs = attrs or {}
        self.status = status
        self.error = error

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        out = {"trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "name": self.name,
               "start": self.start, "end": self.end,
               "duration": self.duration, "status": self.status,
               "attrs": dict(self.attrs)}
        if self.error:
            out["error"] = self.error
        return out


class SpanStore:
    """Bounded span sink.  Past ``max_spans`` it drops, in batches, closed
    successful spans below the p90 duration first, then closed ok spans
    oldest first, then errors, then open spans; ``dropped`` counts them,
    so a truncated profile is detectable."""

    def __init__(self, max_spans: int = 8192):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._dropped = 0

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            overflow = len(self._spans) - self.max_spans
            if overflow > 0:
                self._evict_locked(max(overflow, self.max_spans // 16))

    def _evict_locked(self, n: int) -> None:
        spans = self._spans
        ok = [i for i, s in enumerate(spans)
              if s.end is not None and s.status == "ok"]
        durs = sorted(spans[i].duration for i in ok)
        thresh = durs[(len(durs) * 9) // 10] if len(durs) >= 10 \
            else float("inf")
        victims = [i for i in ok if spans[i].duration < thresh][:n]
        if len(victims) < n:
            chosen = set(victims)
            rest = [i for i in range(len(spans)) if i not in chosen]
            rest.sort(key=lambda i: (spans[i].end is None,
                                     spans[i].status != "ok", i))
            victims.extend(rest[:n - len(victims)])
        for i in sorted(victims, reverse=True):
            del spans[i]
        self._dropped += len(victims)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"spans": len(self._spans),
                    "max_spans": self.max_spans,
                    "dropped": self._dropped}

    def export(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
        return [s.to_dict() for s in spans
                if trace_id is None or s.trace_id == trace_id]


def span_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest exported span dicts by parent link: the roots, each with a
    ``children`` list sorted by start; a span whose parent was dropped
    surfaces as a root."""
    by_id = {s["span_id"]: {**s, "children": []} for s in spans}
    roots = []
    for node in by_id.values():
        parent = by_id.get(node["parent_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)

    def sort(nodes):
        nodes.sort(key=lambda n: (n["start"], n["span_id"]))
        for n in nodes:
            sort(n["children"])
    sort(roots)
    return roots


class Tracer(NoopTracer):
    """The real tracer: one trace a request, recorded with explicit
    contexts (the HTTP thread and the engine loop share no thread-local
    state).  ``clock``: anything with ``.now()``; wall time by default."""

    enabled = True

    def __init__(self, clock=None, max_spans: int = 8192):
        self._now = clock.now if clock is not None else time.time
        self.store = SpanStore(max_spans)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._roots: Dict[str, Span] = {}       # open root span_id -> Span

    def _next_span_id(self) -> str:
        with self._lock:
            return f"s{next(self._ids):06d}"

    def _extend_root(self, parent_id: str, end: float) -> None:
        with self._lock:
            root = self._roots.get(parent_id)
            if root is not None and (root.end is None or end > root.end):
                root.end = end

    def start_request(self, name: str, ts: Optional[float] = None,
                      **attrs) -> TraceContext:
        """A fresh trace with an open root span; close it with
        :meth:`finish_request`."""
        ts = self._now() if ts is None else ts
        with self._lock:
            tid = f"t{next(self._ids):06d}"
            sid = f"s{next(self._ids):06d}"
            root = Span(tid, sid, "", name, start=ts,
                        attrs=dict(attrs) if attrs else None)
            self._roots[sid] = root
        self.store.add(root)
        return TraceContext(tid, sid)

    def finish_request(self, ctx: Optional[TraceContext],
                       ts: Optional[float] = None, status: str = "ok",
                       error: str = "") -> None:
        """Close a request's root span (idempotent; nothing for a remote
        or absent context)."""
        if ctx is None:
            return
        ts = self._now() if ts is None else ts
        with self._lock:
            root = self._roots.pop(ctx.span_id, None)
            if root is None:
                return
            if root.end is None or ts > root.end:
                root.end = ts
            if status != "ok":
                root.status = status
                root.error = error

    def record_span(self, ctx: Optional[TraceContext], name: str,
                    start: float, end: float, parent_id: str = "",
                    status: str = "ok", error: str = "",
                    **attrs) -> None:
        """A finished span under ``ctx`` (parented on ``parent_id`` or the
        context's span); an open root it lands under extends to its
        end."""
        if ctx is None:
            return
        parent_id = parent_id or ctx.span_id
        self.store.add(Span(ctx.trace_id, self._next_span_id(), parent_id,
                            name, start, end, attrs or None, status, error))
        self._extend_root(parent_id, end)

    def export(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        return self.store.export(trace_id)

    def tree(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        return span_tree(self.export(trace_id))
