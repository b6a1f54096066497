"""Trace context for the serving path (a copy of the parts of
``kuberay_tpu/obs/trace.py`` the port calls): ``TraceContext`` parses and
renders the W3C-style ``traceparent`` header the server adopts and
echoes, and ``NoopTracer`` is the engine's default tracer, which records
nothing."""

from __future__ import annotations

from typing import Optional


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
