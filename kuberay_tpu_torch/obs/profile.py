"""Critical-path profiles over recorded spans (a copy of the parts of
``kuberay_tpu/obs/profile.py`` the port calls: ``span_kind``,
``trace_records``, ``aggregate``, ``profile_spans``).

``trace_records`` attributes every second of a root span's window (a
``serve-request``, a bench ``train-step``) to exactly one span kind's
exclusive self time: the window is cut at every span boundary and each
piece charges the deepest span covering it (ties: latest start, then span
id), or the root's own kind where none does, so the self times of a
record sum to its duration.  ``aggregate`` folds the records into the
``tpu-profile/v1`` document: per shape and span kind, the count, total
and mean self seconds, interpolated p50/p90/p99 (``utils/quantiles.py``)
and the fraction of the shape's wall time.  ``python -m
kuberay_tpu_torch.bench --profile-out PATH`` writes one.

The JAX module's trace diff and live request profiler serve the
gateway's upgrade ramp, which the port does not run; they are not
copied.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from kuberay_tpu_torch.utils.quantiles import quantile

PROFILE_SCHEMA = "tpu-profile/v1"

#: Root span name -> trace shape (the bench passes {"train-step":
#: "train"}).
DEFAULT_ROOTS: Dict[str, str] = {
    "serve-request": "serve",
    "slice-ready": "control-plane",
}


def span_kind(name: str) -> str:
    """Normalize a span name to its kind: chain roots collapse to
    ``chain``, ad-hoc error spans to ``error``, everything else (the
    fixed serve/control-plane vocabulary) is already the kind."""
    if name.startswith("chain:"):
        return "chain"
    if name.startswith("error:"):
        return "error"
    return name


def _round(x: float) -> float:
    # Tidy document values: 9 decimals keep ns resolution without
    # 0.30000000000000004-style noise.  Determinism does not depend on
    # this: identical inputs give identical floats either way.
    return round(x, 9)


def _depths(spans: List[Dict[str, Any]]) -> Dict[str, int]:
    """Tree depth per span_id from parent links (orphans and roots are
    depth 0); cycle-safe because the store can hold orphaned links
    after eviction."""
    by_id = {s["span_id"]: s for s in spans}
    depths: Dict[str, int] = {}

    def depth(sid: str) -> int:
        d = depths.get(sid)
        if d is not None:
            return d
        depths[sid] = 0          # breaks cycles / missing parents
        parent = by_id.get(sid, {}).get("parent_id", "")
        if parent and parent in by_id and parent != sid:
            depths[sid] = depth(parent) + 1
        return depths[sid]

    for s in spans:
        depth(s["span_id"])
    return depths


def _window_self_times(root: Dict[str, Any],
                       candidates: List[Dict[str, Any]],
                       depths: Dict[str, int]) -> Dict[str, float]:
    """Exclusive self time per span kind over the root's window.

    Interval sweep: cut [root.start, root.end] at every candidate
    boundary; each elementary interval charges the deepest covering
    candidate (ties: latest start, then span id), or the root's own
    kind when nothing covers it.  The returned values partition the
    window — sum(values) == root duration up to float addition."""
    w0, w1 = root["start"], root["end"]
    root_kind = span_kind(root["name"])
    if w1 is None or w1 <= w0:
        return {root_kind: 0.0}
    live = [s for s in candidates
            if s["span_id"] != root["span_id"] and s["end"] is not None
            and s["end"] > w0 and s["start"] < w1]
    cuts = {w0, w1}
    for s in live:
        cuts.add(max(w0, s["start"]))
        cuts.add(min(w1, s["end"]))
    edges = sorted(cuts)
    self_s: Dict[str, float] = {}
    for a, b in zip(edges, edges[1:]):
        if b <= a:
            continue
        best = None
        best_key: Tuple[int, float, str] = (-1, 0.0, "")
        for s in live:
            if s["start"] <= a and s["end"] >= b:
                key = (depths.get(s["span_id"], 0), s["start"],
                       s["span_id"])
                if key > best_key:
                    best, best_key = s, key
        kind = span_kind(best["name"]) if best is not None else root_kind
        self_s[kind] = self_s.get(kind, 0.0) + (b - a)
    return self_s or {root_kind: 0.0}


def trace_records(spans: List[Dict[str, Any]],
                  roots: Optional[Dict[str, str]] = None
                  ) -> List[Dict[str, Any]]:
    """Per-window critical-path records from exported span dicts.

    One record per closed span whose name is in ``roots``; candidates
    for its window are the other spans of the same trace.  For the
    serve shape that is the whole request tree; for a ``slice-ready``
    window it includes chain siblings (pod-start, queue-wait,
    reconcile) that overlap the window — depth decides attribution,
    uncovered time stays with ``slice-ready`` itself."""
    roots = DEFAULT_ROOTS if roots is None else roots
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    records: List[Dict[str, Any]] = []
    for trace_id in sorted(by_trace):
        tspans = by_trace[trace_id]
        depths = _depths(tspans)
        for s in sorted(tspans, key=lambda s: (s["start"], s["span_id"])):
            if s["name"] not in roots or s["end"] is None:
                continue
            self_s = _window_self_times(s, tspans, depths)
            records.append({
                "trace_id": trace_id,
                "root_span_id": s["span_id"],
                "shape": roots[s["name"]],
                "duration_s": max(0.0, s["end"] - s["start"]),
                "self_s": self_s,
            })
    return records


def aggregate(records: List[Dict[str, Any]],
              meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Fold per-window records into the ``tpu-profile/v1`` document:
    per shape, per span kind — sample count, total/mean self seconds,
    interpolated p50/p90/p99 self time, and the fraction of the
    shape's total wall time (fractions sum to 1.0 per shape, because
    each record's self times partition its window)."""
    by_shape: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        by_shape.setdefault(rec["shape"], []).append(rec)
    shapes: Dict[str, Any] = {}
    for shape in sorted(by_shape):
        recs = by_shape[shape]
        total = sum(r["duration_s"] for r in recs)
        durs = [r["duration_s"] for r in recs]
        kinds: Dict[str, Any] = {}
        for kind in sorted({k for r in recs for k in r["self_s"]}):
            samples = [r["self_s"][kind] for r in recs
                       if kind in r["self_s"]]
            kinds[kind] = {
                "count": len(samples),
                "total_s": _round(sum(samples)),
                "fraction": _round(sum(samples) / total) if total > 0
                else 0.0,
                "mean_s": _round(sum(samples) / len(samples)),
                "p50_s": _round(quantile(samples, 0.50)),
                "p90_s": _round(quantile(samples, 0.90)),
                "p99_s": _round(quantile(samples, 0.99)),
            }
        shapes[shape] = {
            "traces": len(recs),
            "total_s": _round(total),
            "duration_p50_s": _round(quantile(durs, 0.50)),
            "duration_p90_s": _round(quantile(durs, 0.90)),
            "duration_p99_s": _round(quantile(durs, 0.99)),
            "kinds": kinds,
        }
    doc: Dict[str, Any] = {"schema": PROFILE_SCHEMA, "shapes": shapes}
    if meta:
        doc["meta"] = dict(meta)
    return doc


def profile_spans(spans: List[Dict[str, Any]],
                  roots: Optional[Dict[str, str]] = None,
                  meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Extractor + aggregator in one call: exported span dicts in,
    ``tpu-profile/v1`` document out."""
    return aggregate(trace_records(spans, roots), meta=meta)
