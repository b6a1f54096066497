"""Percentiles and spreads.

``quantile`` is a copy of ``kuberay_tpu_torch/utils/quantiles.py``'s
(position ``q * (n - 1)`` over the sorted samples, a linear blend between
the two values that straddle it, numpy's default).  ``spread`` is the
distance between the first and third quartiles as Python's
``statistics.quantiles(values, n=4)`` gives them, over the median: the
measure the bounds of ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def quantile(samples: Sequence[float], q: float) -> float:
    """Interpolated quantile, ``q`` in [0, 1]; 0.0 for no samples."""
    xs = sorted(samples)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
