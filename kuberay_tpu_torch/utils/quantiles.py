"""The interpolated quantile (a copy of ``quantile`` from
``kuberay_tpu/utils/quantiles.py``): position ``q * (n - 1)`` over the
sorted samples, a linear blend between the two values that straddle it
(numpy's default), so a small window's p99 still reports its tail."""

from __future__ import annotations

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
