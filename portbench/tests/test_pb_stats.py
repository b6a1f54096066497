"""Percentiles, spreads and the end-to-end readers' arithmetic."""

import statistics

import numpy as np
import pytest

from portbench import harness
from portbench.stats import quantile, spread


def test_quantile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        xs = rng.normal(size=n).tolist()
        for q in (0.0, 0.5, 0.9, 0.95, 1.0):
            assert quantile(xs, q) == pytest.approx(np.percentile(xs, 100 * q))
    assert quantile([], 0.9) == 0.0


def test_spread_uses_python_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 30.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


def _request(due, first, n=3, gap=0.05, in_window=True):
    times = [first + i * gap for i in range(n)] if first is not None else []
    return {"due": due, "sent": due, "times": times, "failed": not times,
            "end": (times[-1] if times else due + 60.0),
            "in_window": in_window, "trace_id": None}


def _serve(requests, window=(0.0, 10.0)):
    return {"kind": "serve", "window": list(window), "requests": requests}


def test_ttft_counts_every_request_due_in_the_window():
    ttft = harness.reader("ttft_p90_ms")
    reqs = [_request(float(i), i + 0.1) for i in range(10)]
    base = ttft.read(_serve(reqs))
    assert base == pytest.approx(100.0)
    # A stall of 2 s at t = 5 delays the first token of every request due
    # before it ends: the tail moves.
    stalled = [_request(float(i), max(i + 0.1, 7.0) if i >= 5 else i + 0.1)
               for i in range(10)]
    assert ttft.read(_serve(stalled)) > 10 * base
    # Requests due outside the window do not count.
    late = reqs + [_request(20.0, 50.0, in_window=False)]
    assert ttft.read(_serve(late)) == pytest.approx(base)


def test_a_failed_request_lies_beyond_every_other():
    ttft = harness.reader("ttft_p90_ms")
    reqs = [_request(float(i), i + 0.1) for i in range(9)]
    reqs.append(_request(9.0, None))
    assert ttft.read(_serve(reqs)) > 100.0


def test_itl_pools_every_gap_that_ends_in_the_window():
    itl = harness.reader("itl_p50_ms.serve")
    reqs = [_request(float(i), i + 0.1, n=21, gap=0.04) for i in range(5)]
    assert itl.read(_serve(reqs)) == pytest.approx(40.0)
    # Stalls in three of the five requests move the pooled median.
    for r in reqs[:3]:
        r["times"] = [r["times"][0] + 0.06 * k for k in range(21)]
    assert itl.read(_serve(reqs)) == pytest.approx(60.0)
    # Gaps whose later token falls after the window are not counted.
    short = _serve([_request(0.0, 0.1, n=3, gap=20.0)], window=(0.0, 10.0))
    assert itl.read(short) is None


def test_train_rate_is_all_tokens_over_the_window():
    rate = harness.reader("train_tokens_per_s")
    rec = {"kind": "train", "window": [100.0, 130.0], "tokens": 32768 * 29}
    assert rate.read(rec) == pytest.approx(32768 * 29 / 30.0)
    assert rate.read({"kind": "serve"}) is None
