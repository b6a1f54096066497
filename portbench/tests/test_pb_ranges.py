"""The capture split by the program's ranges (``ranges.py``), the readers
of the step spans and ranges, and ``split.py``'s rehearsal."""

import pytest

from portbench import harness, ranges
from portbench.split import RANGE_METRICS, split

CAP, OTHER = 101, 202           # the capturing thread, autograd's


def _x(cat, name, ts, dur, tid=CAP, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _kernel(ts, dur, corr, cat="kernel"):
    return _x(cat, f"k{corr}", ts, dur, tid=7, correlation=corr)


def _launch(ts, corr, tid=CAP, cat="cuda_runtime"):
    return _x(cat, "cudaLaunchKernel", ts, 1.0, tid=tid, correlation=corr)


EVENTS = [
    # Nested ranges on the capturing thread (microseconds).
    _x("user_annotation", "engine-step", 0.0, 100.0),
    _x("user_annotation", "step-decode", 10.0, 80.0),
    _x("user_annotation", "decode-enqueue", 10.0, 40.0),
    _x("user_annotation", "decode-sync", 50.0, 30.0),
    _x("user_annotation", "decode-emit", 80.0, 10.0),
    # A range on another thread: not the capturing thread's, so unread.
    _x("user_annotation", "elsewhere", 0.0, 200.0, tid=OTHER),
    # Launches: one on the capturing thread, one on another thread
    # (autograd's), a driver launch, one in the step's own time, one
    # outside every range; a kernel whose launch is not in the capture.
    _launch(15.0, 1), _kernel(20.0, 20.0, 1),
    _launch(48.0, 2, tid=OTHER), _kernel(45.0, 25.0, 2),
    _launch(55.0, 3, cat="cuda_driver"), _kernel(75.0, 3.0, 3,
                                                 cat="gpu_memcpy"),
    _launch(5.0, 4), _kernel(5.5, 0.5, 4, cat="gpu_memset"),
    _launch(120.0, 5), _kernel(121.0, 4.0, 5),
    _kernel(95.0, 4.0, 9),
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12.0,
     "dur": 2.0, "tid": CAP},
    {"ph": "i", "cat": "user_annotation", "name": "marker", "ts": 1.0},
]


def test_device_time_goes_to_the_range_holding_its_launch():
    got = ranges.summarize(EVENTS, CAP)
    r = got["ranges"]
    assert got["thread"] == CAP
    assert "elsewhere" not in r
    assert r["decode-enqueue"]["device_s"] == pytest.approx(45e-6)
    assert r["decode-enqueue"]["launches"] == 2
    assert r["decode-sync"]["device_s"] == pytest.approx(3e-6)
    assert r["engine-step"]["device_s"] == pytest.approx(0.5e-6)
    assert r["decode-emit"]["device_s"] == 0.0
    assert r["step-decode"]["device_s"] == 0.0
    assert r[ranges.OUTSIDE]["device_s"] == pytest.approx(4e-6)
    assert got["unattributed_s"] == pytest.approx(4e-6)
    assert got["device_s"] == pytest.approx(56.5e-6)
    assert sum(v["device_s"] for v in r.values()) + \
        got["unattributed_s"] == pytest.approx(got["device_s"])


def test_idle_inclusive_and_innermost():
    r = ranges.summarize(EVENTS, CAP)["ranges"]
    # step-decode [10, 90]: busy 20-40, 45-70, 75-78 -> 48 of 80 us.
    assert r["step-decode"]["time_s"] == pytest.approx(80e-6)
    assert r["step-decode"]["idle_s"] == pytest.approx(32e-6)
    # Its own time is what its children leave: 40-50 and nothing else.
    assert r["step-decode"]["self_s"] == pytest.approx(0.0, abs=1e-12)
    assert r["decode-enqueue"]["idle_s"] == pytest.approx(15e-6)
    assert r["decode-sync"]["idle_s"] == pytest.approx(7e-6)
    assert r["decode-emit"]["idle_s"] == pytest.approx(10e-6)
    # engine-step [0, 100]: its self time is 0-10 and 90-100, busy
    # 5.5-6 and 95-99.
    assert r["engine-step"]["self_s"] == pytest.approx(20e-6)
    assert r["engine-step"]["self_idle_s"] == pytest.approx(15.5e-6)
    assert r["engine-step"]["idle_s"] == pytest.approx(100e-6 - 52.5e-6)
    # Self times partition the outermost range.
    assert sum(v["self_s"] for v in r.values()) == \
        pytest.approx(r["engine-step"]["time_s"])
    assert r["decode-enqueue"]["count"] == 1


def test_steps_in_a_row_and_sibling_nesting():
    events = []
    for k in range(3):
        t = 100.0 * k
        events += [_x("user_annotation", "train-iteration", t, 90.0),
                   _x("user_annotation", "train-forward", t + 5, 20.0),
                   _x("user_annotation", "train-backward", t + 30, 40.0),
                   _x("user_annotation", "train-optimizer", t + 75, 10.0),
                   _launch(t + 6, 10 * k + 1), _kernel(t + 8, 15.0,
                                                       10 * k + 1),
                   _launch(t + 31, 10 * k + 2, tid=OTHER),
                   _kernel(t + 32, 36.0, 10 * k + 2),
                   _launch(t + 76, 10 * k + 3), _kernel(t + 78, 9.0,
                                                        10 * k + 3)]
    r = ranges.summarize(events, CAP)["ranges"]
    assert r["train-forward"]["device_s"] == pytest.approx(45e-6)
    assert r["train-backward"]["device_s"] == pytest.approx(108e-6)
    assert r["train-optimizer"]["device_s"] == pytest.approx(27e-6)
    assert r["train-iteration"]["count"] == 3
    assert r["train-iteration"]["self_s"] == pytest.approx(3 * 20e-6)
    record = {"kind": "train", "profile_steps": 3,
              "profile": {"busy_s": 1.0},
              "profile_ranges": ranges.summarize(events, CAP)}
    assert ranges.phase_ms(record, "train-backward") == \
        pytest.approx(1e3 * 36e-6)


def test_every_thread_where_the_capturing_one_has_no_range():
    got = ranges.summarize(EVENTS, thread=999)
    assert got["thread"] is None
    assert "elsewhere" in got["ranges"]
    assert ranges.summarize([], CAP) == {"ranges": {}, "device_s": 0.0,
                                         "unattributed_s": 0.0,
                                         "thread": None}


SERVE = {"kind": "serve", "window": [0.0, 10.0], "spans": [],
         "profile": {"busy_s": 1.0, "window_s": 2.0}}
TRAIN = {"kind": "train", "window": [0.0, 10.0], "profile_steps": 2,
         "profile": {"busy_s": 1.0, "window_s": 2.0}}
NEW = ("decode_enqueue_ms.serve", "enqueue_cpu_share.serve") + \
    RANGE_METRICS


@pytest.mark.parametrize("metric", NEW)
@pytest.mark.parametrize("record", [SERVE, TRAIN], ids=["serve", "train"])
def test_new_readers_read_nothing_without_spans_or_ranges(metric, record):
    assert harness.reader(metric).read(dict(record)) is None
    empty = dict(record, profile_ranges={"ranges": {}})
    assert harness.reader(metric).read(empty) is None


def _span(name, start, end, cpu_s=0.0, trace="t", **attrs):
    return {"name": name, "start": start, "end": end, "trace_id": trace,
            "span_id": name + str(start), "parent_id": "",
            "attrs": {"cpu_s": cpu_s, **attrs}}


def test_span_readers_read_the_window():
    spans = [_span("decode-enqueue", 1.0, 1.030, 0.015),
             _span("decode-enqueue", 2.0, 2.010, 0.010),
             _span("decode-enqueue", 11.0, 11.5, 0.5),     # after it
             _span("prefill-enqueue", 3.0, 3.060, 0.045),
             _span("decode-sync", 1.030, 1.040, 0.0)]
    record = dict(SERVE, spans=spans)
    assert harness.reader("decode_enqueue_ms.serve").read(record) == \
        pytest.approx(20.0)
    assert harness.reader("enqueue_cpu_share.serve").read(record) == \
        pytest.approx(100.0 * 0.070 / 0.100)


def test_span_readers_leave_out_the_captured_steps():
    """Decode steps 4 and 5 ran inside the capture (``profile_steps``
    [3, 5]): their steps' spans, prefills included, are left out."""
    spans = []
    for step in range(1, 8):
        t, tr = float(step), f"t{step}"
        slow = 4 <= step <= 5
        spans.append(_span("decode-enqueue", t, t + (0.080 if slow
                                                     else 0.040),
                           0.040, trace=tr, step=step))
        if step in (2, 5):
            spans.append(_span("prefill-enqueue", t - 0.5, t - 0.4, 0.02,
                               trace=tr))
    record = dict(SERVE, spans=spans, profile_steps=[3, 5])
    assert harness.reader("decode_enqueue_ms.serve").read(record) == \
        pytest.approx(40.0)
    assert harness.reader("enqueue_cpu_share.serve").read(record) == \
        pytest.approx(100.0 * (5 * 0.040 + 0.02) / (5 * 0.040 + 0.1))
    # Without a capture every step counts.
    del record["profile_steps"]
    assert harness.reader("decode_enqueue_ms.serve").read(record) == \
        pytest.approx(1e3 * (5 * 0.040 + 2 * 0.080) / 7)


def test_range_readers_read_the_ranges():
    rng = {"ranges": {"step-decode": {"time_s": 0.5, "idle_s": 0.2},
                      "train-forward": {"device_s": 0.3},
                      "train-backward": {"device_s": 0.6},
                      "train-optimizer": {"device_s": 0.1}}}
    assert harness.reader("decode_idle.serve").read(
        dict(SERVE, profile_ranges=rng)) == pytest.approx(40.0)
    train = dict(TRAIN, profile_ranges=rng)
    for metric, ms in (("forward_ms.train", 150.0),
                       ("backward_ms.train", 300.0),
                       ("optimizer_ms.train", 50.0)):
        assert harness.reader(metric).read(train) == pytest.approx(ms)
    # A capture with no device operation (the CPU) reads nothing.
    cpu = dict(TRAIN, profile_ranges=rng, profile={"busy_s": 0.0})
    assert harness.reader("forward_ms.train").read(cpu) is None


def test_split_rehearsal_reads_the_step_ranges():
    record, metrics = split("mistral7b.chat", 3_000_000_001, 1.0,
                            rehearsal=True)
    r = record["profile_ranges"]["ranges"]
    assert {"engine-step", "step-decode", "decode-enqueue",
            "decode-sync", "decode-emit"} <= set(r)
    assert "ranges" not in record["profile"]
    assert "decode_enqueue_ms.serve" in metrics
    assert 0.0 < metrics["enqueue_cpu_share.serve"]["value"] <= 100.0
    # No device operation on the CPU: the device readers say nothing.
    assert not set(RANGE_METRICS) & set(metrics)
