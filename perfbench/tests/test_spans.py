"""The readers of the program's serving spans (``core/spans.py``) on a
synthetic record and ring, with answers computed by hand; then traced CPU
runs of the tiny cells report the metrics that read the new spans and
histograms."""

import pytest
import torch

from perfbench import harness
from perfbench.core import readers, spans
from perfbench.tests import tiny

W0, W1 = 1_000_000, 2_000_000  # ns: a window of 1 ms
# device operations: 1.1-1.2 ms and 1.5-1.7 ms (busy 0.3 of 1 ms)
RECORD = {"kind": "serve", "trace": {
    "w0": W0, "w1": W1, "window_s": 1e-3, "busy_s": 3e-4,
    "ops": [("k", 1_100_000, 1_200_000), ("k", 1_500_000, 1_700_000)]}}


def span(name, ts_us, dur_us, **args):
    return {"name": name, "cat": "serve", "ph": "X", "pid": "main",
            "tid": "t", "ts": ts_us, "dur": dur_us, "args": args}


# two requests: 1.05-1.30 ms and 1.60-1.90 ms, open 0.55 ms; the device
# runs in 0.1 ms of each; a task span, a request that ended after the
# window and an instant event are not requests of the window
EVENTS = [span("serve.request", 1050.0, 250.0, request_id="a"),
          span("serve.request", 1600.0, 300.0, request_id="b"),
          span("Replica.handle_request", 1000.0, 500.0, trace_id="x"),
          span("serve.request", 1950.0, 100.0, request_id="late"),
          {"name": "chaos", "ph": "i", "ts": 1500.0}]


def test_idle_queued_pct_by_hand():
    got = spans.idle_queued_pct(RECORD, EVENTS, 0)
    assert got == pytest.approx(35.0)  # (0.55 - 0.2) of 1 ms
    # with the idle time no request saw, it makes the device's idle share
    alone = 100.0 * (1.0 - 0.55 - (0.3 - 0.2))  # idle, no request open
    assert got + alone == pytest.approx(readers.idle_pct(RECORD))


def test_tail_queue_pct_by_hand():
    # 20 requests of 10, 20, ..., 180 us and two of 200 us: the 95th
    # percentile is 200, so the two longest are the tail; they queued 50
    # and 150 us of their 400
    events = [span("serve.request", 1000.0 + 40 * i, 10.0 * (i + 1),
                   request_id=f"r{i}") for i in range(18)]
    events += [span("serve.request", 1800.0, 200.0, request_id="t1"),
               span("serve.request", 1700.0, 200.0, request_id="t2"),
               span("serve.queue", 1800.0, 50.0, request_id="t1",
                    batch_id="b1"),
               span("serve.queue", 1700.0, 150.0, request_id="t2",
                    batch_id="b2"),
               span("serve.queue", 1000.0, 5.0, request_id="r0",
                    batch_id="b0")]
    assert spans.tail_queue_pct(RECORD, events, 0) == pytest.approx(50.0)


def test_no_trace_no_spans_or_a_ring_that_dropped_them_read_none():
    untraced = {"kind": "serve", "trace": None}
    older = [e for e in EVENTS if e["name"] != "serve.request"]
    for read in (spans.idle_queued_pct, spans.tail_queue_pct):
        assert read(untraced, EVENTS, 0) is None
        assert read(RECORD, older, 0) is None  # a program without them
        # the ring let spans fall and kept none from before the window
        assert read(RECORD, EVENTS, 3) is None
    # spans fell before the window only: the window is whole
    before = [span("task", 100.0, 200.0)] + EVENTS
    assert spans.idle_queued_pct(RECORD, before, 3) == pytest.approx(35.0)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("tiny_spans"))


def traced(base, cell):
    return harness.run_cell(cell, 2 ** 31 + 23, 1.5, True,
                            torch.device("cpu"), 0.0, tiny.bench_with_tiny(),
                            base)


def test_traced_serve_run_reports_the_span_metrics(base):
    out = traced(base, "tiny.serve")
    assert out["correct"] is True
    m = out["metrics"]
    assert {"serve_route_ms", "serve_tail_queue_pct",
            "serve_idle_queued_pct"} <= set(m)
    assert m["serve_route_ms"]["value"] > 0
    assert 0 < m["serve_tail_queue_pct"]["value"] <= 100
    # no device operations on the CPU: idle whenever a request is open
    assert m["serve_idle_queued_pct"]["value"] <= \
        m["device_idle_pct.serve"]["value"]


def test_traced_train_run_reports_the_optimizer_phase(base):
    out = traced(base, "tiny.train")
    assert out["correct"] is True
    assert out["metrics"]["train_optimizer_ms"]["value"] > 0
