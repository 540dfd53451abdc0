"""Request-scoped serving spans and the optimizer-phase marker of the port.

A batched deployment on the CPU (``max_batch_size`` 4, ``pad_batch_to``
(1, 2, 4)) is called through its handle; the span ring
(``_private/profiling.py``) must then hold, for each request, one
``serve.request``, one ``serve.route`` and one ``serve.queue`` span under
the id the handle minted, and one ``serve.batch`` naming it. The training
step must feed the ``train.optimizer`` histogram once a step with the perf
plane on, and never with it off.
"""

import threading
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.profiling import get_profiler
from ray_tpu_torch.exceptions import BatchExecutionError, ServeOverloadedError
from ray_tpu_torch.observability import perf

DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")
BUCKETS = (1, 2, 4)


class Upper:
    """Upper-cases a batch of strings; keeps the length of every list it
    was handed (padded rows included). "slow" sleeps, "bad" raises."""

    def __init__(self):
        self.calls = []

    def __call__(self, items):
        self.calls.append(len(items))
        if "slow" in items:
            time.sleep(0.6)
        if "bad" in items:
            raise ValueError("poisoned")
        return [x.upper() for x in items]

    def take_calls(self):
        out, self.calls = self.calls, []
        return out


@pytest.fixture(scope="module")
def handle(tmp_path_factory):
    saved = dict(_config._values)
    root = tmp_path_factory.mktemp("serve_tracing")
    for flag in DIR_FLAGS:
        _config.set(flag, str(root / flag))
    _config.set("flight_recorder_enabled", False)
    _config.set("profiling_enabled", True)
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        dep = serve.deployment(
            Upper, name="upper", max_batch_size=4, batch_wait_timeout_s=0.2,
            pad_batch_to=BUCKETS, target_latency_ms=1e6)
        yield serve.run(dep.bind(), route_prefix=None)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            _config._values.clear()
            _config._values.update(saved)


def send(handle, items):
    """Call the handle for each item at once; (responses, results or
    errors)."""
    responses = [handle.remote(x) for x in items]
    out = [None] * len(items)

    def wait(i):
        try:
            out[i] = responses[i].result(timeout=60)
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[i] = e

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    return responses, out


def spans(name, ids):
    return [s for s in get_profiler().chrome_trace()
            if s["name"] == name
            and (s.get("args") or {}).get("request_id") in ids]


def batches_naming(ids):
    return [s for s in get_profiler().chrome_trace()
            if s["name"] == "serve.batch"
            and set(s["args"]["request_ids"]) & ids]


def test_every_request_has_one_span_of_each_kind(handle):
    handle.take_calls.remote().result(timeout=30)
    responses, out = send(handle, ["a", "b", "c"])
    assert out == ["A", "B", "C"]
    ids = {r.request_id for r in responses}
    assert len(ids) == 3 and all(ids)
    for name in ("serve.request", "serve.route", "serve.queue"):
        got = spans(name, ids)
        assert sorted(s["args"]["request_id"] for s in got) == sorted(ids)
        assert all(s["dur"] >= 0 for s in got)
    batches = batches_naming(ids)
    named = [i for b in batches for i in b["args"]["request_ids"]]
    assert sorted(named) == sorted(ids)
    # a queue span names its batch, and lies inside its request's span
    by_batch = {b["args"]["batch_id"]: b for b in batches}
    requests = {s["args"]["request_id"]: s for s in spans("serve.request",
                                                          ids)}
    for q in spans("serve.queue", ids):
        assert q["args"]["request_id"] in \
            by_batch[q["args"]["batch_id"]]["args"]["request_ids"]
        r = requests[q["args"]["request_id"]]
        assert r["ts"] <= q["ts"] and q["ts"] + q["dur"] <= r["ts"] + r["dur"]
    # rows_padded is what pad_items added to each forward's list
    calls = handle.take_calls.remote().result(timeout=30)
    assert sorted(calls) == sorted(b["args"]["rows"] + b["args"]["rows_padded"]
                                   for b in batches)
    for b in batches:
        rows = b["args"]["rows"]
        assert b["args"]["rows_padded"] == next(
            k for k in BUCKETS if k >= rows) - rows
        assert b["args"]["cap"] >= rows and b["args"]["linger_ms"] >= 0


def test_a_shed_request_has_a_queue_span_marked_shed(handle):
    saved = _config.get("serve_queue_deadline_ms")
    # "slow" lingers 0.2 s alone, then runs 0.6 s; the next two come in
    # meanwhile and have waited 0.5 s when it ends
    _config.set("serve_queue_deadline_ms", 400.0)
    try:
        slow = handle.remote("slow")
        time.sleep(0.3)
        responses, out = send(handle, ["d", "e"])
        assert slow.result(timeout=60) == "SLOW"
    finally:
        _config.set("serve_queue_deadline_ms", saved)
    assert all(isinstance(e, ServeOverloadedError) for e in out)
    ids = {r.request_id for r in responses}
    queued = spans("serve.queue", ids)
    assert len(queued) == 2 and all(s["args"]["shed"] for s in queued)
    assert all("batch_id" not in s["args"] for s in queued)
    assert not spans("serve.request", ids)  # no value came back
    assert len(spans("serve.route", ids)) == 2


def test_batch_execution_error_names_the_handles_ids(handle):
    saved = _config.get("serve_batch_retry_singletons")
    _config.set("serve_batch_retry_singletons", False)
    try:
        responses, out = send(handle, ["f", "bad", "g"])
    finally:
        _config.set("serve_batch_retry_singletons", saved)
    ids = {r.request_id for r in responses}
    errors = [e for e in out if isinstance(e, BatchExecutionError)]
    assert errors
    for e in errors:
        assert set(e.request_ids) <= ids
    assert set().union(*(e.request_ids for e in errors)) == ids


def test_route_histogram_holds_one_sample_per_request(handle):
    was = perf.ENABLED
    perf.enable()
    perf.reset()
    try:
        _, out = send(handle, ["h", "i", "j", "k", "l"])
        assert out == ["H", "I", "J", "K", "L"]
        hist = perf.snapshot()["hists"]["serve.route"]
        assert sum(hist["counts"]) == 5 and hist["sum_ms"] > 0
    finally:
        if not was:
            perf.disable()


@pytest.mark.parametrize("on", [True, False])
def test_step_feeds_one_optimizer_sample_a_step(on):
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                            max_seq_len=16, dtype=torch.float32,
                            use_flash=False)
    init_fn, step_fn, shard = make_lm_train_step(cfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    tokens = shard(torch.randint(0, 64, (2, 9),
                                 generator=torch.Generator().manual_seed(1)))
    was = perf.ENABLED
    (perf.enable if on else perf.disable)()
    perf.reset()
    try:
        for _ in range(3):
            state, _ = step_fn(state, tokens)
        hist = perf.snapshot()["hists"].get("train.optimizer")
    finally:
        (perf.enable if was else perf.disable)()
    if on:
        assert sum(hist["counts"]) == 3 and hist["sum_ms"] > 0
    else:
        assert hist is None


@pytest.mark.cuda
def test_ring_spans_share_the_device_traces_clock():
    """A span of the ring around a device sleep and a synchronise holds
    the sleep kernel's interval from a ``torch.profiler`` trace taken at
    the same time, each edge within 0.1 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._private.profiling import Profiler

    ring = Profiler(max_spans=8)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the trace's first launch, not timed
        torch.cuda.synchronize()
        t0 = time.time_ns()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        ring.record_ns("clock", "test", "test", t0, time.time_ns())
    span = ring.chrome_trace()[-1]
    s0, s1 = span["ts"] * 1e3, (span["ts"] + span["dur"]) * 1e3
    # the long sleep: the device's longest operation in the trace
    k0, k1 = max(((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()),
                 key=lambda k: k[1] - k[0])
    assert k1 - k0 > 1e6, (k0, k1)  # a few milliseconds
    assert abs(k0 - s0) <= 1e5 and abs(s1 - k1) <= 1e5, (s0, k0, k1, s1)
