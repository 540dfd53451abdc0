"""The port's ``doctor/`` against the JAX package's.

``diagnose`` and ``explain_knob`` get the same collected dicts in both
packages and must give equal reports; ``render_text`` and
``render_explain`` must be equal up to the package's name. Last, a port
host daemon is SIGKILLed with a task held in flight and
``python -m ray_tpu_torch.doctor`` reconstructs the task from its flight
recording.
"""

import copy
import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu import doctor as jax_doctor
from ray_tpu_torch import doctor as torch_doctor
from ray_tpu_torch import observability


def _collected(cluster=None, bundles=(), root=""):
    return {"ts": 1000.0, "errors": [], "sealed_now": [],
            "local": {"root": root, "recordings": [],
                      "bundles": list(bundles)},
            "cluster": cluster}


def _bundle(pid, clean=False):
    return {"role": "host_daemon", "label": "node-ab12", "pid": pid,
            "dir": f"/flight/{pid}", "clean": clean,
            "exit_reason": "external-kill (SIGKILL)",
            "sealed_by": "posthumous:doctor", "sealed_ts": 900.0 + pid,
            "trace_ids": ["trace-a"],
            "inflight": {"cafe0001": {"name": "mod.slow_task",
                                      "trace_id": "trace-a"}},
            "chaos": ["task.execute delay(30000)"],
            "chaos_spec": "5:task.execute[name=*slow_task*]@1=delay(30000)",
            "state": {"heartbeat_misses": 2},
            "logs": ["one", "two"], "spans": [{"name": "fetch"}],
            "exception": {"type": "KeyError"}, "faulthandler": True}


def _timeline(slow):
    events = []
    for pid, dur in (("node:aa", 100.0), ("node:bb", 100.0),
                     ("node:cc", slow)):
        events += [{"ph": "X", "cat": "task", "name": "train_step",
                    "pid": pid, "dur": dur, "ts": 0}] * 4
    return {"traceEvents": events, "missing_hosts": []}


def _perf_families():
    """Real metric snapshots carrying the perf plane's bucket counts."""
    from ray_tpu_torch.observability import perf
    from ray_tpu_torch.util import metrics
    was = perf.ENABLED
    perf.enable()
    perf.reset()
    try:
        for ms in (1.0, 2.0, 3.0, 250.0):
            perf.observe("serve.queue_wait", ms)
        perf.observe("rpc.call", 0.5)
        return metrics.snapshot()
    finally:
        perf.reset()
        if not was:
            perf.disable()


def _autopilot_journal():
    base = {"bounds": [1, 16], "ttl_s": 600.0}
    return {"decisions": [
        dict(base, knob="data_streams_per_peer", old=1, new=4,
             action="applied", reason="clean chunks",
             evidence={"chunks": 64}, ts=1000.0),
        dict(base, knob="data_streams_per_peer", old=4, new=1,
             action="reverted", reason="SLO regressed",
             evidence={"baseline": 80.0, "observed": 60.0}, ts=1010.0),
        dict(base, knob="serve.lm.linger_ms", old=200.0, new=100.0,
             action="applied", reason="queue_wait p95 214.7ms",
             evidence={"queue_wait_p95_ms": 214.7}, bounds=[1.0, 1000.0],
             ts=1020.0)],
        "flapping": {"data_streams_per_peer": 3}, "flap_window_s": 600.0}


def _cluster_case():
    nodes = [{"node_id": "aa" * 8, "alive": True, "state": "ALIVE"},
             {"node_id": "bb" * 8, "alive": False, "state": "DEAD",
              "death_reason": "heartbeat timeout"},
             {"node_id": "cc" * 8, "alive": False, "state": "DEAD",
              "death_reason": "drained: preemption"},
             {"node_id": "dd" * 8, "alive": True, "state": "DRAINING",
              "drain_reason": "operator"}]
    missing = [{"node_id": "ee" * 8, "address": "10.0.0.5:1",
                "error": "refused"},
               {"node_id": "dd" * 8, "address": "10.0.0.4:1",
                "error": "quiesced"}]
    return {"nodes": {"nodes": nodes},
            "forensics": {"nodes": {"aa" * 8: {"forensics": {
                "bundles": [_bundle(7)]}}}, "missing_hosts": missing},
            "timeline": _timeline(100.0),
            "metrics": {"snapshots": {}, "missing_hosts": missing[:1]},
            "drain": {"dd" * 8: {"phase": "migrating", "pending": 2}},
            "preempt": {"probe_failures": {"aa" * 8: 9, "bb" * 8: 0},
                        "fleet_rate_per_hour": 1.5},
            "autopilot": _autopilot_journal()}


def _hang_case():
    snaps = {"node:ab12cd34": [{
        "name": "heartbeat_consecutive_misses", "type": "gauge",
        "help": "", "samples": [["heartbeat_consecutive_misses",
                                 [["node", "ab12cd34"]], 5.0]]}]}
    forensics = {"nodes": {"ab12cd34ef": {
        "stacks": {"MainThread": "File x, line 1"},
        "inflight": {"t1": {"name": "wedged_task"}}}},
        "missing_hosts": []}
    return {"metrics": {"snapshots": snaps, "missing_hosts": []},
            "forensics": forensics}


CASES = {
    "empty": (lambda: _collected(), {}),
    "straggler": (lambda: _collected({"timeline": _timeline(1000.0)}), {}),
    "uniform": (lambda: _collected({"timeline": _timeline(100.0)}), {}),
    "hang": (lambda: _collected(_hang_case()), {}),
    "crash": (lambda: _collected(bundles=[_bundle(3), _bundle(4, True)],
                                 root="/flight"), {}),
    "cluster": (lambda: _collected(_cluster_case()), {}),
    "perf_drift": (lambda: _collected({"metrics": {
        "snapshots": {"node:aa": _perf_families()}, "missing_hosts": []}}),
        {"perf_baseline": {"serve.queue_wait": {"p99_ms": 10.0,
                                                "tolerance": 1.5}}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnose_equals_the_jax_package(case):
    make, kwargs = CASES[case]
    collected = make()
    got = torch_doctor.diagnose(copy.deepcopy(collected), **kwargs)
    want = jax_doctor.diagnose(copy.deepcopy(collected), **kwargs)
    assert got == want
    assert got["healthy"] is (case in ("empty", "uniform"))
    if case == "cluster":
        assert [c["pid"] for c in got["crashes"]] == [7]
        assert [m["node_id"] for m in got["unreachable_hosts"]] == ["ee" * 8]
        assert got["probe_flags"] == [{"node_id": "aa" * 8,
                                       "consecutive_failures": 9}]
        assert got["autopilot"]["flap_flags"] == [
            {"knob": "data_streams_per_peer", "actuations": 3}]
    if case == "perf_drift":
        assert got["perf"]["drift"][0]["hist"] == "serve.queue_wait"


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_text_equal_up_to_the_package_name(case):
    make, kwargs = CASES[case]
    report = jax_doctor.diagnose(make(), **kwargs)
    want = jax_doctor.render_text(report)
    got = torch_doctor.render_text(copy.deepcopy(report))
    assert want.startswith("ray_tpu doctor\n")
    assert got == want.replace("ray_tpu doctor", "ray_tpu_torch doctor", 1)


@pytest.mark.parametrize("knob", ["data_streams_per_peer",
                                  "serve.lm.linger_ms", "untouched_knob"])
def test_explain_knob_equals_the_jax_package(knob):
    report = jax_doctor.diagnose(_collected(_cluster_case()))
    got = torch_doctor.explain_knob(copy.deepcopy(report), knob)
    want = jax_doctor.explain_knob(copy.deepcopy(report), knob)
    assert got == want
    text = torch_doctor.render_explain(got)
    assert text == jax_doctor.render_explain(want).replace(
        "ray_tpu doctor", "ray_tpu_torch doctor", 1)
    if knob == "serve.lm.linger_ms":
        assert "applied: 200.0 -> 100.0" in text
        assert "queue_wait_p95_ms=214.7" in text
    elif knob == "untouched_knob":
        assert "no journaled decisions" in text
    else:
        assert "FLAPPING" in text and "4 -> 1" in text


def test_public_names_match():
    assert torch_doctor.__all__ == jax_doctor.__all__


def _run_doctor(root, *args):
    p = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.doctor", "--flight-dir",
         str(root), "--json", *args],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, (p.returncode, p.stdout, p.stderr)
    return json.loads(p.stdout)


def test_sigkilled_daemon_is_reconstructed_from_its_flight_dir(tmp_path):
    """A task held in flight by a chaos ``delay`` on the recording daemon,
    which is then SIGKILLed: ``python -m ray_tpu_torch.doctor`` seals its
    recording posthumously and names the task and its trace id. The rule
    matches the ``name`` label that ``task.execute`` carries, and the task
    asks for a resource only the recording daemon has (the JAX package's
    ``test_cluster_sigkill_daemon_doctor_reconstructs`` writes ``key=``,
    which that point never carries, so its delay never fires)."""
    from ray_tpu_torch.cluster_utils import ProcessCluster
    flight_env = {
        "RAY_TPU_FLIGHT_RECORDER_DIR": str(tmp_path),
        "RAY_TPU_FLIGHT_RECORDER_SPOOL_MS": "50",
        "RAY_TPU_CHAOS": "5:task.execute[name=*slow_task*]@1=delay(30000)",
    }
    c = ProcessCluster(num_daemons=1, num_cpus=2)
    try:
        c.add_daemon(num_cpus=2, env=flight_env, resources={"recorded": 1})
        recorded = c.daemons[-1]["proc"].pid
        observability.enable()
        ray_tpu_torch.init(address=c.address)

        @ray_tpu_torch.remote(resources={"recorded": 1}, max_retries=0)
        def slow_task():
            return os.getpid()

        with observability.span("doomed-root") as sp:
            trace_id = sp.trace_id
            ref = slow_task.remote()
            deadline = time.monotonic() + 60
            while not any(trace_id.encode() in lw.read_bytes()
                          for lw in tmp_path.glob("*/lastwords.bin")):
                assert time.monotonic() < deadline, "never in flight"
                time.sleep(0.05)
            c.kill_daemon(len(c.daemons) - 1)
            del ref
        rep = _run_doctor(tmp_path)
        (crash,) = [x for x in rep["crashes"] if trace_id in x["trace_ids"]]
        assert crash["pid"] == recorded
        assert crash["role"] == "host_daemon"
        assert "external-kill" in crash["exit_reason"]
        assert crash["sealed_by"] == "posthumous:doctor"
        assert crash["chaos_spec"].endswith("delay(30000)")
        assert any(t["name"].endswith("slow_task")
                   and t["trace_id"] == trace_id
                   for t in crash["inflight_tasks"])
        assert rep["healthy"] is False
        # a second run has nothing left to seal
        assert _run_doctor(tmp_path)["sealed_now"] == []
    finally:
        observability.disable()
        ray_tpu_torch.shutdown()
        c.shutdown()
