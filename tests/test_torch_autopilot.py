"""The port's ``autopilot/`` against the JAX package's.

The same fixed telemetry payloads go through both packages' policies,
actuator layer, controller and journal, each against private actuator
registries and dict-backed knob stores with virtual clocks (never the
process ``_config``), and the A/B drill runs in both. The last test drives
the seam the port lifts: a batched Serve deployment registers its linger
and batch cap as actuators when ``autopilot_enabled`` is on.
"""

import ast
import copy
import inspect
import json
import time

import pytest

import ray_tpu_torch
from ray_tpu import autopilot as jax_autopilot
from ray_tpu import chaos as jax_chaos
from ray_tpu.autopilot import actuators as jax_actuators
from ray_tpu.autopilot import controller as jax_controller
from ray_tpu.autopilot import drill as jax_drill
from ray_tpu.autopilot import journal as jax_journal
from ray_tpu.autopilot import policies as jax_policies
from ray_tpu_torch import autopilot as torch_autopilot
from ray_tpu_torch import chaos as torch_chaos
from ray_tpu_torch.autopilot import actuators as torch_actuators
from ray_tpu_torch.autopilot import controller as torch_controller
from ray_tpu_torch.autopilot import drill as torch_drill
from ray_tpu_torch.autopilot import journal as torch_journal
from ray_tpu_torch.autopilot import knobs as torch_knobs
from ray_tpu_torch.autopilot import policies as torch_policies

PACKAGES = {
    "jax": (jax_actuators, jax_controller, jax_journal, jax_chaos,
            jax_drill),
    "torch": (torch_actuators, torch_controller, torch_journal, torch_chaos,
              torch_drill),
}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeState:
    """The state client's KV surface, in memory."""

    def __init__(self):
        self.kv = {}

    def kv_put(self, key, value, overwrite=True, namespace=b""):
        self.kv[(namespace, bytes(key))] = bytes(value)

    def kv_keys(self, prefix=b"", namespace=b""):
        return [k for (ns, k) in self.kv
                if ns == namespace and k.startswith(prefix)]

    def kv_get(self, key, namespace=b""):
        return self.kv.get((namespace, bytes(key)))


def make_registry(actuators, drill):
    store = dict(drill.DRILL_KNOBS)
    reg = actuators.ActuatorRegistry()
    actuators.register_config_actuators(reg=reg, store=store)
    return reg, store


def goodput_snapshot(compute, data_wait, wall=100.0):
    return {"goodput": {"jobs": {"train": {
        "wall_s": wall,
        "cats": {"compute": compute, "data_wait": data_wait}}}}}


def test_public_names_and_owned_knobs_match():
    assert torch_autopilot.__all__ == jax_autopilot.__all__
    for name in jax_autopilot.__all__:
        assert hasattr(torch_autopilot, name), name
    assert torch_autopilot.OWNED_KNOBS == jax_autopilot.OWNED_KNOBS
    # knobs.py stays import-free: a linter execs its source
    tree = ast.parse(inspect.getsource(torch_knobs))
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))]
    # the compression choices are the port's wire schemes
    from ray_tpu_torch.collective.quantization import SCHEMES
    assert torch_autopilot.OWNED_KNOBS["collective_compression"][
        "choices"] == SCHEMES


# -- policies: the same payloads give the same proposals ---------------------

def _link(**kw):
    rec = {"bytes": 2 ** 30, "seconds": 1.0, "chunks": 64, "retries": 0,
           "failovers": 0}
    rec.update(kw)
    return {"comms": {"links": {"a|b": rec}}}


def _slow_group(busbw, world=8):
    return {"comms": {"groups": {"g": {"world_size": world, "ops": {
        "allreduce": {"count": 4, "bytes": 2 ** 30, "busbw_gbps": busbw,
                      "compression_ratio": 1.0}}}}}}


POLICY_CASES = {
    "serve_over_budget": ({"perf": {"cluster": {
        "serve.queue_wait": {"count": 32.0, "p95_ms": 80.0},
        "serve.execute": {"count": 32.0, "p50_ms": 2.0}}}},
        {"serve.d.linger_ms": 40.0}),
    "serve_under_budget": ({"perf": {"cluster": {
        "serve.queue_wait": {"count": 32.0, "p95_ms": 40.0}}}},
        {"serve.d.linger_ms": 40.0}),
    "serve_at_floor": ({"perf": {"cluster": {
        "serve.queue_wait": {"count": 32.0, "p95_ms": 80.0}}}},
        {"serve.d.linger_ms": 1.0}),
    "transport_failover": (_link(failovers=3), {}),
    "transport_clean": (_link(), {}),
    "transport_retries": (_link(retries=2), {}),
    "collective_quantize": (_slow_group(2.0), {}),
    "collective_hierarchy": (_slow_group(2.0),
                             {"collective_compression": "q8"}),
    "collective_healthy": (_slow_group(8.0), {}),
    "prefetch_grow": (goodput_snapshot(70.0, 20.0),
                      {"data_prefetch_batches": 2}),
    "prefetch_shrink": (goodput_snapshot(99.5, 0.5),
                        {"data_prefetch_batches": 2}),
    "cadence": ({"hazard_rate_per_hour": 6.0, "cadence_inputs": {
        "step_cost_s": 1.0, "ckpt_cost_s": 0.5, "restart_cost_s": 0.0}},
        {}),
    "cadence_no_feed": ({"cadence_inputs": {"step_cost_s": 1.0}}, {}),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policies_propose_what_the_jax_package_proposes(case):
    snapshot, overrides = POLICY_CASES[case]
    knobs = dict(jax_drill.DRILL_KNOBS, **overrides)
    knobs.setdefault("serve.d.linger_ms", 40.0)
    names = sorted(knobs)
    want = jax_policies.propose(copy.deepcopy(snapshot), knobs.__getitem__,
                                names)
    got = torch_policies.propose(copy.deepcopy(snapshot), knobs.__getitem__,
                                 names)
    assert got == want
    if case in ("serve_over_budget", "transport_failover",
                "collective_quantize", "prefetch_grow", "cadence"):
        assert got, case


# -- the actuator layer -------------------------------------------------------

def _apply_case(pkg, case):
    """Run one ``apply`` scenario in one package: (journal verbs, the store
    after, the values journaled, what was raised)."""
    actuators, _, journal, chaos, drill = PACKAGES[pkg]
    reg, store = make_registry(actuators, drill)
    j = journal.Journal(clock=FakeClock())
    raised = []

    def apply(knob, value):
        try:
            actuators.apply(knob, value, {"case": case}, journal=j, reg=reg)
        except Exception as e:  # noqa: BLE001 — compared across packages
            raised.append(type(e).__name__)

    if case == "clamp_high":
        apply("data_streams_per_peer", 10_000)
    elif case == "clamp_low":
        apply("data_streams_per_peer", 10_000)   # from the floor, 1
        apply("data_streams_per_peer", -3)
    elif case == "bad_enum":
        apply("collective_compression", "zstd")
    elif case == "unknown_knob":
        apply("no_such_knob", 1)
    elif case == "noop":
        apply("data_prefetch_batches", store["data_prefetch_batches"])
    elif case == "chaos_fault":
        prev = chaos.schedule()
        chaos.configure(7, "autopilot.apply@1=error")
        try:
            apply("data_streams_per_peer", 4)
            assert store["data_streams_per_peer"] == 1  # restored
            apply("data_streams_per_peer", 4)           # @1 has fired
        finally:
            if prev is not None:
                chaos.install(prev)
            else:
                chaos.clear()
    recs = j.records()
    return ([d.action for d in recs], dict(store),
            [(d.knob, d.old, d.new, d.bounds) for d in recs], raised)


APPLY_WANT = {
    "clamp_high": (["clamped"], [], {"data_streams_per_peer": 16}),
    "clamp_low": (["clamped", "clamped"], [], {"data_streams_per_peer": 1}),
    "bad_enum": (["rejected"], ["ValueError"],
                 {"collective_compression": "none"}),
    "unknown_knob": (["rejected"], ["KeyError"], {}),
    "noop": ([], [], {}),
    "chaos_fault": (["failed", "applied"], ["ChaosError"],
                    {"data_streams_per_peer": 4}),
}


@pytest.mark.parametrize("case", sorted(APPLY_WANT))
def test_apply_clamps_rejects_and_journals_like_the_reference(case):
    got = _apply_case("torch", case)
    assert got == _apply_case("jax", case)
    verbs, raised, store_want = APPLY_WANT[case]
    assert got[0] == verbs and got[3] == raised
    for knob, value in store_want.items():
        assert got[1][knob] == value


# -- the controller: watch, revert, freeze, budget ---------------------------

def _controller_case(pkg, case):
    actuators, controller, journal, _, drill = PACKAGES[pkg]
    reg, store = make_registry(actuators, drill)
    clock = FakeClock()
    j = journal.Journal(clock=clock)
    out = []
    if case == "freeze":
        for val in (2, 0, 2):
            j.record(journal.Decision(knob="data_prefetch_batches", old=0,
                                      new=val, action=journal.APPLIED))
    pilot = controller.Autopilot(lambda: {}, journal=j, reg=reg, clock=clock)
    if case == "budget":
        snap = goodput_snapshot(compute=70.0, data_wait=20.0)
        snap["hazard_rate_per_hour"] = 6.0
        snap["cadence_inputs"] = {"step_cost_s": 1.0, "ckpt_cost_s": 0.5}
        snap.update(_link(bytes=10 * 2 ** 30))
        ticks = [snap]
    elif case == "revert":
        ticks = [goodput_snapshot(80.0, 20.0), goodput_snapshot(60.0, 5.0)]
    else:  # retire, freeze
        ticks = [goodput_snapshot(80.0, 20.0)] + \
            [goodput_snapshot(80.0, 5.0)] * 3
    for snap in ticks:
        out.append([(d.knob, d.action, d.old, d.new)
                    for d in pilot.tick(snap)])
        clock.t += 10.0
    status = pilot.status()
    return out, dict(store), status["watches"], status["flapping"]


@pytest.mark.parametrize("case", ["revert", "retire", "freeze", "budget"])
def test_controller_ticks_like_the_reference(case):
    got = _controller_case("torch", case)
    assert got == _controller_case("jax", case)
    decisions, store, watches, flapping = got
    if case == "revert":
        assert decisions == [[("data_prefetch_batches", "applied", 0, 2)],
                             [("data_prefetch_batches", "reverted", 2, 0)]]
        assert store["data_prefetch_batches"] == 0 and watches == []
    elif case == "retire":
        assert store["data_prefetch_batches"] == 2 and watches == []
    elif case == "freeze":
        assert decisions[0] == [] and "data_prefetch_batches" in flapping
    else:
        assert len(decisions[0]) == 2


# -- the journal: either package reads the other's ---------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_a_journal_reads_back_in_the_other_package(writer, reader):
    write_journal, read_journal = (PACKAGES[writer][2],
                                   PACKAGES[reader][2])
    state = FakeState()
    clock = FakeClock()
    j = write_journal.Journal(state=state, clock=clock)
    for i, val in enumerate((2, 4), start=1):
        clock.t += 1.0
        j.record(write_journal.Decision(
            knob="data_prefetch_batches", old=val - 2, new=val,
            evidence={"tick": i}, bounds=[0, 8], ttl_s=600.0))
    clock.t += 1.0
    j.record(write_journal.Decision(knob="serve.d.linger_ms", old=40.0,
                                    new=20.0, reason="queue wait"))
    assert read_journal.NAMESPACE == write_journal.NAMESPACE == b"autopilot"
    recs = read_journal.read_from_state(state)
    assert [(r["knob"], r["old"], r["new"]) for r in recs] == [
        ("data_prefetch_batches", 0, 2), ("data_prefetch_batches", 2, 4),
        ("serve.d.linger_ms", 40.0, 20.0)]
    assert recs == [json.loads(d.to_json()) for d in j.records()]
    assert read_journal.read_from_state(
        state, knob="serve.d.linger_ms")[0]["reason"] == "queue wait"
    latest = json.loads(state.kv_get(
        read_journal.KNOB_PREFIX + b"data_prefetch_batches",
        namespace=read_journal.NAMESPACE))
    assert latest["new"] == 4
    assert read_journal.flap_counts(recs, 60.0, 3, now=clock.t) == {}


# -- the A/B drill -----------------------------------------------------------

def test_drill_run_ab_equals_the_jax_package_and_the_autopilot_wins():
    assert torch_drill.DRILL_CHAOS_SPEC == jax_drill.DRILL_CHAOS_SPEC
    got, want = torch_drill.run_ab(), jax_drill.run_ab()
    assert got == want
    assert got["gain_pct"] > 0
    assert got["on"]["goodput_pct"] > got["off"]["goodput_pct"]
    touched = {r["knob"] for r in got["on"]["journal"]}
    assert {torch_drill.LINGER_KNOB, "data_prefetch_batches",
            "collective_compression"} <= touched


# -- the lifted seam: a batched deployment's actuators -----------------------

@pytest.fixture
def autopilot_serve():
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import _config
    was = _config.get("autopilot_enabled")
    _config.set("autopilot_enabled", True)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        yield serve
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        _config.set("autopilot_enabled", was)


def test_a_batched_deployment_registers_and_unregisters_its_actuators(
        autopilot_serve):
    serve = autopilot_serve
    reg = torch_actuators.registry()

    @serve.deployment(max_batch_size=4, batch_wait_timeout_s=0.05)
    def doubled(xs):
        return [2 * x for x in xs]

    @serve.deployment
    def plain(x):
        return x

    h = serve.run(doubled.options(name="ap_batched").bind(),
                  route_prefix=None)
    serve.run(plain.options(name="ap_plain").bind(), route_prefix=None)
    assert h.remote(3).result(timeout=30) == 6
    linger = reg.get("serve.ap_batched.linger_ms")
    cap = reg.get("serve.ap_batched.max_batch_size")
    assert linger is not None and cap is not None
    assert (linger.kind, linger.lo, linger.hi) == ("float", 1.0, 1000.0)
    assert (cap.kind, cap.lo, cap.hi) == ("int", 1, 1024)
    assert not [n for n in reg.names() if n.startswith("serve.ap_plain.")]
    assert linger.get() == pytest.approx(50.0) and cap.get() == 4
    # the guardrailed write path retunes the live deployment
    j = torch_journal.Journal(clock=FakeClock())
    dec = torch_actuators.apply("serve.ap_batched.linger_ms", 5000.0,
                                {"why": "test"}, journal=j)
    assert (dec.action, dec.new) == (torch_journal.CLAMPED, 1000.0)
    assert linger.get() == pytest.approx(1000.0)
    torch_actuators.apply("serve.ap_batched.linger_ms", 2.0, {}, journal=j)
    t0 = time.perf_counter()
    assert h.remote(4).result(timeout=30) == 8
    assert time.perf_counter() - t0 < 0.9   # the 1 s linger is gone
    serve.delete("ap_batched")
    assert reg.get("serve.ap_batched.linger_ms") is None
    assert reg.get("serve.ap_batched.max_batch_size") is None
