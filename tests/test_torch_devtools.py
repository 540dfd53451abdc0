"""The port's static analysis (``ray_tpu_torch/devtools``) against the JAX
package's, and the port's ``bench_micro``.

- The rules that know no JAX (R1-R4, R6-R20, R22-R26) must give the same
  ``(rule, tag, path, line)`` under both engines, on the neutral fixture
  corpus and on every inline source of ``tests/test_devtools.py``; where a
  source names the package, the port lints it with ``ray_tpu`` spelled
  ``ray_tpu_torch`` (and a ``tests/test_*.py`` file named
  ``tests/test_torch_*.py``, the only test files the port's engine counts).
- The JAX rules (R5, R21, R27-R29) fire, in PyTorch form, at the same
  lines as the JAX forms the reference lints; the JAX forms with no
  PyTorch counterpart are named here and stay quiet.
- The port lints clean with an empty baseline, and its fixture corpus
  round-trips ``expected.json``.
"""

import ast
import json
import os
import re
import textwrap
import threading

import numpy as np
import pytest

from ray_tpu.devtools.linter import LintEngine as RefEngine
from ray_tpu_torch.devtools import callgraph as port_cg
from ray_tpu_torch.devtools import linter as port_linter
from ray_tpu_torch.devtools import shardprop as port_sp
from ray_tpu_torch.devtools.linter import FileContext
from ray_tpu_torch.devtools.linter import LintEngine as PortEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "ray_tpu", "devtools", "fixtures")
PORT_FIXTURES = os.path.join(REPO, "ray_tpu_torch", "devtools", "fixtures")
NEUTRAL = {f"R{i}" for i in (1, 2, 3, 4, *range(6, 21), *range(22, 27))}
JAX_RULES = ("R5", "R21", "R27", "R28", "R29")


def _keys(findings, rules=None):
    return sorted({(f.rule, f.tag, f.path.replace("\\", "/"), f.line)
                   for f in findings if rules is None or f.rule in rules})


def _lint(engine_cls, roots, rules=None):
    eng = engine_cls([str(r) for r in roots], only_rules=rules)
    findings = eng.run()
    assert not eng.errors, eng.errors
    return findings


# -- the neutral rules: both engines, same findings ---------------------------

def test_neutral_fixture_corpus_gives_equal_findings():
    ref = _keys(_lint(RefEngine, [REF_FIXTURES]), NEUTRAL)
    port = _keys(_lint(PortEngine, [PORT_FIXTURES]), NEUTRAL)
    assert ref == port
    assert len({k[0] for k in ref}) == 16     # R10-R20, R22-R26


def _module_strings(tree):
    """Module-level NAME = "..." constants (shared sources)."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _text(node, consts):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _inline_cases():
    """(id, rule, {relpath: source}, kind) for every lint call in the
    reference's devtools tests whose rule is neutral and whose sources are
    literal: ``run_rule`` (one file at its name), ``run_rule_in_tree``
    (one file under ``pkg/``) and ``run_tree`` (a tree under ``proj/``)."""
    path = os.path.join(REPO, "tests", "test_devtools.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    consts = _module_strings(tree)
    cases = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.startswith("test_"):
            continue
        n = 0
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Name):
                continue
            helper, args = node.func.id, node.args
            if helper not in ("run_rule", "run_rule_in_tree", "run_tree") \
                    or len(args) < 3:
                continue
            rule = _text(args[1], consts)
            if rule not in NEUTRAL:
                continue
            if helper == "run_rule":
                src = _text(args[2], consts)
                name = _text(args[3], consts) if len(args) > 3 else \
                    "fixture.py"
                files = {name: src} if src and name else None
                kind = "file"
            elif helper == "run_rule_in_tree":
                rel, src = _text(args[2], consts), \
                    _text(args[3], consts) if len(args) > 3 else None
                files = {rel: src} if rel and src else None
                kind = "pkg"
            else:
                files = None
                if isinstance(args[2], ast.Dict):
                    files = {}
                    for k, v in zip(args[2].keys, args[2].values):
                        kt, vt = _text(k, consts), _text(v, consts)
                        if kt is None or vt is None:
                            files = None
                            break
                        files[kt] = vt
                kind = "proj"
            if files:
                n += 1
                cases.append((f"{fn.name}-{n}", rule, files, kind))
    return cases


_CASES = _inline_cases()


def _port_path(rel):
    """Where the port's form of a reference file goes: the package named
    ``ray_tpu_torch``, a test file named ``test_torch_*``."""
    parts = rel.split("/")
    parts = ["ray_tpu_torch" if p == "ray_tpu" else p for p in parts]
    if "tests" in parts[:-1] and parts[-1].startswith("test_"):
        parts[-1] = "test_torch_" + parts[-1][len("test_"):]
    return "/".join(parts)


def _write_and_lint(engine_cls, base, rule, files, kind, port):
    root = base / ("pkg" if kind == "pkg" else "proj")
    written = []
    for rel, src in files.items():
        text = textwrap.dedent(src)
        if port:
            rel = _port_path(rel)
            text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)
        p = (base / rel) if kind == "file" else (root / rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
        written.append(p)
    roots = written if kind == "file" else [root]
    keys = _keys(_lint(engine_cls, roots, {rule}))
    if port:       # name the port's paths as the reference's for comparison
        back = {_port_path(r): r for r in files}
        keys = [(r, t, "/".join(_unport(p, back)), ln)
                for r, t, p, ln in keys]
    return sorted(keys)


def _unport(path, back):
    """A port path (``proj/<rel>``, ``pkg/<rel>`` or a bare file name)
    as the reference's."""
    prefix, _, rest = path.partition("/")
    if rest in back:
        return [prefix, back[rest]]
    return [back.get(path, path)]


def test_inline_cases_cover_the_neutral_rules():
    assert len(_CASES) >= 40, len(_CASES)
    assert {rule for _, rule, _, _ in _CASES} >= {
        "R1", "R2", "R3", "R4", "R7", "R9", "R10", "R11", "R12", "R13",
        "R16", "R17", "R18", "R19", "R20", "R23", "R24", "R25"}


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_inline_source_gives_equal_findings(case, tmp_path):
    _id, rule, files, kind = case
    ref = _write_and_lint(RefEngine, tmp_path / "ref", rule, files, kind,
                          port=False)
    port = _write_and_lint(PortEngine, tmp_path / "port", rule, files,
                           kind, port=True)
    assert port == ref


# -- the JAX rules in PyTorch form ---------------------------------------------

# Lines of the reference's fixtures whose JAX form has no PyTorch
# counterpart: static_argnums fed a dict / list / .shape and a raw len()
# into a jitted call (R21), and a wasted donation (R28).
NO_COUNTERPART = {
    ("R21", "fixtures/r21_jit.py", 53), ("R21", "fixtures/r21_jit.py", 66),
    ("R21", "fixtures/r21_jit.py", 69), ("R21", "fixtures/r21_jit.py", 76),
    ("R28", "fixtures/r28_reshard.py", 46),
}


@pytest.mark.parametrize("rule", ["R21", "R27", "R28", "R29"])
def test_paired_fixtures_fire_at_the_same_lines(rule):
    """The reference's JAX fixture and the port's PyTorch fixture of the
    same rule are line for line alike: each fires where the other does,
    but for the forms named in NO_COUNTERPART."""
    ref = {(r, p, ln) for r, _t, p, ln in
           _keys(_lint(RefEngine, [REF_FIXTURES], {rule}))}
    port = {(r, p, ln) for r, _t, p, ln in
            _keys(_lint(PortEngine, [PORT_FIXTURES], {rule}))}
    assert port, rule
    assert port == ref - NO_COUNTERPART


# The JAX form of the port's r5_host_sync.py, line for line: the
# counterpart of the CUDA-graph capture's body is a function handed to
# lax.scan, whose sink sits on the capture's synchronize() line.
R5_JAX = '''\
"""R5 fixture, JAX form."""









import jax
import numpy as np

def helper(x):
    return float(x)


@jax.jit
def step(x):
    return helper(x) + x.item()


def body(x):
    return np.asarray(x.sum())


def build(xs, static):
    fast = jax.jit(body)
    return fast, jax.lax.scan(_scan_body, static, xs)
def _scan_body(c, x):
    return c, jax.device_get(x)


def report(x):
    return float(x), x.item(), np.asarray(x)
'''


def test_r5_paired_fixture_fires_at_the_same_lines(tmp_path):
    """The reference's R5 on the JAX form and the port's on
    ``fixtures/r5_host_sync.py`` (``torch.compile`` roots and a
    ``torch.cuda.graph`` capture) flag the same lines."""
    jax_file = tmp_path / "r5_host_sync.py"
    jax_file.write_text(R5_JAX)
    ref = {(r, ln) for r, _t, _p, ln in _keys(_lint(RefEngine, [jax_file],
                                                    {"R5"}))}
    port = {(r, ln) for r, _t, _p, ln in _keys(_lint(
        PortEngine, [os.path.join(PORT_FIXTURES, "r5_host_sync.py")],
        {"R5"}))}
    assert port == ref == {("R5", 15), ("R5", 20), ("R5", 24), ("R5", 31)}


def _lint_text(tmp_path, engine_cls, rule, text, name="m.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return _lint(engine_cls, [p], {rule})


def test_r5_quiet_without_a_compiled_root(tmp_path):
    assert _lint_text(tmp_path, PortEngine, "R5", """\
        import torch

        def metrics(x):
            return float(x), x.item(), x.cpu()
        """) == []


def test_r5_resolves_imported_names(tmp_path):
    got = _lint_text(tmp_path, PortEngine, "R5", """\
        from torch import compile as build
        from torch.func import grad
        import numpy as onp

        def loss(x):
            return onp.asarray(x).sum()

        def step(x):
            return x.tolist()

        fast = build(step)
        g = grad(loss)
        """)
    assert [(f.line, f.rule) for f in got] == [(6, "R5"), (9, "R5")]


def test_r21_put_then_write_needs_the_same_tensor(tmp_path):
    got = _lint_text(tmp_path, PortEngine, "R21", """\
        import ray_tpu_torch as rt
        from ray_tpu_torch import put

        def bad(t):
            ref = rt.put(t)
            t[0] = 1
            return ref

        def bad_out(t, a):
            ref = put(t)
            torch.add(a, a, out=t)
            return ref

        def clone_first(t):
            ref = rt.put(t.clone())
            t.add_(1)
            return ref

        def rebound(t):
            ref = rt.put(t)
            t = t * 2
            t.add_(1)
            return ref

        def other_tensor(t, u):
            ref = rt.put(t)
            u.add_(1)
            return ref
        """)
    assert [f.line for f in got] == [6, 11]
    assert all("modified in place" in f.message for f in got)


def test_r21_ignores_local_helpers_named_compile(tmp_path):
    assert _lint_text(tmp_path, PortEngine, "R21", """\
        from mytools import compile

        def hot(xs):
            for x in xs:
                f = compile(x)
                f()
        """) == []


def test_r21_cached_builders_stay_quiet(tmp_path):
    assert _lint_text(tmp_path, PortEngine, "R21", """\
        import functools
        import torch

        _STEP = torch.compile(lambda v: v)

        @functools.lru_cache(maxsize=8)
        def build(n):
            f = torch.compile(lambda v: v)
            f(n)
            return f

        class Model:
            def __init__(self):
                self.graph = torch.cuda.CUDAGraph()

            def step(self):
                self.graph.replay()
        """) == []


def test_r28_needs_redistribute_inputs(tmp_path):
    """Without ``redistribute_inputs=True`` local_map raises on a
    mismatched input instead of resharding: nothing silent to flag."""
    src = """\
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import local_map

        def _one(x):
            return x

        STEP = local_map(_one, out_placements=(Shard(0),),
                         in_placements=((Shard(0),),)%s)

        def run(x, mesh):
            x = distribute_tensor(x, mesh, (Replicate(),))
            return STEP(x)
        """
    assert _lint_text(tmp_path, PortEngine, "R28", src % "") == []
    got = _lint_text(tmp_path, PortEngine, "R28",
                     src % ", redistribute_inputs=True")
    assert [f.line for f in got] == [13]


def test_r29_manifest_is_what_the_doctor_reads(tmp_path):
    """The manifest the port's R29 writes is the plan the port's doctor
    checks the collective ledger against: planned ops are quiet, an op the
    plan lacks is unplanned drift."""
    from ray_tpu_torch import doctor
    from ray_tpu_torch.observability import comms

    src = textwrap.dedent("""\
        import torch.distributed as dist

        from ray_tpu_torch import collective
        from ray_tpu_torch.parallel.spmd import psum

        AXIS_ORDER = ("data", "tensor")

        def ring(x, mesh):
            dist.all_gather_into_tensor(x, x, group=mesh.group("tensor"))
            return psum(x, mesh, "data")

        def sync(t):
            return collective.allreduce(t, group_name="g")
        """)
    p = tmp_path / "m.py"
    p.write_text(src)
    eng = PortEngine([str(p)], only_rules={"R29"})
    assert eng.run() == []
    man = eng.comms_manifest
    assert man["mesh_axes"] == ["data", "tensor"]
    assert man["groups"] == {
        "axis:data": {"psum": {"sites": [["m.py", 10]],
                               "wire_formula": "2*(n-1)/n"}},
        "axis:tensor": {"allgather": {"sites": [["m.py", 9]],
                                      "wire_formula": "(n-1)/n"}},
        "g": {"allreduce": {"sites": [["m.py", 13]],
                            "wire_formula": "2*(n-1)/n"}}}
    ledger = {"g": {"world_size": 2, "ops": {
        "allreduce": {"count": 3, "bytes": 4096.0, "wire_bytes": 4096.0}}}}
    assert doctor._manifest_drift(ledger, man) == []
    ledger["g"]["ops"]["broadcast"] = {"count": 1, "bytes": 8.0}
    assert [d["metric"] for d in doctor._manifest_drift(ledger, man)] == [
        "broadcast_unplanned"]
    for op, fac in comms._BUSBW.items():
        for n in (2, 4, 8):
            assert port_sp.wire_factor(op, n) == pytest.approx(fac(n))


def test_r29_dynamic_axes_and_world_ops_are_unresolved(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(textwrap.dedent("""\
        import torch.distributed as dist
        from ray_tpu_torch.parallel.spmd import psum

        AXIS_ORDER = ("data",)

        def f(x, mesh, axis):
            dist.all_reduce(x)
            return psum(x, mesh, axis)
        """))
    model = port_sp.ShardModel([FileContext(str(p), "m.py",
                                            p.read_text())])
    man = port_sp.build_manifest(model)
    assert man["groups"] == {} and man["unresolved_sites"] == 2


# -- the package's names and the R18 dispatch table -----------------------------

def test_package_names_come_from_the_package_root():
    assert port_cg.PKG == port_linter._PKG == port_sp.PKG == "ray_tpu_torch"
    assert all(q.startswith("ray_tpu_torch.")
               for q in port_cg.BARRIER_QNAMES)
    assert port_linter._OBS_MODULE == "ray_tpu_torch.observability"
    assert port_linter._is_test_path("tests/test_torch_runtime.py")
    assert not port_linter._is_test_path("tests/test_core.py")


def test_r18_reads_the_python_state_services_dispatch_table():
    """The port's state service dispatches through ``{pb.M: handler}``:
    the port's R18 counts its keys as arms, so the state client's sends
    all have a handler; the reference's R18, which looks for ``.method
    ==`` arms and a native switch, finds none of them."""
    files = [os.path.join(REPO, "ray_tpu_torch", "_private", f)
             for f in ("state_client.py", "state_service.py")]
    assert _lint(PortEngine, files, {"R18"}) == []
    ref = _lint(RefEngine, files, {"R18"})
    assert len(ref) >= 20 and all("no dispatcher handles it" in f.message
                                  for f in ref)


def test_r18_dispatch_table_needs_protocol_keys(tmp_path):
    src = """\
        from proto import pb

        def send(client):
            client.call(pb.PING, b"")

        TABLE = %s
        """
    with_table = _lint_text(tmp_path, PortEngine, "R18",
                            src % "{pb.PING: print}")
    plain_dict = _lint_text(tmp_path, PortEngine, "R18",
                            src % "{pb.PING: print, 'x': print}")
    assert with_table == []
    assert [f.line for f in plain_dict] == [4]


def test_state_service_publishes_only_under_its_lock():
    """The justification of R25's allow at ``StateService._publish``:
    every caller holds ``self._lock``. Each publishing handler runs from
    ``_handle``'s dispatch table and the heartbeat sweep from ``serve()``;
    a wrapped ``_publish`` asserts the lock on every call."""
    from ray_tpu_torch._private import state_service
    from ray_tpu_torch._private.state_client import StateClient
    from ray_tpu_torch.protocol import pb

    svc = state_service.StateService(port=0, heartbeat_timeout_ms=300)
    calls = []
    orig = svc._publish

    def checked(channel, kind, payload):
        calls.append((channel, kind, svc._lock.locked()))
        return orig(channel, kind, payload)

    svc._publish = checked
    svc.start()
    errors = []

    def drive():
        # the client on a thread, serve() on this one: the service's own
        # process runs its sweep loop on its main thread
        try:
            client = StateClient(f"127.0.0.1:{svc.port}")
        except BaseException as e:  # raylint: allow(swallow) raised again below, on the test's thread
            errors.append(e)
            svc.stop()
            return
        try:
            node = pb.NodeInfo(node_id=b"n" * 16, address="127.0.0.1:1",
                               alive=True)
            client.register_node(node)
            client.kv_put(b"k", b"v", namespace=b"ns")
            client.drain_node(b"n" * 16, reason="test", deadline_s=5.0)
            wait = threading.Event()
            for _ in range(50):        # the sweep marks the node dead
                if any(k == "NODE_DEAD" for _c, k, _l in calls):
                    break
                wait.wait(0.1)
        except BaseException as e:  # raylint: allow(swallow) raised again below, on the test's thread
            errors.append(e)
        finally:
            client.close()
            svc.stop()

    t = threading.Thread(target=drive)
    t.start()
    svc.serve()
    t.join(timeout=60)
    if errors:
        raise errors[0]
    kinds = [k for _c, k, _l in calls]
    assert {"NODE_ADDED", "PUT", "NODE_DRAINING", "NODE_DEAD"} <= set(kinds)
    assert all(held for _c, _k, held in calls), calls


# -- the port's own tree -----------------------------------------------------

def test_self_check_round_trips_the_ports_corpus(capsys):
    assert port_linter._run_self_check() == 0
    out = capsys.readouterr().out
    assert "self-check: OK (49 fixture findings round-trip)" in out
    expected = json.load(open(os.path.join(PORT_FIXTURES, "expected.json")))
    assert {e["rule"] for e in expected} == {
        f"R{i}" for i in (5, *range(10, 30))}


def test_runtime_modules_stay_field_clean():
    """The port's runtime, Serve and collective modules lint clean under
    the field rules (R23-R25), as the reference's do under its own."""
    targets = [os.path.join(REPO, "ray_tpu_torch", rel) for rel in (
        "_private/rpc.py", "_private/state_server.py",
        "_private/state_service.py", "_private/memory_monitor.py",
        "_private/reference_counter.py", "util/client/client.py",
        "serve/_private", "collective/collective_group")]
    assert _lint(PortEngine, targets, {"R23", "R24", "R25"}) == []


def test_spmd_modules_stay_shard_clean():
    targets = [os.path.join(REPO, "ray_tpu_torch", rel)
               for rel in ("parallel", "train", "models", "rl")]
    assert _lint(PortEngine, targets, set(JAX_RULES)) == []


def test_port_core_lints_clean_with_an_empty_baseline():
    """``_private``, ``serve``, ``parallel`` and ``collective`` together,
    every rule but R13 and R18, whose closures (config knobs and chaos
    points; protocol senders and handlers) span the whole package: the
    CLI's ``python -m ray_tpu_torch.devtools.lint ray_tpu_torch`` holds
    those."""
    rules = {r for r, _t, _f in port_linter.RULES + port_linter.PROJECT_RULES
             if r not in ("R13", "R18")}
    roots = [os.path.join(REPO, "ray_tpu_torch", rel)
             for rel in ("_private", "serve", "parallel", "collective")]
    assert [f.format() for f in _lint(PortEngine, roots, rules)] == []


# -- bench_micro ---------------------------------------------------------------

@pytest.fixture
def bench():
    from ray_tpu_torch import bench_micro
    bench_micro.RESULTS.clear()
    yield bench_micro
    bench_micro.RESULTS.clear()


def test_bench_micro_inproc_rows(bench):
    import ray_tpu_torch as rt
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        bench.bench_tasks("inproc", n=60)
        bench.bench_actor_calls("inproc", n=40)
        bench.bench_trace_overhead("inproc", n=20)
        bench.bench_goodput("inproc", n=5)
        bench.bench_churn_goodput()
    finally:
        rt.shutdown()
    rows = {r["metric"]: r for r in bench.RESULTS}
    assert {"inproc_tasks_per_second", "inproc_actor_roundtrips_per_second",
            "inproc_actor_calls_per_second", "inproc_put_get_traced_us",
            "inproc_trace_overhead_enabled_pct",
            "inproc_trace_overhead_disabled_pct",
            "inproc_goodput_overhead_pct",
            "inproc_fleet_goodput_pct", "goodput_under_churn_pct"} <= set(rows)
    assert rows["inproc_tasks_per_second"]["value"] > 0
    # the fixed-input rows are the JAX package's numbers exactly
    assert rows["inproc_fleet_goodput_pct"]["value"] == 92.5
    assert all(np.isfinite(r["value"]) for r in bench.RESULTS)


def test_bench_micro_check_gates_like_the_reference(bench, tmp_path, capsys):
    """``--check``: throughput floors, latency and overhead ceilings,
    goodput floors; a metric missing on either side (``gpu_serve_qps`` on
    a machine without a card) is skipped."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps([
        {"metric": "inproc_tasks_per_second", "value": 100.0},
        {"metric": "inproc_put_get_1kb_us", "value": 10.0},
        {"metric": "inproc_fleet_goodput_pct", "value": 90.0},
        {"metric": "gpu_serve_qps", "value": 1000.0}]))
    bench.emit("inproc_tasks_per_second", 80.0, "tasks/s")
    bench.emit("inproc_put_get_1kb_us", 20.0, "us")
    bench.emit("inproc_fleet_goodput_pct", 92.5, "%")
    assert bench.check_against(str(base), 0.7) == 1
    out = capsys.readouterr().out
    assert "inproc_put_get_1kb_us: 20.00 vs baseline 10.00" in out
    assert "REGRESSION" in out and "gpu_serve_qps" not in out


def test_bench_micro_preempt_env_is_one_the_daemon_parses(bench):
    """The JAX package's bench passes ``RAY_TPU_PREEMPT_POLL_MS="200.0"``
    for an int knob, so its daemon exits at start; the port's passes an
    integer's text, which the config's int parser takes."""
    from ray_tpu_torch._private import config
    env = bench.preempt_daemon_env(200.0)
    assert env["RAY_TPU_PREEMPT_POLL_MS"] == "200"
    assert config._PARSERS[int](env["RAY_TPU_PREEMPT_POLL_MS"]) == 200
    with pytest.raises(ValueError):
        config._PARSERS[int](str(200.0))
