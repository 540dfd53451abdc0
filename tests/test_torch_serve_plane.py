"""The port's Serve plane (``ray_tpu_torch.serve``) against ``ray_tpu.serve``.

One serve instance per package lives for the whole module (runtime,
controller and HTTP proxy), so the 3 s join of ``serve.shutdown`` is paid
once per package. Each parity scenario is one function ``scenario(pkg)``,
run under ``ray_tpu`` and then under ``ray_tpu_torch``; their returned
values, and the class names of what they raise, must be equal. The
scenarios mirror ``tests/test_serve.py`` and ``tests/test_serve_scale.py``.
Then the tiny transformer served by both packages (``JaxPredictor`` against
``TorchPredictor`` on the CPU, through a handle and through HTTP), and the
seams only the port has: the version hash of tensor arguments, deployments
from a checkpoint of the JAX engine, the autopilot refusal, GPU grants and
the release of a deleted
replica's weights. Checks that need a card are in ``chip_smoke.py``'s
phase 16.
"""

import dataclasses
import gc
import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.air.predictor import JaxPredictor
from ray_tpu.models import transformer as jax_transformer
from ray_tpu_torch.air import TorchPredictor
from ray_tpu_torch.models import transformer
from ray_tpu_torch.serve.batching import next_bucket

PACKAGES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=32, use_flash=True)
LENGTH_BUCKETS = (16, 32)


def sub(rt, name):
    """``rt``'s module ``name``: ``serve.config`` → ``ray_tpu.serve.config``."""
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(scope="module")
def instances(tmp_path_factory):
    """Both packages' runtime, serve controller and HTTP proxy, with their
    files under pytest's temporary directory and no flight recorder:
    ``{package name: SimpleNamespace(rt, serve, config, base)}``. The
    port's node has one GPU, so replicas can ask for one on the CPU (a
    grant names ``cuda:0``; nothing runs there)."""
    saved, out = [], {}
    try:
        for rt in PACKAGES:
            config = sub(rt, "_private.config")._config
            saved.append((config, dict(config._values)))
            root = tmp_path_factory.mktemp(rt.__name__)
            for flag in DIR_FLAGS:
                config.set(flag, str(root / flag))
            # The flight recorder is process-wide and outlives shutdown:
            # installing it here would root it under this module's
            # directory for every later test in the process.
            config.set("flight_recorder_enabled", False)
            rt.shutdown()
            extra = {"num_gpus": 1} if rt is ray_tpu_torch else {}
            rt.init(num_cpus=8, **extra)
            serve = sub(rt, "serve")
            serve.start()
            out[rt.__name__] = types.SimpleNamespace(
                rt=rt, serve=serve, config=config,
                base=serve.start_http_proxy())
            # Deleted at shutdown, which moves the route table and so wakes
            # the proxy's long poll: otherwise it stays parked (up to 30 s)
            # and the shutdown hook that ray_tpu.shutdown runs joins it 3 s
            # more.
            serve.run(serve.deployment(keeper).bind(), route_prefix="/keep")
        yield out
    finally:
        # Each serve.shutdown waits up to 3 s for its parked long polls:
        # the two packages wait side by side.
        threads = [threading.Thread(target=lambda rt=rt: (
            sub(rt, "serve").shutdown(), rt.shutdown())) for rt in PACKAGES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for config, values in saved:
            config._values = values


def keeper(x):
    return x


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def outcome(fn, *args, **kwargs):
    """``fn``'s value, or the class names of what it raised (and of the
    cause a ``TaskError`` carries)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        cause = getattr(e, "cause", None)
        return ("raised", type(e).__name__,
                type(cause).__name__ if cause is not None else None)


def burst(handle, values, timeout=60):
    """All values through the handle at once; each caller's result or the
    exception it got. The handle's router is built first: the JAX
    package's handle builds one per thread when its first requests race,
    and each parks a long poll that its shutdown then waits on."""
    handle._get_router()
    out = [None] * len(values)
    barrier = threading.Barrier(len(values))

    def call(i, v):
        barrier.wait()
        try:
            out[i] = handle.remote(v).result(timeout=timeout)
        except Exception as e:  # noqa: BLE001 - scenarios inspect errors
            out[i] = e

    threads = [threading.Thread(target=call, args=(i, v))
               for i, v in enumerate(values)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    return out


def finish(p, handle, *names):
    """Stop the handle's router, then delete the deployments (the delete
    wakes the router's parked long poll, which then exits)."""
    handle.shutdown()
    for name in names:
        p.serve.delete(name)


def http(base, path, body=None, headers=None, timeout=30):
    """(status, headers, body bytes) of a GET (no body) or POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# -- deploy, call, status (tests/test_serve.py) -----------------------------

@scenario
def deploy_and_call_with_methods(p):
    @p.serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    @p.serve.deployment
    def double(x):
        return 2 * x

    h = p.serve.run(Echo.bind(), route_prefix="/echo")
    by_name = p.serve.get_deployment_handle("Echo")
    out = [h.remote(42).result(timeout=30),
           h.shout.remote("hi").result(timeout=30),
           h.options("shout").remote("yo").result(timeout=30),
           by_name.remote(1).result(timeout=30)]
    by_name.shutdown()
    hd = p.serve.run(double.bind(), route_prefix=None)
    out.append(hd.remote(21).result(timeout=30))
    out.append(outcome(lambda: h.missing.remote(1).result(timeout=30)))
    finish(p, h, "Echo")
    finish(p, hd, "double")
    out.append(sorted(p.serve.status()))
    return out


@scenario
def num_replicas_and_status(p):
    @p.serve.deployment(num_replicas=2)
    class Who:
        def __init__(self):
            self.me = object()

        def __call__(self, _):
            time.sleep(0.2)             # overlap, so both replicas serve
            return id(self.me)

    h = p.serve.run(Who.bind(), route_prefix=None)
    st = p.serve.status()["Who"]
    seen = set(burst(h, list(range(8))))
    finish(p, h, "Who")
    return ({k: st[k] for k in ("name", "target_replicas",
                                "running_replicas", "ready_replicas",
                                "deleting", "version")}, len(seen))


@scenario
def user_config_reconfigures_in_place(p):
    @p.serve.deployment(user_config={"v": 1})
    class Conf:
        def __init__(self):
            self.v, self.me = None, object()

        def reconfigure(self, cfg):
            self.v = cfg["v"]

        def __call__(self, _):
            return self.v, id(self.me)

    h = p.serve.run(Conf.bind(), route_prefix=None)
    v1, me1 = h.remote(0).result(timeout=30)
    p.serve.run(Conf.options(user_config={"v": 2}).bind(), route_prefix=None)
    v2, me2 = h.remote(0).result(timeout=30)
    finish(p, h, "Conf")
    return v1, v2, me1 == me2


@scenario
def rolling_update_on_code_change(p):
    @p.serve.deployment(name="versioned")
    class V1:
        def __call__(self, x):
            return "v1"

    @p.serve.deployment(name="versioned")
    class V2:
        def __call__(self, x):
            return "v2"

    h = p.serve.run(V1.bind(), route_prefix="/v")
    first = h.remote(0).result(timeout=30)
    version = p.serve.status()["versioned"]["version"]
    p.serve.run(V2.bind(), route_prefix="/v")
    deadline = time.monotonic() + 30
    while (h.remote(0).result(timeout=30) != "v2"
           and time.monotonic() < deadline):
        time.sleep(0.05)
    after = h.remote(0).result(timeout=30)
    changed = p.serve.status()["versioned"]["version"] != version
    finish(p, h, "versioned")
    return first, after, changed


@scenario
def deployment_graph_composition(p):
    @p.serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x + 1

    @p.serve.deployment
    class Pipeline:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout=30) * 100

    h = p.serve.run(Pipeline.bind(Preprocessor.bind()), route_prefix=None)
    out = h.remote(4).result(timeout=60)
    # Left to serve.shutdown: the Pipeline replica's own handle would stay
    # parked on a deleted Preprocessor (its replica never stops it).
    h.shutdown()
    return out


@scenario
def checkpoint_value_reaches_init(p):
    @p.serve.deployment(checkpoint={"w": 3})
    class FromCkpt:
        def __init__(self, checkpoint=None):
            self.ckpt = checkpoint

        def __call__(self, x):
            return self.ckpt["w"] * x

    h = p.serve.run(FromCkpt.bind(), route_prefix=None)
    out = h.remote(5).result(timeout=30)
    finish(p, h, "FromCkpt")
    return out


# -- the replica batcher (tests/test_serve_scale.py) ------------------------

@scenario
def batch_sizes_under_pad_batch_to(p):
    # Bursts of whole batches, so no batch waits out the linger, which is
    # long so that a burst stays whole on a loaded machine too.
    @p.serve.deployment(max_batch_size=3, batch_wait_timeout_s=0.5,
                        pad_batch_to=(2, 4))
    class Bucketed:
        def __init__(self):
            self.sizes = []

        def __call__(self, items):
            self.sizes.append(len(items))
            return [2 * v for v in items]

        def seen(self):
            return self.sizes

    h = p.serve.run(Bucketed.bind(), route_prefix=None)
    out = [burst(h, [1, 2, 3]), burst(h, [1, 2, 3, 4, 5, 6])]
    out.append(h.seen.remote().result(timeout=30))
    finish(p, h, "Bucketed")
    return out


@scenario
def batch_errors_isolated_per_item(p):
    @p.serve.deployment(max_batch_size=3, batch_wait_timeout_s=0.5)
    class Picky:
        def __call__(self, items):
            if any(v == "poison" for v in items):
                raise ValueError("poisoned batch")
            return [v + "!" for v in items]

    def kinds(results):
        return [r if isinstance(r, str) else
                (type(r).__name__, type(getattr(r, "cause", None)).__name__)
                for r in results]

    h = p.serve.run(Picky.bind(), route_prefix=None)
    out = [kinds(burst(h, ["a", "poison", "b"]))]
    p.config.set("serve_batch_retry_singletons", False)
    try:
        tagged = burst(h, ["a", "poison", "b"])
    finally:
        p.config.set("serve_batch_retry_singletons", True)
    out.append(kinds(tagged))
    out.append(sorted({getattr(e, "batch_size", None) for e in tagged
                       if isinstance(e, Exception)}))
    finish(p, h, "Picky")
    return out


@scenario
def queue_deadline_sheds_not_hangs(p):
    @p.serve.deployment(max_batch_size=2, batch_wait_timeout_s=0.001)
    class Sluggish:
        def __call__(self, items):
            time.sleep(0.08)
            return list(items)

    h = p.serve.run(Sluggish.bind(), route_prefix=None)
    old = p.config.get("serve_queue_deadline_ms")
    p.config.set("serve_queue_deadline_ms", 150.0)
    try:
        t0 = time.monotonic()
        results = burst(h, [[i] for i in range(16)], timeout=30)
        elapsed = time.monotonic() - t0
    finally:
        p.config.set("serve_queue_deadline_ms", old)
    finish(p, h, "Sluggish")
    ok = [r for r in results if isinstance(r, list)]
    shed = [r for r in results if isinstance(r, p.serve.ServeOverloadedError)]
    return (len(ok) + len(shed), bool(ok), bool(shed),
            all(e.retry_after_s > 0 for e in shed), elapsed < 20.0)


# -- the HTTP proxy ---------------------------------------------------------

@scenario
def http_proxy_routes_health_streaming_and_errors(p):
    @p.serve.deployment
    class Lister:
        def __call__(self, n):
            if n == "set":
                return {1, 2}           # not JSON: the proxy answers 500
            return list(range(n or 3))

    h = p.serve.run(Lister.bind(), name="lister", route_prefix="/list")
    out = []
    for path in ("/-/healthz", "/-/routes"):
        code, _, body = http(p.base, path)
        out.append((code, json.loads(body)))
    code, headers, body = http(p.base, "/list", 4, {"X-Serve-Stream": "1"})
    out.append((code, headers.get("Transfer-Encoding"),
                [json.loads(x) for x in body.split(b"\n") if x]))
    out.append(http(p.base, "/list", 2)[::2])
    out.append(http(p.base, "/list/sub", 1)[::2])
    out.append(http(p.base, "/list", "set")[0])
    out.append(http(p.base, "/nope-xyzzy")[0])
    # A second proxy, draining: new requests and its health check get 503.
    proxy = sub(p.rt, "serve._private.http_proxy").HTTPProxy(
        sub(p.rt, "serve.api")._get_controller())
    try:
        proxy._draining = True
        for path in ("/list", "/-/healthz"):
            code, headers, _ = http(proxy.address(), path)
            out.append((code, headers.get("Retry-After")))
    finally:
        proxy.shutdown()
    finish(p, h, "lister")
    return out


# -- the autoscaler's arithmetic (unit) -------------------------------------

@scenario
def autoscale_arithmetic(p):
    """``ServeController._autoscale`` from the target count, on a controller
    built with its lock (the reference's own test builds one without it)."""
    serve_config = sub(p.rt, "serve.config")
    ds = sub(p.rt, "serve._private.deployment_state")
    ctrl = object.__new__(sub(p.rt, "serve.controller").ServeController)
    ctrl._autoscale_state = {}
    ctrl._lock = threading.RLock()
    out = []
    for asc, total, p95 in (
            (dict(max_replicas=20, smoothing_factor=2.0,
                  downscale_delay_s=3600.0), 8.0, 0.0),
            (dict(max_replicas=5, downscale_delay_s=0.0), 1.0, 0.0),
            (dict(max_replicas=10, target_latency_ms=50.0), 0.0, 120.0)):
        state = ds.DeploymentState("scaling")
        state.config = serve_config.DeploymentConfig(
            autoscaling_config=serve_config.AutoscalingConfig(
                min_replicas=1, **asc))
        state.target_replicas = 4
        state.replicas = [ds.ReplicaInfo("scaling#0", None, "v1")]
        metrics = {"total_ongoing": total, "replicas": {}, "p95_ms": p95}
        for _ in range(3):
            ctrl._autoscale(state, metrics)
            out.append(state.target_replicas)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serve_plane_matches_ray_tpu(instances, name):
    fn = SCENARIOS[name]
    want, got = (outcome(fn, instances[rt.__name__]) for rt in PACKAGES)
    assert got == want


# -- the tiny transformer, served by both packages ---------------------------

def lm_deployment(serve, predictor):
    """A batched deployment answering a token list with the logits of its
    last token, as a list. Requests are right-padded to a length bucket,
    which is exact because attention is causal with a top-left mask."""

    # A budget far above a first call's compile time: the router would
    # shed behind an uncompiled shape at the default 100 ms.
    @serve.deployment(max_batch_size=4, batch_wait_timeout_s=0.05,
                      pad_batch_to=(4,), target_latency_ms=60_000.0)
    class LM:
        def __call__(self, requests):
            L = next_bucket(max(len(r) for r in requests), LENGTH_BUCKETS)
            tokens = np.zeros((len(requests), L), dtype=np.int32)
            for i, r in enumerate(requests):
                tokens[i, :len(r)] = r
            last = np.array([len(r) - 1 for r in requests], dtype=np.int32)
            out = predictor.predict({"tokens": tokens, "last": last})
            return [np.asarray(row, np.float32).tolist() for row in out]

    return LM


def test_tiny_transformer_served_matches_jax(instances):
    """The same weights and requests through ``serve.run`` and the HTTP
    proxy: ``JaxPredictor`` on ``ray_tpu.serve`` against
    ``TorchPredictor(device="cpu")`` on ``ray_tpu_torch.serve``."""
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32)
    cfg = transformer.TransformerConfig(**TINY, dtype=torch.float32)
    # Seeded numpy weights in the JAX tree's layout (its own init compiles
    # once per shape, which takes seconds).
    rng = np.random.default_rng(0)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones(s.shape, np.float32)
                         if "ln" in jax.tree_util.keystr(path) else
                         (0.1 * rng.standard_normal(s.shape)).astype(
                             np.float32)),
        jax.eval_shape(lambda: jax_transformer.init_params(
            jax.random.PRNGKey(0), jcfg)))

    def jax_last_logits(params, batch):
        x = jax_transformer.backbone(params, batch["tokens"], jcfg)
        x = x[jnp.arange(x.shape[0]), batch["last"]][:, None]
        return jax_transformer.head(params, x, jcfg)[:, 0]

    def torch_last_logits(params, batch):
        x = transformer.backbone(params, batch["tokens"], cfg)
        x = x[torch.arange(x.shape[0]), batch["last"]][:, None]
        return transformer.head(params, x, cfg)[:, 0]

    predictors = {
        "ray_tpu": JaxPredictor(jax.tree.map(jnp.asarray, np_params),
                                jax_last_logits),
        "ray_tpu_torch": TorchPredictor(
            transformer.params_from_numpy(np_params, cfg, "cpu"),
            torch_last_logits, device="cpu")}
    requests = [rng.integers(0, 256, size=n).tolist()
                for n in rng.integers(1, 33, size=6)]
    # Compile JAX's two shapes first: a request queued behind a compile
    # could age past serve_queue_deadline_ms and be shed.
    for L in LENGTH_BUCKETS:
        predictors["ray_tpu"].predict({"tokens": np.zeros((4, L), np.int32),
                                       "last": np.zeros(4, np.int32)})
    answers = {}
    for rt in PACKAGES:
        p = instances[rt.__name__]
        LM = lm_deployment(p.serve, predictors[rt.__name__])
        h = p.serve.run(LM.bind(), route_prefix="/lm")
        by_handle = burst(h, requests)
        by_http = [None] * len(requests)
        threads = [threading.Thread(target=lambda i=i: by_http.__setitem__(
            i, http(p.base, "/lm", requests[i])))
            for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(code == 200 for code, _, _ in by_http), by_http
        answers[rt.__name__] = (by_handle,
                                [json.loads(b) for _, _, b in by_http])
        h.shutdown()    # LM stays up: the proxy's own handle watches it
    for want, got in zip(answers["ray_tpu"], answers["ray_tpu_torch"]):
        for g, w in zip(got, want):
            assert len(g) == 256
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


# -- the port's seams --------------------------------------------------------

def test_serve_exports_the_jax_package_names():
    import ray_tpu.serve
    import ray_tpu_torch.serve
    assert sorted(ray_tpu_torch.serve.__all__) == sorted(ray_tpu.serve.__all__)
    for name in ray_tpu.serve.__all__:
        assert getattr(ray_tpu_torch.serve, name).__module__.startswith(
            "ray_tpu_torch"), name


def version(package, *args, **kwargs):
    cfg = sub(package, "serve.config").DeploymentConfig()
    return cfg.version_hash(lm_deployment, args, kwargs)


def test_version_hash_of_tensor_args_follows_values():
    """A tensor argument counts by its values, as a ``jax.Array`` does in
    the JAX package: equal values in another storage (a view, a copy) or
    after an in-place write that leaves them equal give the same version;
    a changed value gives a new one. Without tensors the port's hash is
    the JAX package's."""
    base = torch.arange(12, dtype=torch.float32)
    w = base[:6].reshape(2, 3)
    v = version(ray_tpu_torch, {"w": w}, scale=2)
    assert version(ray_tpu_torch, {"w": w.clone()}, scale=2) == v
    w.mul_(1)
    assert version(ray_tpu_torch, {"w": w}, scale=2) == v
    w.add_(1)
    assert version(ray_tpu_torch, {"w": w}, scale=2) != v
    assert version(ray_tpu_torch, {"w": w.to(torch.bfloat16)}, scale=2) != \
        version(ray_tpu_torch, {"w": w}, scale=2)
    assert version(ray_tpu_torch, {"w": w.reshape(3, 2)}, scale=2) != \
        version(ray_tpu_torch, {"w": w}, scale=2)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert version(ray_tpu, {"w": jnp.asarray(a)}) == \
        version(ray_tpu, {"w": jnp.asarray(a.copy())})
    assert version(ray_tpu, {"w": jnp.asarray(a)}) != \
        version(ray_tpu, {"w": jnp.asarray(a + 1)})
    for args in (({"w": a}, 3), ([1, "x"], None)):
        assert version(ray_tpu_torch, *args) == version(ray_tpu, *args)


def test_class_deployments_load_a_checkpoint_ref_like_jax(instances,
                                                         tmp_path):
    """The JAX checkpoint engine commits a small tree; a class deployment
    in each package, made from the engine's ``CheckpointRef`` and from its
    dict form, loads it on the replica and answers alike. A function
    deployment still refuses a checkpoint (the twin of
    ``tests/test_serve.py::test_function_deployment_rejects_checkpoint``)."""
    from ray_tpu.checkpoint import CheckpointEngine
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    root = str(tmp_path / "ckpt")
    engine = CheckpointEngine(root)
    manifest = engine.save(tree, step=1).result(timeout=60)
    engine.close()
    x = rng.standard_normal(3).astype(np.float32).tolist()

    class Linear:
        def __init__(self, checkpoint):
            self.w = np.asarray(checkpoint["w"])
            self.b = np.asarray(checkpoint["b"])

        def __call__(self, v):
            return (np.asarray(v, np.float32) @ self.w + self.b).tolist()

    answers = {}
    for rt in PACKAGES:
        p = instances[rt.__name__]
        ref = sub(rt, "checkpoint").CheckpointRef(root, manifest)
        for form, ckpt in (("ref", ref), ("dict", dataclasses.asdict(ref))):
            name = f"linear-{form}"
            h = p.serve.run(p.serve.deployment(checkpoint=ckpt)(Linear)
                            .options(name=name).bind(), route_prefix=None)
            answers[rt.__name__, form] = h.remote(x).result(timeout=30)
            finish(p, h, name)
        with pytest.raises(ValueError, match="class"):
            p.serve.deployment(checkpoint=ckpt)(lambda v: v)
    want = (np.asarray(x, np.float32) @ tree["w"] + tree["b"]).tolist()
    assert set(map(tuple, answers.values())) == {tuple(want)}, answers


def test_autopilot_actuators_are_refused_for_batched_deployments(instances):
    p = instances["ray_tpu_torch"]

    @p.serve.deployment(max_batch_size=2)
    class Batched:
        def __call__(self, items):
            return items

    @p.serve.deployment
    class Single:
        def __call__(self, x):
            return x

    p.config.set("autopilot_enabled", True)
    try:
        with pytest.raises(ray_tpu_torch.TaskError) as info:
            p.serve.run(Batched.bind(), route_prefix=None)
        h = p.serve.run(Single.bind(), route_prefix=None)
    finally:
        p.config.set("autopilot_enabled", False)
    assert isinstance(info.value.cause, NotImplementedError)
    assert "Queue 1 item 8" in str(info.value.cause)
    assert "Batched" not in p.serve.status()
    assert h.remote(7).result(timeout=30) == 7
    finish(p, h, "Single")


def test_replica_gpu_grants(instances, monkeypatch):
    """``num_gpus=1`` grants ``cuda:0`` (the node's first card); two
    ``num_gpus=0.5`` replicas share it and get no device, as the JAX
    package's fractional grants get none."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    p = instances["ray_tpu_torch"]

    @p.serve.deployment
    class Devices:
        def __init__(self):
            self.me = object()

        def __call__(self, _):
            time.sleep(0.2)             # overlap, so both replicas serve
            ctx = ray_tpu_torch.get_runtime_context()
            return ctx.get_gpu_devices(), id(self.me)

    h = p.serve.run(Devices.options(
        name="whole", ray_actor_options={"num_gpus": 1}).bind(),
        route_prefix=None)
    assert h.remote(0).result(timeout=30)[0] == [torch.device("cuda", 0)]
    assert p.rt.available_resources().get("GPU", 0) == 0
    finish(p, h, "whole")
    h = p.serve.run(Devices.options(
        name="halves", num_replicas=2,
        ray_actor_options={"num_gpus": 0.5}).bind(), route_prefix=None)
    answers = burst(h, list(range(8)))
    assert all(devices == [] for devices, _ in answers)
    assert len({me for _, me in answers}) == 2
    finish(p, h, "halves")
    assert p.rt.available_resources().get("GPU") == 1.0


def test_racing_first_requests_share_one_router(instances):
    """A reference fault fixed in the port (ROADMAP Queue 3): the first
    requests of a fresh handle, sent from several threads at once, build
    one router, so its in-flight counts see all of them."""
    p = instances["ray_tpu_torch"]

    @p.serve.deployment
    class Echo:
        def __call__(self, x):
            return x

    p.serve.run(Echo.options(name="race").bind(),
                route_prefix=None).shutdown()
    h = p.serve.get_deployment_handle("race")
    barrier = threading.Barrier(8)
    routers = []

    def first_call():
        barrier.wait()
        routers.append(h._get_router())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(routers) == 8 and len({id(r) for r in routers}) == 1
    assert h.remote(3).result(timeout=30) == 3
    finish(p, h, "race")


def test_deleted_replica_releases_its_weights_and_threads(instances):
    """A deleted deployment's replicas free what they hold: the actor's
    instance and init arguments, and every thread of its pool."""
    p = instances["ray_tpu_torch"]

    @p.serve.deployment(max_batch_size=2, max_concurrent_queries=8)
    class Holder:
        def __init__(self, w):
            self.w = w

        def __call__(self, items):
            return [float(self.w.sum()) + v for v in items]

    def replica_threads():
        return {t for t in threading.enumerate() if t.name.startswith(
            ("actor-Replica", "serve-replica-batch"))}

    before = replica_threads()      # the JAX package's, among others
    w = torch.ones(64)
    alive = weakref.ref(w)
    h = p.serve.run(Holder.bind(w), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 65.0
    del w
    finish(p, h, "Holder")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            alive() is not None or replica_threads() - before):
        gc.collect()
        time.sleep(0.05)
    assert alive() is None
    assert not replica_threads() - before
