"""The data plane feeding the flagship transformer: ``BatchPredictor`` and
``TorchTrainer(datasets=)`` in the port against the JAX package's.

From the same seeded numpy weights and tokens: offline inference through
``BatchPredictor`` (``TorchPredictor`` on the CPU against ``JaxPredictor``),
the predictor built once per process (the JAX package builds one per
concurrent task), ``tests/test_train.py``'s dataset-shard scenario under
``JaxTrainer`` and ``TorchTrainer``, and three flagship training steps fed
from a dataset shard through ``iter_device_batches(device="cpu")`` against
the JAX ``make_lm_train_step`` fed through ``iter_jax_batches``. Checks that
need a card are in ``chip_smoke.py``'s phase 20.
"""

import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import ray_tpu
import ray_tpu.data  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from ray_tpu.air.predictor import BatchPredictor as JaxBatchPredictor
from ray_tpu.air.predictor import JaxPredictor
from ray_tpu.models import transformer as jax_transformer
from ray_tpu_torch.air import BatchPredictor, Checkpoint, TorchPredictor
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig

PKGS = (ray_tpu, ray_tpu_torch)
TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64,
            max_seq_len=32)
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")
FIT_TIMEOUT_S = 30.0


def sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtime_dirs(tmp_path_factory):
    """Both packages keep their runtime files under pytest's temporary
    directory; the flags are restored afterwards."""
    saved = []
    for pkg in PKGS:
        config = sub(pkg, "_private.config")._config
        saved.append((config, dict(config._values)))
        root = tmp_path_factory.mktemp(pkg.__name__)
        for flag in DIR_FLAGS:
            config.set(flag, str(root / flag))
    yield
    for config, values in saved:
        config._values = values


def run(pkg, fn, num_cpus=8):
    """``fn()`` on a fresh ``pkg.init(num_cpus=...)``."""
    pkg.shutdown()
    pkg.init(num_cpus=num_cpus)
    try:
        return fn()
    finally:
        pkg.shutdown()


@pytest.fixture(scope="module")
def np_params():
    """Seeded normals at ``init_params``'s shapes and scales (JAX's own init
    compiles for seconds), norms at one."""
    rng = np.random.default_rng(3)

    def draw(path, shape):
        if path[-1].startswith("ln"):
            return np.ones(shape, np.float32)
        fan_in = shape[1] if path[0] == "blocks" else shape[0]
        if path[-2:] == ("attn", "wo"):
            fan_in = shape[1] * shape[2]
        scale = 0.02 if path == ("embed",) else fan_in ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return draw(path, tree)

    return build(transformer.param_shapes(TransformerConfig(**TINY)))


def seeded_tokens(rows, length, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(rows, length), dtype=np.int32)


# -- BatchPredictor -----------------------------------------------------------

def jax_last_logits(params, tokens):
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32,
                                             use_flash=True)
    return jax_transformer.apply(params, tokens, jcfg)[:, -1]


def torch_last_logits(params, batch):
    cfg = TransformerConfig(**TINY, dtype=torch.float32, use_flash=True)
    if isinstance(batch, dict):
        x = transformer.backbone(params, batch["tokens"], cfg)
        x = x[torch.arange(x.shape[0]), batch["length"] - 1][:, None]
        return transformer.head(params, x, cfg)[:, 0]
    return transformer.apply(params, batch, cfg)[:, -1]


def test_batch_predictions_match_jax(np_params):
    """The same weights and tokens through both ``BatchPredictor``s over a
    simple-block dataset (rows are token arrays), 3 blocks, batches of 4;
    then the port over a tabular dataset of the same tokens (a ``tokens``
    column of arrays and a ``length`` column), which the JAX package's
    predictor cannot take (fault (a))."""
    tokens = seeded_tokens(10, 16, seed=7)

    def jax_run():
        ds = ray_tpu.data.from_items(list(tokens), parallelism=3)
        bp = JaxBatchPredictor.from_checkpoint(
            ray_tpu.air.checkpoint.Checkpoint.from_dict(
                {"params": jax.tree.map(jnp.asarray, np_params)}),
            JaxPredictor, apply_fn=jax_last_logits)
        return [r["predictions"] for r in bp.predict(ds,
                                                     batch_size=4).take_all()]

    def port_run():
        params = transformer.params_from_numpy(
            np_params, TransformerConfig(**TINY), "cpu")
        bp = BatchPredictor.from_checkpoint(
            Checkpoint.from_dict({"params": params}), TorchPredictor,
            apply_fn=torch_last_logits, device="cpu")
        simple = bp.predict(ray_tpu_torch.data.from_items(list(tokens),
                                                          parallelism=3),
                            batch_size=4).take_all()
        items = [{"tokens": t, "length": len(t), "id": i}
                 for i, t in enumerate(tokens)]
        tabular = bp.predict(
            ray_tpu_torch.data.from_items(items, parallelism=3),
            batch_size=4, feature_columns=["tokens", "length"],
            keep_columns=["id"]).take_all()
        return [r["predictions"] for r in simple], tabular

    want = run(ray_tpu, jax_run)
    got, tabular = run(ray_tpu_torch, port_run)
    assert len(got) == len(want) == len(tabular) == len(tokens)
    for g, w, t, i in zip(got, want, tabular, range(len(tokens))):
        assert g.shape == (TINY["vocab_size"],)
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4)
        assert t["id"] == i and set(t) == {"id", "predictions"}
        np.testing.assert_allclose(t["predictions"], g, rtol=1e-6, atol=1e-6)


def counting(predictor_cls, built):
    """``predictor_cls`` whose ``from_checkpoint`` takes 0.3 s and records
    each build, so that every map task running at once is inside it."""
    lock = threading.Lock()

    class Counting(predictor_cls):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            time.sleep(0.3)
            with lock:
                built.append(threading.get_ident())
            return super().from_checkpoint(checkpoint, **kwargs)

    return Counting


def test_predictor_is_built_once_per_process():
    """Fault (b): over a 4-block dataset on ``init(num_cpus=4)`` the four
    map tasks run at once. The JAX package's unlocked cache lets each build
    its own predictor; the port builds one, under a lock, and all four
    share it."""
    def apply_jax(params, batch):
        return batch["x"] * params["w"]

    def apply_torch(params, batch):
        return batch["x"] * params["w"]

    counts, outputs = [], []
    for pkg, predictor_cls, bp_cls, apply_fn, kw in (
            (ray_tpu, JaxPredictor, JaxBatchPredictor, apply_jax, {}),
            (ray_tpu_torch, TorchPredictor, BatchPredictor, apply_torch,
             {"device": "cpu"})):
        built = []

        def go():
            ds = pkg.data.from_items([{"x": float(i)} for i in range(16)],
                                     parallelism=4)
            ckpt = sub(pkg, "air.checkpoint").Checkpoint.from_dict(
                {"params": {"w": np.float32(3.0)}})
            bp = bp_cls.from_checkpoint(ckpt, counting(predictor_cls, built),
                                        apply_fn=apply_fn, **kw)
            out = bp.predict(ds, batch_size=2, keep_columns=["x"])
            return [(r["x"], float(r["predictions"])) for r in out.take_all()]

        outputs.append(run(pkg, go, num_cpus=4))
        counts.append(len(built))
    assert outputs[0] == outputs[1] == [(float(i), 3.0 * i)
                                        for i in range(16)]
    assert counts == [4, 1]


def test_the_predictor_is_freed_once_its_predictions_are_taken():
    """After ``predict(ds).take_all()`` nothing holds the predictor (its
    weights) in the port. The JAX package's dispatcher thread keeps the
    last task spec it dispatched, the map task's closure and with it the
    predictor, until the next task is submitted."""
    import gc
    import weakref

    alive = []
    for pkg, predictor_cls, bp_cls, kw in (
            (ray_tpu, JaxPredictor, JaxBatchPredictor, {}),
            (ray_tpu_torch, TorchPredictor, BatchPredictor,
             {"device": "cpu"})):
        refs = []

        class Tracked(predictor_cls):
            @classmethod
            def from_checkpoint(cls, checkpoint, **kwargs):
                p = super().from_checkpoint(checkpoint, **kwargs)
                refs.append(weakref.ref(p))
                return p

        def go():
            ds = pkg.data.from_items([{"x": float(i)} for i in range(16)],
                                     parallelism=4)
            ckpt = sub(pkg, "air.checkpoint").Checkpoint.from_dict(
                {"params": {"w": np.float32(2.0)}})
            rows = bp_cls.from_checkpoint(
                ckpt, Tracked, apply_fn=lambda p, b: b["x"] * p["w"],
                **kw).predict(ds, batch_size=4).take_all()
            time.sleep(0.2)          # the dispatcher's idle passes
            gc.collect()
            return len(rows), sum(r() is not None for r in refs)

        alive.append(run(pkg, go, num_cpus=4))
    assert alive == [(16, 1), (16, 0)]


def scale(params, x):
    return x * params["w"]


def test_a_pickled_predictor_slot_is_its_process_slot():
    """A map task sent to another process carries its ``predict`` call's
    slot pickled: unpickled where that call's slot lives, it is that slot
    (one predictor per process); elsewhere it is a new one, built there
    once."""
    import gc
    import pickle

    from ray_tpu_torch.air.predictor import _slot_for
    ckpt = Checkpoint.from_dict({"params": {"w": torch.tensor(2.0)}})
    slot = _slot_for("call-1", ckpt, TorchPredictor,
                     {"apply_fn": scale, "device": "cpu"})
    data = pickle.dumps(slot)
    assert pickle.loads(data) is slot
    predictor = slot.get()
    assert slot.get() is predictor
    del slot, predictor
    gc.collect()
    fresh = pickle.loads(data)          # as in a process without the slot
    assert fresh.token == "call-1" and fresh._predictor is None
    assert float(fresh.get().predict(np.float32(3.0))) == 6.0


# -- TorchTrainer(datasets=) --------------------------------------------------

def shard_loop(pkg):
    """``tests/test_train.py``'s dataset-shard loop for package ``pkg``."""
    session = sub(pkg, "train").session

    def loop(config):
        shard = session.get_dataset_shard("train")
        total, rows = 0.0, 0
        for batch in shard.iter_batches(batch_size=8, batch_format="numpy",
                                        prefetch_batches=1):
            total += float(batch["x"].sum())
            rows += len(batch["x"])
        session.report({"total": total, "rows": rows,
                        "shard": type(shard).__name__})
    return loop


def fit(pkg, loop, datasets, num_workers, **kwargs):
    train, air = sub(pkg, "train"), sub(pkg, "air")
    trainer_cls = train.JaxTrainer if pkg is ray_tpu else train.TorchTrainer

    def go():
        return trainer_cls(
            loop, scaling_config=air.ScalingConfig(num_workers=num_workers),
            collective_backend=None, results_timeout_s=FIT_TIMEOUT_S,
            datasets=datasets(pkg), **kwargs).fit()
    return run(pkg, go)


def test_dataset_shards_match_jax():
    results = [fit(pkg, shard_loop(pkg),
                   lambda p: {"train": p.data.from_items(
                       [{"x": float(i)} for i in range(40)])}, 2)
               for pkg in PKGS]
    for r in results:
        assert r.error is None, r.error
    hists = [sorted(r.metrics_history, key=lambda m: m["total"])
             for r in results]
    assert hists[0] == hists[1]
    rows = [m["rows"] for m in hists[1]]
    assert sum(rows) == 40 and max(rows) - min(rows) <= 1
    assert sum(m["total"] for m in hists[1]) == float(sum(range(40)))
    assert {m["shard"] for m in hists[1]} == {"DataIterator"}


def lm_loop(config):
    """Three flagship steps, each on the next batch of the worker's shard,
    fed through ``iter_device_batches``."""
    from ray_tpu_torch.train import make_lm_train_step, session
    cfg = TransformerConfig(**TINY, dtype=torch.float32, use_flash=True)
    init_fn, step_fn, shard = make_lm_train_step(cfg, device="cpu")
    state = init_fn(params=transformer.params_from_numpy(
        config["params"], cfg, "cpu"))
    for batch in session.get_dataset_shard("train").iter_device_batches(
            batch_size=2, drop_last=True, device="cpu", prefetch_batches=1):
        tokens = batch["value"]
        assert isinstance(tokens, torch.Tensor) and tokens.shape == (2, 17)
        state, m = step_fn(state, tokens)
        session.report({"loss": m["loss"].item(),
                        "grad_norm": m["grad_norm"].item(),
                        "tokens": tokens.tolist()})


def test_lm_steps_fed_from_a_dataset_shard_match_jax(np_params):
    from ray_tpu.parallel import MeshConfig, build_mesh
    from ray_tpu.parallel.sharding import batch_sharding
    from ray_tpu.train.step import make_lm_train_step as jax_step
    tokens = seeded_tokens(6, 17, seed=11)

    # JAX: the step on a one-device CPU mesh, batches from iter_jax_batches
    # of a one-way split, placed with the step's own batch sharding. Its
    # dataset is simple-block (rows are token arrays): a tabular one, as
    # the port's below, reaches iter_jax_batches as an object column and
    # raises (fault (a)).
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32,
                                             use_flash=True)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    tx = optax.adamw(3e-4, weight_decay=0.01)
    _, step_fn, _ = jax_step(jcfg, mesh, optimizer=tx)
    params = jax.tree.map(jnp.asarray, np_params)
    state = jax.device_put((params, tx.init(params)),
                           NamedSharding(mesh, PartitionSpec()))

    def jax_run():
        shard, = ray_tpu.data.from_items(list(tokens),
                                         parallelism=3).streaming_split(
            1, equal=True)
        out = []
        for batch in shard.iter_jax_batches(
                batch_size=2, drop_last=True,
                sharding=batch_sharding(mesh, ndim=2)):
            nonlocal state
            state, m = step_fn(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    want = run(ray_tpu, jax_run)
    result = fit(ray_tpu_torch, lm_loop,
                 lambda p: {"train": p.data.from_numpy(
                     [tokens[:2], tokens[2:4], tokens[4:]])}, 1,
                 train_loop_config={"params": np_params})
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["tokens"] for m in hist] == [tokens[i:i + 2].tolist()
                                           for i in (0, 2, 4)]
    got = [(m["loss"], m["grad_norm"]) for m in hist]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


@pytest.mark.parametrize("pkg", (ray_tpu, ray_tpu_torch),
                         ids=lambda p: p.__name__)
def test_datasets_are_split_before_the_workers_take_their_resources(
        pkg, monkeypatch):
    """The port splits ``datasets=`` before ``executor.start()``, the JAX
    package after (ROADMAP Queue 3, fixed 14). After, the split's tasks can
    be pushed on a stale cluster view to a daemon the workers fill, and
    wait there for workers that wait for the split: seen on a three-daemon
    cluster with two two-CPU workers
    (``test_torch_tensor_plane.py::test_flagship_trains_from_a_dataset_across_daemons``
    after the dp test)."""
    order = []
    executor_cls = sub(pkg, "train.backend_executor").BackendExecutor
    dataset_cls = sub(pkg, "data.dataset").Dataset
    real_start, real_split = executor_cls.start, dataset_cls.streaming_split

    def start(self):
        order.append("start")
        return real_start(self)

    def split(self, n, **kw):
        order.append("split")
        return real_split(self, n, **kw)

    monkeypatch.setattr(executor_cls, "start", start)
    monkeypatch.setattr(dataset_cls, "streaming_split", split)
    result = fit(pkg, shard_loop(pkg),
                 lambda p: {"train": p.data.from_items(
                     [{"x": float(i)} for i in range(8)])}, 2)
    assert result.error is None, result.error
    assert sum(m["rows"] for m in result.metrics_history) == 8
    want = ["split", "start"] if pkg is ray_tpu_torch else ["start", "split"]
    assert order == want
