"""``TorchTrainer`` (``ray_tpu_torch.train``) against ``JaxTrainer``.

Each scenario of ``tests/test_train.py`` runs under both packages, in turns
(init → fit → shutdown), from the same seeded numpy data: a synthetic
linear regression trained data-parallel, in JAX by the JAX package's
workers and in PyTorch by the port's. The metrics histories and the final
checkpoints must agree at rtol 1e-5 (the two frameworks' f32 arithmetic),
and everything else exactly. Then the seams only the port has: a reported
checkpoint is a snapshot (the port's steps write parameters in place),
``datasets=`` hands each worker its shard, the flagship step trained
through the trainer equals the same loop run directly, and no path falls
back to the CPU.
Checks that need a card are in ``chip_smoke.py``'s phase 17.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PKGS = (ray_tpu, ray_tpu_torch)
TRUE_W = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")
FIT_TIMEOUT_S = 30.0


def sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtime_dirs(tmp_path_factory):
    """Both packages keep their runtime files under pytest's temporary
    directory; the flags are restored afterwards."""
    saved = []
    for rt in PKGS:
        config = sub(rt, "_private.config")._config
        saved.append((config, dict(config._values)))
        root = tmp_path_factory.mktemp(rt.__name__)
        for flag in DIR_FLAGS:
            config.set(flag, str(root / flag))
    yield
    for config, values in saved:
        config._values = values


def data(rank):
    x = np.random.default_rng(rank).standard_normal((64, 4)) \
        .astype(np.float32)
    return x, x @ TRUE_W


def linear_loop(rt):
    """The reference test's ``_linear_loop`` for package ``rt``: the same
    numpy data, its own framework's arithmetic and collective group."""
    session = sub(rt, "train").session
    Checkpoint = sub(rt, "air").Checkpoint
    col = sub(rt, "collective")

    def loop(config):
        rank, world = session.get_world_rank(), session.get_world_size()
        group = session.get_collective_group_name()
        x, y = data(rank)
        start, w0 = 0, np.zeros(4, np.float32)
        ckpt = session.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_dict()
            w0 = np.asarray(state["w"], np.float32)
            start = state["epoch"] + 1
        if rt is ray_tpu:
            w, xj, yj = jnp.asarray(w0), jnp.asarray(x), jnp.asarray(y)
            for epoch in range(start, config["epochs"]):
                grad = jax.grad(lambda w: jnp.mean((xj @ w - yj) ** 2))(w)
                if world > 1:
                    grad = jnp.asarray(col.allreduce(np.asarray(grad),
                                                     group)) / world
                w = w - 0.1 * grad
                loss = float(jnp.mean((xj @ w - yj) ** 2))
                session.report({"loss": loss, "epoch": epoch, "rank": rank},
                               checkpoint=Checkpoint.from_dict(
                                   {"w": np.asarray(w), "epoch": epoch}))
            return
        assert session.get_mesh() is None     # no card granted
        w, xt, yt = (torch.from_numpy(a.copy()) for a in (w0, x, y))
        for epoch in range(start, config["epochs"]):
            wr = w.clone().requires_grad_(True)
            grad, = torch.autograd.grad(((xt @ wr - yt) ** 2).mean(), wr)
            if world > 1:
                grad = col.allreduce(grad, group) / world
            w.sub_(0.1 * grad)                  # in place, as steps do
            loss = float(((xt @ w - yt) ** 2).mean())
            session.report({"loss": loss, "epoch": epoch, "rank": rank},
                           checkpoint=Checkpoint.from_dict(
                               {"w": w, "epoch": epoch}))
    return loop


def crashy_loop(rt):
    session = sub(rt, "train").session
    Checkpoint = sub(rt, "air").Checkpoint

    def loop(config):
        ckpt = session.get_checkpoint()
        start = 0 if ckpt is None else ckpt.to_dict()["epoch"] + 1
        for epoch in range(start, 6):
            if epoch == 3 and ckpt is None:
                raise RuntimeError("simulated worker crash")
            session.report({"epoch": epoch},
                           checkpoint=Checkpoint.from_dict({"epoch": epoch}))
    return loop


def always_crash(config):
    raise RuntimeError("boom")


def fit(rt, loop, **kwargs):
    """``fit()`` of package ``rt``'s trainer on a fresh ``init``."""
    train = sub(rt, "train")
    trainer_cls = train.JaxTrainer if rt is ray_tpu else train.TorchTrainer
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        return trainer_cls(loop, results_timeout_s=FIT_TIMEOUT_S,
                           **kwargs).fit()
    finally:
        rt.shutdown()


def host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v) if hasattr(v, "shape") else v


def result_view(result):
    """(error type, metrics history, final checkpoint as numpy)."""
    ckpt = None
    if result.checkpoint is not None:
        ckpt = {k: host(v) for k, v in result.checkpoint.to_dict().items()}
    return (type(result.error).__name__ if result.error else None,
            result.metrics_history, ckpt)


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (float, np.ndarray, np.floating)):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    else:
        assert a == b


def both(scenario, **kwargs):
    """The scenario's result view under each package, checked equal."""
    views = [result_view(fit(rt, scenario(rt), **kwargs)) for rt in PKGS]
    assert_same(views[0], views[1])
    return views[1]


def air(rt):
    return sub(rt, "air")


def test_single_worker_matches_jax():
    err, hist, ckpt = both(linear_loop, train_loop_config={"epochs": 20},
                           collective_backend=None)
    assert err is None and hist[-1]["loss"] < 1.0 and ckpt["epoch"] == 19
    assert len(hist) == 20


def test_data_parallel_over_cpu_matches_jax():
    views = [result_view(fit(
        rt, linear_loop(rt), train_loop_config={"epochs": 15},
        scaling_config=air(rt).ScalingConfig(
            num_workers=4, resources_per_worker={"CPU": 1}),
        collective_backend="cpu")) for rt in PKGS]
    assert_same(views[0], views[1])
    err, hist, _ = views[1]
    assert err is None and len(hist) == 15 * 4 and hist[-1]["loss"] < 2.0


def test_resume_from_checkpoint_matches_jax():
    views = [result_view(fit(
        rt, linear_loop(rt), train_loop_config={"epochs": 12},
        collective_backend=None,
        resume_from_checkpoint=air(rt).Checkpoint.from_dict(
            {"w": np.zeros(4, np.float32), "epoch": 9}))) for rt in PKGS]
    assert_same(views[0], views[1])
    assert [m["epoch"] for m in views[1][1]] == [10, 11]


def test_worker_failure_restarts_like_jax():
    views = [result_view(fit(
        rt, crashy_loop(rt), train_loop_config={},
        run_config=air(rt).RunConfig(
            failure_config=air(rt).FailureConfig(max_failures=2)),
        collective_backend=None)) for rt in PKGS]
    assert_same(views[0], views[1])
    err, hist, ckpt = views[1]
    assert err is None and hist[-1]["epoch"] == 5 and ckpt["epoch"] == 5


def test_failures_exhausted_like_jax():
    results = [fit(rt, always_crash, train_loop_config={},
                   run_config=air(rt).RunConfig(
                       failure_config=air(rt).FailureConfig(max_failures=1)),
                   collective_backend=None) for rt in PKGS]
    assert [type(r.error).__name__ for r in results] == ["TaskError"] * 2
    assert all("boom" in str(r.error) for r in results)


def test_storage_path_prunes_to_num_to_keep_like_jax(tmp_path):
    def persisting_loop(rt):
        session = sub(rt, "train").session
        Checkpoint = air(rt).Checkpoint

        def loop(config):
            for epoch in range(5):
                session.report({"epoch": epoch}, checkpoint=Checkpoint.
                               from_dict({"epoch": epoch,
                                          "w": np.full(3, float(epoch))}))
        return loop

    kept, restored = [], []
    for rt in PKGS:
        result = fit(rt, persisting_loop(rt), train_loop_config={},
                     run_config=air(rt).RunConfig(
                         name="exp", storage_path=str(tmp_path / rt.__name__),
                         checkpoint_config=air(rt).CheckpointConfig(
                             num_to_keep=2)),
                     collective_backend=None)
        assert result.error is None
        root = str(tmp_path / rt.__name__ / "exp" / "checkpoints")
        ck = sub(rt, "checkpoint")
        kept.append(sorted(ck.read_manifest(root, n).step
                           for n in ck.list_manifest_names(root)))
        restored.append(air(rt).Checkpoint.from_manifest(root).to_dict())
    assert kept[0] == kept[1] == [4, 5]
    assert_same(restored[0], restored[1])
    assert restored[1]["epoch"] == 4


# -- seams only the port has --------------------------------------------------


@pytest.mark.parametrize("engine", [False, True], ids=["device", "engine"])
def test_reported_checkpoint_keeps_the_reported_values(tmp_path, engine):
    """The step writes parameters in place after ``report``: the driver's
    checkpoint must keep the values of the step it was reported at (a clone
    on the tensor's device, or the engine's host copy)."""
    from ray_tpu_torch.air import Checkpoint, CheckpointConfig, RunConfig
    from ray_tpu_torch.train import session
    seen = []

    def loop(config):
        w = torch.zeros(4)
        for epoch in range(3):
            w.add_(1.0)
            session.report({"epoch": epoch}, checkpoint=Checkpoint.from_dict(
                {"w": w, "epoch": epoch}))
            seen.append(session._get_session().latest_checkpoint)
            w.add_(100.0)

    run = RunConfig(name="snap", storage_path=str(tmp_path),
                    checkpoint_config=CheckpointConfig()) if engine else None
    result = fit(ray_tpu_torch, loop, train_loop_config={},
                 collective_backend=None, run_config=run)
    assert result.error is None
    assert result.checkpoint.to_dict()["w"].tolist() == [3.0 + 200.0] * 4
    for epoch, ckpt in enumerate(seen):
        w = ckpt.to_dict()["w"]
        assert w.device.type == "cpu" and w.tolist() == \
            [1.0 + 101.0 * epoch] * 4
    if engine:
        restored = Checkpoint.from_manifest(
            str(tmp_path / "snap" / "checkpoints")).to_dict()
        assert restored["w"].tolist() == [203.0] * 4


def test_datasets_are_refused_until_data_is_ported():
    """The refusal went with the port of ``data/``: ``datasets=`` is taken,
    and ``session.get_dataset_shard("train")`` gives each worker a
    ``DataIterator`` over its equal share of the rows (103 rows over 3
    workers: 35, 34, 34, with nothing lost or read twice); an unknown
    name gives None."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.data import DataIterator, from_items
    from ray_tpu_torch.train import TorchTrainer, session

    def loop(config):
        shard = session.get_dataset_shard("train")
        assert isinstance(shard, DataIterator), shard
        assert session.get_dataset_shard("eval") is None
        session.report({"rank": session.get_world_rank(),
                        "count": shard.count(),
                        "rows": sorted(r["x"] for r in shard.iter_rows())})

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)    # the dataset's blocks live in it
    try:
        ds = from_items([{"x": i} for i in range(103)]).repartition(5)
        result = TorchTrainer(
            loop, collective_backend=None, results_timeout_s=FIT_TIMEOUT_S,
            scaling_config=ScalingConfig(num_workers=3),
            datasets={"train": ds}).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    hist = sorted(result.metrics_history, key=lambda m: m["rank"])
    assert [m["count"] for m in hist] == [35, 34, 34]
    assert [len(m["rows"]) for m in hist] == [35, 34, 34]
    assert sorted(x for m in hist for x in m["rows"]) == list(range(103))


TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64,
            max_seq_len=32)


def lm_loop(config):
    """Three steps of the flagship step, reporting loss and grad norm."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step, session
    cfg = TransformerConfig(**TINY, dtype=torch.float32, use_flash=True)
    init_fn, step_fn, shard = make_lm_train_step(cfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    tokens = shard(np.random.default_rng(5).integers(0, 64, (2, 17)))
    for step in range(3):
        state, m = step_fn(state, tokens)
        row = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
        if session._get_session() is None:
            config["rows"].append(row)
        else:
            session.report(row)


def test_lm_step_through_the_trainer_equals_the_direct_loop():
    goodput = ray_tpu_torch.observability.goodput
    goodput.reset()
    result = fit(ray_tpu_torch, lm_loop, train_loop_config={},
                 collective_backend=None)
    assert result.error is None
    direct = {"rows": []}
    lm_loop(direct)
    assert result.metrics_history == direct["rows"]
    # the wrapped step's first call per signature is a compile
    assert goodput.snapshot()["jobs"]["default"]["compile_count"] >= 1


def test_no_path_falls_back_to_the_cpu():
    from ray_tpu_torch.air import ScalingConfig
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: phase 17 of chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fit(ray_tpu_torch, always_crash,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
    # the default collective backend is nccl, which needs a card
    result = fit(ray_tpu_torch, always_crash)
    assert type(result.error).__name__ == "TaskError"
    assert "needs a CUDA card" in str(result.error)


def test_a_restart_numbers_its_saves_after_the_commit_it_resumes(tmp_path):
    """A failed attempt's writer may commit a later step after the restart
    picked the commit it resumes from: the new attempt's saves number
    after the resumed commit, not after the newest (the JAX package reads
    the newest, so its steps skip one)."""
    from ray_tpu_torch.air import Checkpoint, RunConfig
    from ray_tpu_torch.checkpoint import CheckpointEngine
    from ray_tpu_torch.train import TorchTrainer
    trainer = TorchTrainer(lambda config: None, collective_backend=None,
                           run_config=RunConfig(name="race",
                                                storage_path=str(tmp_path)))
    root = trainer._engine_root()
    engine = CheckpointEngine(root)
    names = [engine.save({"w": np.full(4, s, np.float32)},
                         step=s).result(timeout=60) for s in (1, 2, 3)]
    engine.close()
    resumed = Checkpoint.from_manifest(root, names[1])
    assert trainer._checkpoint_spec(root, resumed)["base_step"] == 2
    assert trainer._checkpoint_spec(root)["base_step"] == 3
