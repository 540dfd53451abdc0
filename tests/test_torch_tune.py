"""The port's ``tune/`` (copied from the JAX package with its imports
rewritten): smoke tests of ``tests/test_tune.py``'s scenarios under both
packages, and the one seam, ``resources_per_trial={"gpu": n}``.

Each package runs on its own ``init(num_cpus=8)`` for the module (the
port's with ``num_gpus=1``, a GPU resource without a card: no trial here
touches CUDA), its directories under pytest's temporary directory; every
``tune.run`` writes under ``tmp_path``.
"""

import importlib
import os

import pytest

import ray_tpu
import ray_tpu.tune  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.tune  # noqa: F401

PKGS = (ray_tpu, ray_tpu_torch)
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


def sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtimes(tmp_path_factory):
    saved = []
    for pkg in PKGS:
        config = sub(pkg, "_private.config")._config
        saved.append((config, dict(config._values)))
        root = tmp_path_factory.mktemp(pkg.__name__)
        for flag in DIR_FLAGS:
            config.set(flag, str(root / flag))
        pkg.shutdown()
        if pkg is ray_tpu_torch:
            pkg.init(num_cpus=8, num_gpus=1)
        else:
            pkg.init(num_cpus=8)
    yield
    for pkg in PKGS:
        pkg.shutdown()
    for config, values in saved:
        config._values = values


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_function_trainable_with_asha(pkg, tmp_path):
    """A function trainable over a grid, cut by ASHA: the best trial runs
    to the end, worse ones stop early (``test_tune.py``'s ASHA scenario),
    the same under both packages."""
    tune = pkg.tune

    def trainable(config):
        for i in range(12):
            tune.report(score=config["q"] * (i + 1))

    sched = tune.AsyncHyperBandScheduler(max_t=12, grace_period=2,
                                         reduction_factor=2)
    analysis = tune.run(trainable,
                        config={"q": tune.grid_search([8, 4, 2, 1])},
                        metric="score", mode="max", scheduler=sched,
                        max_concurrent_trials=1, local_dir=str(tmp_path),
                        verbose=0)
    iters = {t.config["q"]: len(t.results) for t in analysis.trials}
    assert iters[8] == 12 and iters[1] < 12 and iters[2] < 12, iters
    best = analysis.get_best_trial()
    assert best.config["q"] == 8 and best.last_result["score"] == 96
    assert len(list(tmp_path.glob("*/experiment_state.json"))) == 1


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_trial_restarts_from_its_checkpoint(pkg, tmp_path):
    """A class trainable checkpointed every iteration crashes once and
    resumes from its last checkpoint (``test_tune.py``'s failure scenario);
    the trial's checkpoint is a committed engine manifest."""
    tune = pkg.tune

    class Flaky(tune.Trainable):
        def setup(self, config):
            self.x = 0

        def step(self):
            self.x += 1
            marker = os.path.join(self.config["dir"], "crashed")
            if self.x == 3 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("boom")
            return {"x": self.x, "done": self.x >= 5}

        def save_checkpoint(self, d):
            return {"x": self.x}

        def load_checkpoint(self, data):
            self.x = data["x"]

    analysis = tune.run(Flaky, config={"dir": str(tmp_path)},
                        checkpoint_freq=1, max_failures=2, metric="x",
                        mode="max", local_dir=str(tmp_path), verbose=0)
    t = analysis.trials[0]
    assert t.status == "TERMINATED" and t.num_failures == 1
    assert [r["x"] for r in t.results] == [1, 2, 3, 4, 5]
    assert t.checkpoint.load()["data"]["x"] == 5


def test_gpu_per_trial_asks_the_runtime_for_num_gpus(tmp_path,
                                                     monkeypatch):
    """``resources_per_trial={"cpu": 1, "gpu": 1}`` becomes the trial
    actor's ``num_gpus=1`` (the JAX package maps ``"tpu"`` to
    ``num_tpus``): the spec carries it, and the node's one GPU is taken
    while the trial runs."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import execution

    asked = []
    real = execution._TrainableActor.options

    def spy(**kw):
        asked.append(kw)
        return real(**kw)

    monkeypatch.setattr(execution._TrainableActor, "options", spy)

    def trainable(config):
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        tune.report(free_gpus=free)

    analysis = tune.run(trainable, config={},
                        resources_per_trial={"cpu": 1, "gpu": 1},
                        local_dir=str(tmp_path), verbose=0)
    assert asked == [{"num_cpus": 1, "num_gpus": 1}]
    assert analysis.trials[0].last_result["free_gpus"] == 0.0
    assert ray_tpu_torch.available_resources().get("GPU") == 1.0
    # "GPU" is read as well, and a CPU-only trial asks for no GPU
    asked.clear()
    tune.run(trainable, config={}, resources_per_trial={"CPU": 1, "GPU": 1},
             local_dir=str(tmp_path), verbose=0)
    tune.run(trainable, config={}, local_dir=str(tmp_path), verbose=0)
    assert asked == [{"num_cpus": 1, "num_gpus": 1},
                     {"num_cpus": 1, "num_gpus": None}]


def test_trainable_default_logdir_is_under_the_temp_dir(monkeypatch,
                                                        tmp_path):
    """A Trainable built without a logdir writes under
    ``tempfile.gettempdir()`` (the JAX package: ``/tmp``), so that
    ``TMPDIR`` moves it."""
    import tempfile

    from ray_tpu_torch.tune import Trainable

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    t = Trainable.__new__(Trainable)
    Trainable.__init__(t, {})
    assert t.logdir.startswith(str(tmp_path / "ray_tpu_results"))
    assert os.path.isdir(t.logdir)
