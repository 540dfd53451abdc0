"""The port's ES and ARS (``rl/es.py``, copied: numpy only, no learner and
no device) against the JAX package's, on the CPU, and the reference's
ES/ARS gates.

Both packages run the same numpy code on the same seeds, so their
parameter vectors agree exactly after each iteration. The gates are
``tests/test_rl_extended.py``'s, configs, iteration counts, seed and
thresholds unchanged.
"""

import importlib
import tempfile

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.rl import es as jax_es
from ray_tpu_torch.rl import ARS, ES

DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


@pytest.fixture(autouse=True)
def temp_dirs(monkeypatch, tmp_path):
    """A Trainable without a logdir writes under
    ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """One ``init(num_cpus=8)`` for the remote rollouts."""
    config = importlib.import_module("ray_tpu_torch._private.config")._config
    saved = dict(config._values)
    root = tmp_path_factory.mktemp("runtime")
    for flag in DIR_FLAGS:
        config.set(flag, str(root / flag))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()
    config._values = saved


@pytest.mark.parametrize("name", ["ES", "ARS"])
def test_iterations_match_jax_exactly(name, tmp_path):
    """Two iterations of each package's algorithm on the same seed: the
    same parameters, observation statistics and results."""
    ours = {"ES": ES, "ARS": ARS}[name]
    theirs = getattr(jax_es, name)
    algos = [cls.get_default_config().environment("CartPole-v1")
             .training(num_perturbations=4).debugging(seed=0)
             .build() for cls in (ours, theirs)]
    for _ in range(2):
        got, want = (a.step() for a in algos)
        for k in ("timesteps_this_iter", "perturbation_reward_mean",
                  "episode_reward_mean"):
            assert got[k] == want[k], k
    a, b = algos
    np.testing.assert_array_equal(a.theta, b.theta)
    for k, v in b._learner_state().items():
        np.testing.assert_array_equal(a._learner_state()[k], v)


def test_es_learns_cartpole():
    algo = (ES.get_default_config().environment("CartPole-v1")
            .debugging(seed=0).build())
    best = 0
    for _ in range(40):
        r = algo.step()
        best = max(best, r["episode_reward_mean"])
    assert best > 150, best


def test_ars_learns_cartpole_fast():
    algo = (ARS.get_default_config().environment("CartPole-v1")
            .debugging(seed=0).build())
    best = 0
    for _ in range(20):
        r = algo.step()
        best = max(best, r["episode_reward_mean"])
    assert best > 150, best


def test_es_parallel_rollouts_match_serial_api(runtime):
    """num_rollout_workers > 0 evaluates perturbations as remote tasks of
    the port's runtime, with the serial run's results."""
    def one_step(workers):
        algo = (ES.get_default_config().environment("CartPole-v1")
                .rollouts(num_rollout_workers=workers)
                .training(num_perturbations=4)
                .debugging(seed=0).build())
        return algo.step(), algo.theta

    (r, theta), (serial, serial_theta) = one_step(2), one_step(0)
    assert r["timesteps_this_iter"] > 0
    assert "episode_reward_mean" in r
    assert r["timesteps_this_iter"] == serial["timesteps_this_iter"]
    np.testing.assert_array_equal(theta, serial_theta)


def test_es_checkpoint_roundtrip(tmp_path):
    algo = (ARS.get_default_config().environment("CartPole-v1")
            .debugging(seed=0).build())
    algo.step()
    d = tmp_path / "ck"
    d.mkdir()
    state = algo.save_checkpoint(str(d))
    theta = algo.theta.copy()
    algo.step()
    assert not np.allclose(theta, algo.theta)
    algo.load_checkpoint(state)
    np.testing.assert_allclose(theta, algo.theta)
