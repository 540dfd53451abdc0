"""The port's PPO and A2C end to end on the CPU, held to the reference's own
gates (``tests/test_rl.py``), thresholds unchanged.

The learner runs with ``resources(device="cpu")``; rollout workers act on
the CPU as always. Random streams are torch's, not JAX's, so learning is
held by the gates, not by trajectories (``tests/test_torch_rl.py`` holds
the functions and the SGD schedule against JAX). Also: the checkpoint
round trip, remote rollout workers under ``init()`` and a killed one
recreated, ``tune.run`` of a PPO subclass, and the bench's ``ppo`` section
run tiny.
Every trainable's directory is under pytest's temporary directory.
"""

import importlib
import tempfile

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import bench
from ray_tpu_torch.rl import A2C, PPO, RolloutWorker, SampleBatch
from ray_tpu_torch.rl import models

DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops run much faster on one intra-op thread; a Trainable
    built without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """One ``init(num_cpus=8)`` for the tests that start actors."""
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


def small_ppo(**rollouts):
    """``tests/test_rl.py``'s small PPO config, learner on the CPU."""
    kw = dict(num_rollout_workers=0, num_envs_per_worker=2,
              rollout_fragment_length=20)
    kw.update(rollouts)
    n = kw["num_envs_per_worker"] * kw["rollout_fragment_length"]
    return (PPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(**kw)
            .training(train_batch_size=max(40, n), sgd_minibatch_size=n,
                      num_sgd_iter=2)
            .resources(device="cpu"))


def learn(algo, iters):
    """(first, final) ``episode_reward_mean`` over ``iters`` iterations."""
    first = result = None
    try:
        for _ in range(iters):
            result = algo.train()
            if first is None and "episode_reward_mean" in result:
                first = result["episode_reward_mean"]
    finally:
        algo.stop()
    return first, result["episode_reward_mean"]


def test_ppo_learns_cartpole():
    """``test_rl.py:197-218``: final > max(80, 2 x first) in 25
    iterations of 800 env steps."""
    algo = (PPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=100)
            .training(train_batch_size=800, sgd_minibatch_size=256,
                      num_sgd_iter=8, lr=3e-4, entropy_coeff=0.01,
                      kl_coeff=0.0, clip_param=0.2)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    assert algo.learner.device == torch.device("cpu")
    first, final = learn(algo, 25)
    assert final > max(80.0, first * 2.0), (first, final)


def test_a2c_learns_cartpole():
    """``test_rl.py:628-647``: final > 100 and > first + 50 in 200
    iterations."""
    algo = (A2C.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=25)
            .resources(device="cpu")
            .debugging(seed=0).build())
    first, final = learn(algo, 200)
    assert final > 100, (first, final)
    assert final > first + 50, (first, final)


def test_ppo_checkpoint_restore_roundtrip():
    """``test_rl.py:220-241``: weights, learner state (parameters, Adam
    moments and step count) and the KL coefficient come back; a
    checkpoint holds numpy only."""
    config = small_ppo().debugging(seed=0)
    algo = config.build()
    algo.train()
    state = algo.__getstate__()
    w0 = algo.get_weights()
    opt0 = algo.learner.opt_state["count"]
    algo.stop()
    leaves = models.tree_leaves(state)
    assert leaves and not any(isinstance(x, torch.Tensor) for x in leaves)

    algo2 = PPO(config=config)
    algo2.__setstate__(state)
    for a, b in zip(models.tree_leaves(w0),
                    models.tree_leaves(algo2.get_weights())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(models.tree_leaves(algo2.learner.params),
                    models.tree_leaves(w0)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert algo2.learner.opt_state["count"] == opt0 == 2
    assert algo2.kl_coeff == state["learner_state"]["kl_coeff"]
    algo2.train()
    algo2.stop()


def test_ppo_with_remote_workers_and_a_killed_one_recreated(runtime):
    """``test_rl.py:244-273``: two remote rollout workers (CPU actors, no
    GPU grant); one killed, the next iteration absorbs it and the set is
    whole again."""
    algo = small_ppo(num_rollout_workers=2, num_envs_per_worker=1,
                     rollout_fragment_length=25).build()
    try:
        result = algo.train()
        assert result["timesteps_this_iter"] >= 50
        devices = ray_tpu_torch.get(
            [w.apply.remote(lambda w: str(w.policy.device))
             for w in algo.workers.remote_workers], timeout=60)
        assert devices == ["cpu", "cpu"]
        assert str(algo.workers.local_worker.policy.device) == "cpu"
        ray_tpu_torch.kill(algo.workers.remote_workers[0])
        algo.train()          # absorbs the failure, recreates
        result = algo.train()
        assert result["timesteps_this_iter"] >= 50
        assert len(algo.workers.remote_workers) == 2
    finally:
        algo.stop()
    assert algo.workers.remote_workers == []


def test_algorithm_is_tune_trainable(runtime, tmp_path):
    """``test_rl.py:327-350``: ``tune.run`` of a PPO subclass; the trial
    actor builds its learner from the pickled class."""
    from ray_tpu_torch.tune import run as tune_run

    def make_algo(config):
        return (PPO.get_default_config()
                .environment("CartPole-v1")
                .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                          rollout_fragment_length=20)
                .training(train_batch_size=40, sgd_minibatch_size=20,
                          num_sgd_iter=2, lr=config["lr"])
                .resources(device="cpu"))

    class TunablePPO(PPO):
        def __init__(self, config=None, logdir=None):
            super().__init__(config=make_algo(config or {"lr": 3e-4}),
                             logdir=logdir)

    analysis = tune_run(TunablePPO, config={"lr": 3e-4}, num_samples=1,
                        stop={"training_iteration": 2},
                        metric="episode_reward_mean", mode="max",
                        local_dir=str(tmp_path / "results"), verbose=0)
    assert len(analysis.trials) == 1
    trial = analysis.trials[0]
    assert trial.status == "TERMINATED" and len(trial.results) == 2
    assert trial.last_result["timesteps_total"] == 80


def test_build_refuses_the_card_without_one_and_memory_models(monkeypatch):
    """``build()`` puts the learner on the card unless told otherwise, and
    raises without one; use_lstm / use_attention build the memory models'
    policy and sequence learner on the device they are given."""
    from ray_tpu_torch.rl.recurrent import (RecurrentPolicy,
                                            RecurrentPPOLearner)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = small_ppo()
    config.device = None
    with pytest.raises(RuntimeError, match="cuda"):
        config.build()
    for key in ("use_lstm", "use_attention"):
        algo = small_ppo().training(model={key: True}).build()
        try:
            assert isinstance(algo.learner, RecurrentPPOLearner)
            assert algo.learner.device.type == "cpu"
            assert isinstance(algo.workers.local_worker.policy,
                              RecurrentPolicy)
        finally:
            algo.stop()


@pytest.mark.parametrize("name,env", [
    ("Impala", "CartPole-v1"), ("APPO", "CartPole-v1"),
    ("DQN", "CartPole-v1"), ("SAC", "Pendulum-v1"), ("TD3", "Pendulum-v1"),
    ("DDPG", "Pendulum-v1")])
def test_every_learner_defaults_to_the_card(name, env, monkeypatch):
    """Each algorithm of the slice puts its learner on ``cuda`` unless
    ``resources(device=)`` says otherwise: without a card, ``build()``
    raises before any rollout worker starts; with ``"cpu"`` every learner
    tensor is on the CPU."""
    import ray_tpu_torch.rl as rl
    cls = getattr(rl, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = (cls.get_default_config().environment(env)
              .rollouts(num_rollout_workers=0))
    with pytest.raises(RuntimeError, match="cuda"):
        config.build()
    algo = config.resources(device="cpu").build()
    try:
        learner = algo.learner
        assert learner.device.type == "cpu"
        trees = [v for k, v in vars(learner).items()
                 if k in ("params", "target_params", "target_q", "cparams",
                          "aparams", "target", "opt_state")]
        assert trees and all(t.device.type == "cpu"
                             for t in models.tree_leaves(trees)
                             if isinstance(t, torch.Tensor))
    finally:
        algo.stop()


def test_rollout_worker_shapes_and_continuous_actions():
    """``test_rl.py``'s rollout-worker checks, policies on the CPU."""
    w = RolloutWorker("CartPole-v1", num_envs=2, rollout_fragment_length=10,
                      seed=0, device="cpu")
    batch = w.sample()
    assert len(batch) == 20 and batch[SampleBatch.OBS].shape == (20, 4)
    for k in (SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS,
              SampleBatch.ACTION_LOGP, SampleBatch.EPS_ID):
        assert k in batch, k
    w = RolloutWorker("Pendulum-v1", num_envs=1, rollout_fragment_length=5,
                      seed=0, device="cpu")
    batch = w.sample()
    assert batch[SampleBatch.ACTIONS].shape == (5, 1)
    assert np.all(np.abs(batch[SampleBatch.ACTIONS]) <= 2.0)


def test_bench_ppo_section_runs_tiny_on_the_cpu():
    """The work of the bench's ``ppo`` section (its subprocess runs
    ``ppo_env_steps``; chip phase 13 runs the subprocess), learner on the
    CPU, one timed iteration."""
    out = bench.ppo_env_steps("cpu", timed_iters=1)
    assert out["learner_device"] == "cpu"
    c = bench.PPO_CONFIG        # 800 steps cut to 3 minibatches of 256
    assert out["env_steps"] == (c["train_batch_size"]
                                // c["sgd_minibatch_size"]
                                * c["sgd_minibatch_size"]) == 768
    assert out["env_steps_per_sec"] > 0
