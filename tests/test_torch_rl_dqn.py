"""The port's DQN (``rl/dqn.py``: the epsilon-greedy policy, optax's Huber
loss, the TD update with double Q and prioritized-replay weights, the
target sync) against the JAX package's, on the CPU, and the reference's
DQN and DDPG learning gates.

Weights come from the JAX package's own init and are carried across
through numpy; inputs are seeded numpy. The loss, the TD errors and the
Adam moments agree at rtol 1e-5, atol 1e-6 (``tests/test_torch_rl.py``'s
tolerance); the parameters Adam steps at rtol 1e-5 and an atol of a
hundredth of one Adam step (1e-2 x lr): Adam scales every gradient element
to about lr, so an element that nearly cancels, which two f32 backward
passes round differently, can land a visible fraction of a step apart
(``tests/test_torch_rl_impala.py``). The gates are ``tests/test_rl.py``'s
and ``tests/test_rl_extended.py``'s, configs, iteration counts, seed and
thresholds unchanged, with the learner on the CPU. DDPG's gate sits here,
not beside TD3's, so that the slow gates land in different files.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import dqn as jax_dqn
from ray_tpu.rl.env import make_env as jax_make_env
from ray_tpu_torch.rl import DDPG, DQN, DQNConfig, SampleBatch, make_env
from ray_tpu_torch.rl import dqn, models

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops: one intra-op thread is much faster here; a
    Trainable without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = models.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        close(a, b, rtol, atol)


@functools.lru_cache(maxsize=None)
def _jax_policy():
    return jax_dqn.EpsilonGreedyPolicy(
        jax_make_env("CartPole-v1", {"seed": 0}).spec, seed=3)


def jax_weights():
    return jax.tree_util.tree_map(np.copy, _jax_policy().get_weights())


def test_huber_loss_matches_optax():
    rng = np.random.default_rng(0)
    pred = (rng.standard_normal(64) * 2).astype(np.float32)
    target = (rng.standard_normal(64) * 2).astype(np.float32)
    assert (np.abs(pred - target) > 1).any() and \
        (np.abs(pred - target) < 1).any()
    close(dqn.huber_loss(torch.from_numpy(pred), torch.from_numpy(target)),
          optax.huber_loss(jnp.asarray(pred), jnp.asarray(target)))


def test_epsilon_greedy_policy_acts_like_jax():
    """JAX weights in the port's policy: the same greedy actions with
    exploration off; with epsilon 1, uniform actions from the port's own
    generator; a continuous space is refused."""
    spec = make_env("CartPole-v1", {"seed": 0}).spec
    tp = dqn.EpsilonGreedyPolicy(spec, seed=3, device="cpu")
    tp.set_weights(jax_weights())
    obs = np.random.default_rng(1).standard_normal((64, 4)).astype(
        np.float32)
    got, logp, vf = tp.compute_actions(obs, explore=False)
    want = _jax_policy().compute_actions(obs, explore=False)[0]
    np.testing.assert_array_equal(got, want)
    assert (logp == 0).all() and (vf == 0).all()
    assert tp.epsilon == 1.0
    explored = tp.compute_actions(obs)[0]
    assert set(explored.tolist()) == {0, 1} and (explored != got).any()
    tp.set_epsilon(0.0)
    np.testing.assert_array_equal(tp.compute_actions(obs)[0], got)
    with pytest.raises(ValueError, match="discrete"):
        dqn.EpsilonGreedyPolicy(make_env("Pendulum-v1").spec, device="cpu")


def replay_batch(n=32, seed=2, weights=False):
    rng = np.random.default_rng(seed)
    batch = {
        SampleBatch.OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, size=n),
        SampleBatch.REWARDS: rng.random(n).astype(np.float32) * 3,
        SampleBatch.NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.2,
        SampleBatch.EPS_ID: np.arange(n),
    }
    if weights:        # what PrioritizedReplayBuffer.sample adds
        batch["weights"] = rng.random(n).astype(np.float32)
        batch["batch_indexes"] = np.arange(n)
    return SampleBatch(batch)


def cfg_pair(**kw):
    base = dict(lr=1e-3, grad_clip=10.0, gamma=0.99)
    base.update(kw)
    j, t = jax_dqn.DQNConfig(), DQNConfig()
    for k, v in base.items():
        setattr(j, k, v)
        setattr(t, k, v)
    return j, t


@pytest.mark.parametrize("double_q,weights", [
    (True, False), (False, False), (True, True)],
    ids=["double_q", "single_q", "prioritized"])
def test_td_update_matches_jax(double_q, weights):
    """Two TD updates and a target sync against the JAX learner: the loss
    (Huber, prioritized-replay weights), the TD errors read back for the
    priorities (one device->host read an update), parameters and Adam
    moments; the target network moves only at the sync."""
    jcfg, tcfg = cfg_pair(double_q=double_q)
    jl = jax_dqn.DQNLearner(jax_weights(), jcfg)
    tl = dqn.DQNLearner(jax_weights(), tcfg, device="cpu")
    for i, seed in enumerate((2, 3)):
        batch = replay_batch(seed=seed, weights=weights)
        want_loss, want_td = jl.train(batch)
        got_loss, got_td = tl.train(batch)
        assert isinstance(got_td, np.ndarray) and got_td.shape == (32,)
        close(got_loss, want_loss)
        close(got_td, want_td)
        assert tl.host_reads == i + 1
        if i == 0:
            jl.update_target()
            tl.update_target()
    step_atol = 1e-2 * tcfg.lr
    tree_close(tl.params, jl.params, atol=step_atol)
    tree_close(tl.target_params, jl.target_params)
    opt = jl.opt_state[1][0]
    tree_close(tl.opt_state["mu"], opt.mu)
    tree_close(tl.opt_state["nu"], opt.nu)
    assert tl.opt_state["count"] == 2
    # the value head takes no part in the TD loss: it stays where it was
    tree_close(tl.params["vf"], jax_weights()["vf"], rtol=0, atol=0)


def test_learner_state_round_trips_through_numpy():
    _, tcfg = cfg_pair()
    a = dqn.DQNLearner(jax_weights(), tcfg, device="cpu")
    a.train(replay_batch())
    state = a.state()
    assert all(isinstance(x, np.ndarray) for x in models.tree_leaves(
        (state[0], state[1])))
    b = dqn.DQNLearner(jax_weights(), tcfg, device="cpu")
    b.set_state(state)
    batch = replay_batch(seed=4)
    la, ta = a.train(batch)
    lb, tb = b.train(batch)
    assert la == lb and np.array_equal(ta, tb)


def test_dqn_learns_cartpole():
    """``tests/test_rl.py``'s DQN gate."""
    algo = (DQN.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .training(train_batch_size=64, gamma=0.99, lr=1e-3,
                      replay_buffer_capacity=20_000,
                      num_steps_sampled_before_learning_starts=1000,
                      epsilon_timesteps=8000, n_updates_per_iter=8,
                      target_network_update_freq=100, grad_clip=10.0)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        for _ in range(250):
            result = algo.train()
    finally:
        algo.stop()
    final = result["episode_reward_mean"]
    assert final > 50.0, final


def test_dqn_prioritized_replay_runs():
    """``tests/test_rl.py``'s check, with the TD errors fed back as
    priorities."""
    algo = (DQN.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=8)
            .training(train_batch_size=16, prioritized_replay=True,
                      num_steps_sampled_before_learning_starts=32,
                      n_updates_per_iter=2)
            .resources(device="cpu")
            .build())
    try:
        results = [algo.train() for _ in range(5)]
    finally:
        algo.stop()
    assert results[-1]["learning"]
    assert algo.learner.host_reads == 2 * sum(r["learning"]
                                              for r in results)


def test_ddpg_learns_pendulum():
    """``tests/test_rl_extended.py``'s DDPG gate: TD3's learner configured
    back to DDPG (one critic, no smoothing, the actor every step)."""
    algo = (DDPG.get_default_config()
            .environment("Pendulum-v1")
            .training(train_batch_size=128, n_updates_per_iter=8,
                      num_steps_sampled_before_learning_starts=256)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        worst = 0.0
        for _ in range(600):
            r = algo.step()
            rew = r.get("episode_reward_mean")
            if rew is not None:
                worst = min(worst, rew)
    finally:
        algo.stop()
    final = r["episode_reward_mean"]
    assert final > -1000, (worst, final)
    assert final > worst + 250, (worst, final)
