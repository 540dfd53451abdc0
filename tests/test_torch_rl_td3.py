"""The port's TD3 and DDPG (``rl/td3.py``, ``rl/ddpg.py``: the deterministic
policy, the critic-only and actor steps of the learner, target smoothing
and the delayed Polyak step) against the JAX package's, on the CPU, and
the reference's TD3 gate.

Weights come from the JAX package's own init and are carried across
through numpy; inputs are seeded numpy, and each update is fed the
smoothing-noise draw the JAX learner makes from its key. Losses and the
Adam moments agree at rtol 1e-5, atol 1e-6 (``tests/test_torch_rl.py``'s
tolerance); the parameters Adam steps, and the targets that follow them,
at rtol 1e-5 and an atol of a hundredth of one Adam step (1e-2 x lr; see
``tests/test_torch_rl_impala.py`` for why). The gate is
``tests/test_rl.py``'s, config, iteration count, seed and thresholds
unchanged, with the learner on the CPU (DDPG's gate is in
``tests/test_torch_rl_dqn.py``).
"""

import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import ddpg as jax_ddpg
from ray_tpu.rl import td3 as jax_td3
from ray_tpu.rl.env import make_env as jax_make_env
from ray_tpu_torch.rl import (DDPG, TD3, DDPGConfig, SampleBatch, TD3Config,
                              make_env)
from ray_tpu_torch.rl import models, td3
from ray_tpu_torch.rl.sample_batch import batch_to_device

RTOL, ATOL = 1e-5, 1e-6
HIDDEN = (32, 32)
B = 16


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
    return jax_td3.DeterministicPolicy(
        jax_make_env("Pendulum-v1", {"seed": 0}).spec,
        {"fcnet_hiddens": HIDDEN}, seed=3)


def jax_actor():
    return jax.tree_util.tree_map(np.copy, _jax_policy().get_weights())


def test_policy_deterministic_bounded_and_like_jax():
    """``tests/test_rl.py``'s policy checks on the port, with JAX's
    weights: without exploration the action is JAX's and repeats; the
    exploring one differs; both stay in the box."""
    env = make_env("Pendulum-v1", {"seed": 0})
    pol = td3.DeterministicPolicy(env.spec, {"fcnet_hiddens": HIDDEN},
                                  seed=0, device="cpu")
    pol.set_weights(jax_actor())
    obs = np.stack([env.reset(seed=i) for i in range(8)]).astype(np.float32)
    a1 = pol.compute_actions(obs, explore=False)[0]
    np.testing.assert_array_equal(a1, pol.compute_actions(obs,
                                                          explore=False)[0])
    close(a1, _jax_policy().compute_actions(obs, explore=False)[0])
    ae = pol.compute_actions(obs, explore=True)[0]
    assert not np.allclose(a1, ae)
    for a in (a1, ae):
        assert np.all(a >= -2.0) and np.all(a <= 2.0)
    with pytest.raises(ValueError):
        td3.DeterministicPolicy(make_env("CartPole-v1").spec, device="cpu")


def test_ddpg_is_td3_without_the_fixes():
    cfg = DDPG.get_default_config()
    assert isinstance(cfg, TD3Config)
    assert cfg.twin_q is False
    assert cfg.policy_delay == 1
    assert cfg.target_noise == 0.0


def replay_batch(seed):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        SampleBatch.OBS: rng.standard_normal((B, 3)).astype(np.float32),
        SampleBatch.ACTIONS: rng.uniform(-2, 2, (B, 1)).astype(np.float32),
        SampleBatch.REWARDS: -rng.random(B).astype(np.float32) * 5,
        SampleBatch.NEXT_OBS: rng.standard_normal((B, 3)).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(B) < 0.2,
        SampleBatch.EPS_ID: np.arange(B),
    })


def cfg_pair(kind):
    j, t = ((jax_td3.TD3Config(), TD3Config()) if kind == "td3"
            else (jax_ddpg.DDPGConfig(), DDPGConfig()))
    for c in (j, t):
        c.model = {"fcnet_hiddens": HIDDEN}
        c.lr = 3e-3
        c.grad_clip = 1.0       # below the critics' gradient norm
        c.tau = 0.05
    return j, t


@pytest.mark.parametrize("kind", ["td3", "ddpg"])
def test_learner_steps_match_jax(kind):
    """TD3: a critic-only step, then an actor step (the actor's loss reads
    q1 after this step's critic update; the targets, the actor's with
    them, move only then); DDPG: two steps of one critic, no smoothing.
    Against the JAX learner, fed the noise the JAX learner draws."""
    jcfg, tcfg = cfg_pair(kind)
    scale, center = np.float32([2.0]), np.float32([0.0])
    jl = jax_td3.TD3Learner(jax_actor(), 3, 1, scale, center, jcfg)
    tl = td3.TD3Learner(jax_actor(), 3, 1, scale, center, tcfg,
                        device="cpu")
    start = jax.device_get((jl.cparams, jl.aparams, jl.target))
    tl.set_state((*start, None, None, 0))
    step_atol = 1e-2 * tcfg.lr
    for step, seed in enumerate((1, 2), start=1):
        batch = replay_batch(seed)
        _, knoise = jax.random.split(jl.rng)
        noise = torch.from_numpy(np.array(jax.random.normal(knoise, (B, 1))))
        want = jl.train(batch)
        tl._step_count += 1
        do_actor = tl._step_count % tcfg.policy_delay == 0
        assert do_actor == (kind == "ddpg" or step == 2)
        got = tl.update(batch_to_device(
            {k: v for k, v in batch.items() if k in td3._USED}, "cpu"),
            noise, do_actor)
        got = dict(zip(td3.AUX_KEYS, got.tolist()))
        for k in want:
            close(got[k], want[k])
        tree_close(tl.cparams, jl.cparams, atol=step_atol)
        tree_close(tl.copt_state["mu"], jl.copt_state[1][0].mu)
        if not do_actor:
            # a critic-only step touches neither the actor, nor its
            # optimizer state, nor the targets
            tree_close(tl.aparams, start[1], rtol=0, atol=0)
            tree_close(tl.target, start[2], rtol=0, atol=0)
            assert tl.aopt_state["count"] == 0
            assert all(float(m.abs().max()) == 0 for m in
                       models.tree_leaves(tl.aopt_state["mu"]))
            assert got["actor_loss"] == 0.0
    tree_close(tl.aparams, jl.aparams, atol=step_atol)
    tree_close(tl.target, jl.target, atol=step_atol)
    tree_close(tl.aopt_state["mu"], jl.aopt_state[1][0].mu)
    tree_close(tl.aopt_state["nu"], jl.aopt_state[1][0].nu)
    if kind == "ddpg":   # the second critic takes no part
        tree_close(tl.cparams["q2"], start[0]["q2"], rtol=0, atol=0)


def test_learner_state_round_trips_through_numpy():
    _, tcfg = cfg_pair("td3")
    scale, center = np.float32([2.0]), np.float32([0.0])
    a = td3.TD3Learner(jax_actor(), 3, 1, scale, center, tcfg, device="cpu")
    b = td3.TD3Learner(jax_actor(), 3, 1, scale, center, tcfg, device="cpu")
    a.train(replay_batch(1))
    state = a.state()
    assert state[-1] == 1
    b.set_state(state)
    b.generator.set_state(a.generator.get_state())
    assert a.train(replay_batch(2)) == b.train(replay_batch(2))


def test_td3_learns_pendulum():
    """``tests/test_rl.py``'s TD3 gate: lift Pendulum's return well above
    the ~-1300 random level (> -850, and by more than 150 over the early
    episodes)."""
    algo = (TD3.get_default_config()
            .environment("Pendulum-v1")
            .training(train_batch_size=128, n_updates_per_iter=8,
                      num_steps_sampled_before_learning_starts=256)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        early = []
        for _ in range(900):
            r = algo.step()
            rew = r.get("episode_reward_mean")
            if rew is not None and len(early) < 5:
                early.append(rew)
    finally:
        algo.stop()
    final = r["episode_reward_mean"]
    assert final > -850, (early, final)
    assert final - float(np.mean(early)) > 150, (early, final)
