"""The port's SAC (``rl/sac.py``: the squashed-Gaussian sample and its
log-probability, the policy, the learner's joint update and Polyak step)
against the JAX package's, on the CPU, and the reference's SAC gate.

Weights come from the JAX package's own init and are carried across
through numpy; inputs are seeded numpy, and the update is fed the two
standard-normal draws the JAX learner makes from its key. Samples, losses
and the Adam moments agree at rtol 1e-5, atol 1e-6
(``tests/test_torch_rl.py``'s tolerance); the parameters Adam steps, and
the target critics that follow them, at rtol 1e-5 and an atol of a
hundredth of one Adam step (1e-2 x lr; see ``tests/test_torch_rl_impala.py``
for why). The gate is ``tests/test_rl.py``'s, config, iteration count,
seed and thresholds unchanged, with the learner on the CPU.
"""

import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import sac as jax_sac
from ray_tpu.rl.env import make_env as jax_make_env
from ray_tpu_torch.rl import SAC, SACConfig, SampleBatch, make_env
from ray_tpu_torch.rl import models, sac
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
    return jax_sac.SquashedGaussianPolicy(
        jax_make_env("Pendulum-v1", {"seed": 0}).spec,
        {"fcnet_hiddens": HIDDEN}, seed=3)


def jax_actor():
    return jax.tree_util.tree_map(np.copy, _jax_policy().get_weights())


def test_sample_squashed_matches_jax():
    """The action and its log-probability with the tanh correction, the
    standard-normal draw fed from JAX's key; the box is [-2, 3]."""
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((B, 3)).astype(np.float32)
    scale, center = np.float32([2.5]), np.float32([0.5])
    key = jax.random.key(7)
    actor = jax_actor()["actor"]
    want = jax.jit(jax_sac._sample_squashed)(actor, obs, key, scale, center)
    noise = np.array(jax.random.normal(key, (B, 1)))
    got = sac._sample_squashed(
        models.params_from_numpy(actor, "cpu"), torch.from_numpy(obs),
        torch.from_numpy(noise), torch.from_numpy(scale),
        torch.from_numpy(center))
    for g, w in zip(got, want):
        close(g, w)


def test_policy_acts_like_jax_and_stays_in_bounds():
    """``tests/test_rl.py``'s policy checks on the port, with JAX's
    weights: the deterministic action equals JAX's squashed mean; sampled
    actions stay in the box; a discrete space is refused."""
    env = make_env("Pendulum-v1", {"seed": 0})
    pol = sac.SquashedGaussianPolicy(env.spec, {"fcnet_hiddens": HIDDEN},
                                     seed=0, device="cpu")
    pol.set_weights(jax_actor())
    obs = np.stack([env.reset(seed=i) for i in range(16)]).astype(np.float32)
    a, logp, vf = pol.compute_actions(obs)
    assert a.shape == (16, 1) and np.all(np.abs(a) <= 2.0)
    assert np.isfinite(logp).all() and (vf == 0).all()
    a2 = pol.compute_actions(obs, explore=False)[0]
    close(a2, _jax_policy().compute_actions(obs, explore=False)[0])
    np.testing.assert_array_equal(a2, pol.compute_actions(obs,
                                                          explore=False)[0])
    with pytest.raises(ValueError):
        sac.SquashedGaussianPolicy(make_env("CartPole-v1").spec,
                                   device="cpu")


def cfg_pair():
    j, t = jax_sac.SACConfig(), SACConfig()
    for c in (j, t):
        c.model = {"fcnet_hiddens": HIDDEN}
        c.lr = 3e-3
        c.grad_clip = 1.0       # below the joint gradient's norm
        c.tau = 0.05
    return j, t


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


def test_learner_update_matches_jax():
    """Two joint updates (twin critics, actor with frozen critics and
    alpha, temperature; one clip + Adam over all four; then Polyak) against
    the JAX learner, fed the normals the JAX learner draws."""
    jcfg, tcfg = cfg_pair()
    scale, center = np.float32([2.0]), np.float32([0.0])
    jl = jax_sac.SACLearner(jax_actor(), 3, 1, scale, center, jcfg)
    tl = sac.SACLearner(jax_actor(), 3, 1, scale, center, tcfg,
                        device="cpu")
    tl.set_state((jax.device_get(jl.params), jax.device_get(jl.target_q),
                  None))
    assert tl.target_entropy == jl.target_entropy == -1.0
    for seed in (1, 2):
        batch = replay_batch(seed)
        _, k_next, k_pi = jax.random.split(jl.rng, 3)
        noise = [torch.from_numpy(np.array(jax.random.normal(k, (B, 1))))
                 for k in (k_next, k_pi)]
        want = jl.train(batch)
        got = tl.update(batch_to_device(
            {k: v for k, v in batch.items() if k in sac._USED}, "cpu"),
            *noise)
        got = dict(zip(sac.AUX_KEYS, got.tolist()))
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k])
    step_atol = 1e-2 * tcfg.lr
    tree_close(tl.params, jl.params, atol=step_atol)
    tree_close(tl.target_q, jl.target_q, atol=step_atol)
    opt = jl.opt_state[1][0]
    tree_close(tl.opt_state["mu"], opt.mu)
    tree_close(tl.opt_state["nu"], opt.nu)
    # train() draws its own normals from the learner's generator
    assert set(tl.train(replay_batch(3))) == set(sac.AUX_KEYS)


def test_learner_state_round_trips_and_checkpoint_restores():
    """The learner's state through numpy, and ``tests/test_rl.py``'s SAC
    checkpoint round trip through ``__getstate__``/``__setstate__``."""
    _, tcfg = cfg_pair()
    scale, center = np.float32([2.0]), np.float32([0.0])
    a = sac.SACLearner(jax_actor(), 3, 1, scale, center, tcfg, device="cpu")
    b = sac.SACLearner(jax_actor(), 3, 1, scale, center, tcfg, device="cpu")
    a.train(replay_batch(1))
    b.set_state(a.state())
    b.generator.set_state(a.generator.get_state())
    assert a.train(replay_batch(2)) == b.train(replay_batch(2))

    def build(seed):
        return (SAC.get_default_config()
                .environment("Pendulum-v1")
                .training(train_batch_size=32, n_updates_per_iter=1,
                          num_steps_sampled_before_learning_starts=16)
                .resources(device="cpu")
                .debugging(seed=seed)
                .build())

    algo, algo2 = build(1), build(2)
    try:
        for _ in range(5):
            algo.step()
        algo2.__setstate__(algo.__getstate__())
        w1, w2 = algo.get_weights(), algo2.get_weights()
        np.testing.assert_array_equal(w1["actor"]["layers"][0]["w"],
                                      w2["actor"]["layers"][0]["w"])
        for x, y in zip(models.tree_leaves(algo.learner.state()),
                        models.tree_leaves(algo2.learner.state())):
            np.testing.assert_array_equal(x, y)
    finally:
        algo.stop()
        algo2.stop()


def test_sac_learns_pendulum():
    """``tests/test_rl.py``'s SAC gate: lift Pendulum's return from the
    ~-1300 random level to > -800, by more than 100 over the early
    episodes."""
    algo = (SAC.get_default_config()
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
    assert final > -800, (early, final)
    assert final - float(np.mean(early)) > 100, (early, final)
