"""The port's RL models, distributions, PPO loss and optimizer, learner
schedule, CartPole twin and policy against the JAX package's, on the CPU.

Weights come from the JAX package's own init (``actor_critic_init``,
``Policy``) and are carried across through numpy (``params_from_numpy``,
``set_weights``); inputs are seeded numpy. Forward functions agree at
rtol 1e-5 (the reference's own RL tolerance, ``tests/test_rl.py``); the
gradient, the optimizer step and the whole SGD schedule at rtol 1e-5 with
atol 1e-6. The schedule is fed the permutations JAX draws from its key, so
that both learners see the same minibatches.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import models as jax_models
from ray_tpu.rl import policy as jax_policy
from ray_tpu.rl import ppo as jax_ppo
from ray_tpu.rl.env import jax_cartpole_reset, jax_cartpole_step
from ray_tpu_torch.rl import PPOConfig, SampleBatch
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env import (CartPoleEnv, torch_cartpole_reset,
                                  torch_cartpole_step)
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import PPOLearner, adam_init, clip_adam_step_
from ray_tpu_torch.rl.sample_batch import batch_to_device

RTOL = 1e-5
ATOL = 1e-6
SPACES = {"discrete": (4, 2), "continuous": (3, 1)}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread is much faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_init(kind, seed):
    obs_dim, act_dim = SPACES[kind]
    return jax.device_get(jax_models.actor_critic_init(
        jax.random.key(seed), obs_dim, act_dim,
        continuous=kind == "continuous"))


def jax_params(kind, seed=0):
    """The JAX package's initial parameters as numpy (a fresh copy)."""
    return jax.tree_util.tree_map(np.copy, _jax_init(kind, seed))


def seeded_batch(kind, n, seed=1):
    """A batch of the columns the PPO loss reads, as numpy."""
    obs_dim, act_dim = SPACES[kind]
    rng = np.random.default_rng(seed)
    if kind == "discrete":
        actions = rng.integers(0, act_dim, size=n)
    else:
        actions = rng.standard_normal((n, act_dim)).astype(np.float32)
    return {
        SampleBatch.OBS: rng.standard_normal((n, obs_dim)).astype(
            np.float32),
        SampleBatch.ACTIONS: actions,
        SampleBatch.ACTION_LOGP: (rng.standard_normal(n) * 0.3 - 0.7)
        .astype(np.float32),
        SampleBatch.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.standard_normal(n).astype(
            np.float32),
    }


def cfg_pair(**kw):
    """The same PPO settings for both packages."""
    base = dict(lr=3e-3, sgd_minibatch_size=16, num_sgd_iter=3,
                clip_param=0.2, entropy_coeff=0.01, grad_clip=0.5, seed=0)
    base.update(kw)
    j, t = jax_ppo.PPOConfig(), PPOConfig()
    for k, v in base.items():
        setattr(j, k, v)
        setattr(t, k, v)
    return j, t


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = models.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        close(a, b, rtol, atol)


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_actor_critic_apply_matches_jax(kind):
    params = jax_params(kind)
    obs = np.random.default_rng(2).standard_normal(
        (32, SPACES[kind][0])).astype(np.float32)
    want = jax.jit(jax_models.actor_critic_apply)(params, jnp.asarray(obs))
    got = models.actor_critic_apply(models.params_from_numpy(params, "cpu"),
                                    torch.from_numpy(obs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w)
    assert models.num_params(models.params_from_numpy(params, "cpu")) == \
        jax_models.num_params(params)


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_distributions_match_jax(kind):
    """logp, entropy, kl and the deterministic action of Categorical and
    DiagGaussian on seeded inputs."""
    rng = np.random.default_rng(4)
    a_in, b_in = (rng.standard_normal((16, 3)).astype(np.float32) * 2
                  for _ in range(2))
    if kind == "discrete":
        actions = rng.integers(0, 3, size=16)
        jd = [jax_models.Categorical(jnp.asarray(x)) for x in (a_in, b_in)]
        td = [models.Categorical(torch.from_numpy(x)) for x in (a_in, b_in)]
    else:
        actions = rng.standard_normal((16, 3)).astype(np.float32)
        log_std = [rng.standard_normal(3).astype(np.float32) * 0.5
                   for _ in range(2)]
        jd = [jax_models.DiagGaussian(jnp.asarray(x), jnp.asarray(s))
              for x, s in zip((a_in, b_in), log_std)]
        td = [models.DiagGaussian(torch.from_numpy(x), torch.from_numpy(s))
              for x, s in zip((a_in, b_in), log_std)]
    close(td[0].logp(torch.from_numpy(actions)),
          jd[0].logp(jnp.asarray(actions)))
    close(td[0].entropy(), jd[0].entropy())
    close(td[0].kl(td[1]), jd[0].kl(jd[1]), atol=ATOL)
    np.testing.assert_array_equal(td[0].deterministic().numpy(),
                                  np.asarray(jd[0].deterministic()))
    # The port's draws come from a torch.Generator: only their law agrees.
    draws = td[0].sample(torch.Generator().manual_seed(0))
    assert tuple(draws.shape) == tuple(jd[0].deterministic().shape)


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_ppo_loss_and_gradient_match_jax(kind):
    params = jax_params(kind)
    batch = seeded_batch(kind, 24)
    jcfg, tcfg = cfg_pair(entropy_coeff=0.05)
    continuous = kind == "continuous"

    def jax_loss(p):
        dist_in, values = jax_models.actor_critic_apply(
            p, jnp.asarray(batch[SampleBatch.OBS]))
        dist = jax_models.make_distribution(p, dist_in, continuous)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jax_models.ppo_surrogate_loss(dist, values, jb, jcfg, 0.3)

    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = models.params_from_numpy(params, "cpu")
    leaves = models.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = batch_to_device(SampleBatch(batch), "cpu")
    dist_in, values = models.actor_critic_apply(tp, tb[SampleBatch.OBS])
    dist = models.make_distribution(tp, dist_in, continuous)
    got, got_aux = models.ppo_surrogate_loss(dist, values, tb, tcfg, 0.3)
    grads = torch.autograd.grad(got, leaves)
    close(got.item(), want)
    for k in want_aux:
        close(got_aux[k].item(), want_aux[k], atol=ATOL)
    tree_close(list(grads), want_g)


@pytest.mark.parametrize("scale", [1e-3, 100.0], ids=["below", "above"])
def test_clip_and_adam_step_matches_optax(scale):
    """Three steps of clip_by_global_norm(0.5) + adam(1e-3), with gradient
    norms below and above the clip."""
    rng = np.random.default_rng(5)
    params = jax_params("continuous")
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        params) for _ in range(3)]
    grads_copy = jax.tree_util.tree_map(np.copy, grads)
    norm = float(optax.global_norm(grads[0]))
    assert (norm < 0.5) == (scale < 1), norm
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def jax_step(p, s, g):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    tp = models.params_from_numpy(params, "cpu")
    opt = adam_init(tp)
    for g in grads:
        jp, state = jax_step(jp, state, g)
        clip_adam_step_(models.tree_leaves(tp), [
            torch.from_numpy(x) for x in jax.tree_util.tree_leaves(g)],
            opt, 0.5, 1e-3)
    assert opt["count"] == 3
    # the gradients handed in are not clipped in place (JAX reads the same
    # numpy buffers, possibly after the port's step: dispatch is async)
    assert np.array_equal(jax.tree_util.tree_leaves(grads[-1])[0],
                          jax.tree_util.tree_leaves(grads_copy[-1])[0])
    tree_close(tp, jp)
    tree_close(opt["mu"], state[1][0].mu)
    tree_close(opt["nu"], state[1][0].nu)


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_learner_schedule_matches_jax(kind):
    """PPOLearner.train's whole schedule (3 epochs x 3 minibatches of 16 out
    of 56 rows, so a remainder is dropped) against the JAX learner, with
    the permutations the JAX learner draws from its key."""
    params = jax_params(kind)
    batch = seeded_batch(kind, 56)
    jcfg, tcfg = cfg_pair()
    continuous = kind == "continuous"
    jl = jax_ppo.PPOLearner(params, jcfg, continuous)
    want = jl.train(SampleBatch(batch), 0.2)
    rng = jax.random.key(jcfg.seed + 7919)
    perms = []
    for _ in range(jcfg.num_sgd_iter):
        rng, key = jax.random.split(rng)
        perms.append(torch.from_numpy(np.asarray(
            jax.random.permutation(key, 56)).astype(np.int64)))
    tl = PPOLearner(params, tcfg, continuous, device="cpu")
    got = tl.sgd(batch_to_device(SampleBatch(batch), "cpu"), 0.2, perms)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], atol=ATOL)
    tree_close(tl.params, jl.params)
    assert tl.opt_state["count"] == 9
    # train() draws its own permutations from the learner's generator
    assert set(tl.train(SampleBatch(batch), 0.2)) == set(want)


def test_learner_state_round_trips_through_numpy():
    jcfg, tcfg = cfg_pair()
    batch = SampleBatch(seeded_batch("discrete", 32))
    a = PPOLearner(jax_params("discrete"), tcfg, False, device="cpu")
    a.train(batch, 0.2)
    state = a.state()
    assert all(isinstance(x, np.ndarray)
               for x in models.tree_leaves(state[0]))
    b = PPOLearner(jax_params("discrete", seed=9), tcfg, False,
                   device="cpu")
    b.set_state(state)
    tree_close(b.params, state[0], rtol=0, atol=0)
    assert b.opt_state["count"] == a.opt_state["count"] == 6
    torch.manual_seed(0)
    b.generator.set_state(a.generator.get_state())
    assert a.train(batch, 0.2) == b.train(batch, 0.2)


def test_a_mesh_learner_is_not_ported_yet():
    """The mesh learner is ported now (``tests/test_torch_rl_mesh.py``
    holds it against JAX's); what stays here: its device is the mesh's,
    and a ``device=`` that names another is refused before anything is
    built."""
    _, tcfg = cfg_pair()
    gloo_mesh = types.SimpleNamespace(device_type="cpu")
    with pytest.raises(ValueError, match="this rank's device is cpu"):
        PPOLearner(jax_params("discrete"), tcfg, False, mesh=gloo_mesh,
                   device="cuda")


def test_batch_to_device_casts_float64_and_keeps_integers():
    out = batch_to_device(SampleBatch({
        "a": np.arange(4, dtype=np.float64), "b": np.arange(4)}), "cpu")
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.int64
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4))


def test_torch_cartpole_step_matches_jax():
    rng = np.random.default_rng(6)
    state = rng.uniform(-0.2, 0.2, size=(64, 4)).astype(np.float32)
    state[:8, :2] = 2.399, 0.5     # at the track's end: these steps end
    action = rng.integers(0, 2, size=64)
    want = jax_cartpole_step(jnp.asarray(state),
                             jnp.asarray(action, jnp.int32))
    got = torch_cartpole_step(torch.from_numpy(state),
                              torch.from_numpy(action))
    close(got[0], want[0], atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].sum() < 64
    # the numpy env's step, one row at a time
    env = CartPoleEnv({"seed": 0})
    env.reset(seed=0)
    env._state = state[0].copy()
    obs, _, term, _, _ = env.step(int(action[0]))
    close(got[0][0], obs, atol=ATOL)
    assert term == bool(got[2][0])
    s0 = torch_cartpole_reset(torch.Generator().manual_seed(0), 16, "cpu")
    j0 = jax_cartpole_reset(jax.random.key(0), 16)
    assert tuple(s0.shape) == j0.shape == (16, 4)
    assert s0.dtype == torch.float32 and float(s0.abs().max()) <= 0.05


@pytest.mark.parametrize("env_name", ["CartPole-v1", "Pendulum-v1"])
def test_policy_loads_jax_weights_and_acts_like_jax(env_name):
    """A JAX policy's numpy weights in the port's policy: the same
    deterministic actions, logp and values; get_weights hands back the
    same numpy tree."""
    from ray_tpu.rl.env import make_env as jax_make_env
    from ray_tpu_torch.rl import make_env
    jp = jax_policy.Policy(jax_make_env(env_name, {"seed": 0}).spec, seed=3)
    weights = jp.get_weights()
    spec = make_env(env_name, {"seed": 0}).spec
    tp = Policy(spec, seed=3, device="cpu")
    tp.set_weights(weights)
    for a, b in zip(models.tree_leaves(tp.get_weights()),
                    jax.tree_util.tree_leaves(weights)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    obs = np.random.default_rng(7).standard_normal(
        (8,) + spec.observation_space.shape).astype(np.float32)
    got = tp.compute_actions(obs, explore=False)
    want = jp.compute_actions(obs, explore=False)
    close(got[0], want[0], atol=ATOL)     # argmax, or the clipped mean
    close(got[1], want[1], atol=ATOL)
    close(got[2], want[2], atol=ATOL)
    close(tp.value(obs), jp.value(obs), atol=ATOL)
    # exploring draws come from the port's own generator, and stay legal
    actions, logp, _ = tp.compute_actions(obs)
    assert actions.shape == want[0].shape and np.isfinite(logp).all()
    if env_name == "Pendulum-v1":
        assert np.all(np.abs(actions) <= 2.0)


def test_policy_runs_on_cuda_by_default_and_refuses_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = CartPoleEnv().spec
    with pytest.raises(RuntimeError, match="cuda"):
        Policy(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        PPOLearner(jax_params("discrete"), cfg_pair()[1], False)
