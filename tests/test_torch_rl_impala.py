"""The port's IMPALA and APPO (``rl/impala.py``: V-trace, optax's
clip + RMSprop, the learner's update, memory replay) against the JAX
package's, on the CPU, and the reference's IMPALA/APPO learning gates.

Weights come from the JAX package's own init and are carried across
through numpy; inputs are seeded numpy, time-major. V-trace, the
optimizer and the updates of each learner agree at rtol 1e-5, atol 1e-6
(``tests/test_torch_rl.py``'s tolerance), but for the parameters that
Adam steps (IMPALA with a memory model), held at an atol of a hundredth
of one Adam step (1e-2 x lr): Adam scales every gradient element to about
lr, so an element that nearly cancels (9e-9 against 5e-2 in its leaf),
which two f32 backward passes round differently, lands 1.5e-3 of a step
apart. The gates are ``tests/test_rl.py``'s and
``tests/test_rl_extended.py``'s, configs, iteration counts, seed and
thresholds unchanged, with the learner on the CPU and rollout workers as
CPU actors under ``init()``.
"""

import functools
import importlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rl import impala as jax_impala
from ray_tpu.rl import models as jax_models
from ray_tpu.rl import recurrent as jax_rec
from ray_tpu_torch.rl import APPO, APPOConfig, Impala, ImpalaConfig
from ray_tpu_torch.rl import SampleBatch, impala, models

RTOL, ATOL = 1e-5, 1e-6
OBS_DIM, ACT_DIM = 4, 2
LSTM = {"use_lstm": True, "lstm_cell_size": 16}
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops: one intra-op thread is much faster here; a
    Trainable without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """One ``init(num_cpus=8)`` for the gates with remote rollout
    workers."""
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


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = models.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        close(a, b, rtol, atol)


def vtrace_inputs(T=7, B=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    discounts = (0.9 * (rng.random((T, B)) > 0.2)).astype(np.float32)
    return (f(T, B) * 0.5 - 0.7, f(T, B) * 0.5 - 0.7, f(T, B), f(T, B),
            f(B), discounts)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.8, 1.2)],
                         ids=["default", "clipped"])
def test_vtrace_matches_jax(clip):
    """vs and the policy-gradient advantages, episode ends (discount 0)
    inside the window, importance ratios on both sides of the clips."""
    args = vtrace_inputs()
    want = jax.jit(jax_impala.vtrace, static_argnums=(6, 7))(*args, *clip)
    got = impala.vtrace(*map(torch.from_numpy, args), *clip)
    for g, w in zip(got, want):
        assert not g.requires_grad
        close(g, w)


def test_vtrace_on_policy_reduces_to_td_lambda1_targets():
    """``tests/test_rl.py``'s check: with rho = c = 1 and identical
    policies, vs_t is the discounted return."""
    T, B = 4, 1
    logp = torch.zeros((T, B))
    vs, _ = impala.vtrace(logp, logp, torch.ones((T, B)),
                          torch.zeros((T, B)), torch.zeros((B,)),
                          torch.full((T, B), 0.5))
    np.testing.assert_allclose(vs[:, 0].numpy(), [1.875, 1.75, 1.5, 1.0],
                               rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    if kind == "lstm":
        params, _ = jax_rec.memory_model_init(jax.random.key(0), OBS_DIM,
                                              ACT_DIM, LSTM, False)
    else:
        params = jax_models.actor_critic_init(jax.random.key(0), OBS_DIM,
                                              ACT_DIM)
    return jax.device_get(params)


def jax_params(kind):
    return jax.tree_util.tree_map(np.copy, _jax_init(kind))


@pytest.mark.parametrize("scale", [1e-3, 100.0], ids=["below", "above"])
def test_clip_and_rmsprop_step_matches_optax(scale):
    """Three steps of clip_by_global_norm(40) + rmsprop(5e-4, decay 0.99,
    eps 0.1: eps inside the square root), gradient norms below and above
    the clip."""
    rng = np.random.default_rng(5)
    params = jax_params("flat")
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        params) for _ in range(3)]
    assert (float(optax.global_norm(grads[0])) < 40) == (scale < 1)
    tx = optax.chain(optax.clip_by_global_norm(40.0),
                     optax.rmsprop(5e-4, decay=0.99, eps=0.1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def jax_step(p, s, g):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    tp = models.params_from_numpy(params, "cpu")
    opt = impala.rmsprop_init(tp)
    for g in grads:
        jp, state = jax_step(jp, state, g)
        impala.clip_rmsprop_step_(
            models.tree_leaves(tp),
            [torch.from_numpy(x) for x in jax.tree_util.tree_leaves(g)],
            opt, 40.0, 5e-4)
    tree_close(tp, jp)
    tree_close(opt["nu"], state[1][0].nu)


def tm_batch(kind, T=6, B=3, seed=1):
    """Seeded time-major [T, B] columns as ``Impala._to_time_major`` hands
    them to the learner: episode ends inside the window, a bootstrap
    observation per fragment, and for memory models each fragment's
    start state."""
    rng = np.random.default_rng(seed)
    out = {
        SampleBatch.OBS: rng.random((T, B, OBS_DIM)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, ACT_DIM, size=(T, B)),
        SampleBatch.REWARDS: rng.random((T, B)).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random((T, B)) < 0.15,
        SampleBatch.TRUNCATEDS: rng.random((T, B)) < 0.05,
        SampleBatch.ACTION_LOGP: (rng.standard_normal((T, B)) * 0.2 - 0.7)
        .astype(np.float32),
        "bootstrap_obs": np.repeat(
            rng.random((1, B, OBS_DIM)).astype(np.float32), T, 0),
    }
    if kind == "lstm":
        state0 = (rng.standard_normal((1, B, 4 * LSTM["lstm_cell_size"]))
                  * 0.3).astype(np.float32)
        out["state_in"] = np.repeat(state0, T, 0)
    return out


def impala_cfgs(kind):
    """The same learner settings for both packages: IMPALA's defaults,
    APPO's (clip 0.3, lr 3e-3) or IMPALA with an LSTM (Adam)."""
    pairs = {"rmsprop": (jax_impala.ImpalaConfig(), ImpalaConfig()),
             "appo": (jax_impala.APPOConfig(), APPOConfig()),
             "lstm": (jax_impala.ImpalaConfig(), ImpalaConfig())}
    j, t = pairs[kind]
    for c in (j, t):
        c.lr = 3e-3 if kind != "appo" else c.lr
        c.grad_clip = 1.0       # below the gradient's norm: the clip bites
        if kind == "lstm":
            c.model = dict(LSTM)
    return j, t


@pytest.mark.parametrize("kind", ["rmsprop", "appo", "lstm"])
def test_learner_update_matches_jax(kind):
    """Two updates of ImpalaLearner against the JAX learner on the same
    time-major batches: V-trace PG under RMSprop, APPO's clipped surrogate,
    and LSTM replay with the fragment-end bootstrap under Adam."""
    pkind = "lstm" if kind == "lstm" else "flat"
    params = jax_params(pkind)
    jcfg, tcfg = impala_cfgs(kind)
    jl = jax_impala.ImpalaLearner(params, jcfg, False,
                                  clip_param=jcfg.clip_param)
    tl = impala.ImpalaLearner(params, tcfg, False,
                              clip_param=tcfg.clip_param, device="cpu")
    assert tl.recurrent == (kind == "lstm")
    for seed in (1, 2):
        batch = tm_batch(pkind, seed=seed)
        want = jl.train(batch)
        got = tl.train(batch)
        assert set(got) == set(want) == set(impala.AUX_KEYS)
        for k in want:
            close(got[k], want[k])
    tree_close(tl.params, jl.params,
               atol=1e-2 * tcfg.lr if tl.recurrent else ATOL)
    moment = "mu" if kind == "lstm" else "nu"
    tree_close(tl.opt_state[moment],
               getattr(jl.opt_state[1][0], moment))
    state = tl.state()
    assert all(isinstance(x, np.ndarray)
               for x in models.tree_leaves(state[0]))
    twin = impala.ImpalaLearner(params, tcfg, False,
                                clip_param=tcfg.clip_param, device="cpu")
    twin.set_state(state)
    assert twin.train(tm_batch(pkind, seed=3)) == \
        tl.train(tm_batch(pkind, seed=3))


def test_impala_runs_and_improves(runtime):
    """``tests/test_rl.py``'s IMPALA check, 2 remote rollout workers."""
    algo = (Impala.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                      rollout_fragment_length=40)
            .training(lr=3e-3, entropy_coeff=0.01)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        for _ in range(30):
            result = algo.train()
    finally:
        algo.stop()
    assert result["timesteps_total"] > 1000
    assert "policy_loss" in result


def test_appo_learns_cartpole(runtime):
    """``tests/test_rl.py``'s APPO gate: async workers + V-trace + PPO's
    clipped surrogate improve CartPole within 200 rounds."""
    algo = (APPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=50)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        first = None
        for _ in range(200):
            r = algo.train()
            if first is None and "episode_reward_mean" in r:
                first = r["episode_reward_mean"]
    finally:
        algo.stop()
    final = r["episode_reward_mean"]
    assert final > first + 40, (first, final)
    assert final > 80, (first, final)


def test_lstm_impala_learns_cartpole(runtime):
    """``tests/test_rl_extended.py``'s gate: memory models ride IMPALA's
    V-trace learner (sequence replay + the fragment-end bootstrap from the
    replay's final state)."""
    algo = (Impala.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                      rollout_fragment_length=50)
            .training(lr=1e-3, entropy_coeff=0.01,
                      model={"use_lstm": True, "lstm_cell_size": 64})
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        first = None
        for _ in range(60):
            r = algo.step()
            if first is None and "episode_reward_mean" in r:
                first = r["episode_reward_mean"]
    finally:
        algo.stop()
    final = r["episode_reward_mean"]
    assert final > max(45.0, first + 15), (first, final)
