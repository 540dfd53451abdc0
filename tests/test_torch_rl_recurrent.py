"""The port's memory models (``rl/recurrent.py``: LSTM and attention cores,
sequence replay, ``RecurrentPolicy``, ``RecurrentPPOLearner``) against the
JAX package's, on the CPU, and the reference's memory-model learning gates.

Weights come from the JAX package's own init and are carried across
through numpy; inputs are seeded numpy. Forward functions agree at rtol
1e-5, atol 1e-6 (``tests/test_torch_rl.py``'s tolerance), and so do the
sequence loss and its gradient. The learner's whole schedule, fed the
permutations the JAX learner draws from its key, agrees at rtol 1e-5 with
an atol of a hundredth of one Adam step (1e-2 x lr) on the parameters:
Adam scales each element's gradient to about lr whatever its size, so a
gradient element that nearly cancels (1e-8 against 1e-2 elsewhere in its
leaf), whose f32 sum two backward passes round differently, comes out a
visible fraction of a step apart (seen: 5e-4 and 1.5e-3 of a step on one
element of 1024). The gates are ``tests/test_rl_extended.py``'s,
configs, iteration counts, seed and thresholds unchanged, with the
learner on the CPU.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import models as jax_models
from ray_tpu.rl import ppo as jax_ppo
from ray_tpu.rl import recurrent as jax_rec
from ray_tpu.rl.env import make_env as jax_make_env
from ray_tpu_torch.rl import PPO, Impala, PPOConfig, RolloutWorker, SampleBatch
from ray_tpu_torch.rl import models, recurrent
from ray_tpu_torch.rl.sample_batch import batch_to_device

RTOL, ATOL = 1e-5, 1e-6
LR = 3e-3
STEP_ATOL = 1e-2 * LR   # a hundredth of one Adam step (docstring)
LSTM = {"use_lstm": True, "lstm_cell_size": 16}
ATTN = {"use_attention": True, "attention_dim": 16, "attention_window": 4}
SHARED = {"use_lstm": True, "lstm_cell_size": 8, "vf_share_layers": True}
CONFIGS = {"lstm": LSTM, "attention": ATTN, "shared": SHARED}
OBS_DIM, ACT_DIM = 4, 2


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops: one intra-op thread is much faster here; a
    Trainable without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_init(kind, continuous=False):
    params, size = jax_rec.memory_model_init(
        jax.random.key(0), OBS_DIM, ACT_DIM, CONFIGS[kind], continuous)
    return jax.device_get(params), size


def jax_params(kind, continuous=False):
    params, size = _jax_init(kind, continuous)
    return jax.tree_util.tree_map(np.copy, params), size


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = models.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        close(a, b, rtol, atol)


def seeded_state(kind, size, B, rng):
    """A state of ``size`` per row; for attention, windows whose validity
    flags leave some slots empty."""
    state = (rng.standard_normal((B, size)) * 0.5).astype(np.float32)
    if CONFIGS[kind].get("use_attention"):
        d = CONFIGS[kind]["attention_dim"]
        win = state.reshape(B, -1, d + 1)
        win[..., d] = rng.random(win.shape[:-1]) < 0.5
        win[0, :, d] = 0.0             # one row with every slot empty
    return state


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_init_matches_the_jax_tree_and_state_size(kind):
    want, size = jax_params(kind, continuous=True)
    got, got_size = recurrent.memory_model_init(
        torch.Generator().manual_seed(0), OBS_DIM, ACT_DIM, CONFIGS[kind],
        True, "cpu")
    assert got_size == size
    assert jax.tree_util.tree_structure(models.to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(models.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    lstm = got["pi_net"].get("lstm")
    if lstm is not None:               # forget-gate bias 1
        h = CONFIGS[kind]["lstm_cell_size"]
        assert lstm["b"][h:2 * h].eq(1).all() and lstm["b"][:h].eq(0).all()


@pytest.mark.parametrize("kind", ["lstm", "attention"])
def test_branch_step_matches_jax(kind):
    """One step of one branch, attention windows with empty slots (a row
    with all of them empty) included."""
    params, size = jax_params(kind)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((5, OBS_DIM)).astype(np.float32)
    state = seeded_state(kind, size // 2, 5, rng)
    cfg = CONFIGS[kind]
    want = jax.jit(lambda b, o, s: jax_rec._branch_step(b, cfg, o, s))(
        params["pi_net"], obs, state)
    got = recurrent._branch_step(
        models.params_from_numpy(params["pi_net"], "cpu"), cfg,
        torch.from_numpy(obs), torch.from_numpy(state))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_memory_forward_and_bootstrap_value_match_jax(kind):
    """Sequence replay with resets in mid-fragment (and one at t = 0),
    then the bootstrap value from the final state."""
    params, size = jax_params(kind)
    cfg = CONFIGS[kind]
    rng = np.random.default_rng(2)
    B, T = 4, 7
    obs = rng.standard_normal((B, T, OBS_DIM)).astype(np.float32)
    resets = (rng.random((B, T)) < 0.3).astype(np.float32)
    resets[1, 0] = 1.0
    state0 = seeded_state(kind, size, B, rng)
    boot_obs = rng.standard_normal((B, OBS_DIM)).astype(np.float32)

    @jax.jit
    def jax_side(p, o, s, r, b):
        dist_in, values, final = jax_rec.memory_forward(p, cfg, o, s, r)
        return dist_in, values, final, jax_rec.memory_bootstrap_value(
            p, cfg, b, final)

    want = jax_side(params, obs, state0, resets, boot_obs)
    tp = models.params_from_numpy(params, "cpu")
    got = recurrent.memory_forward(tp, cfg, torch.from_numpy(obs),
                                   torch.from_numpy(state0),
                                   torch.from_numpy(resets))
    got = (*got, recurrent.memory_bootstrap_value(
        tp, cfg, torch.from_numpy(boot_obs), got[2]))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def test_policy_loads_jax_weights_and_steps_like_jax():
    """RecurrentPolicy with a JAX policy's weights: the same deterministic
    actions, logp, values and state over steps, an episode reset between
    them, and the value of a subset of envs from their state rows."""
    spec = jax_make_env("MemoryCue-v0", {"seed": 0}).spec
    jp = jax_rec.RecurrentPolicy(spec, LSTM, seed=3)
    tp = recurrent.RecurrentPolicy(spec, LSTM, seed=3, device="cpu")
    tp.set_weights(jp.get_weights())
    rng = np.random.default_rng(4)
    for step in range(3):
        obs = rng.random((6, OBS_DIM)).astype(np.float32)
        got = tp.compute_actions(obs, explore=False)
        want = jp.compute_actions(obs, explore=False)
        np.testing.assert_array_equal(got[0], want[0])
        close(got[1], want[1])
        close(got[2], want[2])
        close(tp.get_recurrent_state(6), jp.get_recurrent_state(6))
        if step == 1:
            tp.on_episode_end([0, 4])
            jp.on_episode_end([0, 4])
    close(tp.value(obs[[1, 3]], env_indices=[1, 3]),
          jp.value(obs[[1, 3]], env_indices=[1, 3]))
    actions, logp, _ = tp.compute_actions(obs)
    assert actions.shape == (6,) and np.isfinite(logp).all()


def seq_batch(kind, n_seq, T, seed=5):
    """A seeded batch of whole fragments: the columns PPO's sequence loss
    reads, episode ends inside fragments, and each fragment's start state
    broadcast over its rows (the rollout worker's ``state_in``)."""
    _, size = jax_params(kind)
    rng = np.random.default_rng(seed)
    n = n_seq * T
    state0 = seeded_state(kind, size, n_seq, rng)
    return SampleBatch({
        SampleBatch.OBS: rng.random((n, OBS_DIM)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, ACT_DIM, size=n),
        SampleBatch.ACTION_LOGP: (rng.standard_normal(n) * 0.2 - 0.7)
        .astype(np.float32),
        SampleBatch.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.15,
        SampleBatch.TRUNCATEDS: rng.random(n) < 0.05,
        "state_in": np.repeat(state0, T, axis=0),
    })


def cfg_pair(model, **kw):
    base = dict(lr=LR, sgd_minibatch_size=10, num_sgd_iter=2,
                clip_param=0.2, entropy_coeff=0.01, grad_clip=0.5, seed=0,
                model=model)
    base.update(kw)
    j, t = jax_ppo.PPOConfig(), PPOConfig()
    for k, v in base.items():
        setattr(j, k, v)
        setattr(t, k, v)
    return j, t


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_sequence_loss_and_gradient_match_jax(kind):
    """The sequence loss (replay from ``state_in`` with resets, then PPO's
    surrogate) and its gradient on one minibatch of 4 sequences."""
    T = 5
    params, _ = jax_params(kind)
    jcfg, tcfg = cfg_pair(CONFIGS[kind])
    arrays = recurrent.sequence_arrays(seq_batch(kind, 4, T), T, 1)
    cfg = CONFIGS[kind]

    def jax_loss(p):
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        dist_in, values, _ = jax_rec.memory_forward(
            p, cfg, jb[SampleBatch.OBS], jb["state_in"], jb["resets"])
        dist = jax_models.make_distribution(p, dist_in, False)
        return jax_models.ppo_surrogate_loss(dist, values, jb, jcfg, 0.3)

    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    tl = recurrent.RecurrentPPOLearner(params, tcfg, False, T, device="cpu")
    got, got_aux = tl._loss(0.3, batch_to_device(arrays, "cpu"))
    grads = torch.autograd.grad(got, models.tree_leaves(tl.params))
    close(got.item(), want)
    for k in want_aux:
        close(got_aux[k].item(), want_aux[k])
    tree_close(list(grads), want_g)


@pytest.mark.parametrize("kind,n_seq", [("lstm", 6), ("attention", 6),
                                        ("shared", 6), ("lstm", 1)],
                         ids=["lstm", "attention", "shared", "lstm-padded"])
def test_recurrent_learner_matches_jax(kind, n_seq):
    """RecurrentPPOLearner's schedule (2 epochs of minibatches of 2
    sequences of 5 steps) against the JAX learner's train, fed the JAX
    learner's permutations; with one sequence, the batch is tiled up to a
    minibatch as the JAX learner tiles it."""
    T = 5
    params, _ = jax_params(kind)
    batch = seq_batch(kind, n_seq, T)
    jcfg, tcfg = cfg_pair(CONFIGS[kind])
    jl = jax_rec.RecurrentPPOLearner(params, jcfg, False, T)
    want = jl.train(batch, 0.2)
    tl = recurrent.RecurrentPPOLearner(params, tcfg, False, T, device="cpu")
    arrays = recurrent.sequence_arrays(batch, T, tl.minibatch)
    n = len(arrays[SampleBatch.OBS])
    assert n == max(n_seq, 2) and tl.minibatch == 2
    rng = jax.random.key(jcfg.seed + 7919)
    perms = []
    for _ in range(jcfg.num_sgd_iter):
        rng, key = jax.random.split(rng)
        perms.append(torch.from_numpy(np.asarray(
            jax.random.permutation(key, n)).astype(np.int64)))
    got = tl.sgd(batch_to_device(arrays, "cpu"), 0.2, perms)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    tree_close(tl.params, jl.params, atol=STEP_ATOL)
    opt = jl.opt_state[1][0]
    tree_close(tl.opt_state["mu"], opt.mu)
    tree_close(tl.opt_state["nu"], opt.nu)
    # train() shapes the batch and draws its own permutations
    assert set(tl.train(batch, 0.2)) == set(want)


def test_sampled_logps_replay_exactly():
    """``tests/test_rl_extended.py``'s replay check on the port: the
    learner's sequence replay reproduces the sampling-time logps
    (``state_in`` + resets contract), LSTM and attention."""
    for cfg in (LSTM, ATTN):
        w = RolloutWorker("CartPole-v1", num_envs=4,
                          rollout_fragment_length=20, policy_config=cfg,
                          seed=0, policy_cls=recurrent.RecurrentPolicy,
                          device="cpu")
        b = w.sample()
        T, n = 20, len(b)
        arrays = batch_to_device(recurrent.sequence_arrays(b, T, 1), "cpu")
        assert arrays["resets"].sum() > 0      # episodes end mid-fragment
        dist_in, _, _ = recurrent.memory_forward(
            w.policy.params, cfg, arrays[SampleBatch.OBS],
            arrays["state_in"], arrays["resets"])
        lp = models.make_distribution(w.policy.params, dist_in, False).logp(
            arrays[SampleBatch.ACTIONS])
        close(lp.reshape(n), b[SampleBatch.ACTION_LOGP], rtol=0)


def test_memory_models_build_for_ppo_and_impala():
    """The catalog seam: use_lstm / use_attention swap in RecurrentPolicy
    and the sequence learner (PPO) or memory replay (IMPALA), the learner
    on the device it is given; a small batch pads (tiles) its sequences
    (``test_recurrent_ppo_small_batch_pads_sequences``)."""
    algo = (PPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=20)
            .training(train_batch_size=40, sgd_minibatch_size=128,
                      num_sgd_iter=2, lr=3e-4,
                      model={"use_lstm": True, "lstm_cell_size": 16})
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        assert isinstance(algo.learner, recurrent.RecurrentPPOLearner)
        assert isinstance(algo.workers.local_worker.policy,
                          recurrent.RecurrentPolicy)
        r = algo.step()
        assert "policy_loss" in r and r["timesteps_this_iter"] == 40
    finally:
        algo.stop()
    algo = (Impala.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=10)
            .training(model=ATTN)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        assert algo.learner.recurrent and algo.learner.device.type == "cpu"
        assert "count" in algo.learner.opt_state       # Adam, not RMSprop
        assert "policy_loss" in algo.step()
    finally:
        algo.stop()


def memory_cue_ppo(**training):
    kw = dict(train_batch_size=640, sgd_minibatch_size=160, num_sgd_iter=10,
              lr=1e-3, grad_clip=10.0)
    kw.update(training)
    return (PPO.get_default_config()
            .environment("MemoryCue-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=20)
            .training(**kw)
            .resources(device="cpu")
            .debugging(seed=0).build())


@pytest.mark.parametrize("model", [
    {"use_lstm": True, "lstm_cell_size": 32},
    {"use_attention": True, "attention_dim": 32, "attention_window": 8}],
    ids=["lstm", "attention"])
def test_memory_ppo_solves_memory_task(model):
    """``test_lstm_ppo_solves_memory_task`` and
    ``test_attention_ppo_solves_memory_task``: MemoryCue pays +1 only for
    recalling a cue visible ONLY at t=0."""
    algo = memory_cue_ppo(entropy_coeff=0.01, model=model)
    try:
        for _ in range(30):
            r = algo.step()
    finally:
        algo.stop()
    assert r["episode_reward_mean"] > 0.8, r["episode_reward_mean"]


def test_memoryless_policy_cannot_solve_memory_task():
    """The control: plain PPO stays near chance on MemoryCue."""
    algo = memory_cue_ppo()
    try:
        for _ in range(20):
            r = algo.step()
    finally:
        algo.stop()
    assert r["episode_reward_mean"] < 0.6, r["episode_reward_mean"]
