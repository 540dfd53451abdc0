"""Recurrent (LSTM) and attention policy models for PPO/IMPALA.

Port of ``ray_tpu/rl/recurrent.py``. Parity with the reference model
catalog's ``use_lstm`` / ``use_attention`` wrappers
(``rllib/models/catalog.py:1``, ``torch/recurrent_net.py``,
``torch/attention_net.py`` GTrXL): a memory core between the observation
encoder and the pi/vf heads, enabled by ``model={"use_lstm": True}`` or
``{"use_attention": True}`` on PPO and IMPALA.

Both cores are one ``core_step`` (state [B, S] -> state [B, S]), so
sampling is a T=1 step and learning replays the SAME function over a
fragment, with mid-fragment episode boundaries handled by a reset mask
applied before each step. Where the JAX package runs the replay as one
``lax.scan``, here it is a Python loop over T of eager steps.

- LSTM: state = [h, c] concatenated.
- Attention: state = the rolling window of the last K encoded frames
  (+ a validity flag per slot); each step attends its current frame over
  the window (single head, learned positional embeddings).

The fragment contract matches rllib's ``state_in`` + sequence replay: the
rollout worker snapshots per-env state at fragment start
(``rollout_worker.py sample()``), the learner replays each fragment from
that snapshot with resets at episode ends. Parameters use the JAX
package's tree layout, so ``params_from_numpy`` carries its weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.env import Box, EnvSpec
from ray_tpu_torch.rl.ppo import PPOLearner
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device


# ---------------------------------------------------------------------------
# memory cores
# ---------------------------------------------------------------------------

def _orthogonal(generator: torch.Generator, shape, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.orthogonal_(w, generator=generator)


def _branch_init(generator: torch.Generator, obs_dim: int,
                 config: Dict[str, Any], device) -> Tuple[Dict, int, int]:
    """One encoder+core branch -> (params, state_size, out_dim)."""
    use_attn = bool(config.get("use_attention"))
    feat = int(config.get("encoder_dim",
                          config.get("attention_dim", 64) if use_attn
                          else config.get("lstm_cell_size", 64)))
    params: Dict[str, Any] = {
        "encoder": _models.mlp_init(generator, obs_dim, (), feat,
                                    out_scale=1.0, device=device),
    }
    if use_attn:
        K = int(config.get("attention_window", 8))
        d = feat
        params["attn"] = {
            "wq": _orthogonal(generator, (d, d), device),
            "wk": _orthogonal(generator, (d, d), device),
            "wv": _orthogonal(generator, (d, d), device),
            "pos": 0.01 * torch.randn((K, d), generator=generator,
                                      device=device),
        }
        return params, K * (d + 1), d  # window + per-slot validity flag
    h = int(config.get("lstm_cell_size", 64))
    params["lstm"] = {
        "wx": _orthogonal(generator, (feat, 4 * h), device),
        "wh": _orthogonal(generator, (h, 4 * h), device),
        # forget-gate bias 1.0 (standard trainability trick)
        "b": torch.cat([torch.zeros(h, device=device),
                        torch.ones(h, device=device),
                        torch.zeros(2 * h, device=device)]),
    }
    return params, 2 * h, h


def memory_model_init(generator: torch.Generator, obs_dim: int,
                      action_dim: int, config: Dict[str, Any],
                      continuous: bool, device=None
                      ) -> Tuple[Dict[str, Any], int]:
    """-> (params, flat state size). ``config`` keys: use_lstm,
    lstm_cell_size, use_attention, attention_window, attention_dim,
    vf_share_layers. Draws from ``generator``, which lives on ``device``.

    The value function gets its OWN encoder+core by default
    (``vf_share_layers=False``, the reference PPO default): with a shared
    trunk the value-regression gradient dwarfs the policy gradient and
    churns the features under the pi head every update."""
    share = bool(config.get("vf_share_layers", False))
    pi_net, s_size, core_out = _branch_init(generator, obs_dim, config,
                                            device)
    params: Dict[str, Any] = {"pi_net": pi_net}
    state_size = s_size
    if not share:
        vf_net, vs, _ = _branch_init(generator, obs_dim, config, device)
        params["vf_net"] = vf_net
        state_size += vs
    params["pi"] = _models.mlp_init(generator, core_out, (), action_dim,
                                    device=device)
    params["vf"] = _models.mlp_init(generator, core_out, (), 1,
                                    out_scale=1.0, device=device)
    if continuous:
        params["log_std"] = torch.zeros((action_dim,), dtype=torch.float32,
                                        device=device)
    return params, state_size


def _branch_step(branch, config: Dict[str, Any], obs: torch.Tensor,
                 state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One memory step of one branch: obs [B, D] + state [B, S]."""
    feat = torch.tanh(_models.mlp_apply(branch["encoder"], obs))
    if config.get("use_attention"):
        ap = branch["attn"]
        K, d = ap["pos"].shape
        win = state.reshape(state.shape[0], K, d + 1)
        # roll the window and append the current frame (valid flag 1)
        new_row = torch.cat([feat, torch.ones_like(feat[..., :1])], dim=-1)
        win = torch.cat([win[:, 1:], new_row[:, None]], dim=1)
        frames, valid = win[..., :d], win[..., d]
        q = feat @ ap["wq"]                        # [B, d]
        k = (frames + ap["pos"]) @ ap["wk"]        # [B, K, d]
        v = frames @ ap["wv"]
        att = torch.einsum("bd,bkd->bk", q, k) / math.sqrt(d)
        att = att + (1.0 - valid) * -1e9           # mask empty slots
        att = torch.softmax(att, dim=-1)
        out = torch.tanh(feat + torch.einsum("bk,bkd->bd", att, v))
        return out, win.reshape(state.shape)
    lp = branch["lstm"]
    h_size = lp["wh"].shape[0]
    h, c = state[:, :h_size], state[:, h_size:]
    gates = feat @ lp["wx"] + h @ lp["wh"] + lp["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, torch.cat([h, c], dim=-1)


def _split_state(params, state):
    """[B, S] -> (pi_state, vf_state_or_None), by branch sizes."""
    if "vf_net" not in params:
        return state, None
    half = state.shape[-1] // 2
    return state[..., :half], state[..., half:]


def _core_step(params, config: Dict[str, Any], obs: torch.Tensor,
               state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both branches, one step: -> (pi_out, vf_out, state')."""
    pi_s, vf_s = _split_state(params, state)
    pi_out, pi_s = _branch_step(params["pi_net"], config, obs, pi_s)
    if vf_s is None:
        return pi_out, pi_out, pi_s
    vf_out, vf_s = _branch_step(params["vf_net"], config, obs, vf_s)
    return pi_out, vf_out, torch.cat([pi_s, vf_s], dim=-1)


def memory_forward(params, config, obs_seq: torch.Tensor,
                   state0: torch.Tensor, resets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence replay: obs [B, T, obs], state0 [B, S], resets [B, T]
    (1.0 where a NEW episode starts at step t) -> (dist_in [B, T, A],
    values [B, T], final_state [B, S]). The state is zeroed where a reset
    is set BEFORE that step runs; the final state feeds the bootstrap
    value (V-trace learners)."""
    state = state0
    pi_outs, vf_outs = [], []
    for t in range(obs_seq.shape[1]):
        state = state * (1.0 - resets[:, t])[:, None]
        pi_out, vf_out, state = _core_step(params, config, obs_seq[:, t],
                                           state)
        pi_outs.append(pi_out)
        vf_outs.append(vf_out)
    dist_in = _models.mlp_apply(params["pi"], torch.stack(pi_outs, dim=1))
    values = _models.mlp_apply(params["vf"],
                               torch.stack(vf_outs, dim=1))[..., 0]
    return dist_in, values, state


def memory_bootstrap_value(params, config, boot_obs: torch.Tensor,
                           final_state: torch.Tensor) -> torch.Tensor:
    """Value of the post-fragment observation from the fragment-end
    state (fragment-boundary bootstrap for V-trace)."""
    _, vf_out, _ = _core_step(params, config, boot_obs, final_state)
    return _models.mlp_apply(params["vf"], vf_out)[..., 0]


# ---------------------------------------------------------------------------
# sampling-side policy
# ---------------------------------------------------------------------------

class RecurrentPolicy:
    """Stateful sampling policy over a memory core (the model-catalog
    ``use_lstm``/``use_attention`` path). Same surface as ``Policy``
    plus the recurrent-state hooks the rollout worker duck-types. The
    per-env state is host numpy between calls; ``device`` (``None``:
    ``cuda``) holds the parameters and runs the core."""

    def __init__(self, spec: EnvSpec, config: Optional[dict] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.spec = spec
        self.config = dict(config or {})
        self.device = resolve_device(device)
        self.continuous = isinstance(spec.action_space, Box)
        obs_dim = int(np.prod(spec.observation_space.shape))
        self.action_dim = (int(np.prod(spec.action_space.shape))
                           if self.continuous else spec.action_space.n)
        self.params, self.state_size = memory_model_init(
            torch.Generator(device=self.device).manual_seed(seed), obs_dim,
            self.action_dim, self.config, self.continuous, self.device)
        # The JAX package's jax.random.key(seed + 1).
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._state: Optional[np.ndarray] = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _ensure_state(self, n: int):
        if self._state is None or len(self._state) != n:
            self._state = np.zeros((n, self.state_size), np.float32)

    @torch.no_grad()
    def compute_actions(self, obs, explore: bool = True):
        obs = self._tensor(obs)
        self._ensure_state(obs.shape[0])
        pi_out, vf_out, state = _core_step(self.params, self.config, obs,
                                           self._tensor(self._state))
        dist_in = _models.mlp_apply(self.params["pi"], pi_out)
        values = _models.mlp_apply(self.params["vf"], vf_out)[..., 0]
        dist = _models.make_distribution(self.params, dist_in,
                                         self.continuous)
        actions = (dist.sample(self._generator) if explore
                   else dist.deterministic())
        logp = dist.logp(actions)
        self._state = state.cpu().numpy().copy()  # reset hooks mutate it
        actions = actions.cpu().numpy()
        if self.continuous:
            actions = np.clip(actions, self.spec.action_space.low,
                              self.spec.action_space.high)
        return actions, logp.cpu().numpy(), values.cpu().numpy()

    @torch.no_grad()
    def value(self, obs, env_indices=None) -> np.ndarray:
        """Bootstrap values from the CURRENT state, without advancing it
        (the worker calls this for fragment-end/truncation bootstraps).
        ``env_indices`` selects the state rows when ``obs`` covers only
        a subset of the sub-envs (truncation bootstraps)."""
        obs = self._tensor(obs)
        if env_indices is not None:
            self._ensure_state(max(env_indices) + 1
                               if self._state is None
                               else len(self._state))
            state = self._state[np.asarray(env_indices, int)]
        else:
            self._ensure_state(obs.shape[0])
            state = self._state
        _, vf_out, _ = _core_step(self.params, self.config, obs,
                                  self._tensor(state))
        return _models.mlp_apply(self.params["vf"],
                                 vf_out)[..., 0].cpu().numpy()

    # -- recurrent-state hooks (duck-typed by the rollout worker) --------
    def get_recurrent_state(self, n_envs: int) -> np.ndarray:
        self._ensure_state(n_envs)
        return self._state.copy()

    def on_episode_end(self, env_indices):
        if self._state is not None:
            self._state[np.asarray(env_indices, int)] = 0.0

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        return _models.to_numpy(self.params)

    def set_weights(self, weights):
        self.params = _models.params_from_numpy(weights, self.device)


# ---------------------------------------------------------------------------
# PPO sequence learner
# ---------------------------------------------------------------------------

def sequence_arrays(batch: SampleBatch, T: int, mb_seqs: int
                    ) -> Dict[str, np.ndarray]:
    """The columns PPO's sequence loss reads, as [n_seq, T, ...] blocks of
    whole fragments (a trailing partial fragment is dropped), with
    ``state_in`` (each fragment's start state) and ``resets`` (1 at t where
    step t - 1 ended an episode; never at t = 0: the fragment-start state
    already reflects any prior boundary). Fewer than ``mb_seqs`` sequences
    are tiled up to ``mb_seqs`` (the sequence analogue of ``pad_to``)."""
    n = len(batch) // T * T
    n_seq = n // T
    reps = 1 if n_seq >= mb_seqs else -(-mb_seqs // max(1, n_seq))

    def pad_seqs(a):
        if reps > 1:
            a = np.concatenate([a] * reps)[:mb_seqs]
        return a

    def to_seq(v):
        a = np.asarray(v)[:n]
        return pad_seqs(a.reshape((n_seq, T) + a.shape[1:]))

    dones = (np.asarray(batch[SampleBatch.TERMINATEDS])[:n]
             | np.asarray(batch[SampleBatch.TRUNCATEDS])[:n]
             ).astype(np.float32).reshape(n_seq, T)
    resets = np.concatenate(
        [np.zeros((n_seq, 1), np.float32), dones[:, :-1]], axis=1)
    arrays = {k: to_seq(batch[k]) for k in (
        SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
        SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)}
    arrays["state_in"] = pad_seqs(np.asarray(batch["state_in"])[:n].reshape(
        n_seq, T, -1)[:, 0])                      # fragment-start rows
    arrays["resets"] = pad_seqs(resets)
    return arrays


class RecurrentPPOLearner(PPOLearner):
    """PPO over fragment sequences: minibatches are SEQUENCES, the loss
    replays each from its fragment-start state (rllib's RNN-PPO
    semantics). ``PPOLearner``'s schedule with a minibatch of
    ``sgd_minibatch_size // T`` sequences and the sequence loss."""

    handles_batch_shaping = True  # sequences must not be cut mid-fragment

    def __init__(self, init_params, cfg, continuous: bool,
                 fragment_length: int, device=None):
        super().__init__(init_params, cfg, continuous, device=device)
        self.T = fragment_length
        self.minibatch = max(1, cfg.sgd_minibatch_size // max(1, self.T))
        self._model_cfg = dict(cfg.model)

    def _loss(self, kl_coeff, batch):
        dist_in, values, _ = memory_forward(
            self.params, self._model_cfg, batch[SampleBatch.OBS],
            batch["state_in"], batch["resets"])
        dist = _models.make_distribution(self.params, dist_in,
                                         self._continuous)
        return _models.ppo_surrogate_loss(dist, values, batch, self.cfg,
                                          kl_coeff)

    def train(self, batch: SampleBatch, kl_coeff: float) -> Dict[str, float]:
        arrays = batch_to_device(
            sequence_arrays(batch, self.T, self.minibatch), self.device)
        n_seq = arrays[SampleBatch.OBS].shape[0]
        perms = [torch.randperm(n_seq, generator=self.generator,
                                device=self.device)
                 for _ in range(self.cfg.num_sgd_iter)]
        return self.sgd(arrays, kl_coeff, perms)


def uses_memory_model(model_config: Dict[str, Any]) -> bool:
    return bool(model_config.get("use_lstm")
                or model_config.get("use_attention"))
