"""Environment API and in-repo classic-control envs.

Port of ``ray_tpu/rl/env.py``. Parity with the reference's env layer
(``rllib/env/``): a Gym-style ``Env`` protocol, ``VectorEnv`` batching, and
an env registry (``rllib/env/env_context.py``,
``ray.tune.registry.register_env``). The reference depends on external gym;
this repo ships its own CartPole and Pendulum dynamics (numpy for CPU
rollout actors), copied unchanged, plus a functional, batched CartPole in
torch (``torch_cartpole_reset`` / ``torch_cartpole_step``, the twins of the
JAX package's ``jax_cartpole_reset`` / ``jax_cartpole_step``) whose state
can stay on a device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass
class Box:
    """Continuous space: shape + bounds (gym.spaces.Box equivalent)."""
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: Any = np.float32

    def sample(self, rng: np.random.Generator):
        lo = max(self.low, -1e3)
        hi = min(self.high, 1e3)
        return rng.uniform(lo, hi, size=self.shape).astype(self.dtype)

    @property
    def n(self) -> None:
        return None


@dataclass
class Discrete:
    """Discrete space with ``n`` actions (gym.spaces.Discrete equivalent)."""
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(self.n))


@dataclass
class EnvSpec:
    observation_space: Box
    action_space: Any  # Box | Discrete
    max_episode_steps: int


class Env:
    """Single-episode environment protocol (gym-style).

    ``reset(seed) -> obs``; ``step(action) -> (obs, reward, terminated,
    truncated, info)``.
    """

    spec: EnvSpec

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, dict]:
        raise NotImplementedError


class CartPoleEnv(Env):
    """CartPole-v1 dynamics (standard Barto-Sutton-Anderson formulation)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.spec = EnvSpec(
            observation_space=Box(-np.inf, np.inf, (4,)),
            action_space=Discrete(2),
            max_episode_steps=int(config.get("max_episode_steps", 500)),
        )
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = np.zeros(4, np.float32)
        self._t = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._t = 0
        return self._state.copy()

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if int(action) == 1 else -self.FORCE_MAG
        costh, sinth = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pm_len = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pm_len * theta_dot ** 2 * sinth) / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * costh ** 2 / total_mass))
        x_acc = temp - pm_len * theta_acc * costh / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._t += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._t >= self.spec.max_episode_steps
        return self._state.copy(), 1.0, terminated, truncated, {}


class PendulumEnv(Env):
    """Pendulum-v1 dynamics: continuous torque control, swing-up."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.spec = EnvSpec(
            observation_space=Box(-8.0, 8.0, (3,)),
            action_space=Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,)),
            max_episode_steps=int(config.get("max_episode_steps", 200)),
        )
        self._rng = np.random.default_rng(config.get("seed"))
        self._theta = 0.0
        self._theta_dot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._theta), np.sin(self._theta),
                         self._theta_dot], np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = float(self._rng.uniform(-np.pi, np.pi))
        self._theta_dot = float(self._rng.uniform(-1.0, 1.0))
        self._t = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self._theta, self._theta_dot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                         + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._theta, self._theta_dot = th, thdot
        self._t += 1
        truncated = self._t >= self.spec.max_episode_steps
        return self._obs(), -cost, False, truncated, {}


class MemoryCueEnv(Env):
    """Partially observable recall task (the memory-model gate env).

    A binary cue is visible ONLY at the first step; after ``delay``
    blank steps the agent must act to match the cue (+1 reward, else
    -1), then the episode ends. A memoryless policy can do no better
    than 0 expected reward; any working recurrence/attention solves it
    — which makes this the decisive test that ``use_lstm`` /
    ``use_attention`` actually carry information through time.
    Observation: [cue_+1, cue_-1, is_query, t/delay].
    """

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.delay = int(config.get("delay", 3))
        self.spec = EnvSpec(
            observation_space=Box(0.0, 1.0, (4,)),
            action_space=Discrete(2),
            max_episode_steps=self.delay + 2,
        )
        self._rng = np.random.default_rng(config.get("seed"))
        self._cue = 0
        self._t = 0

    def _obs(self) -> np.ndarray:
        o = np.zeros(4, np.float32)
        if self._t == 0:
            o[0 if self._cue == 0 else 1] = 1.0
        if self._t == self.delay + 1:
            o[2] = 1.0  # query flag
        o[3] = self._t / (self.delay + 1)
        return o

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cue = int(self._rng.integers(2))
        self._t = 0
        return self._obs()

    def step(self, action):
        acted_on_query = self._t == self.delay + 1
        self._t = min(self._t + 1, self.delay + 1)
        if not acted_on_query:
            return self._obs(), 0.0, False, False, {}
        rew = 1.0 if int(action) == self._cue else -1.0
        return self._obs(), rew, True, False, {}


class VectorEnv:
    """Steps ``num_envs`` copies of an env with auto-reset on episode end.

    Reference: ``rllib/env/vector_env.py`` (``VectorEnv.vector_step``).
    Auto-reset semantics: when a sub-env finishes, ``step`` returns the
    *terminal* obs in ``infos[i]["terminal_obs"]`` and the obs array holds
    the freshly reset state (what the next action should condition on).
    """

    def __init__(self, env_maker: Callable[[dict], Env], num_envs: int,
                 config: Optional[dict] = None, seed: Optional[int] = None):
        config = dict(config or {})
        self.envs = []
        for i in range(num_envs):
            c = dict(config)
            if seed is not None:
                c["seed"] = seed + i
            self.envs.append(env_maker(c))
        self.num_envs = num_envs
        self.spec = self.envs[0].spec

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        return np.stack([
            e.reset(None if seed is None else seed + i)
            for i, e in enumerate(self.envs)])

    def step(self, actions):
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, info = e.step(a)
            if term or trunc:
                info = dict(info, terminal_obs=o)
                o = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        return (np.stack(obs), np.array(rews, np.float32),
                np.array(terms), np.array(truncs), infos)


# --------------------------------------------------------------------------
# Batched CartPole in torch: the state can stay on a device between steps.
# --------------------------------------------------------------------------

def torch_cartpole_reset(generator: torch.Generator, batch: int,
                         device=None) -> torch.Tensor:
    """Batched initial states, shape [batch, 4], uniform in [-0.05, 0.05)
    (``jax_cartpole_reset``). ``device`` defaults to ``cuda``; the
    generator must live on it."""
    from ray_tpu_torch import resolve_device
    u = torch.rand((batch, 4), generator=generator,
                   device=resolve_device(device))
    return u * 0.1 - 0.05


def torch_cartpole_step(state: torch.Tensor, action: torch.Tensor):
    """One batched CartPole step as a pure function (``jax_cartpole_step``).

    state [B,4] float32, action [B] integer -> (state', reward [B], done
    [B]), all on ``state``'s device. Auto-reset is the caller's choice
    (mask or re-init from the generator).
    """
    x, x_dot, th, th_dot = state.unbind(1)
    force = torch.where(action == 1, CartPoleEnv.FORCE_MAG,
                        -CartPoleEnv.FORCE_MAG).to(state.dtype)
    costh, sinth = torch.cos(th), torch.sin(th)
    total_mass = CartPoleEnv.CART_MASS + CartPoleEnv.POLE_MASS
    pm_len = CartPoleEnv.POLE_MASS * CartPoleEnv.POLE_HALF_LEN
    temp = (force + pm_len * th_dot ** 2 * sinth) / total_mass
    th_acc = (CartPoleEnv.GRAVITY * sinth - costh * temp) / (
        CartPoleEnv.POLE_HALF_LEN
        * (4.0 / 3.0 - CartPoleEnv.POLE_MASS * costh ** 2 / total_mass))
    x_acc = temp - pm_len * th_acc * costh / total_mass
    tau = CartPoleEnv.TAU
    nxt = torch.stack([x + tau * x_dot, x_dot + tau * x_acc,
                       th + tau * th_dot, th_dot + tau * th_acc], dim=1)
    done = ((nxt[:, 0].abs() > CartPoleEnv.X_LIMIT)
            | (nxt[:, 2].abs() > CartPoleEnv.THETA_LIMIT))
    reward = torch.ones_like(nxt[:, 0])
    return nxt, reward, done


# --------------------------------------------------------------------------
# Registry (reference: ray.tune.registry.register_env)
# --------------------------------------------------------------------------

_ENV_REGISTRY: Dict[str, Callable[[dict], Env]] = {}


def register_env(name: str, maker: Callable[[dict], Env]) -> None:
    _ENV_REGISTRY[name] = maker


def make_env(name_or_maker, config: Optional[dict] = None) -> Env:
    if callable(name_or_maker):
        return name_or_maker(config or {})
    if name_or_maker in _ENV_REGISTRY:
        return _ENV_REGISTRY[name_or_maker](config or {})
    raise KeyError(f"Unknown env {name_or_maker!r}; registered: "
                   f"{sorted(_ENV_REGISTRY)}")


register_env("CartPole-v1", lambda c: CartPoleEnv(c))
register_env("MemoryCue-v0", lambda c: MemoryCueEnv(c))
register_env("Pendulum-v1", lambda c: PendulumEnv(c))
