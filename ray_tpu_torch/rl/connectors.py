"""Agent/action connectors: pluggable obs/action transform pipelines.

Port of ``ray_tpu/rl/connectors.py``, copied (numpy).

Parity with ``rllib/connectors/`` (``connectors/__init__.py:1``,
``agent/obs_preproc.py``, ``action/clip.py`` roles): small composable
transforms that sit between the environment and the policy —
observation preprocessing on the way IN (flatten, running-stat
normalization, frame stacking, clipping) and action postprocessing on
the way OUT (clip/unsquash to the action space). Connectors carry their
own state (e.g. normalization statistics) and serialize with the policy
weights so restored policies see identically-transformed inputs.

Wiring: ``model={"obs_connectors": [...], "action_connectors": [...]}``
on any algorithm config — the RolloutWorker applies them around
``compute_actions``; states ride ``get_weights``/``set_weights``.
Connectors are constructed per worker from (name, kwargs) specs so they
cross process boundaries without pickling live state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.rl.env import Box

_REGISTRY: Dict[str, type] = {}


def register_connector(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def build_connectors(specs: Optional[Sequence]) -> List["Connector"]:
    """specs: list of name | (name, kwargs) | Connector instances."""
    out: List[Connector] = []
    for spec in specs or ():
        if isinstance(spec, Connector):
            out.append(spec)
        elif isinstance(spec, str):
            out.append(_REGISTRY[spec]())
        else:
            name, kwargs = spec
            out.append(_REGISTRY[name](**dict(kwargs)))
    return out


class Connector:
    """One transform. ``__call__`` maps a BATCH (obs [B, ...] or actions
    [B, ...]); ``on_episode_end(env_indices)`` resets per-env state."""

    name = "connector"

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def peek(self, x: np.ndarray) -> np.ndarray:
        """Transform without advancing any internal state (bootstrap
        side-looks). Stateless connectors: same as __call__."""
        return self(x)

    def on_episode_end(self, env_indices) -> None:
        pass

    def state(self) -> Any:
        return None

    def set_state(self, state: Any) -> None:
        pass


@register_connector("flatten_obs")
class FlattenObs(Connector):
    """[B, *dims] -> [B, prod(dims)] (obs_preproc flatten role)."""

    def __call__(self, obs):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


@register_connector("clip_obs")
class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(np.asarray(obs), self.low, self.high)


@register_connector("normalize_obs")
class NormalizeObs(Connector):
    """Running mean/std normalization (MeanStdFilter role). The running
    statistics ARE policy state: they serialize with the weights."""

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self._n = 1e-4
        self._sum: Optional[np.ndarray] = None
        self._sq: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        flat = obs.reshape(obs.shape[0], -1)
        if self._sum is None:
            self._sum = np.zeros(flat.shape[1])
            self._sq = np.zeros(flat.shape[1])
        if self.update:
            self._n += flat.shape[0]
            self._sum += flat.sum(0)
            self._sq += (flat ** 2).sum(0)
        mean = self._sum / self._n
        var = np.maximum(self._sq / self._n - mean ** 2, 1e-8)
        out = (flat - mean) / np.sqrt(var)
        return np.clip(out, -self.clip, self.clip).reshape(
            obs.shape).astype(np.float32)

    def peek(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._sum is None:
            return obs.astype(np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        mean = self._sum / self._n
        var = np.maximum(self._sq / self._n - mean ** 2, 1e-8)
        out = np.clip((flat - mean) / np.sqrt(var), -self.clip, self.clip)
        return out.reshape(obs.shape).astype(np.float32)

    def state(self):
        return (self._n, self._sum, self._sq)

    def set_state(self, state):
        if state is not None:
            self._n, self._sum, self._sq = state


@register_connector("frame_stack")
class FrameStack(Connector):
    """Concatenate the last k observations per sub-env along the feature
    axis (the velocity-from-positions trick; per-env ring buffer reset
    at episode ends)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._buf: Optional[np.ndarray] = None  # [B, k, D]

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self._buf is None or len(self._buf) != len(flat):
            self._buf = np.repeat(flat[:, None], self.k, axis=1)
        else:
            self._buf = np.concatenate(
                [self._buf[:, 1:], flat[:, None]], axis=1)
        return self._buf.reshape(len(flat), -1)

    def peek(self, obs):
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self._buf is None or len(self._buf) != len(flat):
            return np.repeat(flat[:, None], self.k, axis=1).reshape(
                len(flat), -1)
        shifted = np.concatenate([self._buf[:, 1:], flat[:, None]], axis=1)
        return shifted.reshape(len(flat), -1)

    def on_episode_end(self, env_indices):
        if self._buf is not None:
            idx = np.asarray(env_indices, int)
            # next __call__ overwrites all k slots with the reset obs
            self._buf[idx] = 0.0

    def state(self):
        return None  # rollout-transient; fragments replay raw obs


@register_connector("clip_actions")
class ClipActions(Connector):
    """Clip continuous actions into the Box (action/clip.py role)."""

    def __init__(self, low=None, high=None):
        self.low, self.high = low, high

    def bind_space(self, space):
        if isinstance(space, Box) and self.low is None:
            self.low = np.asarray(space.low)
            self.high = np.asarray(space.high)

    def __call__(self, actions):
        if self.low is None:
            return actions
        return np.clip(np.asarray(actions), self.low, self.high)


@register_connector("scale_actions")
class ScaleActions(Connector):
    """Map [-1, 1] policy outputs onto the Box (unsquash role)."""

    def __init__(self):
        self._scale = self._center = None

    def bind_space(self, space):
        if isinstance(space, Box):
            lo = np.asarray(space.low, np.float32)
            hi = np.asarray(space.high, np.float32)
            self._scale = (hi - lo) / 2.0
            self._center = (hi + lo) / 2.0

    def __call__(self, actions):
        if self._scale is None:
            return actions
        return np.asarray(actions) * self._scale + self._center


class ConnectorPipeline(Connector):
    """Ordered composition; state is the tuple of member states."""

    def __init__(self, connectors: Sequence[Connector]):
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def peek(self, x):
        for c in self.connectors:
            x = c.peek(x)
        return x

    def on_episode_end(self, env_indices):
        for c in self.connectors:
            c.on_episode_end(env_indices)

    def bind_space(self, space):
        for c in self.connectors:
            if hasattr(c, "bind_space"):
                c.bind_space(space)

    def state(self) -> Tuple:
        return tuple(c.state() for c in self.connectors)

    def set_state(self, state):
        if state:
            for c, s in zip(self.connectors, state):
                c.set_state(s)
