"""Experience replay.

Port of ``ray_tpu/rl/replay_buffer.py``, copied (numpy).

Parity with ``rllib/utils/replay_buffers/`` (``ReplayBuffer``,
``PrioritizedReplayBuffer`` with sum-tree sampling) in columnar numpy form:
storage is preallocated ring arrays per column, so sampling a training
batch is one fancy-index per column — no per-timestep Python objects.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring buffer over SampleBatch columns."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        if n > self.capacity:
            batch = batch.slice(n - self.capacity, n)
            n = self.capacity
        end = self._next + n
        for k, v in batch.items():
            if end <= self.capacity:
                self._cols[k][self._next:end] = v
            else:
                split = self.capacity - self._next
                self._cols[k][self._next:] = v[:split]
                self._cols[k][:end - self.capacity] = v[split:]
        self._next = end % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class SumTree:
    """Binary indexed sum tree for O(log n) prefix-sum sampling."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity, np.float64)

    def set(self, idx: np.ndarray, value: np.ndarray) -> None:
        idx = np.atleast_1d(np.asarray(idx)) + self.capacity
        value = np.atleast_1d(np.asarray(value, np.float64))
        for i, v in zip(idx, value):
            delta = v - self.tree[i]
            while i >= 1:
                self.tree[i] += delta
                i //= 2

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx) + self.capacity]

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def find_prefix(self, prefix: np.ndarray) -> np.ndarray:
        """For each prefix sum, the leaf index where it lands."""
        prefix = np.asarray(prefix, np.float64).copy()
        out = np.zeros(len(prefix), np.int64)
        for j in range(len(prefix)):
            i = 1
            p = prefix[j]
            while i < self.capacity:
                left = 2 * i
                if p <= self.tree[left]:
                    i = left
                else:
                    p -= self.tree[left]
                    i = left + 1
            out[j] = i - self.capacity
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """PER (Schaul et al.): P(i) ∝ p_i^alpha, IS weights w_i via beta."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._tree = SumTree(capacity)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = min(len(batch), self.capacity)
        if n == 0:
            return
        start = self._next
        super().add(batch)
        idx = (start + np.arange(n)) % self.capacity
        self._tree.set(idx, np.full(n, self._max_priority ** self.alpha))

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        total = self._tree.total
        prefixes = self._rng.uniform(0, total, num_items)
        idx = self._tree.find_prefix(prefixes)
        idx = np.minimum(idx, self._size - 1)
        probs = self._tree.get(idx) / total
        weights = (self._size * probs) ** (-beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._max_priority = max(self._max_priority, float(priorities.max()))
        self._tree.set(idx, priorities ** self.alpha)
