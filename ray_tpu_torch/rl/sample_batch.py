"""Columnar trajectory batches.

Parity with ``rllib/policy/sample_batch.py`` (``SampleBatch``): a dict of
equal-length numpy columns with concat/slice/shuffle/minibatch operations.
Port of ``ray_tpu/rl/sample_batch.py``, copied but for ``batch_to_device``.
Kept as host numpy — batches are assembled on CPU rollout actors and only
cross to the learner's device once, one pinned copy per column.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


class SampleBatch(dict):
    OBS = "obs"
    NEXT_OBS = "new_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    EPS_ID = "eps_id"
    ACTION_LOGP = "action_logp"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: Optional[np.random.Generator] = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        for s in range(0, n - size + 1, size):
            yield self.slice(s, s + size)

    def split_by_episode(self) -> List["SampleBatch"]:
        if self.EPS_ID not in self:
            return [self]
        ids = self[self.EPS_ID]
        out = []
        start = 0
        for i in range(1, len(ids) + 1):
            if i == len(ids) or ids[i] != ids[start]:
                out.append(self.slice(start, i))
                start = i
        return out

    def pad_to(self, n: int) -> "SampleBatch":
        """Zero-pad every column to length ``n`` (a multiple of the
        minibatch)."""
        cur = len(self)
        if cur >= n:
            return self
        pad = n - cur
        return SampleBatch({
            k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in self.items()})

    def copy(self) -> "SampleBatch":
        return SampleBatch({k: v.copy() for k, v in self.items()})


def concat_samples(batches: List[SampleBatch]) -> SampleBatch:
    """Reference: ``rllib/policy/sample_batch.py`` ``concat_samples``."""
    batches = [b for b in batches if b is not None and len(b) > 0]
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch({
        k: np.concatenate([b[k] for b in batches]) for k in keys})


def batch_to_device(batch: SampleBatch, device,
                    sharding=None) -> Dict[str, torch.Tensor]:
    """The whole batch on ``device``: one host->device copy per column,
    from pinned memory when the device is a card. Float64 columns become
    float32 on the host first, as under JAX's default (no x64); integer
    columns keep their width.

    ``sharding``: a ``(mesh, placements)`` pair (the convention of
    ``data.Dataset.iter_device_batches``), e.g. ``(mesh,
    batch_sharding(mesh, ndim=1))``. Every rank holds the whole host batch
    (an SPMD program from one seed), and each column becomes this rank's
    ``DTensor`` of it (``parallel.sharding.place_local``): the rows split
    evenly over the sharded mesh axes, or it raises. The mesh must live on
    ``device``'s type."""
    device = torch.device(device)
    mesh, placements = sharding if sharding is not None else (None, None)
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the batch "
                             f"on {device}")
        from ray_tpu_torch.parallel.sharding import place_local
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        elif device != t.device:
            t = t.to(device)
        out[k] = t if mesh is None else place_local(t, mesh, placements)
    return out
