"""Proximal Policy Optimization.

Port of ``ray_tpu/rl/ppo.py``. Parity with ``rllib/algorithms/ppo/ppo.py``
(training_step :400-470: synchronous sampling -> advantage standardization
-> minibatch SGD -> weight sync -> adaptive KL update) and
``ppo_torch_policy.py`` (clipped surrogate + clipped value loss + entropy
bonus + KL penalty).

The learner holds its parameters and Adam state on one device. Where the
JAX package compiles the whole ``num_sgd_iter`` x minibatch schedule into
one XLA program (``lax.scan`` over epochs and minibatches), here the same
schedule is a loop of eager minibatch steps, entered with one host->device
copy per column of the sample batch and left with one device->host read
of the metrics. Each epoch's permutation comes from a ``torch.Generator``
on the learner's device, seeded ``seed + 7919`` as the JAX key is. The
optimizer is ``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``
written on the tree with optax's arithmetic (``clip_adam_step_``).

On a mesh (``PPOLearner(mesh=)``, ``resources(mesh=)``) the learner is SPMD
in the torch way: every rank of the ``torch.distributed`` world runs the
same algorithm from the same seed, so all hold the same host batch and
draw the same permutations. Parameters and Adam moments are replicated
(the same tensors on every rank); each minibatch's rows are split over the
mesh axes that ``batch_sharding(mesh, ndim=1)`` shards (``("data",
"fsdp")``), each rank's loss is scaled by its share of the rows, and the
gradient and metrics are summed over those axes (one ``all_reduce`` a
minibatch per axis) before the same clip+Adam step everywhere. A
minibatch that does not split evenly still gives the one-device result;
the JAX package's jitted schedule, where XLA inserts the psum, has no
divisibility rule either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        learner_device)
from ray_tpu_torch.rl.postprocessing import standardize
from ray_tpu_torch.rl.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

AUX_KEYS = ("policy_loss", "vf_loss", "entropy", "kl")
_USED = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
         SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 30
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.lambda_ = 0.95
        self.grad_clip = 0.5


def adam_init(params: Any) -> Dict[str, Any]:
    """optax.adam's state on the tree: the step count and two moments."""
    return {"count": 0,
            "mu": _models.tree_map(torch.zeros_like, params),
            "nu": _models.tree_map(torch.zeros_like, params)}


def opt_state_to_numpy(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """A host copy of an optimizer state: the step count (if any) as an
    int, each moment as a numpy tree."""
    return {k: v if k == "count" else _models.to_numpy(v)
            for k, v in opt_state.items()}


def opt_state_from_numpy(opt_state: Dict[str, Any], device) -> Dict[str, Any]:
    """``opt_state_to_numpy``'s inverse, the moments on ``device``."""
    return {k: int(v) if k == "count" else _models.params_from_numpy(
        v, device) for k, v in opt_state.items()}


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are while their
    global norm is below ``max_norm``, else scaled by ``max_norm / norm``
    (not ``clip_grad_norm_``'s ``norm + 1e-6``). New tensors: the caller's
    stay as given."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return torch._foreach_mul(grads, scale)


@torch.no_grad()
def adam_step_(leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               opt_state: Dict[str, Any], lr: float) -> None:
    """One ``optax.adam(lr)`` update, in place on ``leaves`` and
    ``opt_state``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction
    computed in float32 as optax does."""
    grads = list(grads)
    mu = _models.tree_leaves(opt_state["mu"])
    nu = _models.tree_leaves(opt_state["nu"])
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
    count = opt_state["count"] + 1
    opt_state["count"] = count
    one, c = np.float32(1), np.float32(count)
    bc1 = float(one - np.float32(ADAM_B1) ** c)
    bc2 = float(one - np.float32(ADAM_B2) ** c)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(list(leaves), update, alpha=-lr)


@torch.no_grad()
def clip_adam_step_(leaves: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], opt_state: Dict[str, Any],
                    max_norm: float, lr: float) -> None:
    """One ``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` update,
    in place on ``leaves`` and ``opt_state`` (``adam_step_`` on the clipped
    gradients)."""
    adam_step_(leaves, clip_by_global_norm(grads, max_norm), opt_state, lr)


class _RowShare:
    """This rank's part of each minibatch on a mesh: the mesh axes that
    ``batch_sharding(mesh, ndim=1)`` shards the rows over, this rank's
    index among their ``count`` blocks (outermost axis first, as
    ``place_local`` lays them out), and a sum over them."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Shard

        from ray_tpu_torch.parallel.sharding import batch_sharding
        placements = batch_sharding(mesh, ndim=1)
        self.mesh = mesh
        self.axes = [a for a, p in zip(mesh.axis_names, placements)
                     if isinstance(p, Shard) and mesh.shape[a] > 1]
        self.index, self.count = 0, 1
        for a in self.axes:
            self.index = self.index * mesh.shape[a] + mesh.axis_index(a)
            self.count *= mesh.shape[a]

    def rows(self, n: int):
        """This rank's ``[start, stop)`` of ``n`` rows: ``count`` blocks as
        even as they come (``torch.tensor_split``'s), so that an even split
        is ``place_local``'s."""
        q, r = divmod(n, self.count)
        start = self.index * q + min(self.index, r)
        return start, start + q + (self.index < r)

    def sum_(self, flat: torch.Tensor) -> None:
        for a in self.axes:
            dist.all_reduce(flat, group=self.mesh.group(a))


class PPOLearner:
    """The PPO update on one device, or replicated over a mesh's ranks.
    Holds (params, opt_state) there."""

    def __init__(self, init_params, cfg: PPOConfig, continuous: bool,
                 mesh=None, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = learner_device(device, mesh)
        self._share = None if mesh is None else _RowShare(mesh)
        if self._share is not None and not self._share.axes:
            # No batch axis has more than one rank, so no collective runs:
            # the one-device update, not its mesh form over one share.
            self._share = None
        self._continuous = continuous
        self.minibatch = cfg.sgd_minibatch_size   # rows of the batch's dim 0
        self.set_state((init_params, None))
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 7919)

    def _loss(self, kl_coeff, batch):
        dist_in, values = _models.actor_critic_apply(
            self.params, batch[SampleBatch.OBS])
        dist = _models.make_distribution(self.params, dist_in,
                                         self._continuous)
        return _models.ppo_surrogate_loss(dist, values, batch, self.cfg,
                                          kl_coeff)

    def _grads(self, kl_coeff, minibatch, leaves):
        """(gradients, the stacked ``AUX_KEYS``) of one minibatch: of the
        whole of it on one device; on a mesh, of this rank's rows with the
        loss scaled by their share, summed over the batch axes."""
        if self._share is None:
            loss, aux = self._loss(kl_coeff, minibatch)
            grads = torch.autograd.grad(loss, leaves)
            return grads, torch.stack([aux[k].detach() for k in AUX_KEYS])
        mb = minibatch[SampleBatch.OBS].shape[0]
        start, stop = self._share.rows(mb)
        if stop > start:
            loss, aux = self._loss(kl_coeff, {k: v[start:stop] for k, v
                                              in minibatch.items()})
            scale = (stop - start) / mb
            grads = torch.autograd.grad(loss * scale, leaves)
            aux = torch.stack([aux[k].detach() for k in AUX_KEYS]) * scale
        else:   # fewer rows than ranks: this rank adds nothing
            grads = [torch.zeros_like(t) for t in leaves]
            aux = torch.zeros(len(AUX_KEYS), device=self.device)
        flat = torch.cat([g.reshape(-1) for g in grads] + [aux])
        self._share.sum_(flat)
        parts = flat.split([t.numel() for t in leaves] + [len(AUX_KEYS)])
        return ([p.view_as(t) for p, t in zip(parts, leaves)], parts[-1])

    def sgd(self, batch: Dict[str, torch.Tensor], kl_coeff: float,
            perms: Sequence[torch.Tensor]) -> Dict[str, float]:
        """The whole schedule on a batch already on the device: for each
        permutation (one an epoch), the minibatches of ``x[perm][:num_mb *
        mb]`` in order (the remainder is dropped), each one clip+Adam step,
        ``mb`` being ``self.minibatch``. The metrics are the mean over
        every minibatch of every epoch, and ``kl`` the mean of the last
        epoch's (``lax.scan``'s outputs in the JAX package). On a mesh,
        every rank passes the whole batch and the same permutations."""
        mb = self.minibatch
        n = batch[SampleBatch.OBS].shape[0]
        num_mb = max(1, n // mb)
        leaves = _models.tree_leaves(self.params)
        auxs: List[torch.Tensor] = []
        for perm in perms:
            shuffled = {k: v[perm][:num_mb * mb] for k, v in batch.items()}
            for i in range(num_mb):
                minibatch = {k: v[i * mb:(i + 1) * mb]
                             for k, v in shuffled.items()}
                grads, aux = self._grads(kl_coeff, minibatch, leaves)
                clip_adam_step_(leaves, grads, self.opt_state,
                                self.cfg.grad_clip, self.cfg.lr)
                auxs.append(aux)
        stacked = torch.stack(auxs).view(len(perms), num_mb, len(AUX_KEYS))
        last_kl = stacked[-1, :, AUX_KEYS.index("kl")].mean()
        values = torch.cat([stacked.mean(dim=(0, 1)), last_kl[None]]).tolist()
        metrics = dict(zip(AUX_KEYS, values[:-1]))
        metrics["kl"] = values[-1]
        return metrics

    def train(self, batch: SampleBatch, kl_coeff: float) -> Dict[str, float]:
        used = SampleBatch({k: v for k, v in batch.items() if k in _USED})
        arrays = batch_to_device(used, self.device)
        n = arrays[SampleBatch.OBS].shape[0]
        perms = [torch.randperm(n, generator=self.generator,
                                device=self.device)
                 for _ in range(self.cfg.num_sgd_iter)]
        return self.sgd(arrays, kl_coeff, perms)

    def get_weights(self):
        """The parameters as a host numpy tree."""
        return _models.to_numpy(self.params)

    def state(self):
        return self.get_weights(), opt_state_to_numpy(self.opt_state)

    def set_state(self, state):
        params, opt_state = state
        self.params = _models.params_from_numpy(params, self.device)
        for t in _models.tree_leaves(self.params):
            t.requires_grad_(True)
        if opt_state is None:
            self.opt_state = adam_init(self.params)
        else:
            self.opt_state = opt_state_from_numpy(opt_state, self.device)


class PPO(Algorithm):
    _config_cls = PPOConfig

    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig(cls)

    def _make_learner(self) -> PPOLearner:
        cfg = self.algo_config
        lw = self.workers.local_worker
        self.kl_coeff = cfg.kl_coeff
        from ray_tpu_torch.rl.recurrent import (RecurrentPPOLearner,
                                                uses_memory_model)
        if uses_memory_model(cfg.model):
            return RecurrentPPOLearner(lw.get_weights(), cfg,
                                       lw.policy.continuous,
                                       cfg.rollout_fragment_length,
                                       device=self.device)
        return PPOLearner(lw.get_weights(), cfg, lw.policy.continuous,
                          mesh=cfg.mesh, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        self.workers.sync_weights()
        batch = synchronous_parallel_sample(
            self.workers, max_env_steps=cfg.train_batch_size)
        self._timesteps_total += len(batch)
        # Batch-level advantage standardization (ppo.py:415).
        batch[SampleBatch.ADVANTAGES] = standardize(
            batch[SampleBatch.ADVANTAGES])
        # Slice (or pad) to a multiple of the minibatch, as the JAX package
        # does for its one compiled shape. The sequence learner shapes its
        # own batches (slicing here could cut a fragment mid-sequence).
        if not getattr(self.learner, "handles_batch_shaping", False):
            n = (len(batch) // cfg.sgd_minibatch_size
                 ) * cfg.sgd_minibatch_size
            if n == 0:
                batch = batch.pad_to(cfg.sgd_minibatch_size)
            else:
                batch = batch.slice(0, n)
        metrics = self.learner.train(batch, self.kl_coeff)
        # Adaptive KL coefficient (ppo.py:433-437).
        kl = metrics["kl"]
        if kl > 2.0 * cfg.kl_target:
            self.kl_coeff *= 1.5
        elif kl < 0.5 * cfg.kl_target:
            self.kl_coeff *= 0.5
        self.workers.local_worker.set_weights(self.learner.get_weights())
        metrics.update(timesteps_this_iter=len(batch),
                       kl_coeff=self.kl_coeff,
                       learner_params=_models.num_params(self.learner.params))
        return metrics

    def _learner_state(self):
        return {"learner": self.learner.state(), "kl_coeff": self.kl_coeff}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])
            self.kl_coeff = state["kl_coeff"]
