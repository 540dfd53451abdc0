"""CPU (numpy) collective group — the GLOO-role backend.

Port of ``ray_tpu/collective/collective_group/cpu_group.py`` (parity with
``python/ray/util/collective/collective_group/gloo_collective_group.py:184``):
host-tensor collectives for CPU-only actors and tests, sharing the same
rendezvous machinery as the NCCL group but computing with numpy.

Numpy inputs give numpy outputs, exactly as the JAX package's group
returns them. A ``torch.Tensor`` crosses to numpy on the host (bf16 as
``ml_dtypes.bfloat16``, as the JAX package's ``np.asarray`` gives it),
and its result comes back as a new tensor of the input's dtype on the
input's device, one per rank.

Compression tier (``CollectiveConfig(compression="q8"|"fp8")``): ranks
quantize their allreduce/reducescatter payloads block-wise before the
deposit; the last arrival widens them back to f32 *inside* the reduction
(``quantization.reduce_quantized``), so accumulation is always full
precision. With ``ranks_per_host`` the allreduce becomes two-level:
intra-host spans reduce at full precision and only the per-host partials
move quantized. The (scheme, block) pair rides every rank's rendezvous
fingerprint — mixed q8/f32 ranks raise
:class:`~ray_tpu_torch.observability.comms.CollectiveDivergenceError` instead
of corrupting the sum with a half-quantized accumulate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.collective import quantization
import torch

from ray_tpu_torch._private.host import from_numpy, to_numpy
from ray_tpu_torch.collective.collective_group.nccl_group import _Rendezvous
from ray_tpu_torch.collective.types import ReduceOp
from ray_tpu_torch.observability import comms

_NP_REDUCE = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
}


def _reduce_np_for(op: ReduceOp):
    """SUM takes the fused dequant+accumulate path (None); the rest widen
    each payload before reducing."""
    return None if op == ReduceOp.SUM else _NP_REDUCE[op]


def _host(tensor):
    """(this rank's value for the numpy path, the function that gives its
    result back in the caller's type)."""
    if not isinstance(tensor, torch.Tensor):
        return tensor, lambda r: r
    dtype, device = tensor.dtype, tensor.device
    return to_numpy(tensor), lambda r: from_numpy(r, dtype, device)


class CPUGroupShared:
    def __init__(self, world_size: int, devices: Optional[List] = None,
                 label: str = "default"):
        self.world_size = world_size
        self.label = label
        # Shared rendezvous = same comms instrumentation as the NCCL
        # group: arrival stamps, fingerprint check, launch/collect phases.
        self._rdv = _Rendezvous(world_size, label=label)
        self._p2p: Dict[tuple, _Rendezvous] = {}
        import threading
        self._p2p_lock = threading.Lock()

    def collective(self, rank: int, value, op_desc: tuple,
                   qmeta: tuple = ("none", 0),
                   qconfig=None) -> Dict[Any, Any]:
        if isinstance(value, (quantization.Quantized,
                              quantization.QuantFault)):
            shape, dtype = value.shape, value.dtype
        else:
            value = np.asarray(value)
            shape, dtype = tuple(value.shape), value.dtype
        # Raw-tuple fingerprint — see NCCLGroupShared.collective: equality
        # is what the divergence check needs, and per-op stringification
        # is the single biggest avoidable ledger cost. The trailing
        # (scheme, block_elems) pair is the compression identity.
        fp = ((op_desc, shape, dtype) + tuple(qmeta)) \
            if comms.ENABLED else None

        def compute(slots):
            kind = op_desc[0]
            vals = [slots[r] for r in range(self.world_size)]
            for v in vals:
                if isinstance(v, quantization.QuantFault):
                    raise v.error
            if "hier" in op_desc:
                red, wire = quantization.hierarchical_allreduce(
                    vals, qconfig, _reduce_np_for(op_desc[1]),
                    group=self.label or "default", op_name=kind)
                out: Dict[Any, Any] = {r: red
                                       for r in range(self.world_size)}
                out["wire"] = wire
                return out
            if isinstance(vals[0], quantization.Quantized):
                red = quantization.reduce_quantized(
                    vals, _reduce_np_for(op_desc[1]))
                if kind == "allreduce":
                    return {r: red for r in range(self.world_size)}
                chunks = np.split(red, self.world_size, axis=0)
                return {r: chunks[r] for r in range(self.world_size)}
            xs = np.stack([np.asarray(slots[r])
                           for r in range(self.world_size)])
            if kind == "barrier":
                return {r: None for r in range(self.world_size)}
            if kind == "broadcast":
                return {r: xs[op_desc[1]] for r in range(self.world_size)}
            if kind == "allreduce":
                red = _NP_REDUCE[op_desc[1]](xs)
                return {r: red for r in range(self.world_size)}
            if kind == "reduce":
                red = _NP_REDUCE[op_desc[1]](xs)
                return {r: (red if r == op_desc[2] else xs[r])
                        for r in range(self.world_size)}
            if kind == "allgather":
                return {r: xs for r in range(self.world_size)}
            if kind == "reducescatter":
                red = _NP_REDUCE[op_desc[1]](xs)
                chunks = np.split(red, self.world_size, axis=0)
                return {r: chunks[r] for r in range(self.world_size)}
            raise ValueError(kind)

        return self._rdv.run(rank, value, compute, fingerprint=fp)

    def _pair_rdv(self, src: int, dst: int) -> _Rendezvous:
        with self._p2p_lock:
            key = (src, dst)
            if key not in self._p2p:
                # label=None: no fingerprint/skew on asymmetric p2p pairs.
                self._p2p[key] = _Rendezvous(2, label=None)
            return self._p2p[key]

    def p2p_send(self, rank: int, dst_rank: int, tensor):
        rdv = self._pair_rdv(rank, dst_rank)
        if not isinstance(tensor, torch.Tensor):
            tensor = np.asarray(tensor)
        rdv.run(rank, tensor, lambda slots: slots[rank])

    def p2p_recv(self, rank: int, src_rank: int):
        rdv = self._pair_rdv(src_rank, rank)
        return rdv.run(rank, None, lambda slots: slots[src_rank])


class CPUGroup:
    def __init__(self, world_size: int, rank: int, group_name: str,
                 shared: CPUGroupShared, config=None):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.config = config
        self._shared = shared
        #: wire bytes of the last op when compressed (None = wire ==
        #: logical); the collective API seam feeds it to the comms ledger
        self._last_wire = None

    def _hierarchical(self) -> bool:
        cfg = self.config
        return (cfg is not None and cfg.ranks_per_host > 1
                and self.world_size % cfg.ranks_per_host == 0
                and self.world_size != cfg.ranks_per_host)

    def _compressed(self, arr: np.ndarray, kind: str, op: ReduceOp):
        """Quantized allreduce/reducescatter; returns this rank's result."""
        cfg = self.config
        meta = quantization.qmeta(cfg, arr)
        if kind == "allreduce" and self._hierarchical():
            res = self._shared.collective(
                self.rank, arr, (kind, op, "hier", cfg.ranks_per_host),
                qmeta=meta, qconfig=cfg)
            self._last_wire = res.get("wire")
            return res[self.rank]
        try:
            q = quantization.quantize(arr, cfg, group=self.group_name,
                                      op=kind, rank=self.rank)
        except Exception as e:
            # Still arrive at the rendezvous: the fault sentinel makes the
            # shared compute raise this error for EVERY rank (fail loudly)
            # instead of stranding the peers until their timeout.
            self._shared.collective(
                self.rank,
                quantization.QuantFault(e, tuple(arr.shape), arr.dtype),
                (kind, op), qmeta=meta, qconfig=cfg)
            raise
        self._last_wire = q.wire_bytes
        return self._shared.collective(self.rank, q, (kind, op),
                                       qmeta=meta, qconfig=cfg)[self.rank]

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        arr, back = _host(tensor)
        arr = np.asarray(arr)
        if quantization.active(self.config, arr):
            return back(self._compressed(arr, "allreduce", op))
        return back(self._shared.collective(self.rank, arr,
                                            ("allreduce", op))[self.rank])

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        arr, back = _host(tensor)
        return back(self._shared.collective(
            self.rank, arr, ("reduce", op, root_rank))[self.rank])

    def broadcast(self, tensor, root_rank: int = 0):
        self._last_wire = None
        arr, back = _host(tensor)
        return back(self._shared.collective(
            self.rank, arr, ("broadcast", root_rank))[self.rank])

    def allgather(self, tensor):
        self._last_wire = None
        arr, back = _host(tensor)
        return back(self._shared.collective(self.rank, arr,
                                            ("allgather",))[self.rank])

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        arr, back = _host(tensor)
        arr = np.asarray(arr)
        if quantization.active(self.config, arr):
            return back(self._compressed(arr, "reducescatter", op))
        return back(self._shared.collective(self.rank, arr,
                                            ("reducescatter", op))[self.rank])

    def barrier(self):
        self._last_wire = None
        self._shared.collective(self.rank, np.zeros(()), ("barrier",))

    def send(self, tensor, dst_rank: int):
        self._last_wire = None
        if isinstance(tensor, torch.Tensor):
            # the receiver owns what it gets: the sender may write on
            tensor = tensor.detach().clone()
        self._shared.p2p_send(self.rank, dst_rank, tensor)

    def recv(self, src_rank: int):
        self._last_wire = None
        return self._shared.p2p_recv(self.rank, src_rank)

    def destroy(self):
        pass
