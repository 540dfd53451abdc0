"""NCCL collective group: MPI-style group ops over CUDA tensors.

Port of ``ray_tpu/collective/collective_group/xla_group.py``, which
replaces the reference's NCCL group
(``python/ray/util/collective/collective_group/nccl_collective_group.py:127``)
with compiled ``shard_map`` programs. Here the group is NCCL again, in its
single-process, multi-device form (``torch.cuda.nccl``): a group binds its
ranks to CUDA devices, and rendezvous is an in-process barrier (the
reference needs a named-actor NCCLUniqueID store,
``nccl_collective_group.py:54-95``; ranks that are threads of one process
do not).

Ranks are callers (actor/task threads). Each rank deposits its tensor at
the rendezvous; the last arrival runs the op once for the whole group, and
every rank then reads its own result. The folding rule is the JAX
package's (``xla_group.py:244-251``): ranks map to devices round-robin.

- **Distinct devices** (one rank per device): each op is one
  ``torch.cuda.nccl`` call over the list of the ranks' tensors
  (``all_reduce``, ``reduce``, ``broadcast``, ``all_gather``,
  ``reduce_scatter``). Send and recv are peer copies.
- **Folded ranks** (more ranks than devices): one stacked reduction on
  the first rank's device, each rank's result copied to its device.
- **Compressed and hierarchical ops** (``CollectiveConfig``) stay staged
  on the host through ``collective.quantization``, as the JAX package
  stages them.

Each rank gets a result tensor of its own, never an alias of another
rank's: torch tensors are mutable where JAX arrays are not. A reduction
keeps its input's dtype. A rank's tensor must lie on the device the rank
is bound to: a host tensor given to a group on CUDA devices raises (the
``cpu`` backend is the one for host tensors); numpy input is placed on
the rank's device, as ``jnp.asarray`` places it in the JAX package. With
no ``devices=``, a group binds its ranks to this process's CUDA devices
and raises where there are none; ``devices=[torch.device("cpu")]`` asks
for the folded path on the CPU explicitly (the tests do).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.host import from_numpy, to_numpy
from ray_tpu_torch.collective import quantization
from ray_tpu_torch.collective.types import ReduceOp
from ray_tpu_torch.observability import comms, perf

# ncclRedOp_t
_NCCL_OP = {ReduceOp.SUM: 0, ReduceOp.PRODUCT: 1, ReduceOp.MAX: 2,
            ReduceOp.MIN: 3}

_REDUCE_TORCH = {
    ReduceOp.SUM: lambda xs: xs.sum(0),
    ReduceOp.PRODUCT: lambda xs: xs.prod(0),
    ReduceOp.MIN: lambda xs: xs.amin(0),
    ReduceOp.MAX: lambda xs: xs.amax(0),
}

_REDUCE_NP = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
}


def _device(d) -> torch.device:
    """``d`` with its index: ``cuda`` means the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class _Rendezvous:
    """All ranks deposit; last arrival runs ``compute`` once; all collect.

    When the comms plane is on (and the rendezvous belongs to a named
    group — p2p pair rendezvous pass ``label=None`` and stay dark), each
    rank stamps its arrival and deposits its collective fingerprint; the
    last arrival checks the fingerprints (divergence raises into the
    shared outcome, so every rank sees the error instead of computing
    with the wrong op) and records the per-rank arrival-skew
    distribution that lets the doctor name a laggard rank.
    """

    def __init__(self, world_size: int, label: Optional[str] = "default"):
        self.world_size = world_size
        self.label = label
        self.lock = threading.Lock()
        self.slots: Dict[int, Any] = {}
        self.stamps: Dict[int, float] = {}
        self.fps: Dict[int, tuple] = {}
        # Per-generation outcomes so one failed collective doesn't poison the
        # next: outcome[gen] = (result, error). Old generations are pruned.
        self.outcomes: Dict[int, tuple] = {}
        self.generation = 0
        self.cv = threading.Condition(self.lock)

    def run(self, rank: int, value: Any, compute: Callable[[Dict[int, Any]], Any],
            timeout: float = 30.0, fingerprint: Optional[tuple] = None) -> Any:
        # Stamp before taking the lock so lock contention doesn't
        # masquerade as rank arrival skew.
        observed = comms.ENABLED and self.label is not None
        t_arrive = time.monotonic() if observed else 0.0
        stamps = launch_ms = None
        with self.cv:
            gen = self.generation
            self.slots[rank] = value
            if observed:
                self.stamps[rank] = t_arrive
                if fingerprint is not None:
                    self.fps[rank] = fingerprint
            if len(self.slots) == self.world_size:
                stamps, fps = self.stamps, self.fps
                self.stamps, self.fps = {}, {}
                try:
                    if len(fps) == self.world_size:
                        comms.check_fingerprints(fps, group=self.label,
                                                 seq=gen)
                    t_launch = time.monotonic() if observed else 0.0
                    result = compute(dict(self.slots))
                    if observed:
                        launch_ms = (time.monotonic() - t_launch) * 1e3
                    self.outcomes[gen] = (result, None)
                except BaseException as e:  # noqa: BLE001
                    self.outcomes[gen] = (None, e)
                self.slots.clear()
                self.generation += 1
                for old in [g for g in self.outcomes if g < gen - 2]:
                    del self.outcomes[old]
                self.cv.notify_all()
            else:
                if not self.cv.wait_for(lambda: self.generation > gen,
                                        timeout=timeout):
                    self.slots.pop(rank, None)
                    self.stamps.pop(rank, None)
                    self.fps.pop(rank, None)
                    raise TimeoutError(
                        f"collective rendezvous timed out at rank {rank} "
                        f"({len(self.slots)}/{self.world_size} arrived)")
            result, error = self.outcomes[gen]
        # Ledger writes happen OUTSIDE the rendezvous critical section:
        # they take the comms/perf locks, and every microsecond spent
        # holding the condition variable extends the window in which the
        # other ranks stay parked (and, under the GIL, stretches the
        # whole group's op latency).
        if observed and stamps is not None and len(stamps) == self.world_size:
            first = min(stamps.values())
            comms.record_arrivals(
                self.label, {r: t - first for r, t in stamps.items()},
                self.world_size)
        if error is not None:
            raise error
        if observed and perf.ENABLED:
            if launch_ms is not None:
                perf.observe("collective.launch", launch_ms)
            perf.observe("collective.collect",
                         (time.monotonic() - t_arrive) * 1e3)
        return result



class NCCLGroup:
    def __init__(self, world_size: int, rank: int, group_name: str,
                 shared: "NCCLGroupShared", config=None):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.config = config
        self._shared = shared
        #: wire bytes of the last op when compressed (None = wire ==
        #: logical); read back by the collective API's ledger seam
        self._last_wire = None

    # -- ops ------------------------------------------------------------------

    def _hierarchical(self) -> bool:
        cfg = self.config
        return (cfg is not None and cfg.ranks_per_host > 1
                and self.world_size % cfg.ranks_per_host == 0
                and self.world_size != cfg.ranks_per_host)

    def _compressed(self, arr: np.ndarray, kind: str, op: ReduceOp):
        """Quantized allreduce/reducescatter: the payload is compressed at
        the host seam (the compression tier models the expensive
        inter-host hop; the intra-host NCCL calls stay full precision)."""
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
                quantization.QuantFault(e, tuple(arr.shape),
                                        np.dtype(arr.dtype)),
                (kind, op), qmeta=meta, qconfig=cfg)
            raise
        self._last_wire = q.wire_bytes
        return self._shared.collective(self.rank, q, (kind, op),
                                       qmeta=meta, qconfig=cfg)[self.rank]

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        x = self._shared.place(self.rank, tensor)
        arr = host_if_compressed(self.config, x)
        if arr is not None:
            return self._compressed(arr, "allreduce", op)
        return self._shared.collective(self.rank, x,
                                       ("allreduce", op))[self.rank]

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        x = self._shared.place(self.rank, tensor)
        return self._shared.collective(self.rank, x,
                                       ("reduce", op, root_rank))[self.rank]

    def broadcast(self, tensor, root_rank: int = 0):
        self._last_wire = None
        x = self._shared.place(self.rank, tensor)
        return self._shared.collective(self.rank, x,
                                       ("broadcast", root_rank))[self.rank]

    def allgather(self, tensor):
        self._last_wire = None
        x = self._shared.place(self.rank, tensor)
        return self._shared.collective(self.rank, x,
                                       ("allgather",))[self.rank]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        x = self._shared.place(self.rank, tensor)
        arr = host_if_compressed(self.config, x)
        if arr is not None:
            return self._compressed(arr, "reducescatter", op)
        return self._shared.collective(self.rank, x,
                                       ("reducescatter", op))[self.rank]

    def barrier(self):
        self._last_wire = None
        self._shared.collective(self.rank, None, ("barrier",))

    def send(self, tensor, dst_rank: int):
        self._last_wire = None
        self._shared.p2p_send(self.rank, dst_rank,
                              self._shared.place(self.rank, tensor))

    def recv(self, src_rank: int):
        self._last_wire = None
        return self._shared.p2p_recv(self.rank, src_rank)

    def destroy(self):
        pass


class NCCLGroupShared:
    """State shared by all ranks of one group in this process."""

    def __init__(self, world_size: int, devices: Optional[List] = None,
                 label: str = "default"):
        self.world_size = world_size
        self.label = label
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    f"collective group {label!r}: the nccl backend needs a "
                    "CUDA card and this process sees none; use "
                    "backend='cpu' for host tensors")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [_device(d) for d in devices]
        # Fold ranks onto devices round-robin when ranks > devices.
        self.rank_devices = [devs[i % len(devs)] for i in range(world_size)]
        self.distinct = len(set(self.rank_devices)) == world_size
        self._rdv = _Rendezvous(world_size, label=label)
        self._p2p: Dict[tuple, _Rendezvous] = {}
        self._p2p_lock = threading.Lock()

    def place(self, rank: int, tensor) -> torch.Tensor:
        """``tensor`` checked to lie on ``rank``'s device (numpy is placed
        there); never moved from another device."""
        dev = self.rank_devices[rank]
        if not isinstance(tensor, torch.Tensor):
            return from_numpy(tensor, None, dev)
        if tensor.device != dev:
            raise ValueError(
                f"rank {rank} of collective group {self.label!r} is bound "
                f"to {dev}, and its tensor is on {tensor.device}"
                + ("; use backend='cpu' for host tensors"
                   if tensor.device.type == "cpu" else ""))
        return tensor

    def collective(self, rank: int, tensor, op_desc: tuple,
                   qmeta: tuple = ("none", 0),
                   qconfig=None) -> Dict[Any, Any]:
        if tensor is None:                       # barrier
            shape, dtype = (), None
        else:
            shape, dtype = tuple(tensor.shape), tensor.dtype
        # Raw-tuple fingerprint: (op_desc, shape, dtype) compares by
        # value; stringifying enum/dtype per op costs more than the rest
        # of the ledger combined, so it only happens in the divergence
        # error message. The trailing (scheme, block_elems) pair makes
        # mixed-compression ranks diverge loudly instead of mixing
        # payload types.
        fp = ((op_desc, shape, dtype) + tuple(qmeta)) \
            if comms.ENABLED else None

        def compute(slots: Dict[int, Any]) -> Dict[Any, Any]:
            for v in slots.values():
                if isinstance(v, quantization.QuantFault):
                    raise v.error
            if "hier" in op_desc or isinstance(
                    slots[0], quantization.Quantized):
                return self._run_quantized_op(slots, op_desc, qconfig)
            return self._run_group_op(slots, op_desc)

        return self._rdv.run(rank, tensor, compute, fingerprint=fp)

    def _run_quantized_op(self, slots: Dict[int, Any], op_desc: tuple,
                          qconfig) -> Dict[Any, Any]:
        """Compressed allreduce/reducescatter, staged on the host: the
        dequant-fused reduction happens at f32 in the quant kernels, and
        each rank gets its result as a new tensor on its device."""
        kind = op_desc[0]
        op = op_desc[1]
        reduce_np = None if op == ReduceOp.SUM else _REDUCE_NP[op]
        vals = [slots[r] for r in range(self.world_size)]
        if "hier" in op_desc:
            red, wire = quantization.hierarchical_allreduce(
                vals, qconfig, reduce_np,
                group=self.label or "default", op_name=kind)
            out: Dict[Any, Any] = self._each(red)
            out["wire"] = wire
            return out
        red = quantization.reduce_quantized(vals, reduce_np)
        if kind == "allreduce":
            return self._each(red)
        chunks = np.split(red, self.world_size, axis=0)
        return {r: from_numpy(chunks[r], None, self.rank_devices[r])
                for r in range(self.world_size)}

    def _each(self, host: np.ndarray) -> Dict[Any, Any]:
        return {r: from_numpy(host, None, self.rank_devices[r])
                for r in range(self.world_size)}

    # -- one op for the whole group -------------------------------------------

    def _run_group_op(self, slots: Dict[int, Any],
                      op_desc: tuple) -> Dict[int, Any]:
        kind = op_desc[0]
        if kind == "barrier":
            return {r: None for r in range(self.world_size)}
        xs = [slots[r].contiguous() for r in range(self.world_size)]
        if self.distinct and self.rank_devices[0].type == "cuda":
            # raylint: allow(collective-divergence) one thread runs the op for every rank of the in-process group: the branch picks the whole group's backend
            return self._run_nccl_op(xs, op_desc)
        return self._run_folded_op(xs, op_desc)

    def _run_nccl_op(self, xs: List[torch.Tensor],
                     op_desc: tuple) -> Dict[int, Any]:
        """One ``torch.cuda.nccl`` call over the ranks' tensors, one per
        device, each output a new tensor on its rank's device."""
        import torch.cuda.nccl as nccl
        kind = op_desc[0]
        world = self.world_size
        if kind == "allreduce":
            outs = [torch.empty_like(x) for x in xs]
            nccl.all_reduce(xs, outs, op=_NCCL_OP[op_desc[1]])
        elif kind == "reduce":
            root = op_desc[2]
            out = torch.empty_like(xs[root])
            nccl.reduce(xs, out, root=root, op=_NCCL_OP[op_desc[1]])
            # non-roots get their input back (reference reduce semantics:
            # only root receives the reduction)
            outs = [out if r == root else xs[r] for r in range(world)]
        elif kind == "broadcast":
            root = op_desc[1]
            outs = [x.clone() if r == root else torch.empty_like(x)
                    for r, x in enumerate(xs)]
            # torch.cuda.nccl.broadcast sends from the first tensor of its
            # list, whatever its root argument says: put the root first
            nccl.broadcast([outs[root]] + [o for r, o in enumerate(outs)
                                           if r != root])
        elif kind == "allgather":
            outs = [x.new_empty((world,) + tuple(x.shape)) for x in xs]
            nccl.all_gather(xs, outs)
        elif kind == "reducescatter":
            chunk = _scatter_rows(xs[0], world)
            outs = [x.new_empty((chunk,) + tuple(x.shape[1:])) for x in xs]
            nccl.reduce_scatter(xs, outs, op=_NCCL_OP[op_desc[1]])
        else:
            raise ValueError(kind)
        return dict(enumerate(outs))

    def _run_folded_op(self, xs: List[torch.Tensor],
                       op_desc: tuple) -> Dict[int, Any]:
        """Ranks folded onto fewer devices: a single stacked reduction on
        the first rank's device; rank 0 keeps the result, every other rank
        gets its own copy on its device."""
        kind = op_desc[0]
        dtype = xs[0].dtype
        home = xs[0].device
        if kind == "broadcast":
            src = xs[op_desc[1]]
            return {r: src.to(d, copy=True)
                    for r, d in enumerate(self.rank_devices)}
        stacked = torch.stack([x.to(home) for x in xs])
        if kind == "allgather":
            return self._spread(stacked)
        # sum/prod widen integers and bools; the result keeps the dtype
        red = _REDUCE_TORCH[op_desc[1]](stacked).to(dtype)
        if kind == "allreduce":
            return self._spread(red)
        if kind == "reduce":
            root = op_desc[2]
            return {r: (red.to(self.rank_devices[r]) if r == root else xs[r])
                    for r in range(self.world_size)}
        if kind == "reducescatter":
            chunk = _scatter_rows(red, self.world_size)
            return {r: red[r * chunk:(r + 1) * chunk].to(d, copy=True)
                    for r, d in enumerate(self.rank_devices)}
        raise ValueError(kind)

    def _spread(self, t: torch.Tensor) -> Dict[int, Any]:
        return {r: (t if r == 0 else t.to(d, copy=True))
                for r, d in enumerate(self.rank_devices)}

    # -- point to point -------------------------------------------------------

    def _pair_rdv(self, src: int, dst: int) -> _Rendezvous:
        with self._p2p_lock:
            key = (src, dst)
            rdv = self._p2p.get(key)
            if rdv is None:
                # label=None: pair rendezvous carry asymmetric values by
                # design, so no fingerprint check and no skew attribution.
                rdv = _Rendezvous(2, label=None)
                self._p2p[key] = rdv
            return rdv

    def _p2p_transfer(self, dst: int, tensor: torch.Tensor) -> torch.Tensor:
        """A copy of ``tensor`` on ``dst``'s device: a peer copy between
        distinct cards, a device copy for folded ranks."""
        return tensor.to(self.rank_devices[dst], copy=True)

    def p2p_send(self, rank: int, dst_rank: int, tensor):
        rdv = self._pair_rdv(rank, dst_rank)
        rdv.run(rank, tensor,
                lambda slots: self._p2p_transfer(dst_rank, slots[rank]))

    def p2p_recv(self, rank: int, src_rank: int):
        rdv = self._pair_rdv(src_rank, rank)
        return rdv.run(rank, None,
                       lambda slots: self._p2p_transfer(rank,
                                                        slots[src_rank]))


def host_if_compressed(config, x: torch.Tensor) -> Optional[np.ndarray]:
    """The host copy of ``x`` when a group with ``config`` compresses it,
    else None (the JAX package's ``quantization.active`` on
    ``np.asarray``)."""
    if config is None or getattr(config, "compression", "none") == "none":
        return None
    arr = to_numpy(x)
    return arr if quantization.active(config, arr) else None


def _scatter_rows(t: torch.Tensor, world: int) -> int:
    """Rows of each rank's reduce-scatter chunk; the split must be even
    (``np.split``'s rule in the JAX package)."""
    if t.dim() == 0 or t.shape[0] % world:
        raise ValueError(f"reducescatter of shape {tuple(t.shape)} does not "
                         f"split evenly over {world} ranks")
    return t.shape[0] // world
