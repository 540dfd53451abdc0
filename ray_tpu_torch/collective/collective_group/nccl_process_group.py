"""Cross-process collective group: ranks are daemon processes.

Port of ``ray_tpu/collective/collective_group/xla_process_group.py``, as
``nccl_group.py`` ports ``xla_group.py``. It is the NCCL-communicator group
for ranks that live in DIFFERENT OS processes (on hardware: different
cards or hosts), the reference's
``python/ray/util/collective/collective_group/nccl_collective_group.py:127``.
Ranks join the process-wide ``torch.distributed`` world through the
state-service KV (``collective/tensor_plane.py``), and every group op is
one ``torch.distributed`` call on that world: NCCL between cards, gloo
between CPU processes. Where the JAX package compiles one program over a
mesh of one lead device per process, torch writes in place, so each op
here works on a copy and returns a new tensor of the input's dtype on the
rank's device (as ``nccl_group.py`` does); numpy input is placed there.

Multi-controller contract: every rank (process) must invoke the same op in
the same order — true of collectives by definition. ``send``/``recv`` are
point-to-point and ride the BULK P2P LANE instead: a direct
daemon-to-daemon ``P2P_DATA`` frame whose tensor bytes ride the RPC raw
lane (gather-write out, recv_into in — zero protobuf copies), delivered
into the receiver's p2p mailbox. A tensor crosses as the host bytes of
its ``uint8`` view with its dtype's name (``"bfloat16"`` for bf16), and
lands on the receiver's device. Ranks publish their RPC address at group
init; when a peer's address is unknown the state-KV path remains as the
small-tensor fallback.
"""

from __future__ import annotations

import json
import logging
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private.host import from_numpy
from ray_tpu_torch.collective import quantization
from ray_tpu_torch.collective.collective_group.nccl_group import (
    host_if_compressed)
from ray_tpu_torch.collective.types import ReduceOp

logger = logging.getLogger("ray_tpu")

P2P_NS = b"tplane-p2p"
COMMS_NS = b"tplane-comms"
QUANT_NS = b"tplane-quant"

_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the numpy-style name the
    ``P2PDataMsg`` carries."""
    return str(dtype).rsplit(".", 1)[-1]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The host bytes of ``t`` as a flat ``uint8`` array (any dtype, bf16
    included: numpy has no bf16, its bytes cross as they are)."""
    flat = t.detach().contiguous().reshape(-1).cpu()
    return flat.view(torch.uint8).numpy()


def _from_bytes(dtype: str, shape, data, device) -> torch.Tensor:
    """The tensor that ``_host_bytes`` sent, on ``device``."""
    raw = np.frombuffer(data, dtype=np.uint8)
    if not raw.flags.writeable:
        raw = raw.copy()
    t = torch.from_numpy(raw).view(getattr(torch, dtype))
    return t.reshape(tuple(shape)).to(device)


class NCCLProcessGroup:
    """Rank-per-process collective group over the active tensor plane."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 num_cpu_devices: Optional[int] = None, epoch: int = 0,
                 runtime=None, config=None):
        from ray_tpu_torch.collective.tensor_plane import init_tensor_plane
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.config = config
        #: wire bytes of the last op when compressed (None = wire ==
        #: logical); read back by the collective API's ledger seam
        self._last_wire = None
        self._q_seq = 0  # quantized-exchange sequence (uniform across ranks)
        plane = init_tensor_plane(group_name, world_size, rank, epoch=epoch,
                                  num_cpu_devices=num_cpu_devices,
                                  runtime=runtime)
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"tensor plane has {dist.get_world_size()} processes, group "
                f"wants {world_size}")
        self.backend = plane["backend"]
        self.device = torch.device(plane["device"])
        self._p2p_seq: Dict[tuple, int] = {}
        # Collective sequence number: uniform across ranks because every
        # rank must issue the same ops in the same order (the contract
        # the comms fingerprint check enforces at runtime).
        self._comms_seq = 0
        self._publish_p2p_addr()  # bulk p2p reachability (best-effort)

    # -- plumbing -------------------------------------------------------------

    def _place(self, tensor) -> torch.Tensor:
        """``tensor`` checked to lie on this rank's device (numpy is placed
        there), contiguous; never moved from another device."""
        if not isinstance(tensor, torch.Tensor):
            return from_numpy(tensor, None, self.device)
        if tensor.device != self.device:
            raise ValueError(
                f"rank {self.rank} of collective group {self.group_name!r} "
                f"is on {self.device}, and its tensor is on {tensor.device}")
        return tensor.contiguous()

    # -- comms plane (fingerprint exchange + arrival skew over the KV) --------

    def _comms_pre(self, op_desc: tuple, x: Optional[torch.Tensor],
                   qmeta: tuple = ("none", 0)) -> Optional[tuple]:
        """Publish this rank's fingerprint + arrival stamp for the next
        collective and cross-check rank 0's before launching. The
        fingerprint is ``comms.fingerprint`` of the in-process group's
        (op_desc, shape, dtype, scheme, block), so a process group and a
        thread group name one op alike. A divergent rank raises
        CollectiveDivergenceError with both fingerprints *pre-launch* —
        the cross-process face of the ``_Rendezvous`` check, where the
        alternative is the whole group hanging inside the backend.
        Waiting for rank 0's key adds no critical-path time: the key lands
        before rank 0 enters the very collective we are about to block on
        anyway."""
        from ray_tpu_torch.observability import comms
        seq = self._comms_seq
        self._comms_seq += 1
        if not comms.ENABLED:
            return None
        from ray_tpu_torch._private import clocksync
        shape, dtype = ((), None) if x is None else (tuple(x.shape), x.dtype)
        fp = comms.fingerprint(op_desc, shape, dtype,
                               scheme=qmeta[0], block=qmeta[1])
        ctx = (seq, time.monotonic())
        try:
            kv = self._kv()
        except RuntimeError:
            return ctx  # no state service: phase timings only
        base = f"{self.group_name}/fp/{seq}"
        # Stamps ride the server timebase so skew compares across hosts.
        rec = json.dumps({"fp": [fp[0], list(fp[1]), fp[2], fp[3], fp[4]],
                          "t": clocksync.to_server_s(time.time())})
        try:
            kv.kv_put(f"{base}/{self.rank}".encode(), rec.encode(),
                      overwrite=True, namespace=COMMS_NS)
        except Exception as e:
            logger.debug("comms fingerprint publish failed: %s", e)
            return ctx
        if self.rank != 0:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                try:
                    raw = kv.kv_get(f"{base}/0".encode(),
                                    namespace=COMMS_NS)
                except Exception:  # raylint: allow(swallow) telemetry degrades, the collective itself must not
                    return ctx
                if raw is not None:
                    other = json.loads(raw.decode())["fp"]
                    theirs = (other[0], tuple(other[1]), other[2],
                              other[3], int(other[4]))
                    comms.check_fingerprints({0: theirs, self.rank: fp},
                                             group=self.group_name, seq=seq)
                    break
                # raylint: allow(bare-retry) deadline-bounded KV poll for a peer's key, not a failure retry: backoff would delay the pre-launch divergence check
                time.sleep(0.005)
        return ctx

    def _comms_post(self, ctx: Optional[tuple]) -> None:
        """Launch-phase timing, plus (rank 0) arrival-skew collection: op
        completion implies every rank launched, which implies every rank
        published its stamp — so all keys are present to read, convert
        to skew-after-first-arrival, record, and delete."""
        if ctx is None:
            return
        from ray_tpu_torch.observability import comms, perf
        if not comms.ENABLED:
            return
        seq, t_launch = ctx
        if perf.ENABLED:
            perf.observe("collective.launch",
                         (time.monotonic() - t_launch) * 1e3)
        if self.rank != 0:
            return
        try:
            kv = self._kv()
        except RuntimeError:
            return
        base = f"{self.group_name}/fp/{seq}"
        stamps: Dict[int, float] = {}
        try:
            for r in range(self.world_size):
                key = f"{base}/{r}".encode()
                raw = kv.kv_get(key, namespace=COMMS_NS)
                if raw is not None:
                    stamps[r] = float(json.loads(raw.decode())["t"])
                kv.kv_del(key, namespace=COMMS_NS)
        except Exception as e:
            logger.debug("comms stamp collect failed: %s", e)
            return
        if len(stamps) == self.world_size:
            first = min(stamps.values())
            comms.record_arrivals(self.group_name,
                                  {r: t - first for r, t in stamps.items()},
                                  self.world_size)

    # -- quantized inter-host exchange (the DCN/TCP seam) ---------------------

    def _quantized_reduce(self, arr: np.ndarray, op: ReduceOp,
                          kind: str) -> np.ndarray:
        """Full reduction over the KV/TCP rendezvous with *quantized*
        payloads — the inter-host hop of the hierarchy. What crosses hosts
        here is the block-quantized tensor plus per-block scales, and the
        accumulate happens at f32 after dequantization.

        Ranks publish ``{group}/q/{seq}/{rank}`` and collect all peers;
        a rank's ``seq-1`` key is deleted only after it has collected
        every peer's ``seq`` key (everyone publishing seq means everyone
        finished seq-1, so the old generation is safe to drop)."""
        from ray_tpu_torch.collective.collective_group.cpu_group import \
            _reduce_np_for
        q = quantization.quantize(arr, self.config, group=self.group_name,
                                  op=kind, rank=self.rank)
        self._last_wire = q.wire_bytes
        kv = self._kv()
        seq = self._q_seq
        self._q_seq += 1
        base = f"{self.group_name}/q/{seq}"
        kv.kv_put(f"{base}/{self.rank}".encode(), pickle.dumps(q),
                  overwrite=True, namespace=QUANT_NS)
        payloads: Dict[int, Any] = {self.rank: q}
        deadline = time.monotonic() + 120.0
        while len(payloads) < self.world_size:
            for r in range(self.world_size):
                if r in payloads:
                    continue
                raw = kv.kv_get(f"{base}/{r}".encode(), namespace=QUANT_NS)
                if raw is not None:
                    payloads[r] = pickle.loads(raw)
            if len(payloads) < self.world_size:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"quantized {kind} rendezvous timed out at rank "
                        f"{self.rank} ({len(payloads)}/{self.world_size} "
                        f"payloads)")
                # raylint: allow(bare-retry) deadline-bounded KV poll for peer payloads, not a failure retry
                time.sleep(0.005)
        if seq > 0:
            try:
                kv.kv_del(f"{self.group_name}/q/{seq - 1}/{self.rank}"
                          .encode(), namespace=QUANT_NS)
            except Exception as e:
                logger.debug("quantized payload cleanup failed: %s", e)
        return quantization.reduce_quantized(
            [payloads[r] for r in range(self.world_size)],
            _reduce_np_for(op))

    # -- ops (every process must call, same order) ---------------------------

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        x = self._place(tensor)
        arr = host_if_compressed(self.config, x)
        if arr is not None:
            ctx = self._comms_pre(("allreduce", op), x,
                                  qmeta=quantization.qmeta(self.config, arr))
            val = from_numpy(self._quantized_reduce(arr, op, "allreduce"),
                             None, self.device)
            self._comms_post(ctx)
            return val
        ctx = self._comms_pre(("allreduce", op), x)
        out = x.clone()
        dist.all_reduce(out, op=_DIST_OP[op])
        self._comms_post(ctx)
        return out

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        self._last_wire = None
        x = self._place(tensor)
        ctx = self._comms_pre(("reduce", op, root_rank), x)
        out = x.clone()
        dist.reduce(out, dst=root_rank, op=_DIST_OP[op])
        self._comms_post(ctx)
        # non-roots get their input back (reference reduce semantics: only
        # root receives the reduction)
        return out if self.rank == root_rank else x

    def broadcast(self, tensor, root_rank: int = 0):
        self._last_wire = None
        x = self._place(tensor)
        ctx = self._comms_pre(("broadcast", root_rank), x)
        out = x.clone()
        dist.broadcast(out, src=root_rank)
        self._comms_post(ctx)
        return out

    def allgather(self, tensor):
        self._last_wire = None
        x = self._place(tensor)
        ctx = self._comms_pre(("allgather",), x)
        outs = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(outs, x)
        self._comms_post(ctx)
        return torch.stack(outs)

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """Each rank contributes a tensor whose leading dim divides into
        ``world_size`` chunks; rank r receives chunk r of the reduction
        (same contract as the in-process groups, test_collective.py:78)."""
        self._last_wire = None
        x = self._place(tensor)
        if x.dim() == 0 or x.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter of shape {tuple(x.shape)} does not split "
                f"evenly over {self.world_size} ranks")
        chunk = x.shape[0] // self.world_size
        rows = slice(self.rank * chunk, (self.rank + 1) * chunk)
        arr = host_if_compressed(self.config, x)
        if arr is not None:
            ctx = self._comms_pre(("reducescatter", op), x,
                                  qmeta=quantization.qmeta(self.config, arr))
            red = self._quantized_reduce(arr, op, "reducescatter")
            val = from_numpy(red[rows], None, self.device)
            self._comms_post(ctx)
            return val
        ctx = self._comms_pre(("reducescatter", op), x)
        if self.backend == "nccl":
            out = x.new_empty((chunk,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, op=_DIST_OP[op])
        else:
            # gloo has no reduce-scatter: reduce whole, keep this rank's rows
            full = x.clone()
            # raylint: allow(collective-divergence) the shape check above is rank-uniform: every rank contributes a tensor of the group's one shape
            dist.all_reduce(full, op=_DIST_OP[op])
            out = full[rows].clone()
        self._comms_post(ctx)
        return out

    def barrier(self):
        self._last_wire = None
        ctx = self._comms_pre(("barrier",), None)
        dist.all_reduce(torch.zeros((), dtype=torch.int32,
                                    device=self.device))
        self._comms_post(ctx)

    # -- p2p over the state KV (control-plane; small tensors) ----------------

    def _kv(self):
        state = getattr(self._runtime(), "state", None)
        if state is None:
            raise RuntimeError("p2p needs the cluster state service")
        return state

    def _runtime(self):
        from ray_tpu_torch._private import worker as _worker
        return _worker.try_global_runtime()

    def _addr_key(self, rank: int) -> bytes:
        return f"{self.group_name}/addr/{rank}".encode()

    def _publish_p2p_addr(self):
        """Make this rank reachable for bulk p2p (idempotent)."""
        addr = getattr(self._runtime(), "address", None)
        if addr:
            try:
                self._kv().kv_put(self._addr_key(self.rank), addr.encode(),
                                  overwrite=True, namespace=P2P_NS)
            except Exception as e:
                logger.debug("p2p address publish failed: %s", e)

    def _peer_addr(self, rank: int) -> Optional[str]:
        try:
            raw = self._kv().kv_get(self._addr_key(rank), namespace=P2P_NS)
            return raw.decode() if raw else None
        except Exception as e:
            logger.debug("peer address lookup failed: %s", e)
            return None

    def send(self, tensor, dst_rank: int):
        self._last_wire = None
        seq = self._p2p_seq.get(("s", dst_rank), 0)
        self._p2p_seq[("s", dst_rank)] = seq + 1
        x = self._place(tensor)
        dtype, shape, data = _dtype_name(x.dtype), list(x.shape), \
            _host_bytes(x)
        rt = self._runtime()
        addr = self._peer_addr(dst_rank)
        if addr and getattr(rt, "pool", None) is not None:
            # Bulk lane: metadata in the envelope, bytes gather-written
            # from the host copy's buffer — no pickle, no KV round-trips.
            from ray_tpu_torch.protocol import pb
            msg = pb.P2PDataMsg(
                group=self.group_name, src_rank=self.rank,
                dst_rank=dst_rank, p2p_seq=seq, dtype=dtype, shape=shape)
            rt.pool.get(addr).call(pb.P2P_DATA, msg.SerializeToString(),
                                   timeout=120, raw=data)
            return
        # Fallback (no RPC address): state-KV path.
        key = f"{self.group_name}/{self.rank}>{dst_rank}/{seq}".encode()
        self._kv().kv_put(key, pickle.dumps((dtype, shape, data.tobytes())),
                          overwrite=True, namespace=P2P_NS)

    def recv(self, src_rank: int, timeout_s: float = 30.0):
        self._last_wire = None
        seq = self._p2p_seq.get(("r", src_rank), 0)
        self._p2p_seq[("r", src_rank)] = seq + 1
        rt = self._runtime()
        kv_key = f"{self.group_name}/{src_rank}>{self.rank}/{seq}".encode()
        deadline = time.monotonic() + timeout_s
        while True:
            if hasattr(rt, "p2p_wait"):
                # Primarily wait on the mailbox (event-driven); probe the
                # KV fallback only at a coarse 1s interval — the sender
                # uses the KV path only when OUR address is unpublished,
                # and a tight kv_get loop would hammer the control plane
                # with no-op RPCs.
                try:
                    dtype, shape, data = rt.p2p_wait(
                        (self.group_name, src_rank, self.rank, seq),
                        timeout_s=1.0)
                    return _from_bytes(dtype, shape, data, self.device)
                except TimeoutError:
                    pass
            raw = self._kv().kv_get(kv_key, namespace=P2P_NS)
            if raw is not None:
                self._kv().kv_del(kv_key, namespace=P2P_NS)
                return _from_bytes(*pickle.loads(raw), self.device)
            if time.monotonic() > deadline:
                raise TimeoutError(f"recv from rank {src_rank} timed out")
            if not hasattr(rt, "p2p_wait"):
                # raylint: allow(bare-retry) deadline-bounded KV poll for a peer's payload, not a failure retry
                time.sleep(0.005)

    def destroy(self):
        # The tensor plane outlives individual groups (other groups and the
        # trainer share it); it is torn down by shutdown_tensor_plane() or
        # superseded when a new epoch re-forms. Only this rank's p2p
        # address leaves the KV.
        try:
            self._kv().kv_del(self._addr_key(self.rank), namespace=P2P_NS)
        except Exception as e:
            logger.debug("p2p address cleanup failed: %s", e)
