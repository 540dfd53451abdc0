"""Collective types and options.

Port of ``ray_tpu/collective/types.py`` (parity with
``python/ray/util/collective/types.py``): ``Backend`` and ``ReduceOp``
enums plus per-op options dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List


class Backend:
    """Collective backend names. The reference supports NCCL/GLOO and rejects
    MPI (``collective.py:59-60``); here ``nccl`` is real NCCL over CUDA
    tensors (``torch.cuda.nccl``) and ``cpu`` computes with numpy on host
    tensors. The JAX package's ``xla`` name is an alias of ``nccl`` and
    ``gloo`` one of ``cpu``, so code written for either package runs."""

    NCCL = "nccl"
    CPU = "cpu"

    _ALIASES = {"nccl": NCCL, "xla": NCCL, "gloo": CPU, "cpu": CPU}

    def __new__(cls, name: str = "nccl"):
        backend = cls._ALIASES.get(str(name).lower())
        if backend is None:
            if str(name).lower() == "mpi":
                raise ValueError("MPI backend is not supported")
            raise ValueError(f"unknown collective backend {name!r}; "
                             f"use 'nccl' or 'cpu'")
        return backend


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3


@dataclass(frozen=True)
class CollectiveConfig:
    """Per-group collective tuning, fixed at group creation.

    ``compression`` selects the wire scheme for allreduce/reducescatter
    payloads: ``"q8"`` (block-wise symmetric int8), ``"fp8"``
    (float8_e4m3fn blocks) or ``"none"``. ``quant_block_bytes`` is the
    *input* bytes per scale block — smaller blocks track local dynamic
    range tighter at more scale overhead (at 256 an f32 tensor ships at
    ~0.27x wire). ``ranks_per_host`` > 1 turns on the two-level
    hierarchical decomposition: contiguous rank spans of that size form
    a "host" whose intra-host reduction runs at full precision (the
    in-process hop), and only the per-host partials cross the
    expensive inter-host seam quantized.

    The (scheme, block) pair is folded into every rank's collective
    fingerprint, so ranks joining one group with different configs fail
    with :class:`~ray_tpu_torch.observability.comms.CollectiveDivergenceError`
    instead of corrupting the reduction.
    """

    compression: str = "none"
    quant_block_bytes: int = 256
    ranks_per_host: int = 0

    def __post_init__(self):
        if self.compression not in ("none", "q8", "fp8"):
            raise ValueError(
                f"compression must be 'none', 'q8' or 'fp8', got "
                f"{self.compression!r}")
        if self.quant_block_bytes < 16:
            raise ValueError(
                f"quant_block_bytes must be >= 16 (one f32 scale per "
                f"block caps useful overhead), got {self.quant_block_bytes}")
        if self.ranks_per_host < 0:
            raise ValueError(
                f"ranks_per_host must be >= 0, got {self.ranks_per_host}")


unset_timeout_ms = 30000


@dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = unset_timeout_ms


@dataclass
class BarrierOptions:
    timeout_ms: int = unset_timeout_ms


@dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = unset_timeout_ms


@dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = unset_timeout_ms


@dataclass
class AllGatherOptions:
    timeout_ms: int = unset_timeout_ms


@dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = unset_timeout_ms


@dataclass
class SendOptions:
    dst_rank: int = 0
    timeout_ms: int = unset_timeout_ms


@dataclass
class RecvOptions:
    src_rank: int = 0
    timeout_ms: int = unset_timeout_ms
