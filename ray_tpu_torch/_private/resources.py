"""Cluster resource model with fixed-point arithmetic.

Parity with the reference's resource request/instance model
(``src/ray/raylet/scheduling/fixed_point.h``, ``cluster_resource_data.h``):
resource quantities are fixed-point (1e-4 granularity) so fractional CPUs/TPUs
never accumulate float drift. TPU is a first-class resource here (the
reference only knows NVIDIA GPUs — ``resource_spec.py:273-310``), including
per-topology labels like ``tpu-v5e-8`` usable as custom resources.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

RESOLUTION = 10000  # 1e-4 granularity, matching FixedPoint in the reference

CPU = "CPU"
TPU = "TPU"
GPU = "GPU"  # accepted for API compat; maps onto accelerator slots
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

PREDEFINED = (CPU, TPU, GPU, MEMORY, OBJECT_STORE_MEMORY)


def _fp(value: float) -> int:
    return round(value * RESOLUTION)


def _unfp(value: int) -> float:
    return value / RESOLUTION


class ResourceSet:
    """A bag of named resource quantities (fixed-point internally)."""

    __slots__ = ("_amounts",)

    def __init__(self, amounts: Optional[Dict[str, float]] = None):
        self._amounts: Dict[str, int] = {}
        if amounts:
            for name, qty in amounts.items():
                q = _fp(qty)
                if q < 0:
                    raise ValueError(f"negative resource {name}={qty}")
                if q > 0:
                    self._amounts[name] = q

    @classmethod
    def _from_fp(cls, amounts: Dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._amounts = {k: v for k, v in amounts.items() if v > 0}
        return rs

    def get(self, name: str) -> float:
        return _unfp(self._amounts.get(name, 0))

    def names(self) -> Iterable[str]:
        return self._amounts.keys()

    def is_empty(self) -> bool:
        return not self._amounts

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._amounts.get(k, 0) >= v for k, v in self._amounts.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet._from_fp(out)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            nv = out.get(k, 0) - v
            if nv < 0:
                raise ValueError(f"resource {k} would go negative")
            out[k] = nv
        return ResourceSet._from_fp(out)

    def to_dict(self) -> Dict[str, float]:
        return {k: _unfp(v) for k, v in self._amounts.items()}

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._amounts == other._amounts

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


def resources_from_options(
    num_cpus: Optional[float] = None,
    num_tpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    default_cpus: float = 1.0,
) -> ResourceSet:
    """Build a task/actor resource request from user options."""
    amounts: Dict[str, float] = {}
    amounts[CPU] = default_cpus if num_cpus is None else num_cpus
    if num_tpus:
        amounts[TPU] = num_tpus
    if num_gpus:
        amounts[GPU] = num_gpus
    if memory:
        amounts[MEMORY] = memory
    if resources:
        for k, v in resources.items():
            if k in (CPU, TPU, GPU):
                raise ValueError(
                    f"Use num_cpus/num_tpus/num_gpus instead of resources[{k!r}]")
            amounts[k] = v
    return ResourceSet(amounts)


class NodeResources:
    """Total + available resources of one node, with instance accounting."""

    def __init__(self, total: ResourceSet):
        self.total = total
        self.available = ResourceSet._from_fp(dict(total._amounts))

    def can_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.available)

    def could_ever_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.total)

    def allocate(self, request: ResourceSet):
        self.available = self.available.subtract(request)

    def release(self, request: ResourceSet):
        self.available = self.available.add(request)
        # Guard against double-release pushing past total.
        for k, v in self.available._amounts.items():
            cap = self.total._amounts.get(k, 0)
            if v > cap:
                self.available._amounts[k] = cap

    def utilization(self) -> float:
        """Max utilization across requested dimensions, for hybrid scheduling."""
        best = 0.0
        for k, tot in self.total._amounts.items():
            if tot <= 0:
                continue
            used = tot - self.available._amounts.get(k, 0)
            best = max(best, used / tot)
        return best
