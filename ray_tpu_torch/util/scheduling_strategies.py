"""Scheduling strategies.

Parity with ``python/ray/util/scheduling_strategies.py``: the string
strategies ``"DEFAULT"`` (hybrid pack-then-spread) and ``"SPREAD"``, plus
placement-group and node-affinity strategies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "object"
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str  # hex node id
    soft: bool = False


DEFAULT = "DEFAULT"
SPREAD = "SPREAD"
