"""User-facing scheduling strategy objects.

Reference: python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy,
NodeLabelSchedulingStrategy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Dict[str, Any] = field(default_factory=dict)
    soft: Dict[str, Any] = field(default_factory=dict)
