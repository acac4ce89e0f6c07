"""Task/actor specifications.

Reference: TaskSpecification (src/ray/common/task/task_spec.h) — the
immutable description a submitter hands the scheduler. SchedulingClass here
is the canonicalized resource demand + strategy, the same equivalence class
the reference uses to reuse worker leases
(src/ray/core_worker/transport/normal_task_submitter.cc).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def new_id(prefix: str) -> str:
    return f"{prefix}-{os.urandom(8).hex()}"


@dataclass
class SchedulingStrategy:
    """User-facing scheduling strategies (reference:
    python/ray/util/scheduling_strategies.py)."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP | NODE_LABEL
    node_id: Optional[str] = None
    soft: bool = False
    placement_group_id: Optional[str] = None
    bundle_index: int = -1
    # NODE_LABEL: {label_key: [allowed values]}; hard filters, soft prefers
    labels_hard: Optional[Dict[str, Any]] = None
    labels_soft: Optional[Dict[str, Any]] = None


@dataclass
class TaskSpec:
    task_id: str
    func: Any  # callable (local mode) or pickled bytes (cross-process)
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})
    max_retries: int = 3
    retries_left: int = 3
    strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    # actor fields
    actor_id: Optional[str] = None  # set for actor method calls
    actor_creation: bool = False
    method_name: Optional[str] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    # per-task environment (validated dict: env_vars / working_dir)
    runtime_env: Optional[Dict[str, Any]] = None
    # streaming generator returns (reference: _raylet.pyx streaming
    # generators / num_returns="streaming"): the task's declared return
    # (output index 0) is the END MARKER — item count on success, the
    # error on failure — and yielded items stream at indices 1..n as the
    # task produces them. backpressure>0 bounds unacked in-flight items.
    streaming: bool = False
    backpressure: int = 0
    # bookkeeping
    owner_id: Optional[str] = None
    submitted_at: float = field(default_factory=time.time)
    name: str = ""

    def scheduling_class(self) -> Tuple:
        """Canonical demand signature: tasks in one class are interchangeable
        to the scheduler (lease-reuse equivalence, normal_task_submitter.cc)."""
        res = tuple(sorted((k, float(v)) for k, v in self.resources.items() if v))
        return (
            res,
            self.strategy.kind,
            self.strategy.node_id,
            self.strategy.placement_group_id,
            self.strategy.bundle_index,
        )
