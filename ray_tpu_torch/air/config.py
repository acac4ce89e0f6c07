"""Shared Train/Tune configuration dataclasses.

Reference: python/ray/air/config.py (ScalingConfig, RunConfig, FailureConfig,
CheckpointConfig). Kept as plain dataclasses with the same field names so a
reference user finds the same surface.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many workers a trainer spawns and what each one needs.

    Reference: python/ray/air/config.py (ScalingConfig). Both ``use_tpu``
    and ``use_gpu`` are kept from the JAX package: a worker on the card
    asks for the node's ``GPU`` resource through ``use_gpu=True`` (one
    card) or ``resources_per_worker={"GPU": f}`` (a share of one), and its
    step runs on that card (the framework orchestrates, the step function
    owns the device).
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False  # accepted for API parity; mapped to GPU resource
    resources_per_worker: Optional[Dict[str, float]] = None
    trainer_resources: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def _worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_tpu and "TPU" not in res:
            res["TPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    def as_placement_group_bundles(self):
        """One bundle per worker (+ a trainer bundle), reference semantics."""
        bundles = []
        if self.trainer_resources:
            bundles.append(dict(self.trainer_resources))
        bundles.extend(self._worker_resources() for _ in range(self.num_workers))
        return bundles


@dataclass
class FailureConfig:
    """Reference: python/ray/air/config.py (FailureConfig). max_failures=-1
    means retry forever; 0 means fail fast."""

    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    """Reference: python/ray/air/config.py (CheckpointConfig)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Reference: python/ray/air/config.py (RunConfig): experiment name,
    storage root for results/checkpoints, failure + checkpoint policy."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    # trial stop criteria, e.g. {"training_iteration": 10} (reference:
    # RunConfig(stop=...) / air.config)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results"
        )
        return os.path.abspath(os.path.expanduser(base))
