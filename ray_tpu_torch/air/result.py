"""Result: the terminal report of a training/tuning run.

Reference: python/ray/air/result.py (Result dataclass).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    path: Optional[str] = None
    error: Optional[Exception] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoints(self):
        return [(self.checkpoint, self.metrics)] if self.checkpoint else []

    def __repr__(self):
        keys = sorted(self.metrics)[:6] if self.metrics else []
        shown = {k: self.metrics[k] for k in keys}
        return (
            f"Result(metrics={shown}, checkpoint={self.checkpoint}, "
            f"error={self.error!r})"
        )
