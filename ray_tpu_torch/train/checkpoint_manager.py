"""Driver-side checkpoint bookkeeping: persist, rank, prune.

Reference: python/ray/train/_internal/checkpoint_manager.py
(_CheckpointManager — keeps num_to_keep checkpoints ordered by
checkpoint_score_attribute).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint, persist_checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


class CheckpointManager:
    def __init__(self, run_dir: str, config: CheckpointConfig):
        self.run_dir = run_dir
        self.config = config
        self._kept: List[Tuple[float, str, Dict[str, Any]]] = []
        self._counter = 0
        self.latest: Optional[Checkpoint] = None

    def register(self, worker_ckpt_path: str, metrics: Dict[str, Any]) -> Checkpoint:
        dest = os.path.join(
            self.run_dir, f"checkpoint_{self._counter:06d}"
        )
        self._counter += 1
        ckpt = persist_checkpoint(Checkpoint.from_directory(worker_ckpt_path), dest)
        self.latest = ckpt
        attr = self.config.checkpoint_score_attribute
        if attr is not None:
            if attr not in metrics:
                # reference parity: a configured score attribute missing from
                # the report is an error, not a silent recency fallback
                raise ValueError(
                    f"checkpoint_score_attribute {attr!r} not in reported "
                    f"metrics {sorted(metrics)}"
                )
            score = float(metrics[attr])
            if self.config.checkpoint_score_order == "min":
                score = -score
        else:
            score = float(self._counter)  # recency order
        self._kept.append((score, dest, dict(metrics)))
        self._prune()
        return ckpt

    def _prune(self):
        k = self.config.num_to_keep
        if k is None or len(self._kept) <= k:
            return
        self._kept.sort(key=lambda t: t[0], reverse=True)
        for score, path, _ in self._kept[k:]:
            if self.latest is not None and path == self.latest.path:
                continue
            shutil.rmtree(path, ignore_errors=True)
        self._kept = [
            e for e in self._kept[:k]
        ] + [e for e in self._kept[k:] if self.latest and e[1] == self.latest.path]

    def best(self) -> Optional[Checkpoint]:
        if not self._kept:
            return self.latest
        best = max(self._kept, key=lambda t: t[0])
        return Checkpoint.from_directory(best[1]) if os.path.isdir(best[1]) else self.latest
