"""Trial: one configuration's lifecycle.

Reference: python/ray/tune/experiment/trial.py (Trial — status machine
PENDING/RUNNING/PAUSED/TERMINATED/ERROR, config, checkpoints, results).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any], experiment_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.results: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.iteration = 0
        self.dir = os.path.join(experiment_dir, trial_id)
        os.makedirs(self.dir, exist_ok=True)
        self.checkpoint_path: Optional[str] = None
        # scheduler scratch (ASHA rungs recorded, PBT last perturb iter)
        self.sched_state: Dict[str, Any] = {}
        self.start_time = time.time()

    def record(self, metrics: Dict[str, Any]):
        self.iteration += 1
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", self.iteration)
        metrics["trial_id"] = self.trial_id
        self.last_result = metrics
        self.results.append(metrics)

    # --------------------------------------------------------- persistence
    def save_state(self):
        state = {
            "trial_id": self.trial_id,
            "config": _jsonable(self.config),
            "status": self.status,
            "iteration": self.iteration,
            "last_result": _jsonable(self.last_result),
            "results": _jsonable(self.results),
            "sched_state": _jsonable(self.sched_state),
            "error": self.error,
            "checkpoint_path": self.checkpoint_path,
        }
        with open(os.path.join(self.dir, "trial_state.json"), "w") as f:
            json.dump(state, f, indent=1)

    @classmethod
    def load_state(cls, trial_dir: str, experiment_dir: str) -> Optional["Trial"]:
        p = os.path.join(trial_dir, "trial_state.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            st = json.load(f)
        t = cls(st["trial_id"], st["config"], experiment_dir)
        t.status = st["status"]
        t.iteration = st["iteration"]
        t.last_result = st["last_result"]
        t.results = st.get("results", [])
        t.sched_state = st.get("sched_state", {})
        t.error = st.get("error")
        t.checkpoint_path = st.get("checkpoint_path")
        return t

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iteration})"


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        return repr(obj)
