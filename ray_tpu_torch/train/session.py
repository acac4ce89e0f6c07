"""Worker-side training session: context, report(), get_checkpoint().

Reference: python/ray/train/_internal/session.py (_TrainSession, report,
get_context) — workers call ``train.report(metrics, checkpoint=...)`` which
synchronizes all ranks (a barrier) and ships rank-0's checkpoint to run
storage via the coordinator.

Implementation: each worker pushes to a ``_ReportBus`` actor whose ``push``
is a world-size barrier; the trainer drains completed rounds. Works in both
local (thread-actor) and cluster (process-worker) modes because the bus is an
ordinary actor reached through its handle.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint

_session = threading.local()


@dataclass
class TrainContext:
    """What a worker can ask about itself (reference:
    train/context.py TrainContext)."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = "default"
    trial_name: str = "trial"
    trial_dir: str = ""
    trial_config: Dict[str, Any] = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name


class _WorkerSession:
    def __init__(self, ctx: TrainContext, bus_handle, start_checkpoint_path):
        self.ctx = ctx
        self.bus = bus_handle
        self.iteration = 0
        self.start_checkpoint_path = start_checkpoint_path


def _install_session(ctx, bus_handle, start_checkpoint_path):
    _session.value = _WorkerSession(ctx, bus_handle, start_checkpoint_path)


def _clear_session():
    _session.value = None


def _get_session() -> Optional[_WorkerSession]:
    return getattr(_session, "value", None)


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        # Driver-side / outside a worker: a degenerate 1-worker context,
        # matching the reference's behavior of tolerating non-session use.
        return TrainContext()
    return s.ctx


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this run was (re)started from, if any (reference:
    train.get_checkpoint — the resume path after failure restart)."""
    s = _get_session()
    if s is None or not s.start_checkpoint_path:
        return None
    return Checkpoint.from_directory(s.start_checkpoint_path)


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    """Report metrics (and optionally a checkpoint) for this iteration.
    Synchronizes all workers like the reference's train.report barrier."""
    s = _get_session()
    if s is None:
        return  # tolerated outside a session (reference parity)
    payload = {
        "rank": s.ctx.world_rank,
        "iteration": s.iteration,
        "metrics": dict(metrics),
        "checkpoint_path": checkpoint.path if checkpoint is not None else None,
        "checkpoint_ref": None,
        "time": time.time(),
    }
    if checkpoint is not None:
        # Ship contents through the object store so the driver can
        # materialize them even when the worker's filesystem isn't shared
        # (multi-node cluster mode); the driver prefers the local-path fast
        # path when it sees the same filesystem.
        import io
        import tarfile

        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(checkpoint.path, arcname=".")
        payload["checkpoint_ref"] = ray_tpu_torch.put(buf.getvalue())
    s.iteration += 1
    # Barrier: push returns once every rank has pushed this iteration.
    ray_tpu_torch.get(s.bus.push.remote(payload))


@ray_tpu_torch.remote(num_cpus=0)
class _ReportBus:
    """Coordinator actor: per-iteration barrier + report mailbox.

    max_concurrency must cover all workers blocking in push simultaneously
    plus the trainer's drain polls.
    """

    def __init__(self, world_size: int, barrier_timeout_s: float = 600.0):
        self._world = world_size
        self._timeout = barrier_timeout_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[int, List[dict]] = {}
        self._complete: List[List[dict]] = []
        self._aborted = False

    def push(self, payload: dict) -> bool:
        it = payload["iteration"]
        with self._cv:
            self._pending.setdefault(it, []).append(payload)
            if len(self._pending[it]) == self._world:
                round_ = sorted(self._pending.pop(it), key=lambda p: p["rank"])
                self._complete.append(round_)
                self._cv.notify_all()
                return True
            deadline = time.time() + self._timeout
            while not self._aborted and it in self._pending:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"train.report barrier timed out at iteration {it}: "
                        f"{len(self._pending.get(it, []))}/{self._world} ranks"
                    )
                self._cv.wait(timeout=min(remaining, 1.0))
            if self._aborted:
                raise RuntimeError("training aborted")
        return True

    def drain(self) -> List[List[dict]]:
        with self._lock:
            out = self._complete
            self._complete = []
            return out

    def abort(self):
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


def make_report_bus(world_size: int, barrier_timeout_s: float = 600.0):
    return _ReportBus.options(
        max_concurrency=world_size + 2, num_cpus=0
    ).remote(world_size, barrier_timeout_s)
