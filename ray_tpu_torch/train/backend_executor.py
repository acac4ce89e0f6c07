"""BackendExecutor: starts the worker group, runs rendezvous, drives the
training loop, and streams back reports.

Reference: python/ray/train/_internal/backend_executor.py
(BackendExecutor.start — spawns WorkerGroup, assigns world/local/node ranks,
sets MASTER_ADDR/PORT and calls the backend's on_start). In the port a
worker process owns one device, so the backends' process group is
``torch.distributed``'s (train/torch_trainer.py, train/jax_trainer.py);
this module assigns the ranks and installs each worker's context.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint, persist_checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train.session import make_report_bus
from ray_tpu_torch.train.worker_group import WorkerGroup


def _apply_env(env: Dict[str, str]):
    import os

    os.environ.update({str(k): str(v) for k, v in env.items()})
    return True


class Backend:
    """Hook interface (reference: train/backend/backend.py Backend).
    on_start runs on the driver after worker creation; worker_env(rank)
    values are then exported into each worker's process environment."""

    def on_start(self, worker_group: WorkerGroup, worker_infos: List[dict]):
        pass

    def on_shutdown(self, worker_group: WorkerGroup):
        pass

    def worker_env(self, rank: int, worker_infos: List[dict]) -> Dict[str, str]:
        return {}


class BackendExecutor:
    def __init__(
        self,
        scaling_config: ScalingConfig,
        backend: Optional[Backend] = None,
        experiment_name: str = "default",
        trial_name: str = "trial",
        trial_dir: str = "",
        barrier_timeout_s: float = 600.0,
    ):
        self.scaling = scaling_config
        self.backend = backend or Backend()
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.trial_dir = trial_dir
        self.barrier_timeout_s = barrier_timeout_s
        self.worker_group: Optional[WorkerGroup] = None
        self.bus = None
        self.worker_infos: List[dict] = []

    def start(self, start_checkpoint: Optional[Checkpoint] = None,
              trial_config: Optional[dict] = None):
        n = self.scaling.num_workers
        self.worker_group = WorkerGroup(
            n,
            self.scaling._worker_resources(),
            placement_strategy=self.scaling.placement_strategy,
        )
        self.bus = make_report_bus(n, self.barrier_timeout_s)
        self.worker_infos = self.worker_group.execute("node_info")
        # local/node rank assignment: group by node, order by world rank
        # (reference: backend_executor _create_rank_world_size_mappings)
        per_node: Dict[str, int] = defaultdict(int)
        node_order: Dict[str, int] = {}
        setups = []
        for rank, info in enumerate(self.worker_infos):
            node = info["node_id"]
            if node not in node_order:
                node_order[node] = len(node_order)
            ctx = dict(
                world_size=n,
                world_rank=rank,
                local_rank=per_node[node],
                node_rank=node_order[node],
                experiment_name=self.experiment_name,
                trial_name=self.trial_name,
                trial_dir=self.trial_dir,
                trial_config=dict(trial_config or {}),
            )
            per_node[node] += 1
            setups.append(
                self.worker_group.workers[rank].setup_session.remote(
                    ctx, self.bus,
                    start_checkpoint.path if start_checkpoint else None,
                )
            )
        ray_tpu_torch.get(setups)
        self.backend.on_start(self.worker_group, self.worker_infos)
        # publish backend env vars into the worker processes AFTER on_start
        # (rendezvous may pick ports on_start needs to know first); user
        # loops then see e.g. the torch RANK/WORLD_SIZE/MASTER_* contract
        import os as _os
        import socket as _socket

        driver_ident = (_socket.gethostname(), _os.getpid())
        envs = [
            self.backend.worker_env(rank, self.worker_infos)
            for rank in range(n)
        ]
        # apply only to workers in their OWN processes: local-mode workers
        # are threads of this process, where per-rank env would clobber the
        # driver's environment (and each other, last-rank-wins). Identity is
        # (hostname, pid) — a bare pid can collide with the driver's on a
        # different host.
        calls = [
            w.run.remote(_apply_env, env)
            for w, env, info in zip(
                self.worker_group.workers, envs, self.worker_infos
            )
            if env
            and (info.get("hostname"), info.get("pid")) != driver_ident
        ]
        if calls:
            ray_tpu_torch.get(calls)

    def run_training(self, train_loop: Callable, config: Optional[dict]):
        """Kick off the loop on every worker; returns the per-worker futures."""
        return self.worker_group.execute_async(
            "run_train_loop", train_loop, config
        )

    def drain_reports(self) -> List[List[dict]]:
        """Raises if the bus died — surfaced to the trainer's failure
        handling rather than silently dropping metrics."""
        if self.bus is None:
            return []
        return ray_tpu_torch.get(self.bus.drain.remote(), timeout=30.0)

    def shutdown(self, graceful: bool = True):
        if self.bus is not None:
            try:
                # synchronous abort first: wakes ranks blocked in the push
                # barrier before the actor is torn down
                ray_tpu_torch.get(self.bus.abort.remote(), timeout=5.0)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(self.bus)
            except Exception:
                pass
            self.bus = None
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group)
            self.worker_group.shutdown()
            self.worker_group = None
