"""WorkerGroup: the gang of training-worker actors.

Reference: python/ray/train/_internal/worker_group.py (WorkerGroup) —
spawns N actors (optionally inside a placement group), broadcasts callables,
gathers results, tears down.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@ray_tpu_torch.remote
class _TrainWorker:
    """One rank. Holds the installed session between calls (reference:
    train/_internal/worker_group.py RayTrainWorker)."""

    def __init__(self):
        self._ctx = None

    def node_info(self) -> Dict[str, Any]:
        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": getattr(ctx, "node_id", "local"),
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
        }

    def setup_session(self, ctx_dict: dict, bus, start_checkpoint_path):
        from ray_tpu_torch.train.session import TrainContext, _install_session

        self._ctx = TrainContext(**ctx_dict)
        _install_session(self._ctx, bus, start_checkpoint_path)
        return True

    def run(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def run_train_loop(self, train_loop: Callable, config: Optional[dict]):
        import inspect

        sig = inspect.signature(train_loop)
        if len(sig.parameters) == 0:
            return train_loop()
        return train_loop(config or {})

    def shutdown_session(self):
        from ray_tpu_torch.train.session import _clear_session

        _clear_session()
        return True


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_strategy: str = "PACK",
        use_placement_group: bool = True,
    ):
        self.num_workers = num_workers
        self._pg: Optional[PlacementGroup] = None
        worker_cls = _TrainWorker
        if use_placement_group and num_workers > 0:
            self._pg = placement_group(
                [dict(resources_per_worker) for _ in range(num_workers)],
                strategy=placement_strategy,
            )
            self._pg.ready(timeout=120.0)
        self.workers = []
        for i in range(num_workers):
            opts: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1.0),
                "name": f"train_worker_{i}",
            }
            extra = {
                k: v for k, v in resources_per_worker.items()
                if k not in ("CPU", "GPU", "TPU")
            }
            if extra:
                opts["resources"] = extra
            if resources_per_worker.get("TPU"):
                opts["num_tpus"] = resources_per_worker["TPU"]
            if resources_per_worker.get("GPU"):
                opts["num_gpus"] = resources_per_worker["GPU"]
            if self._pg is not None:
                opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group=self._pg, placement_group_bundle_index=i
                )
            self.workers.append(worker_cls.options(**opts).remote())

    def execute_async(self, method: str, *args, **kwargs):
        return [getattr(w, method).remote(*args, **kwargs) for w in self.workers]

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(method, *args, **kwargs))

    def execute_single(self, rank: int, method: str, *args, **kwargs):
        return ray_tpu_torch.get(
            getattr(self.workers[rank], method).remote(*args, **kwargs)
        )

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
