"""JaxTrainer: the flagship trainer — the train step over a mesh of ranks.
The port of ray_tpu/train/jax_trainer.py, with the reference's names.

Reference analog: python/ray/train/torch/torch_trainer.py (TorchTrainer).
In the JAX package a worker owns every local device, all parallelism within
a host is compiled into its program, and JaxBackend calls
jax.distributed.initialize only when the workers span nodes. In the port a
worker process owns one device, so the mesh is a ``torch.distributed``
group of worker processes (train/jax_utils.py ``prepare_mesh``) and the
rendezvous is TorchBackend's.
"""

from __future__ import annotations

from typing import List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.torch_trainer import TorchBackend
from ray_tpu_torch.train.trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup


def _device_identity():
    """(hostname, the UUID of this process's current card), None without one."""
    import socket

    import torch

    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return socket.gethostname(), str(props.uuid)


class JaxBackend(TorchBackend):
    """Rendezvous of the workers' ``torch.distributed`` group: rank 0's host
    serves the TCP store on `coordinator_port` (0: a free port there) and
    every worker joins before the loop starts.

    The one difference from the reference: with ``distributed=None`` (auto)
    the group is formed whenever there is more than one worker, not only
    when the workers span nodes, since here each worker is one rank with
    one device. ``distributed=True`` forms it for one worker too;
    ``False`` never. `backend` is gloo by default (it takes CUDA tensors and
    allows two ranks on one card); "nccl" is used only when asked, and
    raises unless every worker has a card of its own. Local mode with more
    than one worker raises, as TorchBackend does: its workers are threads
    of one process."""

    def __init__(self, coordinator_port: int = 7621,
                 distributed: Optional[bool] = None, backend: str = "gloo",
                 timeout_s: float = 120.0):
        super().__init__(backend=backend, port=coordinator_port, timeout_s=timeout_s)
        self.coordinator_port = coordinator_port
        self.distributed = distributed

    def on_start(self, worker_group: WorkerGroup, worker_infos: List[dict]):
        dist = self.distributed
        if dist is None:
            dist = len(worker_infos) > 1
        if not dist:
            return
        if self.backend == "nccl":
            ids = ray_tpu_torch.get(
                [w.run.remote(_device_identity) for w in worker_group.workers],
                timeout=self.timeout_s)
            if None in ids or len(set(ids)) < len(ids):
                raise RuntimeError(
                    "JaxBackend(backend='nccl') needs a card of its own for each "
                    f"worker; the workers' cards are {ids}: use gloo")
        super().on_start(worker_group, worker_infos)

    def worker_env(self, rank: int, worker_infos: List[dict]):
        dist = self.distributed
        if dist is None:
            dist = len(worker_infos) > 1
        return super().worker_env(rank, worker_infos) if dist else {}


class JaxTrainer(DataParallelTrainer):
    def __init__(self, train_loop_per_worker, *, jax_backend: Optional[JaxBackend] = None,
                 **kwargs):
        kwargs.setdefault("backend", jax_backend or JaxBackend())
        super().__init__(train_loop_per_worker, **kwargs)
