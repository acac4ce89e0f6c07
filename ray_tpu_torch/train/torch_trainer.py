"""TorchTrainer: torch.distributed (gloo) data-parallel training.

Reference: python/ray/train/torch/torch_trainer.py +
train/torch/config.py (_TorchBackend: rank-0 is MASTER, every worker runs
init_process_group) + train/torch/train_loop_utils.py (prepare_model ->
DDP wrap, prepare_data_loader -> DistributedSampler). The flagship path is
JaxTrainer (jax_trainer.py: the port's train step over a mesh of ranks),
whose rendezvous is this backend's. gloo is the default; NCCL is asked for
with ``TorchBackend(backend="nccl")`` and needs a card for each rank.
"""

from __future__ import annotations

from typing import List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.backend_executor import Backend
from ray_tpu_torch.train.trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup


class TorchBackend(Backend):
    """Rendezvous: rank-0's host serves a TCP store; every worker joins the
    process group before the training loop starts."""

    def __init__(self, backend: str = "gloo", port: int = 0,
                 timeout_s: float = 120.0):
        self.backend = backend
        # 0 = pick a free port ON RANK-0's HOST at rendezvous (the store
        # binds there, not on the driver; a fixed default would also make
        # two concurrent trainers on one host share a TCP store). Probed
        # then released — the standard racy-but-practical pattern.
        self.port = port
        self.timeout_s = timeout_s

    def on_start(self, worker_group: WorkerGroup, worker_infos: List[dict]):
        master = worker_infos[0]["hostname"]
        world = len(worker_infos)
        if not self.port:
            def _pick_port():
                import socket

                with socket.socket() as s:
                    s.bind(("", 0))
                    return s.getsockname()[1]

            self.port = int(ray_tpu_torch.get(
                worker_group.workers[0].run.remote(_pick_port), timeout=60
            ))
        if world > 1 and len({i["pid"] for i in worker_infos}) < world:
            # local mode runs actors as threads of one process; a process
            # group cannot form (rank 1 would see rank 0's init and bail,
            # deadlocking rank 0's rendezvous). The reference never hits
            # this because its workers are always processes.
            raise RuntimeError(
                "TorchTrainer with num_workers>1 needs cluster mode "
                "(ray_tpu_torch.init(cluster=True) or a real cluster): local "
                "mode workers share one process and torch.distributed "
                "requires one process per rank"
            )

        def _init(master_addr, port, world_size, rank, backend, timeout_s):
            import datetime
            import os
            import socket

            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                return True
            try:
                master_ip = socket.gethostbyname(master_addr)
            except OSError:
                master_ip = master_addr
            if master_ip.startswith("127."):
                # single-host group: gloo would otherwise advertise a
                # non-loopback interface (whatever eth address exists) for
                # peer pairing and hang at connectFullMesh
                os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
                os.environ.setdefault("TP_SOCKET_IFNAME", "lo")
            dist.init_process_group(
                backend=backend,
                init_method=f"tcp://{master_addr}:{port}",
                world_size=world_size,
                rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s),
            )
            return True

        futs = [
            w.run.remote(_init, master, self.port, world, rank,
                         self.backend, self.timeout_s)
            for rank, w in enumerate(worker_group.workers)
        ]
        ray_tpu_torch.get(futs, timeout=self.timeout_s + 60)

    def on_shutdown(self, worker_group: WorkerGroup):
        def _destroy():
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()
            return True

        try:
            ray_tpu_torch.get(
                [w.run.remote(_destroy) for w in worker_group.workers],
                timeout=30,
            )
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass

    def worker_env(self, rank: int, worker_infos: List[dict]):
        return {
            "MASTER_ADDR": worker_infos[0]["hostname"],
            "MASTER_PORT": str(self.port),
            "WORLD_SIZE": str(len(worker_infos)),
            "RANK": str(rank),
        }


def prepare_model(model):
    """Wrap in DistributedDataParallel when a multi-worker group is up
    (reference: train_loop_utils.prepare_model; gloo -> CPU DDP)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model


class _EpochedLoader:
    """Iterates the sharded loader, bumping sampler.set_epoch each pass so
    shuffle=True draws a fresh permutation per epoch (reference:
    prepare_data_loader's epoch wrapping; without it DistributedSampler
    replays the epoch-0 permutation forever)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0
        self.batch_size = loader.batch_size
        self.dataset = loader.dataset

    def __iter__(self):
        # each pass IS an epoch; manual sampler.set_epoch is unnecessary
        # (and would be overridden here)
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        # delegate everything else (sampler, num_workers, pin_memory, ...)
        # so code written against a real DataLoader keeps working
        return getattr(self._loader, name)


def prepare_data_loader(loader):
    """Re-shard a DataLoader across the group with a DistributedSampler,
    preserving the loader's own ordering choice (reference:
    train_loop_utils.prepare_data_loader). Returns the loader unchanged
    outside a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return loader
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler

    sampler = DistributedSampler(
        loader.dataset,
        num_replicas=dist.get_world_size(),
        rank=dist.get_rank(),
        # keep the user's ordering: only shuffle if their loader did
        shuffle=isinstance(loader.sampler, RandomSampler),
    )
    sharded = DataLoader(
        loader.dataset,
        batch_size=loader.batch_size,
        sampler=sampler,
        num_workers=0,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
    )
    return _EpochedLoader(sharded, sampler)


class TorchTrainer(DataParallelTrainer):
    def __init__(self, train_loop_per_worker, *,
                 torch_backend: Optional[TorchBackend] = None, **kwargs):
        kwargs.setdefault("backend", torch_backend or TorchBackend())
        super().__init__(train_loop_per_worker, **kwargs)
