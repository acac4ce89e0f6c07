"""Tensor collectives for actors/tasks.

Reference: python/ray/util/collective/collective.py
(init_collective_group/allreduce/allgather/reducescatter/broadcast/
send/recv/barrier over NCCL via cupy or GLOO via pygloo).

Device collectives over a mesh are torch.distributed's, inside the
parallel programs (ray_tpu_torch.parallel.mesh). This module is the
HOST-side path the reference's GLOO group covers, with the JAX package's
numpy semantics: numpy tensors exchanged between actors/tasks through a
rendezvous actor — used for control-plane sync, CPU preprocessing, and
parameter averaging outside the step. The group coordinator is a named
actor; members find it via ray_tpu_torch.get_actor, so it works
identically in local (thread) and cluster (process) modes.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

_local = threading.local()

REDUCE_OPS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "prod": lambda arrs: np.prod(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
    "mean": lambda arrs: np.mean(arrs, axis=0),
}


@ray_tpu_torch.remote(num_cpus=0)
class _GroupCoordinator:
    """Rendezvous + reduction for one collective group. Methods are
    world-size barriers (threaded actor), mirroring a synchronous ring."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # op sequence -> {"in": {rank: array}, "out": result}
        self._ops: Dict[str, dict] = {}
        self._p2p: Dict[tuple, Any] = {}
        self._timeout = 300.0

    def world_size(self):
        return self._world

    def _op_slot(self, op_id: str):
        return self._ops.setdefault(op_id, {"in": {}, "out": None, "done": 0})

    def collect(self, op_id: str, rank: int, payload, compute: str,
                op: str = "sum"):
        """Generic barrier-collect: every rank contributes, one computation
        runs, every rank receives. compute: reduce | gather | reducescatter
        | bcast (op carries the src rank; only src ships a payload)."""
        with self._cv:
            slot = self._op_slot(op_id)
            slot["in"][rank] = payload
            if len(slot["in"]) == self._world:
                if compute == "bcast":
                    slot["out"] = slot["in"][int(op)]
                elif compute == "barrier":
                    slot["out"] = True
                else:
                    arrs = [slot["in"][r] for r in range(self._world)]
                    if compute == "reduce":
                        slot["out"] = REDUCE_OPS[op](arrs)
                    elif compute == "gather":
                        slot["out"] = arrs
                    elif compute == "reducescatter":
                        red = REDUCE_OPS[op](arrs)
                        slot["out"] = np.array_split(red, self._world, axis=0)
                self._cv.notify_all()
            else:
                deadline = time.time() + self._timeout
                while slot["out"] is None:
                    left = deadline - time.time()
                    if left <= 0:
                        raise TimeoutError(
                            f"collective {op_id}: {len(slot['in'])}/{self._world}"
                        )
                    self._cv.wait(min(left, 1.0))
            out = slot["out"]
            slot["done"] += 1
            if slot["done"] == self._world:
                del self._ops[op_id]
            if compute == "reducescatter":
                return out[rank]
            return out

    # point-to-point
    def put_p2p(self, key, payload):
        with self._cv:
            self._p2p[tuple(key)] = payload
            self._cv.notify_all()
        return True

    def take_p2p(self, key):
        key = tuple(key)
        with self._cv:
            deadline = time.time() + self._timeout
            while key not in self._p2p:
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(f"recv {key} timed out")
                self._cv.wait(min(left, 1.0))
            return self._p2p.pop(key)


class _GroupHandle:
    def __init__(self, name: str, world_size: int, rank: int, coordinator):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coord = coordinator
        self.seq = 0

    def next_op(self, kind: str) -> str:
        self.seq += 1
        return f"{kind}:{self.seq}"


def _groups() -> Dict[str, _GroupHandle]:
    if not hasattr(_local, "groups"):
        _local.groups = {}
    return _local.groups


def init_collective_group(
    world_size: int, rank: int, backend: str = "auto",
    group_name: str = "default",
) -> None:
    """Join (rank 0: create) a collective group (reference:
    init_collective_group; backend arg accepted for parity — the host path
    is always the store group, in-mesh collectives never come here)."""
    key = f"collective_group:{group_name}"
    if rank == 0:
        coord = _GroupCoordinator.options(
            max_concurrency=world_size + 2, num_cpus=0, name=key
        ).remote(world_size)
    else:
        coord = None
        deadline = time.time() + 60.0
        while time.time() < deadline:
            try:
                coord = ray_tpu_torch.get_actor(key)
                break
            except ValueError:
                time.sleep(0.02)
        if coord is None:
            raise TimeoutError(f"collective group {group_name} never appeared")
    _groups()[group_name] = _GroupHandle(group_name, world_size, rank, coord)


def _get_group(group_name: str) -> _GroupHandle:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this worker "
            "(call init_collective_group first)"
        )
    return g


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups().pop(group_name, None)
    if g is not None and g.rank == 0:
        try:
            ray_tpu_torch.kill(g.coord)
        except Exception:
            pass


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    g = _get_group(group_name)
    out = ray_tpu_torch.get(g.coord.collect.remote(
        g.next_op("ar"), g.rank, np.asarray(tensor), "reduce", op))
    return np.asarray(out)


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    g = _get_group(group_name)
    out = ray_tpu_torch.get(g.coord.collect.remote(
        g.next_op("ag"), g.rank, np.asarray(tensor), "gather"))
    return [np.asarray(a) for a in out]


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    g = _get_group(group_name)
    out = ray_tpu_torch.get(g.coord.collect.remote(
        g.next_op("rs"), g.rank, np.asarray(tensor), "reducescatter", op))
    return np.asarray(out)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _get_group(group_name)
    # only the source ships bytes; other ranks contribute a placeholder
    payload = np.asarray(tensor) if g.rank == src_rank else None
    out = ray_tpu_torch.get(g.coord.collect.remote(
        g.next_op("bc"), g.rank, payload, "bcast", str(src_rank)))
    return np.asarray(out)


def barrier(group_name: str = "default") -> None:
    g = _get_group(group_name)
    ray_tpu_torch.get(g.coord.collect.remote(g.next_op("bar"), g.rank, None, "barrier"))


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    g = _get_group(group_name)
    ray_tpu_torch.get(g.coord.put_p2p.remote(
        (g.rank, dst_rank, tag), np.asarray(tensor)))


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    g = _get_group(group_name)
    return np.asarray(ray_tpu_torch.get(g.coord.take_p2p.remote(
        (src_rank, g.rank, tag))))


def get_rank(group_name: str = "default") -> int:
    return _get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get_group(group_name).world_size
