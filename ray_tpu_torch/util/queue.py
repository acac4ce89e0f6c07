"""Distributed FIFO queue backed by an async actor.

Reference: python/ray/util/queue.py (Queue — an asyncio.Queue inside an
async actor; blocking put/get with timeouts, qsize/empty/full). Same
design here now that async actors exist: blocking semantics live
SERVER-side as coroutines parked on an asyncio.Condition, woken by the
matching put/get instead of the old 10ms client poll loop.

Capacity note: this runtime's async-actor bridge still pins one dispatch
thread per IN-FLIGHT call (the coroutines share one loop, but each
caller's slot blocks on the bridge future), so a parked waiter costs a
thread up to the actor's max_concurrency (1000 for async actors). To
keep a fully saturated waiter pool from wedging putters out of the
dispatch pool forever, clients park in bounded slices: a waiter re-calls
every few seconds, freeing its slot at each boundary — under saturation
this degrades to coarse polling instead of deadlock.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(num_cpus=0)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._max = maxsize
        self._q: deque = deque()
        self._cv = asyncio.Condition()

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        """Blocking put: parks until space frees or the timeout elapses.
        Returns False on timeout."""
        async with self._cv:
            if self._max > 0 and len(self._q) >= self._max:
                try:
                    await asyncio.wait_for(
                        self._cv.wait_for(
                            lambda: len(self._q) < self._max
                        ),
                        timeout,
                    )
                except asyncio.TimeoutError:
                    return False
            self._q.append(item)
            self._cv.notify_all()
            return True

    async def get(self, timeout: Optional[float] = None):
        """Blocking get: parks until an item arrives or the timeout
        elapses. Returns a ("__item__", value) tuple, or ("__empty__",)
        on timeout (exceptions stay client-side so a timeout isn't a
        logged actor failure)."""
        async with self._cv:
            if not self._q:
                try:
                    await asyncio.wait_for(
                        self._cv.wait_for(lambda: bool(self._q)), timeout
                    )
                except asyncio.TimeoutError:
                    return ("__empty__",)
            item = self._q.popleft()
            self._cv.notify_all()
            return ("__item__", item)

    def try_put(self, item) -> bool:
        if self._max > 0 and len(self._q) >= self._max:
            return False
        self._q.append(item)
        self._notify()
        return True

    def try_get(self):
        if not self._q:
            return ("__empty__",)
        item = self._q.popleft()
        self._notify()
        return ("__item__", item)

    def _notify(self):
        # sync methods run ON the loop thread (async-actor contract), so
        # parked coroutines must still be woken after a try_put/try_get
        async def _kick():
            async with self._cv:
                self._cv.notify_all()

        asyncio.get_running_loop().create_task(_kick())

    def qsize(self) -> int:
        return len(self._q)

    def drain(self, max_items: int) -> List[Any]:
        out = []
        while self._q and len(out) < max_items:
            out.append(self._q.popleft())
        self._notify()
        return out


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self.maxsize = maxsize
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    # server-side parking slice: bounds how long one blocked waiter pins a
    # dispatch slot (see module docstring)
    _SLICE_S = 5.0

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        if not block:
            if not ray_tpu_torch.get(self._actor.try_put.remote(item)):
                raise Full("queue full")
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        # ship the payload ONCE: retries across parking slices pass the
        # ref, which the actor's node resolves from its local store cache
        # instead of re-receiving the full item every slice
        ref = ray_tpu_torch.put(item)
        while True:
            remaining = (
                self._SLICE_S if deadline is None
                else min(self._SLICE_S, deadline - time.monotonic())
            )
            if remaining <= 0:
                raise Full("queue full")
            if ray_tpu_torch.get(self._actor.put.remote(ref, remaining)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full("queue full")

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            res = ray_tpu_torch.get(self._actor.try_get.remote())
            if res[0] == "__item__":
                return res[1]
            raise Empty("queue empty")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (
                self._SLICE_S if deadline is None
                else min(self._SLICE_S, deadline - time.monotonic())
            )
            if remaining <= 0:
                raise Empty("queue empty")
            res = ray_tpu_torch.get(self._actor.get.remote(remaining))
            if res[0] == "__item__":
                return res[1]
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty("queue empty")

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        return ray_tpu_torch.get(self._actor.drain.remote(max_items))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self):
        ray_tpu_torch.kill(self._actor)
