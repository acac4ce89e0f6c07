"""multiprocessing.Pool API over tasks/actors.

Reference: python/ray/util/multiprocessing/pool.py (Pool — map/starmap/
apply/imap/async variants over an actor pool).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _run_fn(fn, args, kwargs):
    return fn(*args, **(kwargs or {}))


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        vals = ray_tpu_torch.get(self._refs, timeout=timeout)
        return vals[0] if self._single else vals

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            # multiprocessing contract: raise if the result isn't in yet
            raise ValueError("AsyncResult not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Process-pool semantics on the cluster. processes= bounds per-task
    parallelism only through scheduling (each task takes 1 CPU)."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes
        self._closed = False
        if initializer:
            # best-effort: run once per pool (reference runs per worker
            # process; with shared thread workers once is the equivalent)
            ray_tpu_torch.get(_run_fn.remote(initializer, tuple(initargs), None))

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        self._check()
        return AsyncResult([_run_fn.remote(fn, tuple(args), kwds)], single=True)

    def map(self, fn, iterable: Iterable, chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable, chunksize=None) -> AsyncResult:
        self._check()
        refs = [_run_fn.remote(fn, (x,), None) for x in iterable]
        return AsyncResult(refs, single=False)

    def starmap(self, fn, iterable: Iterable) -> List[Any]:
        self._check()
        refs = [_run_fn.remote(fn, tuple(args), None) for args in iterable]
        return ray_tpu_torch.get(refs)

    def imap(self, fn, iterable: Iterable, chunksize=None):
        self._check()
        refs = [_run_fn.remote(fn, (x,), None) for x in iterable]
        for r in refs:
            yield ray_tpu_torch.get(r)

    def imap_unordered(self, fn, iterable: Iterable, chunksize=None):
        self._check()
        refs = [_run_fn.remote(fn, (x,), None) for x in iterable]
        pending = list(refs)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield ray_tpu_torch.get(done[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
