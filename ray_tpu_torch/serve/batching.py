"""Dynamic request batching for deployment methods (@serve.batch).

Reference: python/ray/serve/batching.py — concurrent calls to a decorated
method are coalesced; the wrapped function receives a LIST of inputs and
returns a LIST of outputs, one per caller. Batches flush when
max_batch_size accumulates or batch_wait_timeout_s elapses since the
first queued item.

Replicas here are threaded actors (max_concurrency > 1), so batching is a
thread rendezvous: callers enqueue and block on a per-item event; one
dedicated flusher thread per batcher (the analog of the reference's
asyncio flush task) waits out each batch's window — anchored to the
OLDEST queued item's arrival time — and runs the function. A dedicated
flusher means no caller is ever held past its own result to serve later
arrivals' windows, and every trailing batch still gets its full
coalescing window.
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from typing import Any, Callable, List, Optional


class _Item:
    __slots__ = ("value", "event", "result", "error", "t")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t = time.monotonic()  # arrival, anchors the batch window


class _Batcher:
    def __reduce__(self):
        # Queue state and threads are process-local; a batcher landing in
        # another process (a @serve.batch-decorated class pickled into a
        # cluster replica) starts fresh with the same configuration —
        # by-value pickling is impossible anyway (locks/condvars inside).
        return (_Batcher, (self.fn, self.max_batch_size, self.timeout_s))

    def __init__(self, fn: Callable[..., List[Any]], max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self._cv = threading.Condition()
        self._queue: List[_Item] = []
        # weakref: the daemon flusher thread outlives dropped replicas,
        # and a strong ref here would keep their model state alive forever
        self._bound_ref = None
        self._thread: Optional[threading.Thread] = None

    def submit(self, bound_self, value):
        item = _Item(value)
        with self._cv:
            self._queue.append(item)
            if bound_self is not None and self._bound_ref is None:
                try:
                    self._bound_ref = weakref.ref(bound_self)
                except TypeError:  # __slots__ without __weakref__
                    self._bound_ref = lambda inst=bound_self: inst
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"serve-batch-{self.fn.__name__}",
                )
                self._thread.start()
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    # how long an empty-queue flusher lingers before exiting; submit()
    # restarts it. Bounds the thread count for replica churn: a dropped
    # replica's flusher parks at most this long instead of forever.
    _IDLE_EXIT_S = 10.0

    def _loop(self):
        """Flusher: sleep until the oldest item's window elapses or the
        queue fills, take one batch, run it, repeat. Only this thread
        removes items, so `self._queue[0]` stays valid across waits.
        Exits after _IDLE_EXIT_S of empty queue (handing `self._thread`
        back under the cv, so a racing submit starts a fresh one)."""
        while True:
            with self._cv:
                idle_deadline = time.monotonic() + self._IDLE_EXIT_S
                while not self._queue:
                    remaining = idle_deadline - time.monotonic()
                    if remaining <= 0:
                        self._thread = None
                        return
                    self._cv.wait(timeout=remaining)
                deadline = self._queue[0].t + self.timeout_s
                while len(self._queue) < self.max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._queue[: self.max_batch_size]
                self._queue = self._queue[self.max_batch_size:]
                # queued items imply a caller thread blocked inside the
                # instance's method, so the weakref cannot be dead here
                bound = self._bound_ref() if self._bound_ref else None
            self._run_batch(bound, batch)

    def _run_batch(self, bound_self, batch):
        try:
            args = [it.value for it in batch]
            out = (self.fn(bound_self, args) if bound_self is not None
                   else self.fn(args))
            if not isinstance(out, (list, tuple)) or len(out) != len(batch):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(batch)} results (one per input); got {type(out)}"
                )
            for it, r in zip(batch, out):
                it.result = r
        except BaseException as e:  # noqa: BLE001 - delivered to callers
            for it in batch:
                it.error = e
        finally:
            for it in batch:
                it.event.set()


class AdaptiveBatchSizer:
    """Target-latency-driven batch sizing for the serve fast path's
    continuous batcher (reference points: Gavel sizes allocations to
    measured throughput; continuous batching in LLM serving sizes the
    running batch from the live request stream).

    The replica loop asks :meth:`target` how many queued requests to
    dispatch as one group and :meth:`wait_budget` how long a partial
    group may coalesce; it feeds measured service times back through
    :meth:`record`. The model: one item costs ``ema`` seconds, so a batch
    of ``target_latency / ema`` items keeps the *oldest* item's
    end-to-end latency near the target — more load -> bigger batches
    (throughput), light load -> batch of 1 (latency). EMA over service
    time, not throughput, so a reconfigured/slow model adapts within a
    few batches."""

    def __init__(self, target_latency_s: float = 0.02, max_batch: int = 64,
                 alpha: float = 0.2):
        self.target_latency_s = float(target_latency_s)
        self.max_batch = max(int(max_batch), 1)
        self._alpha = alpha
        self._ema_item_s: Optional[float] = None

    def record(self, batch_size: int, elapsed_s: float) -> None:
        if batch_size <= 0:
            return
        per_item = max(elapsed_s / batch_size, 1e-7)
        if self._ema_item_s is None:
            self._ema_item_s = per_item
        else:
            self._ema_item_s += self._alpha * (per_item - self._ema_item_s)

    def target(self) -> int:
        if self._ema_item_s is None:
            # no signal yet: take whatever is queued (the continuous-
            # batching default) — the first measurement clamps from there.
            # A target of 1 here would let a cold replica burn a whole
            # burst through as singles before any feedback lands.
            return self.max_batch
        return max(1, min(self.max_batch,
                          int(self.target_latency_s / self._ema_item_s)))

    def wait_budget(self) -> float:
        """How long a partial batch may wait for more arrivals before it
        dispatches anyway: a quarter of the latency target, floored so an
        idle replica still dispatches promptly."""
        return max(self.target_latency_s * 0.25, 0.0005)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a deployment method (or function) taking a LIST of inputs
    and returning a LIST of outputs; concurrent single-input calls are
    coalesced into one invocation. Usable bare (@serve.batch) or with
    arguments (@serve.batch(max_batch_size=..., batch_wait_timeout_s=...)).
    """

    def wrap(fn):
        # one batcher per (instance, method): replicas must not share state
        attr = f"__rt_batcher_{fn.__name__}"
        module_level = _Batcher(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def method_wrapper(*args, **kwargs):
            if kwargs:
                raise TypeError("@serve.batch calls take one positional arg")
            if len(args) == 2:  # bound method: (self, value)
                inst, value = args
                b = getattr(inst, attr, None)
                if b is None:
                    # GIL-atomic attach (no lock in this closure: the
                    # wrapper is pickled into cluster replicas with the
                    # decorated class, and a captured Lock cell would make
                    # the whole class unpicklable); racing first uses both
                    # build a batcher, dict.setdefault keeps exactly one
                    b = inst.__dict__.setdefault(
                        attr, _Batcher(fn, max_batch_size,
                                       batch_wait_timeout_s)
                    )
                return b.submit(inst, value)
            if len(args) == 1:  # plain function: (value,)
                return module_level.submit(None, args[0])
            raise TypeError("@serve.batch expects (self, value) or (value)")

        method_wrapper._rt_is_batched = True
        return method_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap
