"""Async (asyncio) actor support: one event loop per actor.

Reference: python/ray/actor.py + src/ray/core_worker async actor support —
an actor class with any coroutine method runs its tasks on a dedicated
per-actor asyncio event loop; ``max_concurrency`` bounds the number of
in-flight coroutines. Coroutines from different calls interleave at await
points on ONE loop thread, so asyncio primitives (Event, Lock, Condition)
coordinate naturally across calls — the capability Serve's handle
composition and the distributed Queue lean on.

Execution model here: dispatch threads (the actor's concurrency slots)
resolve args and report results — blocking RPC work that must not stall
the loop — and bridge into the loop only for the user method itself via
``ActorEventLoop.call``. Sync methods of an async actor also run ON the
loop (matching upstream: everything the user wrote executes on the loop
thread, so actor state is never touched from two OS threads at once).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Callable


def class_is_async(cls) -> bool:
    """Upstream detection rule: any coroutine (or async generator) method
    makes it an async actor (python/ray/actor.py _is_asyncio)."""
    return any(
        inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
        for _, m in inspect.getmembers(cls, inspect.isfunction)
    )


def agen_to_iter(agen, aio: "ActorEventLoop"):
    """Bridge an async-generator actor method into a plain iterator:
    each item is pulled by running __anext__ on the actor's event loop
    (streamed async-gen methods, reference: _raylet.pyx async streaming
    generators)."""
    while True:
        try:
            yield aio.call(agen.__anext__, (), {})
        except StopAsyncIteration:
            return


class ActorEventLoop:
    """A per-actor asyncio loop on a dedicated daemon thread, with a
    blocking bridge for the actor's dispatch threads."""

    #: bound on the post-stop drain: a coroutine that catches
    #: CancelledError and keeps awaiting must not wedge the loop thread
    #: (and with it every dispatch thread blocked in call()) forever
    DRAIN_TIMEOUT_S = 5.0

    def __init__(self, name: str):
        self.loop = asyncio.new_event_loop()
        self._closed = False
        # wall-clock bound past which call() treats the actor as dead
        # even though the loop thread is still alive (a stubborn
        # coroutine riding out the drain window); set by shutdown()
        self._dead_at = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name
        )
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()
        # Drain before close. Two distinct leftovers exist after stop():
        # 1) tasks that survived cancellation (caught CancelledError and
        #    kept awaiting) — wait for them, BOUNDED: asyncio.wait with a
        #    timeout (NOT wait_for/gather-cancel, which would block until
        #    the stubborn task acknowledges a cancellation it swallows);
        # 2) done-callbacks of tasks that were cancelled DURING shutdown:
        #    a task's done-callback (which resolves the caller's bridge
        #    future in run_coroutine_threadsafe's chaining) is call_soon-
        #    scheduled AFTER the already-queued loop.stop, so it has not
        #    run yet — closing now would strand every blocked call() in
        #    fut.result() forever. One sleep(0) cycle flushes them.
        try:
            pending = asyncio.all_tasks(self.loop)
            if pending:
                self.loop.run_until_complete(
                    asyncio.wait(pending, timeout=self.DRAIN_TIMEOUT_S)
                )
            self.loop.run_until_complete(asyncio.sleep(0))
        finally:
            try:
                self.loop.close()
            except RuntimeError:
                pass  # a still-pending stubborn task; the thread exits

    def call(self, method: Callable, args: tuple, kwargs: dict) -> Any:
        """Run a user method on the loop from a dispatch thread, blocking
        until it completes. Coroutine methods are awaited; sync methods
        run inline on the loop thread (briefly blocking other coroutines,
        as upstream does)."""
        if self._closed:
            raise RuntimeError("actor event loop is shut down")

        async def _invoke():
            r = method(*args, **kwargs)
            # isawaitable, not iscoroutine: __anext__ of an async
            # generator returns an async_generator_asend object, which
            # must be awaited too (streamed async-gen methods)
            if inspect.isawaitable(r):
                return await r
            return r

        fut = asyncio.run_coroutine_threadsafe(_invoke(), self.loop)
        # Not a bare fut.result(): a call racing shutdown() can slip its
        # bridge callback into the loop's queue after the drain's last
        # cycle — loop.close() then discards it and the future never
        # resolves. Poll with a bound so the dispatch thread surfaces the
        # actor's death instead of wedging forever.
        import concurrent.futures as _cf

        import time as _time

        while True:
            try:
                return fut.result(timeout=0.5)
            except _cf.TimeoutError:
                # (closed + thread dead) OR (closed + the shutdown grace
                # window expired): either way the loop will never resolve
                # this bridge future — a stubborn coroutine that swallows
                # CancelledError keeps the THREAD alive, so thread death
                # alone is not a sufficient wedge signal
                if self._closed and (
                    not self._thread.is_alive()
                    or (self._dead_at is not None
                        and _time.time() > self._dead_at)
                ):
                    if not self.loop.is_closed():
                        # cancelling after close would fire the bridge
                        # future's cross-loop callback into a closed
                        # loop (logged noise, no effect)
                        fut.cancel()
                    raise RuntimeError(
                        "actor event loop shut down during call"
                    ) from None

    def shutdown(self, join_timeout: float = 2.0):
        """Cancel every in-flight coroutine and stop the loop. Dispatch
        threads blocked in call() observe CancelledError on their bridge
        futures — the actor's death propagates to callers as task
        errors."""
        if self._closed:
            return
        self._closed = True
        import time as _time

        # past this point call() gives up on unresolved bridge futures
        # even if the loop thread is still draining a stubborn coroutine
        self._dead_at = _time.time() + join_timeout + self.DRAIN_TIMEOUT_S

        def _cancel_and_stop():
            for t in asyncio.all_tasks(self.loop):
                t.cancel()
            # cancellation resumptions were scheduled first; stop after
            self.loop.call_soon(self.loop.stop)

        try:
            self.loop.call_soon_threadsafe(_cancel_and_stop)
        except RuntimeError:
            return  # loop already closed
        self._thread.join(timeout=join_timeout)
