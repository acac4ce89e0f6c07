"""ObjectRefGenerator: streaming generator task returns.

Reference: python/ray/_raylet.pyx (ObjectRefGenerator /
num_returns="streaming") — a generator task yields ObjectRefs to its
caller INCREMENTALLY, as the remote generator produces them, instead of
materializing every return before the task completes. Upstream Ray Data's
streaming executor is built on this; here ``ray_tpu.data``'s map exchange
adopts it the same way.

Wire protocol (shared by local and cluster mode):
  - output index 0 is the END MARKER — the task's one declared return.
    On success it holds the item count; on failure it holds the error.
    Because it IS the normal task result, every existing completion path
    (task_result pushes, retries, worker-death errors, lineage) applies
    to stream termination unchanged.
  - yielded item i (0-based) lands at output index i+1, published as the
    task produces it.

Semantics:
  - iteration blocks until the next item exists (or the stream ends);
  - a mid-stream failure delivers the error as the LAST element — the
    ref is yielded and raising happens at ``get`` (upstream behavior);
  - each ``__next__`` acks the consumed index, releasing the producer's
    backpressure window (``_backpressure_num_objects``);
  - a retried streaming task re-runs the whole generator (at-least-once,
    as upstream); already-consumed refs stay valid.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch.core.object_ref import ObjectRef


def end_marker_ref(task_id: str, owner: Optional[str] = None) -> ObjectRef:
    return ObjectRef.for_task_output(task_id, 0, owner=owner)


def item_ref(task_id: str, i: int, owner: Optional[str] = None) -> ObjectRef:
    """Ref for 0-based yielded item i (wire index i+1)."""
    return ObjectRef.for_task_output(task_id, i + 1, owner=owner)


class ObjectRefGenerator:
    """Iterator of ObjectRefs for one streaming task's yields."""

    def __init__(self, task_id: str, owner_id: Optional[str],
                 ack: bool = False):
        self._task_id = task_id
        self._owner = owner_id
        # acks exist only to widen the producer's backpressure window;
        # skip the per-item runtime call when no window was requested
        self._ack = ack
        self._i = 0  # next 0-based item index to hand out
        self._count: Optional[int] = None  # known once the end marker lands
        self._error_delivered = False

    @property
    def task_id(self) -> str:
        return self._task_id

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._next(timeout=None)

    def next_ready(self, timeout: float) -> ObjectRef:
        """Like __next__ but raises TimeoutError if no item arrives in
        ``timeout`` seconds (StopIteration still signals exhaustion)."""
        return self._next(timeout=timeout)

    def _next(self, timeout: Optional[float]) -> ObjectRef:
        from ray_tpu_torch.core.api import _get_runtime

        rt = _get_runtime()
        deadline = None if timeout is None else time.time() + timeout
        end = end_marker_ref(self._task_id, self._owner)
        while True:
            if self._count is not None and self._i >= self._count:
                raise StopIteration
            item = item_ref(self._task_id, self._i, self._owner)
            if rt.stream_item_ready(item):
                self._i += 1
                if self._ack:
                    rt.stream_ack(self._task_id, self._i)
                return item
            if self._count is not None:
                # The end marker proves this item was produced (it landed
                # before the count). A lost push (daemon->GCS relay
                # failure, driver reconnect) must not spin or hang the
                # consumer: hand the ref out with a pull-through hint so
                # get() fetches it via the GCS directory.
                mark = getattr(rt, "stream_mark_remote", None)
                if mark is not None:
                    mark(item)
                self._i += 1
                if self._ack:
                    rt.stream_ack(self._task_id, self._i)
                return item
            if self._count is None and rt.stream_item_ready(end):
                value, is_err = rt.stream_read_end(end)
                if is_err:
                    # The error marker carries no produced-count, so check
                    # whether THIS item was actually produced before the
                    # failure (its push announcement may have been lost on
                    # a reconnect) — produced items are never dropped.
                    locate = getattr(rt, "stream_locate", None)
                    if locate is not None and locate(item):
                        mark = getattr(rt, "stream_mark_remote", None)
                        if mark is not None:
                            mark(item)
                        continue  # now ready; delivered by the re-check
                    # the failure is the stream's last element: hand out
                    # the marker ref (get() raises the task error), then
                    # stop. Items published before the failure were
                    # already consumable.
                    if self._error_delivered:
                        raise StopIteration
                    self._error_delivered = True
                    self._count = self._i
                    return end
                self._count = int(value)
                continue  # re-check: the item may exist after all
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"no stream item from {self._task_id} within {timeout}s"
                )
            remaining = 1.0 if deadline is None else min(
                1.0, max(0.05, deadline - time.time())
            )
            rt.stream_wait_any([item, end], timeout=remaining)

    def completed(self) -> bool:
        """True once every yielded item has been handed out."""
        return self._count is not None and self._i >= self._count

    @property
    def errored(self) -> bool:
        """True if the stream terminated with an error (the last handed-out
        ref raises it on get)."""
        return self._error_delivered

    def __del__(self):
        # Abandoned consumer: a backpressured producer would otherwise
        # park on acks that never come, wedging its worker forever. A
        # final unbounded ack lets it run to completion (items land in
        # the store unconsumed; normal eviction reclaims them).
        if self._ack and not self.completed():
            try:
                from ray_tpu_torch.core import api as _api

                # only an ALREADY-LIVE runtime: _get_runtime() would
                # auto-init a fresh one if GC runs after shutdown()
                rt = _api._runtime
                if rt is not None:
                    rt.stream_ack(self._task_id, 1 << 30)
            except Exception:  # noqa: BLE001 - interpreter teardown etc.
                pass

    def __reduce__(self):
        # Streams are push-delivered to the OWNER's connection only; a
        # pickled generator on another worker would wait on pushes that
        # never arrive there. Hand out the ObjectRefs instead (they are
        # location-addressed and travel fine).
        raise TypeError(
            "ObjectRefGenerator is not serializable: consume it where the "
            "task was submitted and pass the yielded ObjectRefs instead"
        )
