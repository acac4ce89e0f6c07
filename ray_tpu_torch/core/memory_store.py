"""In-process object store for small / inlined results.

Reference: src/ray/core_worker/store_provider/memory_store/memory_store.cc —
the core worker's in-process store holding inlined results (below
max_direct_call_object_size) and error markers, with blocking Get. The
plasma-equivalent shm store is a separate component (ray_tpu.core.shm_store);
this one is pure Python and always present.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.core.object_ref import ObjectRef


class _Entry:
    __slots__ = ("value", "is_exception")

    def __init__(self, value: Any, is_exception: bool = False):
        self.value = value
        self.is_exception = is_exception


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[str, _Entry] = {}
        self._cv = threading.Condition(self._lock)

    def put(self, ref: ObjectRef, value: Any, is_exception: bool = False) -> None:
        with self._cv:
            self._store[ref.id] = _Entry(value, is_exception)
            self._cv.notify_all()

    def list_entries(self, limit: int = 1000):
        """State-API view (reference: `ray list objects`)."""
        import sys

        out = []
        with self._lock:
            for oid, e in list(self._store.items())[:limit]:
                out.append({
                    "object_id": oid,
                    "is_exception": e.is_exception,
                    "approx_size": sys.getsizeof(e.value),
                    "type": type(e.value).__name__,
                })
        return out

    def contains(self, ref: ObjectRef) -> bool:
        with self._lock:
            return ref.id in self._store

    def try_get(self, ref: ObjectRef) -> Optional[_Entry]:
        with self._lock:
            return self._store.get(ref.id)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[_Entry]:
        """Blocking get of all refs; raises GetTimeoutError on expiry."""
        deadline = None if timeout is None else (threading.TIMEOUT_MAX if timeout < 0 else timeout)
        with self._cv:
            def ready():
                return all(r.id in self._store for r in refs)

            if not self._cv.wait_for(ready, timeout=deadline):
                raise GetTimeoutError(
                    f"get timed out after {timeout}s; "
                    f"missing {[r.id[:8] for r in refs if r.id not in self._store]}"
                )
            return [self._store[r.id] for r in refs]

    def wait(
        self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        with self._cv:
            def enough():
                return sum(1 for r in refs if r.id in self._store) >= num_returns

            self._cv.wait_for(enough, timeout=timeout)
            ready = [r for r in refs if r.id in self._store]
            not_ready = [r for r in refs if r.id not in self._store]
            return ready[:num_returns] + [], not_ready + ready[num_returns:]

    def delete(self, refs: List[ObjectRef]) -> None:
        with self._lock:
            for r in refs:
                self._store.pop(r.id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._store)
