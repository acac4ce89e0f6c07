"""ObjectRef: a future naming an object in the distributed store.

Reference: ObjectRef in python/ray/includes/object_ref.pxi / the ObjectID in
src/ray/common/id.h. IDs here are 16-byte random (task-output ids are derived
deterministically from task id + output index, mirroring
ObjectID::FromIndex).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
from typing import Optional


def _rand_hex(n: int = 16) -> str:
    return os.urandom(n).hex()


# Thread-local construction hook: while active, every ObjectRef built on this
# thread (including via unpickling) is reported to the callback. This is how
# refs NESTED inside values are discovered — at serialize time on the owner
# (so they join the task's deps and get pinned) and at deserialize time in
# the worker (so the worker registers as a borrower). Reference analog: the
# serialization hooks feeding reference_count.cc's AddNestedObjectIds /
# AddBorrowedObject.
_capture = threading.local()


@contextlib.contextmanager
def capture_refs(cb):
    prev = getattr(_capture, "cb", None)
    _capture.cb = cb
    try:
        yield
    finally:
        _capture.cb = prev


class ObjectRef:
    __slots__ = ("id", "owner", "task_id", "_hash", "_on_del")

    def __init__(self, id: Optional[str] = None, owner: Optional[str] = None,
                 task_id: Optional[str] = None):
        self.id = id or _rand_hex()
        self.owner = owner  # owner worker/driver id (ownership-based directory)
        self.task_id = task_id  # creating task, for lineage reconstruction
        self._hash = hash(self.id)
        cb = getattr(_capture, "cb", None)
        if cb is not None:
            cb(self)

    def _register(self, on_del) -> bool:
        """Runtime hook: count this instance toward the owner's local
        refcount; its deletion decrements (reference: reference_count.cc
        AddLocalReference / the Cython __dealloc__ path). Returns False if
        already registered (never double-count one instance)."""
        if getattr(self, "_on_del", None) is not None:
            return False
        self._on_del = on_del
        return True

    def __del__(self):
        cb = getattr(self, "_on_del", None)
        if cb is not None:
            try:
                cb(self.id)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    @staticmethod
    def for_task_output(task_id: str, index: int, owner: Optional[str] = None) -> "ObjectRef":
        oid = hashlib.sha1(f"{task_id}:{index}".encode()).hexdigest()[:32]
        return ObjectRef(oid, owner=owner, task_id=task_id)

    def hex(self) -> str:
        return self.id

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def __repr__(self):
        return f"ObjectRef({self.id[:16]})"

    def __reduce__(self):
        # fires the capture hook at SERIALIZE time too, so an owner pickling
        # a value discovers the refs nested in it (deserialize-side capture
        # goes through __init__)
        cb = getattr(_capture, "cb", None)
        if cb is not None:
            cb(self)
        return (ObjectRef, (self.id, self.owner, self.task_id))
