"""Host-side shared-memory object store (the plasma equivalent).

Reference: src/ray/object_manager/plasma/ (store, client), surfaced here as a
single C++ shm arena (ray_tpu_torch/_native/object_store.cc) that every process on
a node maps, plus this zero-copy ctypes client.
"""

from ray_tpu_torch.object_store.store import (
    ObjectStore,
    StoreFullError,
    ObjectExistsError,
    ObjectNotFoundError,
)

__all__ = [
    "ObjectStore",
    "StoreFullError",
    "ObjectExistsError",
    "ObjectNotFoundError",
]
