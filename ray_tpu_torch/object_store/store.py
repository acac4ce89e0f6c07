"""ctypes client for the C++ shm object store.

Reference: src/ray/object_manager/plasma/client.cc (PlasmaClient::Create/
Seal/Get/Release/Delete) — same lifecycle, but instead of a unix-socket
protocol every process maps the same shm segment and synchronizes through a
process-shared mutex inside it, so get() is pure pointer math (zero-copy).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

from ray_tpu_torch._native import load_library

_ID_LEN = 20


class StoreFullError(MemoryError):
    """Allocation failed even after LRU eviction."""


class ObjectExistsError(ValueError):
    pass


class ObjectNotFoundError(KeyError):
    pass


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_library("object_store")
        lib.rts_create.restype = ctypes.c_int64
        lib.rts_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.rts_attach.restype = ctypes.c_int64
        lib.rts_attach.argtypes = [ctypes.c_char_p]
        lib.rts_detach.argtypes = [ctypes.c_int64]
        lib.rts_unlink.argtypes = [ctypes.c_char_p]
        lib.rts_base.restype = ctypes.c_void_p
        lib.rts_base.argtypes = [ctypes.c_int64]
        lib.rts_obj_create.restype = ctypes.c_int64
        lib.rts_obj_create.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint64]
        lib.rts_obj_create2.restype = ctypes.c_int64
        lib.rts_obj_create2.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.rts_obj_seal.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.rts_obj_get.restype = ctypes.c_int64
        lib.rts_obj_get.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rts_obj_release.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.rts_obj_delete.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.rts_obj_contains.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.rts_evict.restype = ctypes.c_uint64
        lib.rts_evict.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        lib.rts_stats.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rts_list_evictable.restype = ctypes.c_uint32
        lib.rts_list_evictable.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint32,
        ]
        _lib = lib
    return _lib


def _check_id(object_id: bytes) -> bytes:
    if len(object_id) != _ID_LEN:
        raise ValueError(f"object id must be {_ID_LEN} bytes, got {len(object_id)}")
    return object_id


def unlink(name: str) -> None:
    """Remove a (possibly stale) shm segment by name; ignores absence."""
    _get_lib().rts_unlink(name.encode())


class ObjectStore:
    """One node's shm object store; create() in the daemon, attach() in workers."""

    def __init__(self, handle: int, name: str, owns: bool):
        self._h = handle
        self._name = name
        self._owns = owns
        self._lib = _get_lib()
        self._base = self._lib.rts_base(handle)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, name: str, capacity: int, max_objects: int = 65536) -> "ObjectStore":
        lib = _get_lib()
        h = lib.rts_create(name.encode(), capacity, max_objects)
        if h < 0:
            raise OSError(-h, f"shm store create failed: {os.strerror(-h)} ({name})")
        return cls(h, name, owns=True)

    @classmethod
    def attach(cls, name: str) -> "ObjectStore":
        lib = _get_lib()
        h = lib.rts_attach(name.encode())
        if h < 0:
            raise OSError(-h, f"shm store attach failed: {os.strerror(-h)} ({name})")
        return cls(h, name, owns=False)

    def close(self) -> None:
        """Drop the store (unlinks the shm name if this process created it).

        The mapping itself is NOT munmapped: zero-copy views returned by
        get()/create_buffer() point straight into it, and unmapping under
        them would turn later reads into segfaults (plasma keeps buffers
        alive through client refs; here the mapping is process-lifetime
        instead — one bounded mapping per store, reclaimed at exit). Call
        detach() only when no views are outstanding.
        """
        if self._h >= 0:
            if self._owns:
                self._lib.rts_unlink(self._name.encode())
            self._h = -1

    def detach(self) -> None:
        """munmap the segment. UNSAFE while any view from get()/
        create_buffer() is still referenced."""
        if self._h >= 0:
            self._lib.rts_detach(self._h)
            if self._owns:
                self._lib.rts_unlink(self._name.encode())
            self._h = -1

    @property
    def name(self) -> str:
        return self._name

    # ------------------------------------------------------------ object API
    def create_buffer(self, object_id: bytes, size: int,
                      allow_evict: bool = True) -> memoryview:
        """Allocate a writable buffer; must be sealed before it is readable.
        allow_evict=False raises StoreFullError instead of silently LRU-
        evicting, letting a spill-aware owner persist victims first."""
        off = self._lib.rts_obj_create2(
            self._h, _check_id(object_id), size, 1 if allow_evict else 0
        )
        if off == -4:
            raise ObjectExistsError(object_id.hex())
        if off == -2:
            raise StoreFullError(f"cannot allocate {size} bytes")
        if off < 0:
            raise OSError(f"create failed: {off}")
        return self._view(off, size)

    def seal(self, object_id: bytes) -> None:
        rc = self._lib.rts_obj_seal(self._h, _check_id(object_id))
        if rc == -1:
            raise ObjectNotFoundError(object_id.hex())
        if rc < 0:
            raise ValueError(f"seal failed (state): {rc}")

    def put(self, object_id: bytes, payload: bytes,
            allow_evict: bool = True) -> None:
        """create + copy + seal in one call."""
        buf = self.create_buffer(object_id, len(payload), allow_evict)
        buf[:] = payload
        self.seal(object_id)

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy read-only view of a sealed object; pins it until
        release().  Returns None if absent or unsealed."""
        size = ctypes.c_uint64()
        off = self._lib.rts_obj_get(self._h, _check_id(object_id), ctypes.byref(size))
        if off < 0:
            return None
        return self._view(off, size.value).toreadonly()

    def release(self, object_id: bytes) -> None:
        self._lib.rts_obj_release(self._h, _check_id(object_id))

    def delete(self, object_id: bytes) -> None:
        self._lib.rts_obj_delete(self._h, _check_id(object_id))

    def contains(self, object_id: bytes) -> bool:
        return self._lib.rts_obj_contains(self._h, _check_id(object_id)) == 2

    def evict(self, nbytes: int) -> int:
        return self._lib.rts_evict(self._h, nbytes)

    def list_evictable(self, max_ids: int = 4096) -> List[bytes]:
        buf = ctypes.create_string_buffer(max_ids * _ID_LEN)
        n = self._lib.rts_list_evictable(self._h, buf, max_ids)
        raw = buf.raw
        return [raw[i * _ID_LEN:(i + 1) * _ID_LEN] for i in range(n)]

    def stats(self) -> Dict[str, int]:
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        n = ctypes.c_uint32()
        nev = ctypes.c_uint64()
        bev = ctypes.c_uint64()
        self._lib.rts_stats(self._h, ctypes.byref(used), ctypes.byref(cap),
                            ctypes.byref(n), ctypes.byref(nev), ctypes.byref(bev))
        return {
            "used": used.value,
            "capacity": cap.value,
            "n_objects": n.value,
            "n_evictions": nev.value,
            "bytes_evicted": bev.value,
        }

    # ------------------------------------------------------------ internals
    def _view(self, offset: int, size: int) -> memoryview:
        addr = self._base + offset
        return memoryview((ctypes.c_char * size).from_address(addr)).cast("B")
