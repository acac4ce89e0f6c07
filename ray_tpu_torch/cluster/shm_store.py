"""Shm-backed node object store: the C++ segment as THE local data plane.

Reference layering being matched (not translated): the plasma store runs
inside the raylet (src/ray/object_manager/plasma/store_runner.cc) and
local_object_manager.cc layers disk spill/restore on top of eviction. Same
split here: the daemon owns the segment + the spill policy; same-node
workers and drivers attach the segment directly and create/seal/get with
zero copies (plasma client.cc's role, minus the unix-socket handshake).

String object ids are mapped to the store's fixed 20-byte keys with SHA-1
(exactly 20 bytes) — the same intern-by-digest trick scheduling_ids.h uses
for resource strings.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.object_store import (
    ObjectExistsError,
    ObjectStore as ShmSegment,
    StoreFullError,
)
from ray_tpu_torch.object_store.store import unlink as shm_unlink


def shm_key(object_id: str) -> bytes:
    return hashlib.sha1(object_id.encode()).digest()


class ShmNodeStore:
    """Daemon-side owner of one node's shm segment.

    Public surface mirrors the in-process fallback store in node_daemon.py
    (put/get/contains/object_ids/delete/stats) plus:
      - ``shm_name``     segment name workers/drivers attach to
      - ``note(oid)``    register an id written directly into shm by a peer
                         process (worker result, driver put)
      - ``make_room(n)`` spill LRU-evictable objects until n bytes fit
    """

    def __init__(self, capacity_bytes: int, spill_dir: str, name: str,
                 max_objects: int = 65536):
        shm_unlink(name)  # heal a stale segment from a SIGKILLed daemon
        self.shm = ShmSegment.create(name, capacity_bytes, max_objects)
        self.shm_name = name
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._known: Dict[bytes, str] = {}  # 20-byte key -> object id string
        self._spilled: Dict[str, str] = {}  # object id -> spill file path

    # ------------------------------------------------------------------ put

    def put(self, oid: str, payload: bytes) -> None:
        key = shm_key(oid)
        with self._lock:
            self._known[key] = oid
            if oid in self._spilled:
                return
        try:
            self.shm.put(key, payload, allow_evict=False)
            return
        except ObjectExistsError:
            return
        except StoreFullError:
            pass
        self.make_room(len(payload))
        try:
            self.shm.put(key, payload, allow_evict=False)
        except ObjectExistsError:
            return
        except StoreFullError:
            # larger than what eviction can free (e.g. > capacity): spill
            # the payload itself straight to disk
            self._spill_bytes(oid, payload)

    def note(self, oid: str) -> None:
        with self._lock:
            self._known[shm_key(oid)] = oid

    # ---------------------------------------------------------------- spill

    def make_room(self, nbytes: int) -> int:
        """Spill sealed, unpinned objects (LRU-first) to disk until ~nbytes
        fit (reference: local_object_manager.cc SpillObjects on pressure)."""
        freed = 0
        target = nbytes + (nbytes >> 2)
        for key in self.shm.list_evictable():
            if freed >= target:
                break
            view = self.shm.get(key)
            if view is None:
                continue
            try:
                data = bytes(view)
            finally:
                self.shm.release(key)
            with self._lock:
                oid = self._known.get(key)
            if oid is None:
                # sealed by an attached writer whose note() hasn't landed
                # yet: spilling it now would file it under an unfindable
                # name — leave it; it becomes spillable once noted
                continue
            self._spill_bytes(oid, data)
            self.shm.delete(key)
            freed += len(data)
        return freed

    def _spill_bytes(self, oid: str, data: bytes) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, shm_key(oid).hex())
        with open(path, "wb") as f:
            f.write(data)
        with self._lock:
            self._spilled[oid] = path

    # ------------------------------------------------------------------ get

    def get(self, oid: str, timeout: Optional[float] = None) -> Optional[bytes]:
        """Blocking get returning a copy (callers here are RPC/network paths
        that serialize anyway; same-process zero-copy readers attach the
        segment and use get_view)."""
        key = shm_key(oid)
        deadline = time.time() + (timeout or 0.0)
        while True:
            view = self.shm.get(key)
            if view is not None:
                try:
                    data = bytes(view)
                finally:
                    self.shm.release(key)
                return data
            with self._lock:
                path = self._spilled.get(oid)
            if path is not None:
                with open(path, "rb") as f:
                    data = f.read()
                # best-effort restore so repeat readers hit shm
                try:
                    self.shm.put(key, data, allow_evict=False)
                except (StoreFullError, ObjectExistsError):
                    pass
                else:
                    with self._lock:
                        self._spilled.pop(oid, None)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                return data
            if timeout is None or time.time() >= deadline:
                return None
            time.sleep(0.005)

    # ------------------------------------------------- chunked transfer

    def object_size(self, oid: str) -> Optional[int]:
        key = shm_key(oid)
        view = self.shm.get(key)
        if view is not None:
            try:
                return len(view)
            finally:
                self.shm.release(key)
        with self._lock:
            path = self._spilled.get(oid)
        if path is not None:
            try:
                return os.path.getsize(path)
            except OSError:
                return None
        return None

    def read_range(self, oid: str, offset: int, length: int) -> Optional[bytes]:
        """One transfer chunk (reference: object_manager.cc serves objects
        in object_buffer_pool chunks)."""
        key = shm_key(oid)
        view = self.shm.get(key)
        if view is not None:
            try:
                return bytes(view[offset:offset + length])
            finally:
                self.shm.release(key)
        with self._lock:
            path = self._spilled.get(oid)
        if path is not None:
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    return f.read(length)
            except OSError:
                return None
        return None

    def begin_streaming_put(self, oid: str, size: int):
        """Writable buffer for an incoming chunked pull (created, unsealed);
        None when it can't be allocated or already exists."""
        key = shm_key(oid)
        buf = None
        try:
            buf = self.shm.create_buffer(key, size, allow_evict=False)
        except ObjectExistsError:
            return None
        except StoreFullError:
            self.make_room(size)
            try:
                buf = self.shm.create_buffer(key, size, allow_evict=False)
            except (StoreFullError, ObjectExistsError):
                return None
        with self._lock:
            self._known[key] = oid
        return buf

    def commit_streaming_put(self, oid: str) -> None:
        self.shm.seal(shm_key(oid))

    def abort_streaming_put(self, oid: str) -> None:
        self.shm.delete(shm_key(oid))

    # ----------------------------------------------------------------- misc

    def contains(self, oid: str) -> bool:
        if self.shm.contains(shm_key(oid)):
            return True
        with self._lock:
            return oid in self._spilled

    def object_ids(self) -> List[str]:
        with self._lock:
            known = dict(self._known)
            out = set(self._spilled)
        for key, oid in known.items():
            if self.shm.contains(key):
                out.add(oid)
        return list(out)

    def delete(self, oids: List[str]) -> None:
        for oid in oids:
            self.shm.delete(shm_key(oid))
            with self._lock:
                self._known.pop(shm_key(oid), None)
                path = self._spilled.pop(oid, None)
            if path:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def stats(self) -> dict:
        s = self.shm.stats()
        with self._lock:
            n_spilled = len(self._spilled)
        return {
            "objects": s["n_objects"] + n_spilled,
            "bytes_in_memory": s["used"],
            "spilled": n_spilled,
            "capacity": s["capacity"],
            "n_evictions": s["n_evictions"],
        }

    def close(self) -> None:
        self.shm.close()


class ShmClientStore:
    """Worker/driver-side attachment to a daemon's segment (plasma
    client.cc's role): zero-copy reads, direct create/seal writes."""

    def __init__(self, name: str):
        self.shm = ShmSegment.attach(name)
        self.shm_name = name

    def get_view(self, oid: str):
        """Pinned zero-copy view or None; caller MUST release(oid)."""
        return self.shm.get(shm_key(oid))

    def get_bytes(self, oid: str) -> Optional[bytes]:
        key = shm_key(oid)
        view = self.shm.get(key)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.shm.release(key)

    def release(self, oid: str) -> None:
        self.shm.release(shm_key(oid))

    def put(self, oid: str, payload: bytes) -> bool:
        """True if stored (or already present); False when full (caller
        falls back to the daemon RPC path or asks it to make room)."""
        try:
            self.shm.put(shm_key(oid), payload, allow_evict=False)
            return True
        except ObjectExistsError:
            return True
        except StoreFullError:
            return False

    def put_with_make_room(self, oid: str, payload: bytes, daemon) -> bool:
        """put; on full, ask the owning daemon to spill and retry once.
        Shared by worker result writes and driver puts so the store-full
        handshake lives in one place."""
        if self.put(oid, payload):
            return True
        try:
            daemon.call("make_room", {"nbytes": len(payload)}, timeout=30.0)
        except Exception:  # noqa: BLE001
            return False
        return self.put(oid, payload)

    def contains(self, oid: str) -> bool:
        return self.shm.contains(shm_key(oid))
