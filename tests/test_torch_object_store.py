"""The port's C++ shm object store (ray_tpu_torch/_native/object_store.cc
through ray_tpu_torch.object_store) and its serialization, held to the
reference's: every case of tests/test_object_store.py on the port's
modules, one seeded sequence of operations under memory pressure that
must give the same returns and stats() on both stores, and pack() giving
the same bytes in both packages."""

import hashlib
import multiprocessing
import os
import subprocess

import numpy as np
import pytest

from ray_tpu_torch.object_store import (
    ObjectExistsError,
    ObjectStore,
    StoreFullError,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def oid(i: int) -> bytes:
    return i.to_bytes(20, "big")


@pytest.fixture
def store():
    name = f"/rtst_test_{os.getpid()}_{np.random.randint(1 << 30)}"
    s = ObjectStore.create(name, capacity=1 << 20, max_objects=256)
    yield s
    s.close()


def test_put_get_roundtrip(store):
    store.put(oid(1), b"hello world")
    view = store.get(oid(1))
    assert bytes(view) == b"hello world"
    store.release(oid(1))


def test_get_missing_returns_none(store):
    assert store.get(oid(99)) is None


def test_unsealed_not_readable(store):
    buf = store.create_buffer(oid(2), 4)
    buf[:] = b"abcd"
    assert store.get(oid(2)) is None  # not sealed yet
    assert store.contains(oid(2)) is False
    store.seal(oid(2))
    assert store.contains(oid(2)) is True
    assert bytes(store.get(oid(2))) == "abcd".encode()


def test_duplicate_create_raises(store):
    store.put(oid(3), b"x")
    with pytest.raises(ObjectExistsError):
        store.create_buffer(oid(3), 1)


def test_zero_copy_numpy(store):
    arr = np.arange(1000, dtype=np.float32)
    store.put(oid(4), arr.tobytes())
    view = store.get(oid(4))
    out = np.frombuffer(view, dtype=np.float32)
    np.testing.assert_array_equal(out, arr)
    # the view is read-only (sealed objects are immutable)
    with pytest.raises(ValueError):
        out[0] = 1.0
    store.release(oid(4))


def test_delete_frees_space(store):
    before = store.stats()["used"]
    store.put(oid(5), b"z" * 4096)
    assert store.stats()["used"] > before
    store.delete(oid(5))
    assert store.stats()["used"] == before
    assert store.get(oid(5)) is None


def test_delete_deferred_while_pinned(store):
    store.put(oid(6), b"pinned")
    view = store.get(oid(6))  # pin
    store.delete(oid(6))
    # still readable through the existing view; freed on release
    assert bytes(view) == b"pinned"
    store.release(oid(6))
    assert store.get(oid(6)) is None


def test_lru_eviction_under_pressure(store):
    # fill most of the 1MB store with 64KB objects, then keep inserting:
    # oldest unpinned sealed objects must be evicted, newest survive.
    blob = b"e" * (64 << 10)
    for i in range(100, 130):
        store.put(oid(i), blob)
    stats = store.stats()
    assert stats["n_evictions"] > 0
    assert store.get(oid(129)) is not None  # newest survives
    store.release(oid(129))
    assert store.get(oid(100)) is None  # oldest evicted


def test_pinned_objects_survive_eviction(store):
    blob = b"p" * (64 << 10)
    store.put(oid(200), blob)
    pinned = store.get(oid(200))  # pin
    for i in range(201, 240):
        store.put(oid(i), blob)
    assert bytes(pinned[:4]) == b"pppp"  # still alive despite pressure
    store.release(oid(200))


def test_store_full_when_nothing_evictable(store):
    with pytest.raises(StoreFullError):
        store.put(oid(300), b"x" * (2 << 20))  # bigger than capacity


def test_free_list_coalescing(store):
    # alloc a,b,c; free b then a; a+b coalesce so a big object fits again
    store.put(oid(400), b"a" * (256 << 10))
    store.put(oid(401), b"b" * (256 << 10))
    store.put(oid(402), b"c" * (256 << 10))
    store.delete(oid(400))
    store.delete(oid(401))
    store.put(oid(403), b"d" * (500 << 10))  # needs the coalesced hole
    assert store.contains(oid(403))


def _child_attach(name, result_q):
    s = ObjectStore.attach(name)
    view = s.get(b"A" * 20)
    result_q.put(bytes(view) if view is not None else None)
    s.put(b"B" * 20, b"from-child")
    s.close()


def test_cross_process_visibility():
    name = f"/rtst_xproc_{os.getpid()}"
    s = ObjectStore.create(name, capacity=1 << 20)
    try:
        s.put(b"A" * 20, b"from-parent")
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=_child_attach, args=(name, q))
        p.start()
        got = q.get(timeout=30)
        p.join(timeout=30)
        assert got == b"from-parent"
        assert bytes(s.get(b"B" * 20)) == b"from-child"
    finally:
        s.close()


def test_stats_shape(store):
    st = store.stats()
    assert set(st) == {"used", "capacity", "n_objects", "n_evictions", "bytes_evicted"}
    assert st["capacity"] >= 1 << 20


def _stress_proc(name: str, proc_id: int, iters: int, errors):
    s = ObjectStore.attach(name)
    for i in range(iters):
        key = hashlib.sha1(f"{proc_id}:{i % 32}".encode()).digest()
        payload = bytes([(proc_id * 37 + i % 32) % 256]) * (512 + (i % 5) * 2048)
        try:
            s.put(key, payload)
        except (ObjectExistsError, StoreFullError):
            pass
        other = hashlib.sha1(f"{(proc_id + 1) % 3}:{(i * 7) % 32}".encode()).digest()
        view = s.get(other)
        if view is not None:
            b = bytes(view)
            s.release(other)
            if len(set(b)) > 1:  # payloads are constant-byte; mix = corruption
                errors.put(f"corrupt read in proc {proc_id} iter {i}")
                return
        if i % 11 == 0:
            s.delete(key)
        if i % 29 == 0:
            s.evict(4096)


def test_concurrent_multiprocess_stress():
    """3 processes hammer create/seal/get/release/delete/evict on one
    segment under eviction pressure; any torn read or deadlock fails."""
    name = f"/rtst_mpstress_{os.getpid()}"
    store = ObjectStore.create(name, capacity=1 << 19, max_objects=512)
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    procs = [
        ctx.Process(target=_stress_proc, args=(name, p, 2000, errors))
        for p in range(3)
    ]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
            assert not p.is_alive(), "stress process hung (deadlock?)"
            assert p.exitcode == 0
        assert errors.empty(), errors.get()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        store.close()


def test_tsan_thread_stress(tmp_path):
    """Build the port's C++ stress harness with -fsanitize=thread and run
    it; any data race TSAN finds is a hard failure."""
    src = os.path.join(ROOT, "ray_tpu_torch", "_native", "store_stress.cc")
    out = str(tmp_path / "store_stress_tsan")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-std=c++17", "-o", out,
         src, "-lpthread", "-lrt"],
        capture_output=True, text=True,
    )
    if build.returncode != 0:
        pytest.skip(f"tsan build unavailable: {build.stderr[:200]}")
    run = subprocess.run(
        [out, f"/rtst_tsan_{os.getpid()}", "4", "10000"],
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, f"stdout={run.stdout}\nstderr={run.stderr[-2000:]}"
    assert "WARNING: ThreadSanitizer" not in run.stderr, run.stderr[-2000:]


# --------------------------------------------------------------------------
# Held against the reference's store and serialization
# --------------------------------------------------------------------------


def _seeded_sequence(store_cls, full_err, exists_err, name, seed=0, n_ops=3000):
    """Drive one store through a seeded mix of create, seal, put, get,
    release, delete, contains, evict and list_evictable on 48 ids in a
    256 KiB arena (many objects of up to 24 KiB: eviction, pinned
    survivors and full stores all happen); returns every observable
    result, stats() after each operation included."""
    rng = np.random.default_rng(seed)
    s = store_cls.create(name, capacity=256 << 10, max_objects=128)
    log = []
    pins = {}
    unsealed = set()
    try:
        for step in range(n_ops):
            op = int(rng.integers(0, 9))
            k = int(rng.integers(0, 48))
            key = oid(k)
            size = int(rng.integers(1, 24 << 10))
            try:
                if op == 0:
                    buf = s.create_buffer(key, size, allow_evict=bool(rng.integers(0, 2)))
                    buf[:] = bytes([step % 251]) * size
                    unsealed.add(k)
                    res = ("created", size)
                elif op == 1:
                    s.seal(key)
                    unsealed.discard(k)
                    res = "sealed"
                elif op == 2:
                    s.put(key, bytes([(step * 7) % 251]) * size)
                    res = "put"
                elif op == 3:
                    view = s.get(key)
                    if view is None:
                        res = None
                    else:
                        res = hashlib.sha1(bytes(view)).hexdigest()
                        pins[k] = pins.get(k, 0) + 1
                elif op == 4:
                    if pins.get(k):
                        pins[k] -= 1
                        s.release(key)
                    res = "released"
                elif op == 5:
                    s.delete(key)
                    res = "deleted"
                elif op == 6:
                    res = s.contains(key)
                elif op == 7:
                    res = int(s.evict(int(rng.integers(0, 64 << 10))))
                else:
                    res = sorted(x.hex() for x in s.list_evictable(64))
            except (full_err, exists_err, KeyError, ValueError, OSError) as e:
                res = ("raised", type(e).__name__)
            log.append((step, op, k, res, s.stats()))
    finally:
        s.close()
    return log


def test_seeded_sequence_equals_reference_store():
    import ray_tpu.object_store as ref_store

    pid = os.getpid()
    got = _seeded_sequence(ObjectStore, StoreFullError, ObjectExistsError,
                           f"/rtst_seq_port_{pid}")
    want = _seeded_sequence(ref_store.ObjectStore, ref_store.StoreFullError,
                            ref_store.ObjectExistsError, f"/rts_seq_ref_{pid}")
    assert got == want
    # the sequence really reached the store's hard cases
    outcomes = [r for _, _, _, r, _ in got]
    assert ("raised", "StoreFullError") in outcomes
    assert ("raised", "ObjectExistsError") in outcomes
    assert got[-1][4]["n_evictions"] > 0


def _payloads():
    rng = np.random.default_rng(3)
    return [
        np.arange(1000, dtype=np.float32),
        {"a": rng.standard_normal((17, 5)), "b": [1, 2.5, "x", None],
         "c": (rng.integers(0, 9, 33, dtype=np.int64), b"raw")},
        [np.zeros((0, 4), np.float16), {"nested": {"deep": np.ones(3, bool)}}],
        "plain string",
        12345678901234567890,
        np.asfortranarray(rng.standard_normal((6, 7))),
    ]


def test_pack_same_bytes_as_reference_and_unpack_inverts():
    from ray_tpu.core import serialization as ref_ser
    from ray_tpu_torch.core import serialization as ser

    for obj in _payloads():
        data = ser.pack(obj)
        assert data == ref_ser.pack(obj)
        back = ser.unpack(data)
        back_mv = ser.unpack(memoryview(data))
        for b in (back, back_mv):
            np.testing.assert_equal(b, obj)


def test_native_library_is_built_into_build_dir_by_hash():
    from ray_tpu_torch import _native

    path = _native.library_path("object_store")
    assert path.parent == _native.BUILD_DIR
    assert path.parent.as_posix().endswith("build/torch_ext")
    ObjectStore.create(f"/rtst_lib_{os.getpid()}", capacity=1 << 16).close()
    assert path.exists()
    # the reference builds next to its source; the port never does
    assert not os.path.exists(os.path.join(ROOT, "ray_tpu_torch", "_native",
                                           "libobject_store.so"))
