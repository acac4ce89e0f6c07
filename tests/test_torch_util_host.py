"""The port's host utilities held against the reference's on the CPU:
util/collective (numpy collectives through a rendezvous actor), util/queue,
util/graph (dask-style graphs), util/multiprocessing (Pool) and the joblib
backend. Each case runs the same seeded inputs through both packages, each
in a fresh local runtime of 8 CPUs, and compares what they return.
"""

import operator

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_runtime import TORCH_CPU

PACKAGES = {"ref": ray_tpu, "port": ray_tpu_torch}


def both(fn):
    """fn(rt, "ref" | "port") in a fresh local runtime of each package,
    the reference first. Returns (reference's, port's)."""
    out = {}
    for which, rt in PACKAGES.items():
        if which == "ref":
            rt.init(num_cpus=8)
        else:
            rt.init(num_cpus=8, _system_config=TORCH_CPU)
        try:
            out[which] = fn(rt, which)
        finally:
            rt.shutdown()
    return out["ref"], out["port"]


def same(fn):
    ref, port = both(fn)
    assert _plain(port) == _plain(ref), (port, ref)
    return port


def _plain(x):
    """Arrays as (dtype, shape, values), containers recursively."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return (type(x).__name__, x)


def _util(rt, name):
    import importlib

    return importlib.import_module(f"{rt.__name__}.util.{name}")


# ---------------------------------------------------------------- collective


def test_collective_allreduce_allgather_reducescatter_broadcast_barrier():
    world = 4

    def fn(rt, which):
        @rt.remote
        def worker(rank, world, x):
            col = _util(rt, "collective")
            col.init_collective_group(world, rank, group_name="g")
            out = {
                "sum": col.allreduce(x, group_name="g"),
                "max": col.allreduce(x, group_name="g", op="max"),
                "mean": col.allreduce(x, group_name="g", op="mean"),
                "prod": col.allreduce(x[:2], group_name="g", op="prod"),
                "gather": col.allgather(x[:1] * (rank + 1), group_name="g"),
                "rs": col.reducescatter(np.arange(world * 3.0) + rank, group_name="g"),
                "bc": col.broadcast(x * 10, src_rank=2, group_name="g"),
                "rank": col.get_rank("g"), "size": col.get_collective_group_size("g"),
            }
            col.barrier(group_name="g")
            col.destroy_collective_group("g")
            return out

        rng = np.random.default_rng(40)
        xs = [rng.normal(size=5) for _ in range(world)]
        return rt.get([worker.remote(r, world, xs[r]) for r in range(world)], timeout=60)

    out = same(fn)
    assert [o["rank"] for o in out] == list(range(world))


def test_collective_send_recv():
    def fn(rt, which):
        @rt.remote
        def worker(rank):
            col = _util(rt, "collective")
            col.init_collective_group(2, rank, group_name="p2p")
            if rank == 0:
                col.send(np.array([1.0, 2.0]), dst_rank=1, group_name="p2p")
                col.send(np.arange(3), dst_rank=1, group_name="p2p", tag=7)
                return None
            return (col.recv(src_rank=0, group_name="p2p", tag=7),
                    col.recv(src_rank=0, group_name="p2p"))

        return rt.get([worker.remote(0), worker.remote(1)], timeout=60)

    same(fn)


def test_collective_uninitialized_group_raises_as_reference():
    for rt in PACKAGES.values():
        with pytest.raises(RuntimeError, match="not initialized"):
            _util(rt, "collective").allreduce(np.ones(2), group_name="absent")


# --------------------------------------------------------------------- queue


def test_queue_fifo_timeouts_empty_full():
    def fn(rt, which):
        q_mod = _util(rt, "queue")
        q = q_mod.Queue(maxsize=3)
        seen = []
        for i in range(3):
            q.put(i)
        seen.append(("full", q.full(), q.qsize()))
        for what in (lambda: q.put_nowait(9), lambda: q.put(9, timeout=0.1)):
            try:
                what()
                seen.append("put")
            except q_mod.Full:
                seen.append("Full")
        seen.append(("get", q.get(), q.get_nowait()))
        q.put(3)
        seen.append(("batch", q.get_nowait_batch(5), q.empty()))
        for what in (q.get_nowait, lambda: q.get(timeout=0.1)):
            try:
                seen.append(what())
            except q_mod.Empty:
                seen.append("Empty")
        q.shutdown()
        return seen

    out = same(fn)
    assert out[0] == ("full", True, 3) and out[1:3] == ["Full", "Full"]


def test_queue_producer_consumer():
    def fn(rt, which):
        q = _util(rt, "queue").Queue(maxsize=2)

        @rt.remote
        def producer(q, xs):
            for x in xs:
                q.put(x, timeout=30)
            return len(xs)

        @rt.remote
        def consumer(q, n):
            return [q.get(timeout=30) for _ in range(n)]

        xs = [np.full(3, i, dtype=np.int32) for i in range(10)]
        p = producer.remote(q, xs)
        got = rt.get(consumer.remote(q, len(xs)), timeout=60)
        n = rt.get(p, timeout=60)
        q.shutdown()
        return n, got

    same(fn)


# --------------------------------------------------------------------- graph


def _inc(x):
    return x + 1


def _total(xs):
    return sum(xs)


GRAPH = {
    "a": 1,
    "b": (_inc, "a"),
    "c": (operator.add, "a", "b"),
    "d": (_total, ["a", "b", "c", 10]),
    "e": (operator.mul, "d", (_inc, "c")),
    "f": "e",
    "g": {"x": "d", "y": ["a", "b"]},
    "unused": (operator.truediv, 1, 0),
}


def test_graph_get_dask_style_dict():
    def fn(rt, which):
        g = _util(rt, "graph")
        chain = {f"k{i}": (_inc, f"k{i - 1}") for i in range(1, 300)}
        chain["k0"] = 0
        return (g.get(GRAPH, "e"), g.get(GRAPH, ["f", ["b", "c"]]), g.get(GRAPH, "g"),
                g.get(chain, "k299"), g.ray_dask_get(GRAPH, ["a", "d"]))

    out = same(fn)
    assert out[0] == 64 and out[3] == 299


def test_graph_errors_as_reference():
    def fn(rt, which):
        g = _util(rt, "graph")
        out = []
        for dsk, keys in (({"x": (_inc, "y"), "y": (_inc, "x")}, "x"), (GRAPH, "missing")):
            try:
                g.get(dsk, keys)
                out.append(None)
            except (ValueError, KeyError) as e:
                out.append(type(e).__name__)
        return out

    assert same(fn) == ["ValueError", "KeyError"]


# ---------------------------------------------------------------------- Pool


def _square(x):
    return x * x


def _scaled(a, b):
    return a * b + 0.5


def test_pool_map_imap_apply_async_starmap():
    def fn(rt, which):
        Pool = _util(rt, "multiprocessing").Pool
        with Pool(2) as pool:
            xs = list(np.random.default_rng(41).integers(-9, 9, 12))
            ar = pool.apply_async(_scaled, (3, 4))
            out = {"map": pool.map(_square, xs), "imap": list(pool.imap(_square, xs)),
                   "unordered": sorted(pool.imap_unordered(_square, xs)),
                   "apply": pool.apply(_scaled, (2, 5)), "async": ar.get(timeout=30),
                   "ready": ar.ready(), "successful": ar.successful(),
                   "starmap": pool.starmap(_scaled, [(1, 2), (3, 4)]),
                   "map_async": pool.map_async(_square, range(5)).get(timeout=30)}
            pool.close()
            try:
                pool.map(_square, [1])
            except ValueError as e:
                out["closed"] = str(e)
            pool.join()
        return out

    out = same(fn)
    assert out["closed"] == "Pool not running" and out["async"] == 12.5


def test_pool_async_failure_as_reference():
    def fn(rt, which):
        Pool = _util(rt, "multiprocessing").Pool
        with Pool() as pool:
            ar = pool.apply_async(operator.truediv, (1, 0))
            ar.wait(timeout=30)
            return ar.ready(), ar.successful()

    assert same(fn) == (True, False)


# -------------------------------------------------------------------- joblib


def test_joblib_backend_runs_batches_as_reference():
    from joblib import Parallel, delayed, parallel_backend

    def fn(rt, which):
        jb = _util(rt, "joblib_backend")
        jb.register_ray_tpu()
        name = "ray_tpu" if which == "ref" else "ray_tpu_torch"
        with parallel_backend(name, n_jobs=4):
            return Parallel()(delayed(_square)(i) for i in range(12))

    assert same(fn) == [i * i for i in range(12)]
