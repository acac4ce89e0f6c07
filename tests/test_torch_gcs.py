"""The port's GCS scheduling loop (ray_tpu_torch.cluster.gcs) with the
torch_cuda policy (scheduler_device="cpu": the plain PyTorch versions of
the kernels), held against ray_tpu's GCS on the same submission sequence.

Ports tests/test_jax_policy_gcs.py with the decisions parametrized over the
three kernel algorithms (scan K1, rounds K5, chunked K6): the port's GCS
must place every task exactly where ray_tpu's GCS places it, under both of
ray_tpu's policies (hybrid on NumPy and jax_tpu). Also ports the pipelined
window's drain, guard and topology-change cases, and the dep-gate voucher
cases of tests/test_inflight_voucher.py.

Every GCS is shut down in `finally`; scheduler loops are parked, so no test
waits on a live scheduler thread.
"""

import logging
import time

import numpy as np
import pytest
import torch

from ray_tpu.core.config import Config as JaxConfig
from ray_tpu.cluster.gcs import GcsServer as JaxGcsServer
from ray_tpu.cluster import testing as jax_testing
from ray_tpu_torch.cluster import testing as torch_testing
from ray_tpu_torch.cluster.gcs import GcsServer
from ray_tpu_torch.cluster.testing import (
    FakeConn,
    park_scheduler_loop,
    register_fake_nodes,
    run_rounds_to_quiescence,
)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.sched.kernel_torch import TorchScheduler
from ray_tpu_torch.sched.policy import make_policy_from_config
from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other's (one plain K1 call on config_5's round took
    ~200 s with six processes at once, ~1 s at one thread each). One
    thread for this module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALGOS = ["scan", "rounds", "chunked"]


def _gcs_config(policy_name, algo, pipeline_depth):
    return {
        "scheduling_policy": policy_name,
        "scheduler_kernel_algo": algo,
        "scheduler_round_interval_ms": 60_000.0,
        # force the device path even at toy sizes
        "jax_policy_min_cells": 0,
        # depth 0 = synchronous rounds (per-round lockstep)
        "jax_policy_pipeline_depth": pipeline_depth,
    }


def _register(gcs, testing, n_nodes):
    rng = np.random.default_rng(42)
    cpus = rng.integers(8, 65, n_nodes)
    mems = rng.integers(32, 257, n_nodes)
    testing.register_fake_nodes(
        gcs, n_nodes, lambda i: {"CPU": int(cpus[i]), "memory": int(mems[i])},
    )


def _boot_gcs(n_nodes=64, algo="scan", pipeline_depth=0):
    """The port's GCS: torch_cuda on the CPU."""
    gcs = GcsServer(config=Config({
        **_gcs_config("torch_cuda", algo, pipeline_depth), "scheduler_device": "cpu",
    }))
    park_scheduler_loop(gcs)
    _register(gcs, torch_testing, n_nodes)
    return gcs, FakeConn()


def _boot_jax_gcs(policy_name, n_nodes=64, algo="scan"):
    gcs = JaxGcsServer(config=JaxConfig(_gcs_config(policy_name, algo, 0)))
    jax_testing.park_scheduler_loop(gcs)
    _register(gcs, jax_testing, n_nodes)
    return gcs, jax_testing.FakeConn()


def _submit_workload(gcs, conn, n_tasks, seed=7):
    rng = np.random.default_rng(seed)
    cpu = rng.integers(1, 5, n_tasks)
    mem = np.where(rng.random(n_tasks) < 0.4, rng.integers(1, 9, n_tasks), 0)
    for i in range(n_tasks):
        res = {"CPU": int(cpu[i])}
        if mem[i]:
            res["memory"] = int(mem[i])
        gcs.rpc_submit_task(
            {
                "task_id": f"t-{i}",
                "class_key": (("CPU", int(cpu[i])), ("memory", int(mem[i]))),
                "resources": res,
                "num_returns": 1,
            },
            conn,
        )


@pytest.mark.parametrize("algo", ALGOS)
def test_torch_policy_decisions_match_ray_tpu_in_gcs(algo):
    n_tasks = 3000
    gcs_th, conn_th = _boot_gcs(algo=algo)
    gcs_np, conn_np = _boot_jax_gcs("hybrid", algo=algo)
    gcs_jx, conn_jx = _boot_jax_gcs("jax_tpu", algo=algo)
    try:
        assert gcs_th.policy.name == "torch_cuda"
        assert gcs_th.policy.device.type == "cpu"
        assert gcs_th.policy.algo == algo
        placements = []
        for gcs, conn, testing in ((gcs_th, conn_th, torch_testing),
                                   (gcs_np, conn_np, jax_testing),
                                   (gcs_jx, conn_jx, jax_testing)):
            _submit_workload(gcs, conn, n_tasks)
            placements.append(testing.run_rounds_to_quiescence(gcs))
        p_th, p_np, p_jx = placements
        assert len(p_th) == len(p_np) == len(p_jx) == n_tasks
        for ref_name, ref in (("hybrid", p_np), ("jax_tpu", p_jx)):
            mismatches = {t: (p_th[t], ref[t]) for t in ref if p_th[t] != ref[t]}
            assert not mismatches, (
                f"{len(mismatches)}/{n_tasks} placements differ from ray_tpu's "
                f"{ref_name} GCS, e.g. {dict(list(mismatches.items())[:5])}"
            )
        # the device-side scheduler was used, not the NumPy twin
        assert gcs_th.policy._torch is not None
    finally:
        gcs_th.shutdown()
        gcs_np.shutdown()
        gcs_jx.shutdown()


@pytest.mark.parametrize("algo", ALGOS)
def test_torch_policy_10k_tasks_through_gcs(algo):
    """Volume: 10k task metas through _schedule_round on the device-side
    policy; everything places, nothing leaks."""
    gcs, conn = _boot_gcs(n_nodes=64, algo=algo)
    try:
        _submit_workload(gcs, conn, 10_000, seed=3)
        placements = run_rounds_to_quiescence(gcs, max_rounds=400)
        assert len(placements) == 10_000
        with gcs._lock:
            assert not gcs.pending
            assert not gcs.waiting_tasks
            assert not gcs.active_outputs
    finally:
        gcs.shutdown()


def test_gcs_default_config_builds_cuda_policy(monkeypatch):
    """GcsServer() with no config builds its policy on CUDA (the port's
    default), so without a card it raises before any thread starts; asking
    for the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        GcsServer()
    for cpu_request in ({"scheduler_device": "cpu"}, {"scheduling_policy": "hybrid"}):
        gcs = GcsServer(config=Config(cpu_request))
        try:
            park_scheduler_loop(gcs)
            assert gcs.policy.name == (
                "hybrid" if "scheduling_policy" in cpu_request else "torch_cuda")
        finally:
            gcs.shutdown()


@pytest.mark.parametrize("algo", ALGOS)
def test_pipelined_torch_policy_places_everything(algo):
    """Deep-pipelined device rounds through the GCS: placements lag by the
    window depth but every task lands, nothing double-schedules, and the
    cluster view balances to empty."""
    gcs, conn = _boot_gcs(n_nodes=64, algo=algo, pipeline_depth=4)
    try:
        assert gcs.policy.pipelined
        _submit_workload(gcs, conn, 5_000, seed=11)
        placements = run_rounds_to_quiescence(gcs, max_rounds=600)
        assert len(placements) == 5_000
        with gcs._lock:
            assert not gcs.pending
            assert not gcs._class_buckets
            assert not gcs.waiting_tasks
            assert not gcs.active_outputs
            assert not gcs.policy.has_inflight()
            np.testing.assert_allclose(
                gcs.state.available, gcs.state.total * gcs.state.alive[:, None],
                atol=1e-3,
            )
    finally:
        gcs.shutdown()


@pytest.mark.parametrize("algo", ALGOS)
def test_pipelined_guard_discards_window(monkeypatch, caplog, algo):
    """A corrupted device result on the pipelined fetch discards the whole
    in-flight window, re-syncs, and the stream still completes."""
    gcs, conn = _boot_gcs(n_nodes=16, algo=algo, pipeline_depth=2)
    try:
        real_fetch = TorchScheduler.fetch
        poisoned = {"n": 1}

        def bad_fetch(self, handle):
            out = real_fetch(self, handle)
            if poisoned["n"] > 0 and out.size:
                poisoned["n"] -= 1
                out = out.copy()
                out[:, 0] += 1000  # over-assign node 0
            return out

        monkeypatch.setattr(TorchScheduler, "fetch", bad_fetch)
        _submit_workload(gcs, conn, 1_000, seed=12)
        with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
            placements = run_rounds_to_quiescence(gcs, max_rounds=600)
        assert "invariant" in caplog.text
        assert len(placements) == 1_000
    finally:
        gcs.shutdown()


@pytest.mark.parametrize("algo", ALGOS)
def test_pipelined_topology_change_mid_window(algo):
    """Node add/remove while rounds are in flight: the window (and any
    buffered ready plans) is discarded with host debits credited back; no
    shape crash, no lost capacity."""
    st = NodeResourceState(space=ResourceSpace())
    for i in range(8):
        st.add_node(f"n{i}", {"CPU": 8})
    pol = make_policy_from_config(Config({
        "scheduling_policy": "torch_cuda", "scheduler_device": "cpu",
        "scheduler_kernel_algo": algo, "jax_policy_min_cells": 0,
        "jax_policy_pipeline_depth": 3,
    }))
    demands = np.zeros((2, 16), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 2.0
    placed = np.zeros(2, np.int64)
    remaining = np.array([40, 20], np.int64)
    used_cpu = np.zeros(16)

    def take(plan):
        nonlocal placed, remaining
        if plan is None:
            return
        _, d_r, assigned = plan
        got = assigned.sum(axis=1)
        placed += got
        remaining -= got
        per_node = (assigned.astype(np.float64).T @ d_r)[:, 0]
        used_cpu[: len(per_node)] += per_node

    for r in range(30):
        if remaining.sum() <= 0 and not pol.has_inflight():
            break
        counts = np.maximum(remaining, 0).astype(np.int32)
        take(pol.schedule_pipelined(st, demands, counts, ["a", "b"]))
        if r == 2:
            st.add_node("late", {"CPU": 8})
        if r == 5:
            st.remove_node("n0")
    for _ in range(10):
        if not pol.has_inflight():
            break
        take(pol.schedule_pipelined(
            st, np.zeros((0, 16), np.float32), np.zeros(0, np.int32), []))
    assert placed.sum() > 0
    actual = (st.total * st.alive[:, None] - st.available)[:, 0]
    for i in range(len(st.node_ids)):
        if st.alive[i]:
            assert abs(actual[i] - used_cpu[i]) < 1e-3, (i, actual[i], used_cpu[i])


# --------------------------------------- tests/test_inflight_voucher.py


@pytest.fixture()
def voucher_gcs():
    g = GcsServer(config=Config({
        "scheduler_device": "cpu",
        "scheduler_round_interval_ms": 60_000.0,
        "own_inflight_lease_s": 5.0,
    }))
    try:
        park_scheduler_loop(g)
        register_fake_nodes(g, 2, lambda i: {"CPU": 4})
        yield g
    finally:
        g.shutdown()


def _submit_dep(gcs, conn, tid, deps):
    return gcs.rpc_submit_task(
        {"task_id": tid, "class_key": 1, "resources": {"CPU": 1},
         "num_returns": 1, "owner": "drv", "deps": deps},
        conn,
    )


def test_fresh_voucher_parks_instead_of_deps_lost(voucher_gcs):
    r = _submit_dep(voucher_gcs, FakeConn(), "t-fresh",
                    [{"id": "obj-pending", "own_inflight": time.time()}])
    assert r.get("ok", True), r
    voucher_gcs._schedule_round()
    assert "t-fresh" in voucher_gcs.waiting_tasks


def test_no_voucher_is_deps_lost(voucher_gcs):
    r = _submit_dep(voucher_gcs, FakeConn(), "t-naked", [{"id": "obj-nowhere"}])
    assert r.get("deps_lost") == ["obj-nowhere"], r


def test_expired_voucher_is_deps_lost(voucher_gcs):
    r = _submit_dep(voucher_gcs, FakeConn(), "t-stale",
                    [{"id": "obj-gone", "own_inflight": time.time() - 60.0}])
    assert r.get("deps_lost") == ["obj-gone"], r


def test_voucher_retired_once_object_produced(voucher_gcs):
    gcs = voucher_gcs
    conn = FakeConn()
    _submit_dep(gcs, conn, "t-oneshot",
                [{"id": "obj-late", "own_inflight": time.time()}])
    gcs._schedule_round()
    assert "t-oneshot" in gcs.waiting_tasks
    node_id = next(iter(gcs.nodes))
    gcs.rpc_add_object_location({"object_id": "obj-late", "node_id": node_id}, conn)
    assert "t-oneshot" not in gcs.waiting_tasks
    gcs._schedule_round()
    info = gcs.running.get("t-oneshot")
    assert info is not None, "task did not dispatch after dep arrived"
    deps = info["meta"].get("deps") or ()
    assert deps and all("own_inflight" not in d for d in deps), deps
