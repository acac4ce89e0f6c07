"""The pipelined torch_cuda window and the host's out-of-band debits.

A pipelined round is solved against the device's availability and stays
in flight until a later call fetches it; the guard then checks it against
the host's availability at fetch time. An out-of-band ``state.allocate``
(node affinity, node labels, placement-group bundles, compiled-graph
stages, speculative copies) made while such a round is in flight debits
the host under the round's feet: the two together overcommit the node,
and the guard rightly discards the round. ``HybridPolicy.flush`` fetches
the window first, so the out-of-band debit sees the true availability and
fails where there is no room.

- Policy level, deterministic: three nodes of 1 CPU, window depth 2, a
  round of one task in flight, node n's CPU debited out of band (n where
  the NumPy twin places the task). Without a flush the guard warns (the
  overcommit is real); with ``flush`` first the allocate fails, the task
  lands once on n, and no guard record is written.
- GCS level: a plain task and a hard NODE_AFFINITY task to the same node
  through ``_schedule_round``: every task placed exactly once, no node
  over its total at any round, no guard record.
- GCS level: a placement group of one 1-CPU bundle on every node
  (STRICT_SPREAD) staged while a round that places a task is in flight.
  With the GCS's flush the group waits (PENDING) until the task is done,
  then takes every node, and no guard record is written; with the flush
  taken out the staging overcommits and the guard warns.
"""

import logging

import numpy as np
import pytest

from ray_tpu_torch.cluster.gcs import GcsServer
from ray_tpu_torch.cluster.testing import (
    FakeConn,
    complete_running,
    park_scheduler_loop,
    register_fake_nodes,
)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.sched.policy import HybridPolicy
from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace

GUARD = "violated scheduling invariant"
N_NODES = 3


def _state():
    st = NodeResourceState(space=ResourceSpace())
    for i in range(N_NODES):
        st.add_node(f"n{i}", {"CPU": 1})
    return st


def _one_cpu():
    d = np.zeros((1, 16), np.float32)
    d[0, 0] = 1.0
    return d


def _twin_node():
    """The node the bit-identical NumPy twin gives one 1-CPU task."""
    assigned = HybridPolicy(backend="numpy").schedule(_state(), _one_cpu(),
                                                      np.ones(1, np.int32))
    return int(np.flatnonzero(assigned[0])[0])


def _drain(pol, st):
    plans = []
    for _ in range(8):
        if not pol.has_inflight():
            break
        plan = pol.schedule_pipelined(st, np.zeros((0, 16), np.float32),
                                      np.zeros(0, np.int32), [])
        if plan is not None:
            plans.append(plan)
    return plans


@pytest.mark.parametrize("flush", [False, True], ids=["raw_allocate", "flush_first"])
def test_out_of_band_debit_mid_window(caplog, flush):
    st = _state()
    pol = HybridPolicy(backend="torch", device="cpu", device_min_cells=0, pipeline_depth=2)
    n = _twin_node()
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
        assert pol.schedule_pipelined(st, _one_cpu(), np.ones(1, np.int32), ["a"]) is None
        assert pol.has_inflight()
        if flush:
            pol.flush(st)
        granted = st.allocate(n, _one_cpu()[0])
        plans = _drain(pol, st)
    if not flush:
        # the round and the debit both took node n's one CPU: the guard
        # discards the round, as it must for a real overcommit
        assert granted and GUARD in caplog.text
        assert f"at node {n} resource 0" in caplog.text
        return
    assert not granted
    assert GUARD not in caplog.text
    assert len(plans) == 1 and list(plans[0][0]) == ["a"]
    placed = plans[0][2][0]
    assert placed.sum() == 1 and placed[n] == 1
    assert st.available[n, 0] == 0.0 and (st.available >= 0).all()
    assert not pol.has_inflight()


def test_flush_discards_a_window_of_another_topology():
    st = _state()
    pol = HybridPolicy(backend="torch", device="cpu", device_min_cells=0, pipeline_depth=2)
    pol.schedule_pipelined(st, _one_cpu(), np.ones(1, np.int32), ["a"])
    st.add_node("late", {"CPU": 1})
    pol.flush(st)
    assert not pol.has_inflight()
    np.testing.assert_array_equal(st.available[:, 0], np.ones(N_NODES + 1))


def test_node_joining_with_plans_buffered_credits_them_back(caplog):
    """A node joins (an autoscaler's launch) while a fetched plan waits in
    the ready buffer: the topology change discards the plan and credits its
    host debit back into the rows it was solved for (rows are only ever
    appended), the new row stays whole, and the next round places its task
    once on the grown cluster."""
    st = _state()
    pol = HybridPolicy(backend="torch", device="cpu", device_min_cells=0, pipeline_depth=2)
    pol.schedule_pipelined(st, _one_cpu(), np.ones(1, np.int32), ["a"])
    pol.flush(st)
    assert len(pol._ready) == 1 and st.available[:, 0].sum() == N_NODES - 1
    st.add_node("late", {"CPU": 1})
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
        first = pol.schedule_pipelined(st, _one_cpu(), np.ones(1, np.int32), ["b"])
        assert not pol._ready
        if first is None:
            np.testing.assert_array_equal(st.available[:, 0], np.ones(N_NODES + 1))
        plans = ([first] if first is not None else []) + _drain(pol, st)
    assert GUARD not in caplog.text
    assert [list(p[0]) for p in plans] == [["b"]] and plans[0][2].sum() == 1
    assert st.available[:, 0].sum() == N_NODES


def _submit(gcs, conn, tid, strategy=None):
    spec = {"task_id": tid, "class_key": (("CPU", 1),), "resources": {"CPU": 1},
            "num_returns": 1}
    if strategy is not None:
        spec["strategy"] = strategy
    gcs.rpc_submit_task(spec, conn)


def _pipelined_gcs():
    return GcsServer(config=Config({
        "scheduling_policy": "torch_cuda", "scheduler_device": "cpu",
        "scheduler_round_interval_ms": 60_000.0, "jax_policy_min_cells": 0,
        "jax_policy_pipeline_depth": 2,
    }))


def test_gcs_affinity_debit_mid_window_places_each_task_once(caplog):
    gcs = _pipelined_gcs()
    try:
        park_scheduler_loop(gcs)
        register_fake_nodes(gcs, N_NODES, lambda i: {"CPU": 1})
        conn = FakeConn()
        target = f"node-{_twin_node()}"
        _submit(gcs, conn, "plain")
        _submit(gcs, conn, "pinned", {"kind": "NODE_AFFINITY", "node_id": target,
                                      "soft": False})
        placements = {}
        with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
            for rnd in range(12):
                gcs._schedule_round()
                with gcs._lock:
                    used = np.zeros(N_NODES)
                    for tid, info in gcs.running.items():
                        assert placements.setdefault(tid, info["node_id"]) == info["node_id"]
                        used[gcs.state.node_index(info["node_id"])] += info["demand"][0]
                    assert (used <= gcs.state.total[:, 0]).all(), (rnd, used)
                    assert (gcs.state.available >= 0).all()
                    done = sorted(gcs.running) if rnd % 3 == 2 else []
                complete_running(gcs, done)
                with gcs._lock:
                    if gcs.pending_task_count() == 0 and not gcs.running \
                            and not gcs.policy.has_inflight():
                        break
        assert GUARD not in caplog.text
        assert sorted(placements) == ["pinned", "plain"]
        assert placements["pinned"] == target
    finally:
        gcs.shutdown()


@pytest.mark.parametrize("flush", [False, True], ids=["no_flush", "flush_first"])
def test_gcs_placement_group_mid_window(caplog, flush):
    gcs = _pipelined_gcs()
    try:
        park_scheduler_loop(gcs)
        register_fake_nodes(gcs, N_NODES, lambda i: {"CPU": 1})
        if not flush:
            gcs._flush_before_debit = lambda: None
        _submit(gcs, FakeConn(), "plain")
        bundles = [{"CPU": 1}] * N_NODES
        with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
            gcs._schedule_round()
            with gcs._lock:
                assert gcs.policy.has_inflight()
                staged = gcs._stage_pg_locked("pg", bundles, "STRICT_SPREAD")
            for _ in range(4):
                gcs._schedule_round()
        if not flush:
            # the group took every node's CPU under the round's feet: the
            # round overcommits, and the guard discards it
            assert staged is not None and GUARD in caplog.text
            return
        assert staged is None and gcs.placement_groups["pg"]["state"] == "PENDING"
        with gcs._lock:
            assert sorted(gcs.running) == ["plain"]
            node = gcs.running["plain"]["node_id"]
            assert gcs.state.available[gcs.state.node_index(node), 0] == 0.0
            assert (gcs.state.available >= 0).all()
        complete_running(gcs, ["plain"])
        with gcs._lock:
            assert not gcs.policy.has_inflight()
            staged = gcs._stage_pg_locked("pg", bundles, "STRICT_SPREAD")
            assert sorted(staged) == [f"node-{i}" for i in range(N_NODES)]
            np.testing.assert_array_equal(gcs.state.available[:, 0], np.zeros(N_NODES))
        assert GUARD not in caplog.text
    finally:
        gcs.shutdown()
