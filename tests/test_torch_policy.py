"""ray_tpu_torch's torch_cuda policy (on the CPU: the plain PyTorch versions
of the kernels) against ray_tpu's policies on identical states.

Ports tests/test_jax_policy_gcs.py's incremental-sync equality and
invariant-guard tests, and drives schedule_pipelined in lockstep with
ray_tpu's jax_tpu policy, including a topology change mid-window.
"""

import logging

import numpy as np
import pytest

from ray_tpu.core.config import Config as JaxConfig
from ray_tpu.sched.policy import make_policy_from_config as jax_make_policy
from ray_tpu.sched.resources import (
    NodeResourceState as JaxNodeResourceState,
    ResourceSpace as JaxResourceSpace,
)
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.sched.kernel_torch import TorchScheduler
from ray_tpu_torch.sched.policy import make_policy_from_config
from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace

TORCH_CPU = {"scheduling_policy": "torch_cuda", "scheduler_device": "cpu",
             "jax_policy_min_cells": 0}


def _pair_states(res):
    st_t = NodeResourceState(space=ResourceSpace())
    st_j = JaxNodeResourceState(space=JaxResourceSpace())
    for i, r in enumerate(res):
        st_t.add_node(f"n{i}", r)
        st_j.add_node(f"n{i}", r)
    return st_t, st_j


def test_policy_name_and_device():
    pol = make_policy_from_config(Config(TORCH_CPU))
    assert pol.name == "torch_cuda"
    assert pol.device.type == "cpu"
    assert pol.pipelined  # default pipeline depth 8


def test_policy_incremental_sync_equality():
    """hybrid, torch_cuda (CPU) and ray_tpu's jax_tpu through interleaved
    schedule/release rounds on identical states: decisions equal round
    after round (dirty-row sync through update_rows)."""
    rng = np.random.default_rng(1)
    n = 32
    res = [{"CPU": int(rng.integers(4, 33))} for _ in range(n)]
    st_np, _ = _pair_states(res)
    st_th, st_jx = _pair_states(res)
    pol_np = make_policy_from_config(Config({"scheduling_policy": "hybrid"}))
    pol_th = make_policy_from_config(Config(TORCH_CPU))
    pol_jx = jax_make_policy(JaxConfig(
        {"scheduling_policy": "jax_tpu", "jax_policy_min_cells": 0}))
    for rnd in range(12):
        demands = np.zeros((3, 16), np.float32)
        demands[:, 0] = rng.integers(1, 4, 3)
        counts = rng.integers(0, 20, 3).astype(np.int32)
        a = pol_np.schedule(st_np, demands, counts)
        b = pol_th.schedule(st_th, demands, counts)
        c = pol_jx.schedule(st_jx, demands, counts)
        np.testing.assert_array_equal(a, b, err_msg=f"round {rnd}")
        np.testing.assert_array_equal(c, b, err_msg=f"round {rnd}")
        np.testing.assert_allclose(st_np.available, st_th.available, atol=1e-4)
        np.testing.assert_allclose(st_jx.available, st_th.available, atol=1e-4)
        for _ in range(5):
            i = int(rng.integers(0, n))
            vec = np.zeros(16, np.float32)
            vec[0] = float(rng.integers(1, 3))
            for st in (st_np, st_th, st_jx):
                st.release(i, vec)
    assert pol_th._torch is not None  # the device-side path was used


def _fresh_state(n=8, cpu=8):
    st = NodeResourceState(space=ResourceSpace())
    for i in range(n):
        st.add_node(f"n{i}", {"CPU": cpu})
    return st


@pytest.mark.parametrize("fault", ["over_demand", "over_capacity"])
def test_torch_policy_invariant_guard_fallback(monkeypatch, caplog, fault):
    """A corrupted device result is detected, logged, and replaced by the
    NumPy twin's answer for the round — never applied to the view."""
    demands = np.zeros((2, 16), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 2.0
    counts = np.array([5, 3], np.int32)
    st_ref = _fresh_state()
    pol_ref = make_policy_from_config(Config({"scheduling_policy": "hybrid"}))
    expected = pol_ref.schedule(st_ref, demands.copy(), counts.copy())

    def bad_schedule(self, demands, counts, spread_threshold, algo="scan"):
        out = np.zeros((demands.shape[0], int(self.total.shape[0])), np.int32)
        if fault == "over_demand":
            out[:, 0] = np.asarray(counts) + 1
        else:
            out[0, 0] = 5  # 5x1 + 3x2 = 11 CPUs on an 8-CPU node
            out[1, 0] = 3
        return out

    monkeypatch.setattr(TorchScheduler, "schedule", bad_schedule)
    st = _fresh_state()
    pol = make_policy_from_config(Config(TORCH_CPU))
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
        got = pol.schedule(st, demands.copy(), counts.copy())
    assert "violated scheduling invariant" in caplog.text
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_allclose(st.available, st_ref.available, atol=1e-5)


def test_torch_policy_guard_passes_clean_rounds(caplog):
    st = _fresh_state(n=16, cpu=16)
    pol = make_policy_from_config(Config(TORCH_CPU))
    rng = np.random.default_rng(3)
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.sched.policy"):
        for _ in range(8):
            demands = np.zeros((3, 16), np.float32)
            demands[:, 0] = rng.integers(1, 4, 3)
            counts = rng.integers(0, 10, 3).astype(np.int32)
            pol.schedule(st, demands, counts)
    assert "invariant" not in caplog.text


def test_pipelined_equals_jax_tpu_with_topology_change(caplog):
    """schedule_pipelined driven as the live control plane drives it
    (per-class queues, lagged plans, releases between rounds), torch_cuda
    on the CPU against ray_tpu's jax_tpu, window depth 2; a node joins
    mid-window on round 4, discarding the window on both sides."""
    rng = np.random.default_rng(9)
    n = 24
    res = [{"CPU": int(rng.integers(4, 17)), "memory": int(rng.integers(8, 33))}
           for _ in range(n)]
    st_th, st_jx = _pair_states(res)
    depth = {"jax_policy_pipeline_depth": 2}
    pol_th = make_policy_from_config(Config({**TORCH_CPU, **depth}))
    pol_jx = jax_make_policy(JaxConfig(
        {"scheduling_policy": "jax_tpu", "jax_policy_min_cells": 0, **depth}))
    assert pol_th.pipelined and pol_jx.pipelined
    C = 5
    demands = np.zeros((C, 16), np.float32)
    demands[:, 0] = rng.integers(1, 4, C)
    demands[:, 3] = np.where(rng.random(C) < 0.5, rng.integers(1, 5, C), 0)
    tags = [f"k{c}" for c in range(C)]
    queues = np.zeros(C, np.int64)
    running = []
    plans = 0
    with caplog.at_level(logging.WARNING):
        for rnd in range(40):
            if rnd < 6:
                queues += rng.integers(0, 25, C)
            if rnd == 4:
                st_th.add_node("late", {"CPU": 16, "memory": 32})
                st_jx.add_node("late", {"CPU": 16, "memory": 32})
            keys = [c for c in range(C) if queues[c] > 0]
            dem = demands[keys] if keys else np.zeros((0, 16), np.float32)
            cnt = queues[keys].astype(np.int32)
            ktags = [tags[c] for c in keys]
            p_th = pol_th.schedule_pipelined(st_th, dem, cnt, ktags)
            p_jx = pol_jx.schedule_pipelined(st_jx, dem, cnt, ktags)
            assert (p_th is None) == (p_jx is None), f"round {rnd}"
            if p_th is not None:
                plans += 1
                assert list(p_th[0]) == list(p_jx[0])
                np.testing.assert_array_equal(p_th[2], p_jx[2], err_msg=f"round {rnd}")
                for c, t in enumerate(p_th[0]):
                    queues[tags.index(t)] -= int(p_th[2][c].sum())
                    for node in np.flatnonzero(p_th[2][c]):
                        running += [(int(node), p_th[1][c])] * int(p_th[2][c, node])
            np.testing.assert_allclose(st_th.available, st_jx.available, atol=1e-4)
            for _ in range(min(15, len(running))):
                node, d = running.pop(int(rng.integers(0, len(running))))
                st_th.release(node, d)
                st_jx.release(node, d)
            if rnd > 6 and queues.sum() == 0 and not pol_th.has_inflight():
                break
    assert plans > 3
    assert queues.sum() == 0 and not pol_jx.has_inflight()
    assert "violated scheduling invariant" not in caplog.text
