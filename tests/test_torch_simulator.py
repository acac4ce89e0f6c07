"""ray_tpu_torch's makespan simulator (sched/simulator.py), the quality
gate for the batched kernels: a port of tests/test_simulator.py, with the
device-backend test holding the port's CPU TorchScheduler to the NumPy
twin for all three algorithms and the makespans held to ray_tpu's
simulator on the same workloads.
"""

import numpy as np
import pytest

from ray_tpu.sched import simulator as jax_simulator
from ray_tpu_torch.sched.simulator import (
    make_workload,
    makespan_gap_pct,
    simulate_makespan,
)

R = 16


def tiny_problem():
    total = np.zeros((4, R), np.float32)
    total[:, 0] = 4.0  # 4 nodes x 4 CPU
    alive = np.ones(4, bool)
    demands = np.zeros((1, R), np.float32)
    demands[0, 0] = 1.0
    return total, alive, demands


def test_single_wave_makespan_is_max_duration():
    # 16 CPU total, 16 1-CPU tasks: everything runs in one wave; makespan is
    # the longest duration.
    total, alive, demands = tiny_problem()
    counts = np.array([16], np.int32)
    durations = [np.array([3] * 15 + [7], np.int64)]
    for sched in ("greedy", "classes", "rounds"):
        res = simulate_makespan(
            total, alive, demands, counts, durations, scheduler=sched
        )
        assert res.makespan == 7, (sched, res)
        assert res.decisions == 16
        assert res.unplaced == 0


def test_two_waves():
    # 32 unit-duration tasks on 16 CPUs: exactly two waves.
    total, alive, demands = tiny_problem()
    counts = np.array([32], np.int32)
    durations = [np.ones(32, np.int64)]
    for sched in ("greedy", "classes", "rounds"):
        res = simulate_makespan(
            total, alive, demands, counts, durations, scheduler=sched
        )
        assert res.makespan == 2, (sched, res)
        assert res.unplaced == 0


def test_infeasible_tasks_reported_unplaced():
    total, alive, demands = tiny_problem()
    demands = demands.copy()
    demands[0, 0] = 100.0  # fits nowhere
    counts = np.array([5], np.int32)
    durations = [np.ones(5, np.int64)]
    res = simulate_makespan(
        total, alive, demands, counts, durations, scheduler="greedy"
    )
    assert res.unplaced == 5
    assert res.makespan == 0


def test_all_tasks_complete_multi_class():
    rng = np.random.default_rng(7)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=8, n_classes=6, n_tasks=300
    )
    for sched in ("greedy", "classes", "rounds"):
        res = simulate_makespan(
            total, alive, demands, counts, durations, scheduler=sched
        )
        assert res.unplaced == 0, sched
        assert res.decisions == int(counts.sum()), sched
        assert res.makespan > 0


def test_makespan_gap_small_homogeneous():
    # Config-1 shape: uniform 1-CPU tasks, 16 homogeneous nodes. The batched
    # kernel must land within the north-star 3% of per-task greedy.
    rng = np.random.default_rng(0)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=16, n_classes=1, n_tasks=1000, heterogeneous=False
    )
    demands[0] = 0.0
    demands[0, 0] = 1.0
    gap = makespan_gap_pct(total, alive, demands, counts, durations)
    assert gap["unplaced_greedy"] == 0
    assert gap["unplaced_batched"] == 0
    assert gap["makespan_gap_pct"] <= 3.0, gap


@pytest.mark.parametrize("scheduler", ["classes", "rounds", "chunked"])
def test_makespan_gap_small_heterogeneous(scheduler):
    # Config-2 shape (scaled down): mixed {cpu, mem} classes, heterogeneous
    # nodes, multiple waves.
    rng = np.random.default_rng(3)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=32, n_classes=8, n_tasks=2000
    )
    gap = makespan_gap_pct(
        total, alive, demands, counts, durations, scheduler=scheduler
    )
    assert gap["unplaced_batched"] == 0
    assert gap["makespan_gap_pct"] <= 5.0, gap


def test_masked_feasibility_gpu_custom():
    # Config-3 shape (scaled down): GPU + custom-resource constraints; only
    # some nodes qualify. Everything must still complete, and the batched
    # schedule must respect feasibility (no unplaced when greedy places all).
    rng = np.random.default_rng(11)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=64, n_classes=12, n_tasks=2000,
        gpu_frac=0.3, custom_frac=0.2,
    )
    gap = makespan_gap_pct(total, alive, demands, counts, durations)
    assert gap["unplaced_batched"] == gap["unplaced_greedy"]
    # constrained-first class ordering holds this within the north-star 3%
    # (it typically BEATS greedy here — negative gap)
    assert gap["makespan_gap_pct"] <= 3.0, gap


def test_dead_nodes_excluded():
    total, alive, demands = tiny_problem()
    alive = alive.copy()
    alive[2:] = False  # only 8 CPUs live
    counts = np.array([8], np.int32)
    durations = [np.ones(8, np.int64)]
    res = simulate_makespan(
        total, alive, demands, counts, durations, scheduler="classes"
    )
    assert res.makespan == 1
    assert res.unplaced == 0


@pytest.mark.parametrize("scheduler", ["classes", "rounds", "chunked"])
def test_makespan_gap_contended(scheduler):
    # target_waves forces real contention (~4 full waves through the
    # cluster) — the regime where placement quality shows up in makespan.
    rng = np.random.default_rng(17)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=32, n_classes=8, n_tasks=3000, target_waves=4.0
    )
    gap = makespan_gap_pct(
        total, alive, demands, counts, durations, scheduler=scheduler
    )
    assert gap["unplaced_batched"] == 0
    assert gap["greedy_rounds"] > 3  # really multi-wave
    assert gap["makespan_gap_pct"] <= 5.0, gap


@pytest.mark.parametrize("scheduler", ["classes", "rounds", "chunked"])
def test_torch_backend_matches_numpy(scheduler):
    # The device-side batched round (TorchScheduler on the CPU: the plain
    # versions of K1, K5 and K6) must give the NumPy twin's makespan and
    # decisions; the simulator's keyword for it is `torch_sched`.
    from ray_tpu_torch.sched.kernel_torch import TorchScheduler

    rng = np.random.default_rng(5)
    total, alive, demands, counts, durations = make_workload(
        rng, n_nodes=16, n_classes=4, n_tasks=400, target_waves=3.0
    )
    res_np = simulate_makespan(
        total, alive, demands, counts, durations, scheduler=scheduler
    )
    sched = TorchScheduler(total, alive, device="cpu")
    res_th = simulate_makespan(
        total, alive, demands, counts, durations, scheduler=scheduler,
        torch_sched=sched,
    )
    assert res_np.makespan == res_th.makespan
    assert res_np.decisions == res_th.decisions
    assert res_th.unplaced == 0


@pytest.mark.parametrize("scheduler", ["greedy", "classes", "rounds", "chunked"])
def test_makespan_equals_ray_tpu_simulator(scheduler):
    rng = np.random.default_rng(17)
    workload = make_workload(rng, n_nodes=32, n_classes=8, n_tasks=1500,
                             target_waves=3.0)
    rng = np.random.default_rng(17)
    jax_workload = jax_simulator.make_workload(rng, n_nodes=32, n_classes=8,
                                               n_tasks=1500, target_waves=3.0)
    for a, b in zip(workload[:4], jax_workload[:4]):
        np.testing.assert_array_equal(a, b)
    got = simulate_makespan(*workload, scheduler=scheduler)
    want = jax_simulator.simulate_makespan(*jax_workload, scheduler=scheduler)
    assert (got.makespan, got.decisions, got.unplaced, got.rounds) == (
        want.makespan, want.decisions, want.unplaced, want.rounds)
