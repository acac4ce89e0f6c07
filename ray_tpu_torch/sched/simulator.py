"""Discrete-event makespan simulator for scheduler-quality measurement.

The north star (BASELINE.json) requires the batched device kernel to match the
reference's default per-task policy makespan within 3%. The reference has no
in-tree simulator; its scheduling quality is observed through release tests
(release/benchmarks/distributed/test_scheduling.py). Here quality is measured
directly: run the SAME synthetic timed workload to completion under

- ``greedy``  — per-task hybrid placement (`kernel_np.greedy_assign`
  semantics, the comparator: one task at a time, full rescore between tasks,
  mirroring ClusterResourceScheduler::GetBestSchedulableNode), and
- ``classes`` / ``rounds`` — the batched kernels (`schedule_classes`,
  `schedule_classes_rounds`) that place whole class-grouped queues per round,

and report makespan (the tick the last task finishes) for each. Time is
integer ticks; all tasks arrive at t=0 (offline makespan — the regime the
1M-task north-star round targets). Scheduling happens at t=0 and whenever
completions free resources, matching the event-driven reference loop
(ScheduleAndDispatchTasks runs on every state change).

Tasks are FIFO within a class and classes are visited in index order by both
schedulers, so the only difference measured is placement quality, not order.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.sched import kernel_np


@dataclass
class SimResult:
    makespan: int
    rounds: int
    decisions: int
    sched_time_s: float  # host time spent inside scheduler calls
    unplaced: int  # tasks that could never be placed (infeasible forever)


def _greedy_round(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    queue: List[int],
    spread_threshold: float,
) -> List[Tuple[int, int]]:
    """Place queued tasks one at a time (reference semantics). Mutates
    `avail` and `queue`. Returns [(class, node_row)] placements in order.

    A class whose demand fits nowhere is skipped for the whole round (exact:
    feasibility is class-wide, so no later task of that class could place
    either)."""
    placements: List[Tuple[int, int]] = []
    C = demands.shape[0]
    for c in range(C):
        while queue[c] > 0:
            d = demands[c]
            feas = kernel_np.feasible_mask(avail, alive, d)
            if not feas.any():
                break
            score = kernel_np.node_scores(avail, total, spread_threshold)
            score = np.where(feas, score, np.float32(np.inf))
            n = int(np.argmin(score))
            avail[n] = np.maximum(avail[n] - d, 0.0)
            queue[c] -= 1
            placements.append((c, n))
    return placements


def _batched_round(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    queue: List[int],
    spread_threshold: float,
    algo: str,
    torch_sched=None,
) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """One batched kernel round over the whole queue (most-constrained
    classes first, like the production policy). Returns (placements,
    new_avail); mutates `queue`."""
    order = kernel_np.constrained_order(total, alive, demands)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    demands = demands[order]
    counts = np.array(queue, dtype=np.int32)[order]
    if torch_sched is not None:
        # the host view is authoritative (completions freed resources since
        # the last round); push it to the device before scheduling. The
        # simulator's "classes" scheduler is the scan kernel (K1).
        torch_sched.set_available(avail)
        assigned = torch_sched.schedule(
            demands, counts, spread_threshold,
            algo="scan" if algo == "classes" else algo,
        )
        taken = assigned.astype(np.float32).T @ demands
        new_avail = np.maximum(avail - taken, 0.0)
    elif algo == "rounds":
        assigned, new_avail = kernel_np.schedule_classes_rounds(
            avail, total, alive, demands, counts,
            spread_threshold=spread_threshold,
        )
    elif algo == "chunked":
        assigned, new_avail = kernel_np.schedule_classes_chunked(
            avail, total, alive, demands, counts,
            spread_threshold=spread_threshold,
        )
    else:
        assigned, new_avail = kernel_np.schedule_classes(
            avail, total, alive, demands, counts,
            spread_threshold=spread_threshold,
        )
    assigned = np.asarray(assigned)[inv]  # back to caller's class indexing
    demands = demands[inv]
    placements: List[Tuple[int, int]] = []
    for c in range(demands.shape[0]):
        row = assigned[c]
        placed = int(row.sum())
        if placed <= 0:
            continue
        queue[c] -= placed
        for n in np.flatnonzero(row):
            placements.extend([(c, int(n))] * int(row[n]))
    return placements, new_avail


def simulate_makespan(
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    counts: np.ndarray,
    durations: Sequence[np.ndarray],
    scheduler: str = "greedy",
    spread_threshold: float = 0.5,
    torch_sched=None,
    max_rounds: int = 1_000_000,
) -> SimResult:
    """Run a workload to completion; return the makespan in ticks.

    Args:
      total: [N, R] cluster capacity; alive: [N] bool.
      demands: [C, R] per-class demand vectors.
      counts: [C] task counts (all arrive at t=0).
      durations: per-class int arrays, durations[c][i] = ticks for the i-th
        task of class c (consumed FIFO — both schedulers hand tasks out in
        class order, so task i of class c gets the same duration under both).
      scheduler: "greedy" | "classes" | "rounds" | "chunked".
      torch_sched: optional kernel_torch.TorchScheduler to run the batched kernels
        on device (its avail view must start equal to `total*alive`).
    """
    import time as _time

    avail = total.astype(np.float32).copy()
    avail *= alive[:, None].astype(np.float32)
    total = np.asarray(total, np.float32)
    C = demands.shape[0]
    queue = [int(c) for c in counts]
    next_task = [0] * C  # FIFO duration cursor per class
    events: List[Tuple[int, int, int]] = []  # (t_end, class, node)
    now = 0
    n_rounds = 0
    decisions = 0
    sched_time = 0.0
    total_tasks = int(sum(queue))

    def run_sched() -> int:
        nonlocal decisions, sched_time
        t0 = _time.perf_counter()
        if scheduler == "greedy":
            placements = _greedy_round(
                avail, total, alive, demands, queue, spread_threshold
            )
        else:
            placements, new_avail = _batched_round(
                avail, total, alive, demands, queue, spread_threshold,
                algo=scheduler, torch_sched=torch_sched,
            )
            avail[:] = new_avail
        sched_time += _time.perf_counter() - t0
        for c, n in placements:
            i = next_task[c]
            next_task[c] = i + 1
            dur = int(durations[c][i])
            heapq.heappush(events, (now + max(dur, 1), c, n))
        decisions += len(placements)
        return len(placements)

    run_sched()
    n_rounds += 1
    makespan = 0
    while events and n_rounds < max_rounds:
        now = events[0][0]
        # free everything completing at this tick, then one scheduling pass
        while events and events[0][0] == now:
            _, c, n = heapq.heappop(events)
            avail[n] = np.minimum(avail[n] + demands[c], total[n])
        makespan = now
        if any(q > 0 for q in queue):
            run_sched()
            n_rounds += 1
    unplaced = int(sum(queue))
    return SimResult(
        makespan=makespan,
        rounds=n_rounds,
        decisions=decisions,
        sched_time_s=sched_time,
        unplaced=unplaced,
    )


def makespan_gap_pct(
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    counts: np.ndarray,
    durations: Sequence[np.ndarray],
    scheduler: str = "classes",
    spread_threshold: float = 0.5,
    torch_sched=None,
) -> Dict[str, float]:
    """Run greedy (reference comparator) and the batched scheduler on the
    identical workload; gap > 0 means the batched schedule is worse."""
    g = simulate_makespan(
        total, alive, demands, counts, durations, "greedy",
        spread_threshold,
    )
    b = simulate_makespan(
        total, alive, demands, counts, durations, scheduler,
        spread_threshold, torch_sched=torch_sched,
    )
    gap = (
        100.0 * (b.makespan - g.makespan) / g.makespan
        if g.makespan > 0 else 0.0
    )
    return {
        "makespan_greedy": g.makespan,
        "makespan_batched": b.makespan,
        "makespan_gap_pct": round(gap, 3),
        "greedy_rounds": g.rounds,
        "batched_rounds": b.rounds,
        "greedy_sched_s": round(g.sched_time_s, 4),
        "batched_sched_s": round(b.sched_time_s, 4),
        "unplaced_greedy": g.unplaced,
        "unplaced_batched": b.unplaced,
    }


def make_workload(
    rng: np.random.Generator,
    n_nodes: int,
    n_classes: int,
    n_tasks: int,
    r_dim: int = 16,
    heterogeneous: bool = True,
    gpu_frac: float = 0.0,
    custom_frac: float = 0.0,
    load_factor: float = 0.8,
    dur_range: Tuple[int, int] = (1, 20),
    target_waves: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]:
    """Synthetic cluster + class-grouped workload generator shared by the
    benchmark configs (BASELINE.json configs 1-3) and tests.

    Column convention matches resources.PREDEFINED_RESOURCES:
    0=CPU, 1=GPU, 2=TPU, 3=memory; columns >=5 are custom resources.
    """
    total = np.zeros((n_nodes, r_dim), np.float32)
    if heterogeneous:
        total[:, 0] = rng.integers(16, 129, n_nodes)
        total[:, 3] = rng.integers(64, 513, n_nodes)
    else:
        total[:, 0] = 64.0
        total[:, 3] = 256.0
    if gpu_frac > 0:
        has_gpu = rng.random(n_nodes) < gpu_frac
        total[has_gpu, 1] = rng.choice([4.0, 8.0], int(has_gpu.sum()))
    if custom_frac > 0:
        has_c = rng.random(n_nodes) < custom_frac
        total[has_c, 5] = 16.0
    alive = np.ones(n_nodes, bool)

    demands = np.zeros((n_classes, r_dim), np.float32)
    demands[:, 0] = rng.integers(1, 5, n_classes)
    mem_heavy = rng.random(n_classes) < 0.4
    demands[mem_heavy, 3] = rng.integers(1, 9, int(mem_heavy.sum()))
    if gpu_frac > 0:
        gpu_c = rng.random(n_classes) < 0.2
        demands[gpu_c, 1] = rng.integers(1, 3, int(gpu_c.sum()))
    if custom_frac > 0:
        cus = rng.random(n_classes) < 0.15
        demands[cus, 5] = 1.0
    counts = rng.multinomial(
        n_tasks, np.ones(n_classes) / n_classes
    ).astype(np.int32)

    # With target_waves set, rescale CPU capacity so the workload needs about
    # that many full waves through the cluster (contention is what makes
    # makespan differences visible; a single-wave run measures nothing).
    if target_waves is not None:
        cpu_demand = float((demands[:, 0] * counts).sum())
        want_capacity = cpu_demand / (load_factor * target_waves)
        scale = want_capacity / max(float(total[:, 0].sum()), 1.0)
        total[:, 0] = np.maximum(np.round(total[:, 0] * scale), 4.0)
    durations = [
        rng.integers(dur_range[0], dur_range[1] + 1, int(k)).astype(np.int64)
        for k in counts
    ]
    return total, alive, demands, counts, durations
