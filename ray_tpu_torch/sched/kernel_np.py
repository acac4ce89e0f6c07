"""NumPy reference scheduler kernels (the CPU fallback path).

These define the authoritative scheduling semantics; `kernel_jax` implements
the *identical math* under jit and is golden-tested for decision equality
(mirroring how the reference tests schedulers as pure functions on synthetic
resource views — e.g. src/ray/raylet/scheduling/cluster_resource_scheduler_test.cc,
policy/hybrid_scheduling_policy_test.cc).

Semantics reproduced from the reference's default HybridSchedulingPolicy
(src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc):
- a node's score is its *critical resource utilization* (max over resources of
  used/total), flattened to 0 while under `spread_threshold` (default 0.5,
  RAY_CONFIG scheduler_spread_threshold in src/ray/common/ray_config_def.h);
- the best (lowest-score) feasible node wins; ties break toward the lowest
  row index, and row 0 is the local node — giving the reference's
  pack-local-until-threshold-then-spread behavior.

Deliberate divergence: the reference adds top-k random tiebreak
(scheduler_top_k_fraction) to avoid thundering herds of independent raylets;
our decisions are made in batched rounds by one kernel, so they are kept
deterministic — required for NumPy/JAX decision equality.

Two granularities:
- `greedy_assign`: per-task loop, bit-exact reference semantics, used for
  small queues and as the makespan comparator.
- `schedule_classes`: the batched kernel. Tasks are grouped by *scheduling
  class* (identical demand vector — the same equivalence the reference uses
  for lease reuse in src/ray/core_worker/transport/normal_task_submitter.cc),
  and the kernel assigns per-class counts to nodes in vectorized passes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EPS = 1e-4
INF_FIT = np.int32(2**30)
DEFAULT_SPREAD_THRESHOLD = 0.5
MAX_PASSES = 8


def critical_util(avail: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Per-node critical resource utilization: max_r used/total (total>0 only)."""
    used = total - avail
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total > 0, used / np.maximum(total, EPS), 0.0)
    return frac.max(axis=1).astype(np.float32)


def node_scores(
    avail: np.ndarray,
    total: np.ndarray,
    spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
) -> np.ndarray:
    util = critical_util(avail, total)
    return np.where(util >= spread_threshold, util, 0.0).astype(np.float32)


def feasible_mask(avail: np.ndarray, alive: np.ndarray, demand: np.ndarray) -> np.ndarray:
    return np.all(avail + EPS >= demand[None, :], axis=1) & alive


def greedy_assign(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-task hybrid-policy placement, one task at a time (reference loop).

    Returns (assignment[T] int32 node row or -1, new availability). Mirrors
    ClusterResourceScheduler::GetBestSchedulableNode called per task.
    """
    avail = avail.astype(np.float32).copy()
    total = np.asarray(total, dtype=np.float32)
    T = demands.shape[0]
    out = np.full(T, -1, dtype=np.int32)
    for t in range(T):
        d = demands[t]
        feas = feasible_mask(avail, alive, d)
        if not feas.any():
            continue
        score = node_scores(avail, total, spread_threshold)
        score = np.where(feas, score, np.float32(np.inf))
        n = int(np.argmin(score))  # ties -> lowest row (local-first)
        out[t] = n
        avail[n] = np.maximum(avail[n] - d, 0.0)
    return out, avail


def _class_fit(avail: np.ndarray, alive: np.ndarray, demand: np.ndarray) -> np.ndarray:
    """How many tasks of `demand` fit on each node right now. [N] int32."""
    pos = demand > 0
    if not pos.any():
        return np.where(alive, INF_FIT, 0).astype(np.int32)
    ratios = np.floor((avail[:, pos] + EPS) / demand[pos][None, :])
    fit = ratios.min(axis=1)
    fit = np.clip(fit, 0, float(INF_FIT))
    return np.where(alive, fit, 0).astype(np.int32)


def _threshold_cap(
    avail: np.ndarray,
    total: np.ndarray,
    demand: np.ndarray,
    spread_threshold: float,
) -> np.ndarray:
    """Tasks until a node's critical utilization reaches the spread threshold.

    k_n = min over r with d_r>0 of floor((thr*total_r - used_r)/d_r); the +1
    matches per-task greedy, which still places the task that *crosses* the
    threshold (scores are computed before placement).
    """
    pos = demand > 0
    if not pos.any():
        return np.full(avail.shape[0], INF_FIT, dtype=np.int32)
    used = total - avail
    head = spread_threshold * total[:, pos] - used[:, pos]
    k = np.floor((head + EPS) / demand[pos][None, :]).min(axis=1)
    k = np.clip(k, 0, float(INF_FIT) - 1)
    return (k + 1).astype(np.int32)


def _fill_by_score(
    take_cap: np.ndarray, score: np.ndarray, remaining: int
) -> np.ndarray:
    """Take up to `take_cap[n]` from nodes in ascending-score order (stable)
    until `remaining` is exhausted. Vectorized prefix fill. [N] int32."""
    order = np.argsort(score, kind="stable")
    cap_sorted = take_cap[order].astype(np.int64)
    cum = np.cumsum(cap_sorted)
    prev = cum - cap_sorted
    take_sorted = np.clip(remaining - prev, 0, cap_sorted)
    take = np.zeros_like(take_sorted)
    take[order] = take_sorted
    return take.astype(np.int32)


# Number of quantized score levels in the class kernel's fill. Sorting 10k
# float scores per class is the TPU bottleneck; quantizing utilization into
# buckets turns the sort into a one-hot cumsum (MXU/VPU work) at the cost of
# within-bucket ties breaking by node index — bounded score error 1/BUCKETS.
SCORE_BUCKETS = 64


def _score_bucket(
    util: np.ndarray, spread_threshold: float, n_buckets: int = SCORE_BUCKETS
) -> np.ndarray:
    """Quantize hybrid scores: bucket 0 = under threshold; 1..B-1 = utilization
    above threshold, linearly quantized. Stable sort by bucket == sort by
    (quantized score, node index) — the deterministic tiebreak."""
    over = (util - np.float32(spread_threshold)) / np.float32(
        max(1e-6, 1.0 - spread_threshold)
    )
    over = np.clip(over, 0.0, 1.0)
    b = np.where(
        util >= spread_threshold, 1.0 + np.floor(over * (n_buckets - 2)), 0.0
    )
    return np.clip(b, 0, n_buckets - 1).astype(np.int32)


def schedule_classes(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    counts: np.ndarray,
    spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
    max_passes: int = MAX_PASSES,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched hybrid placement over scheduling classes.

    Args:
      avail, total: [N, R] float32 cluster view.
      alive: [N] bool.
      demands: [C, R] float32 per-class demand vectors.
      counts: [C] int32 pending task counts per class.
    Returns:
      (assigned[C, N] int32 counts, new availability [N, R]).
      sum(assigned[c]) < counts[c] means the remainder is currently infeasible
      (stays queued, like the reference's infeasible/waiting queues in
      cluster_task_manager.cc).

    Each class runs a few vectorized passes: fill under-threshold nodes up to
    the threshold in score order, then equal-share balance across feasible
    nodes — converging to the same shape per-task greedy produces.
    """
    avail = avail.astype(np.float32).copy()
    total = np.asarray(total, dtype=np.float32)
    C, _ = demands.shape
    N = avail.shape[0]
    assigned = np.zeros((C, N), dtype=np.int32)
    for c in range(C):
        d = demands[c]
        remaining = int(counts[c])
        for _ in range(max_passes):
            if remaining <= 0:
                break
            fit = _class_fit(avail, alive, d)
            n_feasible = int((fit > 0).sum())
            if n_feasible == 0:
                break
            util = critical_util(avail, total)
            bucket = _score_bucket(util, spread_threshold)
            under = util < spread_threshold
            cap_thresh = _threshold_cap(avail, total, d, spread_threshold)
            equal_share = np.int32(-(-remaining // n_feasible))  # ceil
            cap = np.where(under, cap_thresh, equal_share).astype(np.int32)
            cap = np.minimum(np.minimum(cap, fit), np.int32(remaining))
            take = _fill_by_score(cap, bucket.astype(np.float32), remaining)
            got = int(take.sum())
            if got == 0:
                break
            assigned[c] += take
            remaining -= got
            avail = np.maximum(avail - take[:, None].astype(np.float32) * d[None, :], 0.0)
    return assigned, avail


def _fit_matrix(avail, alive, demands):
    """[C, N] float32 fit counts; twin of kernel_jax._fit_matrix."""
    C, R = demands.shape
    N = avail.shape[0]
    fit = np.full((C, N), np.float32(INF_FIT), dtype=np.float32)
    for r in range(R):
        d_r = demands[:, r]
        ratio = np.floor(
            (avail[:, r][None, :] + np.float32(EPS))
            / np.maximum(d_r, np.float32(1e-9))[:, None]
        )
        fit = np.where(d_r[:, None] > 0, np.minimum(fit, ratio), fit)
    fit = np.clip(fit, 0.0, np.float32(INF_FIT))
    return fit * alive[None, :].astype(np.float32)


def _threshold_cap_matrix(avail, total, demands, thr):
    """[C, N] float32 tasks-until-threshold; twin of kernel_jax."""
    C, R = demands.shape
    N = avail.shape[0]
    used = total - avail
    k = np.full((C, N), np.float32(INF_FIT), dtype=np.float32)
    for r in range(R):
        d_r = demands[:, r]
        head = np.float32(thr) * total[:, r] - used[:, r]
        cap_r = np.floor(
            (head[None, :] + np.float32(EPS))
            / np.maximum(d_r, np.float32(1e-9))[:, None]
        )
        k = np.where(d_r[:, None] > 0, np.minimum(k, cap_r), k)
    return np.clip(k, 0.0, np.float32(INF_FIT) - 1.0) + np.float32(1.0)


# float32 holds ints exactly to 2**24; saturate prefix sums at 2**23.
SAT = float(1 << 23)


def _sat_cumsum(x: np.ndarray, axis: int) -> np.ndarray:
    """min(prefix_sum, SAT) — twin of kernel_jax._sat_cumsum (associative
    saturating scan == clipped exact cumsum for nonnegative inputs)."""
    return np.minimum(np.cumsum(x.astype(np.int64), axis=axis), np.int64(SAT)).astype(
        np.float32
    )


def schedule_classes_rounds(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    counts: np.ndarray,
    spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
    rounds: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of kernel_jax.schedule_classes_rounds (the jax_tpu policy's
    CPU fallback): identical math, golden-tested for decision equality.
    See the jax docstring for the algorithm and exactness bounds."""
    thr = np.float32(spread_threshold)
    avail = avail.astype(np.float32).copy()
    total = np.asarray(total, np.float32)
    demands = demands.astype(np.float32)
    C, R = demands.shape
    N = avail.shape[0]
    alive_f = alive.astype(np.float32)
    remaining = counts.astype(np.float32)
    assigned = np.zeros((C, N), np.float32)

    def claim_phase(avail_p, remaining, cap):
        capc = np.minimum(cap, np.minimum(remaining[:, None], np.float32(SAT)))
        prev = _sat_cumsum(capc, axis=1) - capc
        want = np.clip(remaining[:, None] - prev, 0.0, capc)
        take = want.copy()
        for r in range(R):
            d_r = demands[:, r]
            usage_r = want * d_r[:, None]
            # fractional demands: cumsum in float32 to mirror jax exactly is
            # not possible here (int64 path requires integer quanta); match
            # the jax scan on the integer-granular case, which _sat_cumsum
            # guarantees only for integer-valued usage.
            prev_r = _sat_cumsum_f(usage_r, axis=0) - usage_r
            head = avail_p[None, :, r] - prev_r
            fit_r = np.floor(
                (head + np.float32(EPS)) / np.maximum(d_r, np.float32(1e-9))[:, None]
            )
            take = np.where(
                d_r[:, None] > 0,
                np.minimum(take, np.clip(fit_r, 0.0, np.float32(SAT))),
                take,
            )
        return np.clip(take, 0.0, want)

    def run_phase(avail, remaining, assigned, cap):
        # node-index fill order, matching the jax twin (see its run_phase
        # comment: exact for phase A, a measured quality tradeoff for B)
        take = claim_phase(avail, remaining, cap)
        usage = np.einsum("cn,cr->nr", take, demands).astype(np.float32)
        avail = np.maximum(avail - usage, 0.0)
        return avail, remaining - take.sum(axis=1), assigned + take

    for _ in range(rounds):
        util = critical_util(avail, total)
        under = (util < thr).astype(np.float32)[None, :] * alive_f[None, :]
        fit = _fit_matrix(avail, alive, demands)
        capA = np.minimum(fit, _threshold_cap_matrix(avail, total, demands, thr))
        avail, remaining, assigned = run_phase(
            avail, remaining, assigned, capA * under
        )
        fit = _fit_matrix(avail, alive, demands)
        n_feas = (fit > 0).sum(axis=1).astype(np.float32)
        share = np.ceil(remaining / np.maximum(n_feas, np.float32(1.0)))
        capB = np.minimum(fit, share[:, None])
        avail, remaining, assigned = run_phase(avail, remaining, assigned, capB)
    return assigned.astype(np.int32), avail


def schedule_classes_chunked(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    counts: np.ndarray,
    spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
    chunk: int = 16,
    rounds: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of kernel_jax.schedule_classes_chunked: classes are placed
    `chunk` at a time by the two-phase rounds core, with availability carried
    between chunks (sequential at chunk granularity, parallel within). See
    the jax docstring for rationale; golden-tested decision equality on
    integer-granular problems. A trailing partial chunk is allowed here (the
    jax path pads instead)."""
    avail = avail.astype(np.float32).copy()
    C = demands.shape[0]
    out = []
    for s in range(0, C, chunk):
        a, avail = schedule_classes_rounds(
            avail, total, alive,
            demands[s : s + chunk], counts[s : s + chunk],
            spread_threshold, rounds,
        )
        out.append(a)
    if not out:
        return np.zeros((0, avail.shape[0]), np.int32), avail
    return np.concatenate(out, axis=0), avail


def _sat_cumsum_f(x: np.ndarray, axis: int) -> np.ndarray:
    """Saturating cumsum over possibly-fractional nonnegative float32 values.
    Sequential semantics = min(prefix, SAT); exact (and equal to the jax
    associative scan) when inputs are integer-valued with partials < 2**24."""
    cum = np.minimum(np.cumsum(x.astype(np.float64), axis=axis), SAT)
    return cum.astype(np.float32)


def feasible_node_counts(
    total: np.ndarray, alive: np.ndarray, demands: np.ndarray
) -> np.ndarray:
    """[C] how many nodes could EVER host each demand (total capacity, not
    current availability — stable across rounds). One [C, N, R] broadcast;
    shared by the simulator and the live policy so their class orderings
    can never diverge."""
    return (
        np.all(total[None, :, :] + EPS >= demands[:, None, :], axis=2)
        & alive[None, :]
    ).sum(axis=1)


def feasible_node_count(
    total: np.ndarray, alive: np.ndarray, demand: np.ndarray
) -> int:
    """Single-demand case of feasible_node_counts (policy cache misses)."""
    return int(feasible_node_counts(total, alive, demand[None, :])[0])


def constrained_order(
    total: np.ndarray, alive: np.ndarray, demands: np.ndarray
) -> np.ndarray:
    """Schedule most-constrained classes FIRST: order by feasible-node
    count. Unconstrained workloads are untouched (stable sort keeps equal
    counts in submission order); constrained ones stop losing their
    only-feasible nodes to flexible classes that could run anywhere.
    Measured effect: masked-feasibility makespan gap vs per-task greedy
    drops from ~5% to about -10% (bench config 3)."""
    return np.argsort(
        feasible_node_counts(total, alive, demands), kind="stable"
    )


def spread_assign(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demands: np.ndarray,
    start: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """SPREAD strategy: round-robin over feasible nodes (reference:
    src/ray/raylet/scheduling/policy/spread_scheduling_policy.cc)."""
    avail = avail.astype(np.float32).copy()
    T = demands.shape[0]
    N = avail.shape[0]
    out = np.full(T, -1, dtype=np.int32)
    cursor = start % max(N, 1)
    for t in range(T):
        d = demands[t]
        feas = feasible_mask(avail, alive, d)
        if not feas.any():
            continue
        # first feasible node at/after the cursor, wrapping
        idx = np.flatnonzero(feas)
        pos = np.searchsorted(idx, cursor)
        n = int(idx[pos % len(idx)])
        out[t] = n
        avail[n] = np.maximum(avail[n] - d, 0.0)
        cursor = (n + 1) % N
    return out, avail


def expand_class_assignment(
    assigned: np.ndarray, class_task_ids: list
) -> list:
    """Expand [C, N] counts into per-task (task_id, node_row) pairs.

    `class_task_ids[c]` is the ordered list of task ids in class c; tasks are
    handed out to nodes in node-row order. Host-side (not jitted).
    """
    pairs = []
    for c, ids in enumerate(class_task_ids):
        k = 0
        row = assigned[c]
        for n in np.flatnonzero(row):
            cnt = int(row[n])
            for tid in ids[k : k + cnt]:
                pairs.append((tid, int(n)))
            k += cnt
    return pairs
