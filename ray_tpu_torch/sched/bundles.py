"""Placement-group bundle packing: STRICT_PACK / PACK / SPREAD / STRICT_SPREAD.

Reference: src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc
(BundlePackSchedulingPolicy etc., node scoring via LeastResourceScorer) driven
by src/ray/gcs/gcs_server/gcs_placement_group_scheduler.cc. Semantics are
all-or-nothing: either every bundle gets a node or the PG fails this round
(the 2PC prepare/commit against node daemons lives in the control plane, not
here — this module is the pure packing math).

STRICT_PACK reduces to a single summed demand, which lets many PGs be packed
as one batched-kernel call (`strict_pack_batch`) — the vectorized bin-packing
path of BASELINE.json config 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ray_tpu_torch.sched import kernel_np
from ray_tpu_torch.sched.kernel_np import EPS


def _least_resource_score(avail_after: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Best-fit score per node: mean remaining fraction after placement —
    lower is better (reference: LeastResourceScorer::Score, which rewards
    nodes left with the least slack)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total > 0, avail_after / np.maximum(total, EPS), 0.0)
    denom = np.maximum((total > 0).sum(axis=1), 1)
    return (frac.sum(axis=1) / denom).astype(np.float32)


def schedule_bundles(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    bundles: np.ndarray,
    strategy: str = "PACK",
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Place one PG's bundles[B, R]. Returns (nodes[B] int32 or None on
    failure, new availability). All-or-nothing."""
    avail = avail.astype(np.float32).copy()
    B = bundles.shape[0]
    N = avail.shape[0]
    out = np.full(B, -1, dtype=np.int32)

    if strategy == "STRICT_PACK":
        demand = bundles.sum(axis=0)
        feas = kernel_np.feasible_mask(avail, alive, demand)
        if not feas.any():
            return None, avail
        score = _least_resource_score(avail - demand[None, :], total)
        score = np.where(feas, score, np.float32(np.inf))
        n = int(np.argmin(score))
        out[:] = n
        avail[n] = np.maximum(avail[n] - demand, 0.0)
        return out, avail

    used_nodes = np.zeros(N, dtype=bool)
    # Larger bundles first so best-fit has room to work (stable within ties).
    order = np.argsort(-bundles.sum(axis=1), kind="stable")
    for b in order:
        d = bundles[b]
        feas = kernel_np.feasible_mask(avail, alive, d)
        if strategy == "STRICT_SPREAD":
            feas = feas & ~used_nodes
        if not feas.any():
            return None, avail
        score = _least_resource_score(avail - d[None, :], total)
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            # Prefer unused nodes; among them spread by *most* slack.
            score = -score
            if strategy == "SPREAD" and (feas & ~used_nodes).any():
                feas = feas & ~used_nodes
        score = np.where(feas, score, np.float32(np.inf))
        n = int(np.argmin(score))
        out[b] = n
        used_nodes[n] = True
        avail[n] = np.maximum(avail[n] - d, 0.0)
    return out, avail


def strict_pack_batch(
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    pg_demands: np.ndarray,
    backend: str = "numpy",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place many STRICT_PACK PGs at once: pg_demands[P, R] are summed bundle
    demands; each PG is a scheduling class with count 1, so this is exactly
    one batched-kernel call (device-vectorized bin-packing, config 4).
    backend="torch" runs kernel_torch.schedule_classes on `device` (CUDA
    unless the caller asks for the CPU).

    Returns (node[P] int32 or -1, new availability)."""
    P = pg_demands.shape[0]
    counts = np.ones(P, dtype=np.int32)
    if backend == "torch":
        import torch

        from ray_tpu_torch.sched import kernel_torch

        dev = kernel_torch.resolve_device(device)
        pad = kernel_torch.bucket_size(P)
        d, k = kernel_torch.pad_problem(pg_demands.astype(np.float32), counts, pad)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        assigned, new_avail = kernel_torch.schedule_classes(
            put(np.asarray(avail, np.float32)), put(np.asarray(total, np.float32)),
            put(np.asarray(alive, bool)), put(d), put(k),
        )
        assigned = assigned[:P].cpu().numpy()
        new_avail = new_avail.cpu().numpy()
    else:
        assigned, new_avail = kernel_np.schedule_classes(
            avail, total, alive, pg_demands.astype(np.float32), counts
        )
    nodes = np.where(
        assigned.sum(axis=1) > 0, assigned.argmax(axis=1), -1
    ).astype(np.int32)
    return nodes, new_avail
