"""Node-axis-sharded scheduling kernel: K1 with the node axis split over shards.

Counterpart of ray_tpu/sched/kernel_shard.py. The NODE axis of
avail/total/alive splits into p contiguous blocks; each shard runs the same
per-class pass as K1 (kernel_torch.schedule_classes) over its block, and the
few quantities that cross blocks ride collectives:

  - the feasible-node count and the placed total: sums of one scalar a
    shard (JAX's psum);
  - the (score-bucket, node-index) prefix order of the fill: each shard's 64
    bucket totals are gathered (JAX's all_gather), and the bucket offsets
    plus the totals of the shards before it recompose the GLOBAL prefix
    each of its nodes sees.

Three forms of the same decomposition:

  - K7, ``schedule_classes_sharded`` on CUDA tensors: K1's hand-written
    kernel (csrc/sched_kernels.cu) on one thread-block cluster of p blocks
    (p in 1, 2, 4, 8), block r owning shard r, in K1's layout
    (kernel_torch.k1_plan with p blocks); the collectives are K1's
    exchanges, pushed into the peers' shared memory. On CPU tensors the
    wrapper runs the plain version.
  - the plain version, ``_schedule_classes_sharded_plain``: the shard axis
    written out in one process ([p, N/p, R]), the collectives a sum and a
    view over it.
  - across ranks, ``make_sharded_scheduler(group)``: one shard a rank of a
    ``torch.distributed`` process group, the collectives ``all_reduce`` and
    ``all_gather`` (CPU tensors on gloo; the NCCL form on CUDA tensors is
    ROADMAP queue 1, item 3).

Decisions and availability equal kernel_np.schedule_classes (and K1)
exactly: the prefixes are exact int64 where the JAX program saturates
float32 at 2**23, which agree wherever the result depends on them because
counts stay below 2**23 (the wrapper checks). Where kernel_jax and
kernel_np differ (negative availability in a round that places nothing,
ROADMAP §3), this module follows kernel_np, as K1 does; JAX's K7 follows
kernel_jax.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ray_tpu_torch.sched import _build
from ray_tpu_torch.sched.kernel_torch import (
    DEFAULT_SPREAD_THRESHOLD,
    MAX_PASSES,
    SCORE_BUCKETS,
    _MAX_CLASS_COUNT,
    _check,
    _pass_consts,
    _pass_terms,
    k1_plan,
    resolve_device,
)
from ray_tpu_torch.util.device import current_stream as _stream
from ray_tpu_torch.util.device import device_of as _device_of

#: shard counts K7 takes: the portable thread-block cluster sizes
SHARDS = (1, 2, 4, 8)
#: threads a block of K7's cluster with the rows in shared memory and in
#: global memory (csrc/sched_kernels.cu kK7ThreadsRows, kK7ThreadsGlobal)
K7_THREADS_ROWS = 512
K7_THREADS_GLOBAL = 1024


def k7_threads(n_nodes: int, n_res: int, shards: int) -> int:
    """Threads a block of K7 for this shape: by k1_plan's row form."""
    return K7_THREADS_ROWS if k1_plan(n_nodes, n_res, shards).rows_in_smem \
        else K7_THREADS_GLOBAL


def _check_problem(avail, total, alive, demands, counts, n_shards) -> None:
    """Shapes, types, N divisible by `n_shards` and counts below 2**23
    (one read of counts' maximum); raises ValueError."""
    if avail.dim() != 2 or demands.dim() != 2:
        raise ValueError(f"avail {tuple(avail.shape)} and demands {tuple(demands.shape)} "
                         "must be [N, R] and [C, R]")
    N, R = avail.shape
    C = demands.shape[0]
    if total.shape != (N, R) or alive.shape != (N,) or demands.shape != (C, R) \
            or counts.shape != (C,):
        raise ValueError(
            f"shape mismatch: avail {tuple(avail.shape)} total {tuple(total.shape)} "
            f"alive {tuple(alive.shape)} demands {tuple(demands.shape)} "
            f"counts {tuple(counts.shape)}"
        )
    if not all(t.is_floating_point() for t in (avail, total, demands)) \
            or alive.dtype != torch.bool or counts.is_floating_point():
        raise ValueError("avail, total and demands must be float, alive bool, counts integer")
    if N % n_shards:
        raise ValueError(f"N={N} nodes do not divide over {n_shards} shards")
    if C and int(counts.max()) >= _MAX_CLASS_COUNT:
        raise ValueError("per-class count reaches 2**23; split into rounds")


def _check_shards(shards) -> None:
    if shards not in SHARDS:
        raise ValueError(f"shards={shards!r}: K7 takes {SHARDS} shards")


# ---------------------------------------------------------------- plain


def _sharded_body(avail, total, alive, demands, counts, spread_threshold, max_passes,
                  shard_index, sum_scalar: Callable, gather_buckets: Callable):
    """One round over the local shards, JAX's _sharded_body
    (kernel_shard.py:54-130) spelled out with kernel_np's control flow.

    avail/total [P, Nl, R] float32 and alive [P, Nl] bool hold the P local
    shards, whose global indices are `shard_index` [P]; demands [C, R],
    counts [C]. sum_scalar(x [P] int64) -> int is the psum over every shard;
    gather_buckets(t [P, B] int64) -> [p, B] the all_gather of every
    shard's bucket totals in shard order. Returns (assigned [C, P, Nl]
    int32, avail [P, Nl, R] float32); `avail` is not modified."""
    dev = avail.device
    avail = avail.clone()
    d_host = demands.detach().to("cpu", torch.float32).numpy()
    k_host = counts.detach().to("cpu").numpy()
    C = d_host.shape[0]
    P, Nl = alive.shape
    consts = _pass_consts(spread_threshold, dev)
    zero = consts[3]
    buckets = torch.arange(SCORE_BUCKETS, device=dev)
    assigned = torch.zeros((C, P, Nl), dtype=torch.int32, device=dev)
    for c in range(C):
        pos = torch.from_numpy(np.flatnonzero(d_host[c] > 0)).to(dev)
        d = demands[c]
        dpos = d[pos]
        remaining = int(k_host[c])
        for _ in range(max_passes):
            if remaining <= 0:
                break
            fit, bucket, under, cap_thresh = _pass_terms(avail, total, alive, pos, dpos,
                                                         consts)
            n_feasible = sum_scalar((fit > 0).sum(dim=1))  # psum (:105)
            if n_feasible == 0:
                break
            equal_share = -(-remaining // n_feasible)
            cap = torch.where(under, cap_thresh.to(torch.int64), equal_share)
            cap = torch.clamp(torch.minimum(cap, fit.to(torch.int64)), max=remaining)
            # _fill_by_bucket_sharded (:54-91) with exact int64 prefixes
            onehot = bucket[:, None, :] == buckets[None, :, None]  # [P, B, Nl]
            contrib = onehot * cap[:, None, :]
            within_excl = torch.cumsum(contrib, dim=2) - contrib
            all_tot = gather_buckets(contrib.sum(dim=2))  # [p, B] (:75)
            before = torch.cumsum(all_tot, dim=0) - all_tot  # earlier shards' totals
            bucket_tot = all_tot.sum(dim=0)
            bucket_off = torch.cumsum(bucket_tot, dim=0) - bucket_tot
            base = bucket_off[None, :] + before[shard_index]  # [P, B]
            prev = torch.gather(base[:, :, None] + within_excl, 1,
                                bucket.to(torch.int64)[:, None, :])[:, 0]
            take = torch.minimum(torch.clamp(remaining - prev, min=0), cap)
            got = sum_scalar(take.sum(dim=1))  # psum (:117)
            if got == 0:
                break
            assigned[c] += take.to(torch.int32)
            remaining -= got
            avail = torch.maximum(avail - take.to(torch.float32)[..., None] * d, zero)
    return assigned, avail


def _schedule_classes_sharded_plain(avail, total, alive, demands, counts,
                                    spread_threshold=DEFAULT_SPREAD_THRESHOLD,
                                    max_passes=MAX_PASSES, shards=8):
    """Plain PyTorch version of K7: every shard in one process, the node
    axis viewed as [shards, N/shards]; the psum is a sum and the all_gather
    a view over the shard axis. Same arguments and result as K1."""
    N, R = avail.shape
    p = shards
    assigned, new_avail = _sharded_body(
        avail.to(torch.float32).reshape(p, N // p, R),
        total.to(torch.float32).reshape(p, N // p, R),
        alive.to(torch.bool).reshape(p, N // p),
        demands.to(torch.float32), counts, spread_threshold, max_passes,
        torch.arange(p, device=avail.device),
        sum_scalar=lambda x: int(x.sum()),
        gather_buckets=lambda t: t,
    )
    return assigned.reshape(-1, N), new_avail.reshape(N, R)


# ------------------------------------------------------------------- K7


def _launch(avail, total, alive, demands, counts, spread_threshold, max_passes, shards):
    """The CUDA launch of K7 on checked arguments: K1's kernel on one
    cluster of `shards` blocks on the current stream, in k1_plan's layout.
    Raises RuntimeError, naming the shard count, where the card has no room
    for that cluster; it never takes another size."""
    dev = avail.device
    N, R = avail.shape
    C = demands.shape[0]
    lib = _build.load()
    new_avail = avail.to(torch.float32).contiguous().clone()
    total = total.to(torch.float32).contiguous()
    alive = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    plan = k1_plan(N, R, shards)
    scratch = torch.empty(max(plan.scratch_words, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_classes_sharded(
            new_avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), assigned.data_ptr(),
            scratch.data_ptr(), plan.scratch_words, N, R, C, shards,
            float(np.float32(spread_threshold)),
            float(np.float32(max(1e-6, 1.0 - spread_threshold))),
            int(max_passes), _stream(dev),
        )
    _check(lib, rc, f"schedule_classes_sharded (a cluster of {shards} blocks)")
    return assigned, new_avail


def schedule_classes_sharded(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                             demands: torch.Tensor, counts: torch.Tensor,
                             spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                             max_passes: int = MAX_PASSES, *, shards: int = 8):
    """K7. K1's round with the node axis split over `shards` (1, 2, 4 or 8)
    contiguous blocks; the semantics of kernel_np.schedule_classes.

    avail/total [N, R] float32, alive [N] bool, demands [C, R] float32,
    counts [C] integer, each below 2**23 (read back to the host to check);
    N must divide by `shards`. Returns (assigned [C, N] int32, new avail
    [N, R] float32); the input `avail` is not modified. Raises ValueError
    on arguments K7 does not take."""
    dev = _device_of(avail, total, alive, demands, counts)
    _check_shards(shards)
    _check_problem(avail, total, alive, demands, counts, shards)
    if dev.type == "cpu":
        return _schedule_classes_sharded_plain(avail, total, alive, demands, counts,
                                               spread_threshold, max_passes, shards)
    out = _launch(avail, total, alive, demands, counts, spread_threshold, max_passes, shards)
    schedule_classes_sharded.launches += 1
    return out


schedule_classes_sharded.launches = 0

#: the kernels of this module by name, each with its `launches` counter
KERNELS = {"schedule_classes_sharded": schedule_classes_sharded}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ------------------------------------------------------------ scheduler


def _tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: bool}[dtype]
    return torch.from_numpy(np.array(x, np_dtype, order="C")).to(dev)


def _group_round(group, avail, total, alive, demands, counts, thr, max_passes):
    """One round with this rank's block as its one shard: psum is
    all_reduce, the bucket totals' all_gather is all_gather, and the
    blocks of both results are all-gathered back whole."""
    import torch.distributed as dist

    p = dist.get_world_size(group)
    rank = dist.get_rank(group)
    _check_problem(avail, total, alive, demands, counts, p)
    Nl = avail.shape[0] // p
    blk = slice(rank * Nl, (rank + 1) * Nl)

    def sum_scalar(x):
        s = x.sum().reshape(1)
        dist.all_reduce(s, group=group)
        return int(s)

    def gather_buckets(t):
        parts = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    a, v = _sharded_body(avail[None, blk], total[None, blk], alive[None, blk], demands,
                         counts, thr, max_passes, torch.tensor([rank]), sum_scalar,
                         gather_buckets)
    a_parts = [torch.empty_like(a[:, 0]) for _ in range(p)]
    v_parts = [torch.empty_like(v[0]) for _ in range(p)]
    dist.all_gather(a_parts, a[:, 0].contiguous(), group=group)
    dist.all_gather(v_parts, v[0].contiguous(), group=group)
    return torch.cat(a_parts, dim=1), torch.cat(v_parts, dim=0)


def make_sharded_scheduler(shards=8, *, axis: str = "nodes", max_passes: int = MAX_PASSES,
                           device=None):
    """The counterpart of ray_tpu.sched.kernel_shard.make_sharded_scheduler.

    `shards` is an int (1, 2, 4 or 8: the blocks of K7's cluster on the
    card, or in-process shards of the plain version on the CPU) or a
    ``torch.distributed`` ProcessGroup (one shard a rank). `axis` names
    the node axis, kept for the reference's signature: the shards here
    are blocks or ranks, not mesh axes. Returns fn(avail [N,R], total
    [N,R], alive [N], demands [C,R], counts [C], thr=0.5) -> (assigned
    [C,N] int32, new_avail [N,R] float32), taking host arrays or tensors;
    N must divide by the number of shards. Runs on the card unless
    `device="cpu"`; raises without a card. In the group form every rank
    passes the whole arrays, computes its own block, and gets both results
    back whole; it takes the CPU (gloo) for now and raises
    NotImplementedError on CUDA."""
    dev = resolve_device(device)
    if isinstance(shards, int):
        _check_shards(shards)
    elif dev.type == "cuda":
        raise NotImplementedError(
            "the sharded scheduler across ranks on CUDA tensors (NCCL) is ROADMAP "
            "queue 1, item 3; pass device='cpu' for the gloo form")

    def fn(avail, total, alive, demands, counts,
           thr: float = DEFAULT_SPREAD_THRESHOLD) -> Tuple[torch.Tensor, torch.Tensor]:
        args = (_tensor(avail, torch.float32, dev), _tensor(total, torch.float32, dev),
                _tensor(alive, torch.bool, dev), _tensor(demands, torch.float32, dev),
                _tensor(counts, torch.int32, dev))
        if isinstance(shards, int):
            return schedule_classes_sharded(*args, thr, max_passes, shards=shards)
        return _group_round(shards, *args, thr, max_passes)

    return fn
