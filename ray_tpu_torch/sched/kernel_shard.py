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
    ``all_gather``. On CPU tensors (gloo) each rank runs the plain
    ``_sharded_body``; on CUDA tensors K7r (``rank_pass``,
    csrc/sched_kernels.cu ``k7r_kernel``), K1's arithmetic on the rank's
    block, one launch a step of a pass (terms, caps, fill), the host's loop
    (``_rank_body``) running the collectives between them: gloo over CUDA
    tensors, or NCCL across cards (not yet run on more than one card).

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
                  shard_index, sum_scalar: Callable, gather_buckets: Callable, trace=None):
    """One round over the local shards, JAX's _sharded_body
    (kernel_shard.py:54-130) spelled out with kernel_np's control flow.

    avail/total [P, Nl, R] float32 and alive [P, Nl] bool hold the P local
    shards, whose global indices are `shard_index` [P]; demands [C, R],
    counts [C]. sum_scalar(x [P] int64) -> int is the psum over every shard;
    gather_buckets(t [P, B] int64) -> [p, B] the all_gather of every
    shard's bucket totals in shard order. Returns (assigned [C, P, Nl]
    int32, avail [P, Nl, R] float32); `avail` is not modified. `trace`, a
    list, receives (class, pass, feasible count, placed count) for each
    pass that reached the feasible count's psum."""
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
        for p_ in range(max_passes):
            if remaining <= 0:
                break
            fit, bucket, under, cap_thresh = _pass_terms(avail, total, alive, pos, dpos,
                                                         consts)
            n_feasible = sum_scalar((fit > 0).sum(dim=1))  # psum (:105)
            if n_feasible == 0:
                if trace is not None:
                    trace.append((c, p_, 0, 0))
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
            if trace is not None:
                trace.append((c, p_, n_feasible, got))
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

# ------------------------------------------------------------------ K7r

#: K7r's modes, one a step of a pass (csrc/sched_kernels.cu kK7rTerms, ...)
TERMS, CAPS, FILL = 0, 1, 2


class RankRound:
    """One round's working state of K7r on P local shards of Nl nodes: the
    availability the fills write (avail [P, Nl, R], a copy), total, alive,
    assigned [C, P, Nl], and the per-node state a pass leaves for the next
    step: on the card the kernel's scratch (P = 1, the rank's block), on
    the CPU the plain versions' fit, cap, bucket and caps by bucket."""

    def __init__(self, avail, total, alive, demands, spread_threshold):
        self.dev = avail.device
        self.avail = avail.to(torch.float32).contiguous().clone()
        self.total = total.to(torch.float32).contiguous()
        self.alive = alive.to(torch.bool).contiguous()
        self.demands = demands.to(torch.float32).contiguous()
        self.d_host = self.demands.detach().to("cpu").numpy()
        P, Nl, R = self.avail.shape
        self.assigned = torch.zeros((len(self.d_host), P, Nl), dtype=torch.int32,
                                    device=self.dev)
        self.thr = spread_threshold
        self.consts = _pass_consts(spread_threshold, self.dev)
        self.fit = self.cap = self.bucket = self.contrib = None  # the plain versions'
        if self.dev.type == "cuda":
            if P != 1:
                raise ValueError(f"K7r runs one shard a rank on the card, not {P}")
            words = _build.load().sched_k7r_scratch_words(Nl, R)
            self.scratch = torch.empty(words, dtype=torch.int32, device=self.dev)


def _terms_plain(st: RankRound, c: int) -> torch.Tensor:
    """Plain version of K7r's terms of class c: each node's fit, threshold
    cap (-1 over the threshold) and bucket; the shards' feasible counts
    [P] int64."""
    pos = torch.from_numpy(np.flatnonzero(st.d_host[c] > 0)).to(st.dev)
    fit, bucket, under, cap_thresh = _pass_terms(st.avail, st.total, st.alive, pos,
                                                 st.demands[c][pos], st.consts)
    st.fit, st.bucket = fit, bucket
    st.cap = torch.where(under, cap_thresh, -1)
    return (fit > 0).sum(dim=-1)


def _caps_plain(st: RankRound, remaining: int, n_feasible: int) -> torch.Tensor:
    """Plain version of K7r's caps: min(threshold cap or the equal share,
    fit, remaining); the shards' bucket totals [P, 64] int64."""
    share = -(-remaining // n_feasible)
    cap = torch.where(st.cap >= 0, st.cap.to(torch.int64), share)
    st.cap = torch.clamp(torch.minimum(cap, st.fit.to(torch.int64)), max=remaining)
    onehot = st.bucket[..., None, :] == torch.arange(SCORE_BUCKETS, device=st.dev)[:, None]
    st.contrib = onehot * st.cap[..., None, :]  # [P, B, Nl]
    return st.contrib.sum(dim=-1)


def _fill_plain(st: RankRound, c: int, nc: int, remaining: int, all_tot: torch.Tensor,
                shard_index: torch.Tensor, more: bool) -> torch.Tensor:
    """Plain version of K7r's fill of class c from every shard's totals
    all_tot [p, 64]: the global prefix of each node in (bucket, node)
    order, exact int64, as _sharded_body forms it; the take, the debit
    and the shards' placed counts; then the next pass's terms (class c
    again where it placed, has tasks left and `more` passes, else nc;
    none when nc < 0). Returns [P, 2] int64: placed, next feasible."""
    within_excl = torch.cumsum(st.contrib, dim=2) - st.contrib
    before = torch.cumsum(all_tot, dim=0) - all_tot  # earlier shards' totals
    bucket_tot = all_tot.sum(dim=0)
    bucket_off = torch.cumsum(bucket_tot, dim=0) - bucket_tot
    base = bucket_off[None, :] + before[shard_index]  # [P, B]
    prev = torch.gather(base[:, :, None] + within_excl, 1,
                        st.bucket.to(torch.int64)[:, None, :])[:, 0]
    take = torch.minimum(torch.clamp(remaining - prev, min=0), st.cap)
    got = min(remaining, int(bucket_tot.sum()))
    if got > 0:
        st.assigned[c] += take.to(torch.int32)
        st.avail = torch.maximum(st.avail - take.to(torch.float32)[..., None] * st.demands[c],
                                 st.consts[3])
    placed = take.sum(dim=-1)
    nxt = c if got > 0 and remaining - got > 0 and more else nc
    feas = _terms_plain(st, nxt) if nxt >= 0 else torch.zeros_like(placed)
    return torch.stack([placed, feas], dim=-1)


def _k7r_launch(mode, st: RankRound, c, nc, remaining, n_feasible, all_tot, rank, flag):
    """One launch of K7r on the rank's block (P = 1) on the current stream."""
    lib = _build.load()
    _, Nl, R = st.avail.shape
    out = torch.empty(SCORE_BUCKETS if mode == CAPS else 2, dtype=torch.int64, device=st.dev)
    row = st.demands[c]
    nxt = st.demands[nc] if nc >= 0 else None
    p = 1 if all_tot is None else all_tot.shape[0]
    with torch.cuda.device(st.dev):
        rc = lib.sched_k7r_pass(
            mode, st.avail.data_ptr(), st.total.data_ptr(), st.alive.data_ptr(),
            row.data_ptr(), nxt.data_ptr() if nxt is not None else None,
            st.assigned[c].data_ptr(), st.scratch.data_ptr(), st.scratch.numel(),
            out.data_ptr(), all_tot.data_ptr() if all_tot is not None else None,
            Nl, R, p, rank, int(remaining), int(n_feasible), flag,
            float(np.float32(st.thr)), float(np.float32(max(1e-6, 1.0 - st.thr))),
            _stream(st.dev))
    _check(lib, rc, f"k7r_pass (mode {mode})")
    return out[None]


def rank_pass(mode: int, st: RankRound, c: int, *, nc: int = -1, remaining: int = 0,
              n_feasible: int = 0, all_tot: torch.Tensor = None, shard_index=None,
              refresh: bool = False, clamp: bool = False, more: bool = False) -> torch.Tensor:
    """K7r. One step of a pass of class c on the state's shards, by `mode`:

      TERMS: fit, threshold cap and bucket (`refresh`: the round's first
             step, every node's utilization and bucket anew); -> [P, 2]
             int64 (0, feasible count);
      CAPS:  the final caps for `remaining` tasks over `n_feasible` nodes
             (> 0); -> [P, 64] int64, the bucket totals;
      FILL:  from every shard's totals all_tot [p, 64], the shards with
             global indices `shard_index` take their places, debit avail
             (`clamp`: the round's first placing pass) and compute the next
             pass's terms (class c while it placed, has tasks left and
             `more` passes, else class nc, none when nc < 0); -> [P, 2]
             int64 (placed count, the next pass's feasible count).

    On the card K7r (one shard, the rank's block), counted in `launches`;
    on the CPU the plain versions."""
    if st.dev.type == "cpu":
        if mode == TERMS:
            feas = _terms_plain(st, c)
            return torch.stack([torch.zeros_like(feas), feas], dim=-1)
        if mode == CAPS:
            return _caps_plain(st, remaining, n_feasible)
        return _fill_plain(st, c, nc, remaining, all_tot, shard_index, more)
    if mode == TERMS:
        flag = int(refresh)
    elif mode == FILL:
        flag = int(clamp) | (int(more) << 1)
    else:
        flag = 0
    rank = int(shard_index[0]) if mode == FILL else 0
    out = _k7r_launch(mode, st, c, nc, remaining, n_feasible, all_tot, rank, flag)
    rank_pass.launches += 1
    return out


rank_pass.launches = 0


def _rank_loop(step: Callable, counts, max_passes, sum_counts: Callable,
               gather_buckets: Callable, trace=None) -> None:
    """The host's loop of a round through K7r's three steps a pass:
    _sharded_body's round in K1's order of work. Classes with tasks in
    order, each for at most `max_passes` passes: CAPS, the all_gather of
    the totals, FILL, and one psum of the placed and next feasible counts,
    read as two scalars; TERMS at the round's start and after a pass with
    no feasible node. Every shard takes the same branches, since every
    scalar it branches on is global.

    step(mode, c, **kw) runs one step of class c (rank_pass's keywords but
    the state and shard_index); sum_counts(x [P, 2] int64) -> (int, int) is
    the psum over every shard, gather_buckets(t [P, 64]) -> [p, 64] the
    all_gather; counts [C]; `trace` as _sharded_body's."""
    k_host = counts.detach().to("cpu").numpy() if isinstance(counts, torch.Tensor) \
        else np.asarray(counts)
    order = [c for c in range(len(k_host)) if k_host[c] > 0]
    if not order or max_passes <= 0:
        return
    following = dict(zip(order, order[1:] + [-1]))
    c, remaining, p, clamped = order[0], int(k_host[order[0]]), 0, False
    _, n_feasible = sum_counts(step(TERMS, c, refresh=True))  # psum (:105)
    while True:
        nc = following[c]
        got, same = 0, False
        if n_feasible > 0:
            tot = step(CAPS, c, remaining=remaining, n_feasible=n_feasible)
            all_tot = gather_buckets(tot)  # all_gather (:75)
            more = p + 1 < max_passes
            got, feas_next = sum_counts(step(  # psum (:117, and :105 of the next pass)
                FILL, c, nc=nc, remaining=remaining, all_tot=all_tot, clamp=not clamped,
                more=more))
            clamped = clamped or got > 0
            same = got > 0 and remaining - got > 0 and more
        if trace is not None:
            trace.append((c, p, n_feasible, got))
        if same:
            remaining, p, n_feasible = remaining - got, p + 1, feas_next
            continue
        if nc < 0:
            break
        if n_feasible > 0:  # the fill took the next class's terms
            n_feasible = feas_next
        else:
            _, n_feasible = sum_counts(step(TERMS, nc))
        c, remaining, p = nc, int(k_host[nc]), 0


def _rank_body(avail, total, alive, demands, counts, spread_threshold, max_passes,
               shard_index, sum_counts: Callable, gather_buckets: Callable, trace=None):
    """One round over the local shards through K7r (_rank_loop). Arguments
    as _sharded_body's; sum_counts(x [P, 2] int64) -> (int, int) is the
    psum over every shard. Returns (assigned [C, P, Nl] int32, avail [P,
    Nl, R] float32); `avail` is not modified."""
    st = RankRound(avail, total, alive, demands, spread_threshold)

    def step(mode, c, **kw):
        return rank_pass(mode, st, c, shard_index=shard_index, **kw)

    _rank_loop(step, counts, max_passes, sum_counts, gather_buckets, trace)
    return st.assigned, st.avail


#: the kernels of this module by name, each with its `launches` counter
KERNELS = {"schedule_classes_sharded": schedule_classes_sharded, "rank_pass": rank_pass}


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
    blocks of both results are all-gathered back whole. CPU tensors run
    the plain _sharded_body, CUDA tensors K7r (_rank_body)."""
    import torch.distributed as dist

    p = dist.get_world_size(group)
    rank = dist.get_rank(group)
    _check_problem(avail, total, alive, demands, counts, p)
    Nl = avail.shape[0] // p
    blk = slice(rank * Nl, (rank + 1) * Nl)

    def psum(x):
        s = x.sum(dim=0)
        dist.all_reduce(s, group=group)
        return s.tolist()

    def gather_buckets(t):
        parts = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    if avail.device.type == "cuda":
        a, v = _rank_body(avail[None, blk], total[None, blk], alive[None, blk], demands,
                          counts, thr, max_passes, [rank], psum, gather_buckets)
    else:
        a, v = _sharded_body(avail[None, blk], total[None, blk], alive[None, blk], demands,
                             counts, thr, max_passes, torch.tensor([rank]), psum,
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
    passes the whole arrays, computes its own block (on the card through
    K7r, whose library is built here), and gets both results back whole;
    the inputs are not modified."""
    dev = resolve_device(device)
    if isinstance(shards, int):
        _check_shards(shards)
    elif dev.type == "cuda":
        _build.load()  # build the kernels now, not in the first round

    def fn(avail, total, alive, demands, counts,
           thr: float = DEFAULT_SPREAD_THRESHOLD) -> Tuple[torch.Tensor, torch.Tensor]:
        args = (_tensor(avail, torch.float32, dev), _tensor(total, torch.float32, dev),
                _tensor(alive, torch.bool, dev), _tensor(demands, torch.float32, dev),
                _tensor(counts, torch.int32, dev))
        if isinstance(shards, int):
            return schedule_classes_sharded(*args, thr, max_passes, shards=shards)
        return _group_round(shards, *args, thr, max_passes)

    return fn
