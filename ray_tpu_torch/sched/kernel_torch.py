"""PyTorch/CUDA twin of the NumPy scheduler kernels — the `policy="torch_cuda"` path.

Counterpart of ray_tpu/sched/kernel_jax.py. The four device programs of a
scheduling round are hand-written CUDA kernels (csrc/sched_kernels.cu, built
by _build.py on first CUDA use); each has a public wrapper here and, beside
it, a plain PyTorch version of the same function:

  K1 schedule_classes  the batched hybrid placement round, on one
                       thread-block cluster (k1_plan)
  K2 scatter_rows_     dirty-row refresh of the device availability
  K3 delta_clip        clip(avail + delta, 0, total)
                       (K2 and K3 are applied by K1 in its own launch when
                       a scan round follows the refresh; alone, they are
                       the rows and delta modes of refresh_view_kernel)
  K4 compact_nonzero   COO compaction of the [C, N] assignment for download,
                       one cooperative launch (k4_launch_plan)
  K5 schedule_classes_rounds   the fully parallel two-phase [C, N] round
                               (scheduler_kernel_algo="rounds"), three
                               kernels a phase (caps, prefix, trim)
  K6 schedule_classes_chunked  K5's core over chunks of 16 classes
                               (scheduler_kernel_algo="chunked"), on one
                               thread-block cluster (rounds_plan)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel; K2's and K3's count every refresh applied on
the card, and their ``fused`` counters those that K1 applied.

Decisions are bit-identical to kernel_np.schedule_classes (and, for K5/K6,
to kernel_np.schedule_classes_rounds / _chunked on integer-granular
problems), golden-tested in tests/test_torch_sched_kernel.py and
tests/test_torch_sched_rounds.py against kernel_np and kernel_jax: IEEE
float32 division, no fast math, no product-into-sum contraction, and exact
integer prefix sums in the score-ordered fill.

TorchScheduler is the twin of kernel_jax.JaxScheduler: the cluster view
stays resident on the device across rounds, the host pushes dirty rows or
deltas, and schedule_async / fetch pipeline rounds without a host sync. Its
rounds write the view in place (the wrappers' private `_in_place`), so no
round copies the view. A refresh is copied to the card when it is pushed and
applied later: by the next scan round's K1, in its own launch (the private
`_refresh`), or by K2/K3 alone before anything else reads the view.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.sched import _build
from ray_tpu_torch.util import device as _device
from ray_tpu_torch.util.device import current_stream as _stream
from ray_tpu_torch.util.device import device_of as _device_of

EPS = 1e-4
INF_FIT = np.int32(2**30)
DEFAULT_SPREAD_THRESHOLD = 0.5
MAX_PASSES = 8
_MAX_CLASS_COUNT = 2**23
SCORE_BUCKETS = 64
# float32 holds integers exactly up to 2**24; the reference's prefix sums
# saturate at 2**23 (the kernels here use exact int64 prefixes instead,
# which agree wherever the result depends on them: counts < 2**23)
SAT = float(1 << 23)

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Never falls back to the CPU quietly."""
    return _device.resolve_device(
        device, what="the scheduler",
        cpu_hint="pass device='cpu' (Config key scheduler_device='cpu')")


def pad_problem(
    demands: np.ndarray, counts: np.ndarray, class_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the class dimension to a fixed bucket size (few distinct shapes
    across rounds); padded classes demand INF_FIT of resource 0, so they
    match nothing."""
    C = demands.shape[0]
    assert C <= class_pad, (C, class_pad)
    if int(counts.max(initial=0)) >= _MAX_CLASS_COUNT:
        raise ValueError("per-class count exceeds 2**23; split into rounds")
    d = np.zeros((class_pad, demands.shape[1]), dtype=np.float32)
    d[:C] = demands
    d[C:, 0] = np.float32(INF_FIT)
    k = np.zeros((class_pad,), dtype=np.int32)
    k[:C] = counts
    return d, k


def bucket_size(n: int, buckets=(16, 64, 256, 1024, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


# ------------------------------------------------------------ dispatch helpers


def _check(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.sched_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


# ------------------------------------------------------------------------- K1


def _pass_consts(spread_threshold, dev):
    """The float32 constants of _pass_terms on `dev`: (eps, thr, denom, zero)."""
    return tuple(_f32(x).to(dev) for x in (
        EPS, spread_threshold, max(1e-6, 1.0 - spread_threshold), 0.0))


def _pass_terms(avail, total, alive, pos, dpos, consts):
    """One pass's per-node terms over a view [..., R] (the leading axes are
    nodes, or shards and nodes): kernel_np's _class_fit, critical_util,
    _score_bucket and _threshold_cap, op for op. `pos` are the demanded
    columns, `dpos` their demands, `consts` _pass_consts(). Returns (fit
    int32, bucket int32, under bool, cap_thresh int32), each [...]; K1's and
    K7's plain versions share it as their kernels share node_terms."""
    eps, thr, denom, zero = consts
    dev = avail.device
    inf_fit = float(INF_FIT)
    # _class_fit
    if len(pos) == 0:
        fit = torch.where(alive, INF_FIT, 0).to(torch.int32)
    else:
        ratios = torch.floor((avail[..., pos] + eps) / dpos)
        fit = torch.clamp(ratios.min(dim=-1).values, 0.0, inf_fit)
        fit = torch.where(alive, fit, zero).to(torch.int32)
    # critical_util
    used = total - avail
    frac = torch.where(total > 0, used / torch.maximum(total, eps), zero)
    util = frac.max(dim=-1).values
    # _score_bucket
    over = torch.clamp((util - thr) / denom, 0.0, 1.0)
    b = torch.where(util >= thr, 1.0 + torch.floor(over * float(SCORE_BUCKETS - 2)), zero)
    bucket = torch.clamp(b, 0, SCORE_BUCKETS - 1).to(torch.int32)
    # _threshold_cap
    if len(pos) == 0:
        cap_thresh = torch.full(avail.shape[:-1], int(INF_FIT), dtype=torch.int32, device=dev)
    else:
        head = thr * total[..., pos] - used[..., pos]
        k = torch.floor((head + eps) / dpos).min(dim=-1).values
        k = torch.clamp(k, 0.0, float(np.float32(inf_fit - 1.0)))
        cap_thresh = (k + 1.0).to(torch.int32)
    return fit, bucket, util < thr, cap_thresh


def _schedule_classes_plain(avail, total, alive, demands, counts,
                            spread_threshold=DEFAULT_SPREAD_THRESHOLD,
                            max_passes=MAX_PASSES, passes_out=None, refresh=None):
    """Plain PyTorch version of K1: kernel_np.schedule_classes, op for op.
    `passes_out`, a list, receives the number of passes each class ran.
    `refresh` (a Refresh) is applied to the round's copy of avail first, by
    K2's or K3's plain version, as K1 applies it before its first sweep."""
    dev = avail.device
    avail = avail.to(torch.float32).clone()
    total = total.to(torch.float32)
    if refresh is not None:
        avail = _refresh_plain(avail, total, refresh)
    alive = alive.to(torch.bool)
    d_host = demands.detach().to("cpu", torch.float32).numpy()
    k_host = counts.detach().to("cpu").numpy()
    demands = demands.to(torch.float32)
    C = d_host.shape[0]
    N = avail.shape[0]
    consts = _pass_consts(spread_threshold, dev)
    zero = consts[3]
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    for c in range(C):
        pos = torch.from_numpy(np.flatnonzero(d_host[c] > 0)).to(dev)
        d = demands[c]
        dpos = d[pos]
        remaining = int(k_host[c])
        passes = 0
        for _ in range(max_passes):
            if remaining <= 0:
                break
            passes += 1
            fit, bucket, under, cap_thresh = _pass_terms(avail, total, alive, pos, dpos,
                                                         consts)
            n_feasible = int((fit > 0).sum())
            if n_feasible == 0:
                break
            equal_share = -(-remaining // n_feasible)
            cap = torch.where(under, cap_thresh, equal_share).to(torch.int32)
            cap = torch.clamp(torch.minimum(cap, fit), max=remaining)
            # _fill_by_score on bucket keys: stable order, exact prefix
            order = torch.sort(bucket, stable=True).indices
            cap_sorted = cap[order].to(torch.int64)
            prev = torch.cumsum(cap_sorted, 0) - cap_sorted
            take_sorted = torch.minimum(
                torch.clamp(remaining - prev, min=0), cap_sorted
            )
            take = torch.zeros(N, dtype=torch.int64, device=dev)
            take[order] = take_sorted
            got = int(take.sum())
            if got == 0:
                break
            assigned[c] += take.to(torch.int32)
            remaining -= got
            avail = torch.maximum(
                avail - take.to(torch.float32)[:, None] * d[None, :], zero
            )
        if passes_out is not None:
            passes_out.append(passes)
    return assigned, avail


# K1's launch shape (csrc/sched_kernels.cu k1_plan, which this mirrors): one
# thread-block cluster of the first of K1_CLUSTER_SIZES the card has room
# for; block r owns nodes [r*Nb, (r+1)*Nb), N padded up to a multiple of the
# cluster with dead, empty nodes; a block holds its nodes' rows and state in
# shared memory while they fit in K1_SMEM_BUDGET, else in global memory.
K1_CLUSTER_SIZES = (16, 8)
K1_SMEM_BUDGET = 200 * 1024


class K1Plan(NamedTuple):
    cluster: int           # blocks in the cluster
    nodes_per_block: int   # Nb = ceil(N / cluster)
    rows_in_smem: bool     # rows and per-node state in shared memory
    smem_bytes: int        # dynamic shared memory a block
    scratch_words: int     # int32 words of global scratch (rows in global memory)


def k1_block_bytes(nodes: int, n_res: int, rows: bool) -> int:
    """Bytes of one block's share of K1's state (`nodes` nodes): with the
    rows, avail and total by column (an odd stride), then the per-node
    utilization, fit and cap (4 bytes each), bucket and alive (1 each);
    16-aligned."""
    b = (8 * n_res * (nodes | 1) if rows else 0) + 14 * nodes
    return (b + 15) & ~15


def k1_plan(n_nodes: int, n_res: int, cluster: int) -> K1Plan:
    """K1's layout for n_nodes nodes of n_res columns over `cluster` blocks."""
    nb = -(-n_nodes // cluster)
    rows = k1_block_bytes(nb, n_res, True)
    if rows <= K1_SMEM_BUDGET:
        return K1Plan(cluster, nb, True, rows, 0)
    return K1Plan(cluster, nb, False, 0, cluster * k1_block_bytes(nb, n_res, False) // 4)


_K1_CLUSTER = {}  # (device index, N, R) -> the cluster size the card takes


def k1_launch_plan(n_nodes: int, n_res: int, device) -> K1Plan:
    """The layout K1 launches with on `device` (a CUDA device) for n_nodes
    nodes of n_res columns: the first of K1_CLUSTER_SIZES the card has room
    for, asked of the card once per shape."""
    dev = torch.device(device)
    key = (dev.index, n_nodes, n_res)
    if key not in _K1_CLUSTER:
        lib = _build.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.sched_k1_cluster_size(n_nodes, n_res, ctypes.addressof(out))
        _check(lib, rc, "schedule_classes (cluster size)")
        _K1_CLUSTER[key] = out.value
    return k1_plan(n_nodes, n_res, _K1_CLUSTER[key])


def _round_view(avail: torch.Tensor, in_place: bool) -> torch.Tensor:
    """The [N, R] float32 view a round's kernel writes: a copy of avail, or
    avail itself where the caller lets the round work in place."""
    view = avail.to(torch.float32).contiguous()
    return view if in_place else view.clone()


def schedule_classes(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                     demands: torch.Tensor, counts: torch.Tensor,
                     spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                     max_passes: int = MAX_PASSES, _in_place: bool = False,
                     _refresh: Optional["Refresh"] = None):
    """K1. Batched hybrid placement, the semantics of kernel_np.schedule_classes.

    avail/total [N, R] float32, alive [N] bool, demands [C, R] float32,
    counts [C] int32. Returns (assigned [C, N] int32, new avail [N, R]
    float32); the input `avail` is not modified, unless `_in_place`
    (TorchScheduler's rounds, which replace their view by the result) lets
    the kernel write the new avail into it. `_refresh` (TorchScheduler's
    pending refresh, a Refresh) is applied to the round's view before the
    round: on a card in K1's own launch, counted as a launch of K2 or K3
    and as a fused one (where no K1 launches, N or C 0, by K2/K3 alone).
    """
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_plain(
            avail, total, alive, demands, counts, spread_threshold, max_passes,
            refresh=_refresh)
    N, R = avail.shape
    C = demands.shape[0]
    if total.shape != (N, R) or alive.shape != (N,) or demands.shape != (C, R) \
            or counts.shape != (C,):
        raise ValueError(
            f"shape mismatch: avail {tuple(avail.shape)} total {tuple(total.shape)} "
            f"alive {tuple(alive.shape)} demands {tuple(demands.shape)} "
            f"counts {tuple(counts.shape)}"
        )
    if _refresh is not None:
        _refresh.check(N, R, dev)
    new_avail = _round_view(avail, _in_place)
    total = total.to(torch.float32).contiguous()
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    if N == 0 or C == 0:
        if _refresh is not None:
            _refresh.apply(new_avail, total)
        return assigned, new_avail
    lib = _build.load()
    alive_u8 = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    plan = k1_launch_plan(N, R, dev)
    scratch = torch.empty(max(plan.scratch_words, 1), dtype=torch.int32, device=dev)
    ref = _refresh or _NO_REFRESH
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_classes(
            new_avail.data_ptr(), total.data_ptr(), alive_u8.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), assigned.data_ptr(),
            scratch.data_ptr(), plan.scratch_words, N, R, C, plan.cluster,
            float(np.float32(spread_threshold)),
            float(np.float32(max(1e-6, 1.0 - spread_threshold))),
            int(max_passes), _REFRESH_MODES[ref.mode], _ptr(ref.idx), _ptr(ref.src),
            ref.pad, _stream(dev),
        )
    _check(lib, rc, "schedule_classes" if _refresh is None
           else f"schedule_classes (with the {_refresh.mode} refresh)")
    schedule_classes.launches += 1
    if _refresh is not None:
        counter = _REFRESH_COUNTERS[_refresh.mode]
        counter.launches += 1
        counter.fused += 1
    return assigned, new_avail


schedule_classes.launches = 0


# ------------------------------------------------------------------- K2 / K3
#
# A refresh of the view: rows mode (K2) writes dirty rows into it in place,
# delta mode (K3) writes clip(avail + delta, 0, total). K1 applies one in its
# own launch (schedule_classes' `_refresh`); alone, each is one launch of
# refresh_view_kernel<MODE>.

_REFRESH_MODES = {None: 0, "rows": 1, "delta": 2}  # the source's RefreshMode


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _refresh_launch(mode, out, avail, src, total=None, idx=None):
    """One launch of refresh_view_kernel in `mode` on the current stream,
    counted as K2's (rows) or K3's (delta) launch."""
    dev = out.device
    N, R = out.shape
    pad = 0 if idx is None else idx.shape[0]
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.sched_refresh_view(_ptr(out), _ptr(avail), _ptr(src), _ptr(total), _ptr(idx),
                                    pad, N, R, _REFRESH_MODES[mode], _stream(dev))
    _check(lib, rc, f"refresh_view ({mode})")
    _REFRESH_COUNTERS[mode].launches += 1
    return out


class Refresh(NamedTuple):
    """A refresh of the view not yet applied: mode "rows" (idx [pad] int32,
    src the rows [pad, R] float32) or "delta" (idx None, src the delta [N, R]
    float32). `stream`: on a card, the stream its operands were copied on."""
    mode: Optional[str]
    idx: Optional[torch.Tensor]
    src: Optional[torch.Tensor]
    stream: Optional[object] = None

    @property
    def pad(self) -> int:
        return 0 if self.idx is None else int(self.idx.shape[0])

    def check(self, N: int, R: int, dev) -> None:
        """Raise ValueError where K1 cannot take this refresh for an [N, R]
        view on `dev`."""
        want = (self.pad, R) if self.mode == "rows" else (N, R)
        ok = self.mode in ("rows", "delta") and self.src is not None \
            and tuple(self.src.shape) == want and self.src.dtype == torch.float32 \
            and self.src.is_contiguous() and self.src.device == dev
        if self.mode == "rows":
            ok = ok and self.idx is not None and self.idx.dtype == torch.int32 \
                and self.idx.dim() == 1 and self.idx.is_contiguous() and self.idx.device == dev
        if not ok:
            raise ValueError(
                f"refresh {self.mode!r} for a view [{N}, {R}] on {dev}: idx "
                f"{None if self.idx is None else (tuple(self.idx.shape), self.idx.dtype)}, src "
                f"{None if self.src is None else (tuple(self.src.shape), self.src.dtype)}")

    def apply(self, view: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        """Apply this refresh to `view` in place by K2 or K3 alone (their
        plain versions on the CPU). Returns view."""
        if self.mode == "rows":
            return scatter_rows_(view, self.idx, self.src)
        return delta_clip(view, self.src, total, _in_place=True)


_NO_REFRESH = Refresh(None, None, None)


def _refresh_plain(avail, total, refresh: Refresh):
    """K2's (in place) or K3's plain version, as K1 applies `refresh`."""
    if refresh.mode == "rows":
        return _scatter_rows_plain_(avail, refresh.idx, refresh.src)
    return _delta_clip_plain(avail, refresh.src, total)


def _scatter_rows_plain_(avail, idx, rows):
    """Plain version of K2: avail[idx] = rows, dropping out-of-range idx."""
    N = avail.shape[0]
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < N)
    avail[idx[keep]] = rows.to(avail.dtype)[keep]
    return avail


def scatter_rows_(avail: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """K2. In place: avail[idx[i]] = rows[i] for every idx[i] in [0, N);
    other indices (the padding value N) are dropped, as `mode="drop"` does
    in the reference. Indices in range must be distinct. Returns avail.
    On a card, refresh_view_kernel in rows mode."""
    dev = _device_of(avail, idx, rows)
    if dev.type == "cpu":
        return _scatter_rows_plain_(avail, idx, rows)
    R = avail.shape[1]
    pad = idx.shape[0]
    if rows.shape != (pad, R) or avail.dtype != torch.float32 \
            or not avail.is_contiguous():
        raise ValueError(
            f"scatter_rows_: avail {tuple(avail.shape)} {avail.dtype} "
            f"(contiguous float32 needed), idx {tuple(idx.shape)}, "
            f"rows {tuple(rows.shape)}"
        )
    return _refresh_launch("rows", avail, None, rows.to(torch.float32).contiguous(),
                           idx=idx.to(torch.int32).contiguous())


scatter_rows_.launches = 0
scatter_rows_.fused = 0


def _delta_clip_plain(avail, delta, total):
    """Plain version of K3 (jnp.clip(avail + delta, 0, total))."""
    x = avail + delta
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), total)


def delta_clip(avail: torch.Tensor, delta: torch.Tensor, total: torch.Tensor,
               _in_place: bool = False):
    """K3. Returns clip(avail + delta, 0, total) as a new [N, R] float32,
    or, with `_in_place` (TorchScheduler's view), written into avail, which
    must then be contiguous float32. On a card, refresh_view_kernel in delta
    mode."""
    dev = _device_of(avail, delta, total)
    if _in_place and (avail.dtype != torch.float32 or not avail.is_contiguous()):
        raise ValueError(f"delta_clip in place: avail {avail.dtype}, contiguous "
                         f"{avail.is_contiguous()} (contiguous float32 needed)")
    if dev.type == "cpu":
        out = _delta_clip_plain(avail, delta, total)
        return avail.copy_(out) if _in_place else out
    if not (avail.shape == delta.shape == total.shape):
        raise ValueError(
            f"delta_clip: shapes {tuple(avail.shape)} {tuple(delta.shape)} "
            f"{tuple(total.shape)} differ"
        )
    avail = avail.to(torch.float32).contiguous()
    return _refresh_launch("delta", avail if _in_place else torch.empty_like(avail), avail,
                           delta.to(torch.float32).contiguous(),
                           total.to(torch.float32).contiguous())


delta_clip.launches = 0
delta_clip.fused = 0
_REFRESH_COUNTERS = {"rows": scatter_rows_, "delta": delta_clip}


# ------------------------------------------------------------------------- K4

_IDX_DTYPES = (torch.int16, torch.int32)
_VAL_DTYPES = (torch.uint8, torch.int32)
#: K4's block counts: one scratch array a (device, stream), made at the
#: stream's first call, so that no call allocates and no two streams share
K4_MAX_BLOCKS = 4096
_k4_scratch = {}


def _k4_counts(dev) -> torch.Tensor:
    key = (dev.index, _stream(dev))
    counts = _k4_scratch.get(key)
    if counts is None:
        counts = _k4_scratch[key] = torch.empty(K4_MAX_BLOCKS, dtype=torch.int32, device=dev)
    return counts


def _compact_nonzero_plain(out, cap, ci_dtype, ni_dtype, val_dtype):
    """Plain version of K4: the nonzeros numbered in row-major order by a
    prefix count, each written to its slot."""
    C, N = out.shape
    flat = out.reshape(-1)
    flag = flat != 0
    pos = torch.cumsum(flag.to(torch.int64), 0) - 1
    keep = flag & (pos < cap)
    dest = torch.where(keep, pos, torch.full_like(pos, cap))  # slot cap: discarded
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=out.device)
    idx.scatter_(0, dest, torch.arange(flat.numel(), device=out.device))
    idx = idx[:cap]
    return (
        (idx // N).to(ci_dtype),
        (idx % N).to(ni_dtype),
        flat[idx].to(val_dtype),
    )


def compact_nonzero(out: torch.Tensor, cap: int, ci_dtype=torch.int32,
                    ni_dtype=torch.int32, val_dtype=torch.int32):
    """K4. (ci, ni, vals) of the nonzero cells of out [C, N] int32 in
    row-major order, `cap` slots each, equal slot for slot to
    ``jnp.nonzero(out, size=cap, fill_value=0)`` and ``out[ci, ni]``: slots
    past the last nonzero hold cell (0, 0) and its value. Indices are
    written as ci_dtype/ni_dtype (int16 or int32), values as val_dtype
    (uint8 or int32) — the narrowing of the reference's sparse download."""
    if out.dim() != 2 or out.numel() == 0 or cap <= 0:
        raise ValueError(f"compact_nonzero: bad input {tuple(out.shape)} cap={cap}")
    if ci_dtype not in _IDX_DTYPES or ni_dtype not in _IDX_DTYPES \
            or val_dtype not in _VAL_DTYPES:
        raise ValueError(f"compact_nonzero: unsupported dtypes "
                         f"{ci_dtype} {ni_dtype} {val_dtype}")
    dev = _device_of(out)
    if dev.type == "cpu":
        return _compact_nonzero_plain(out, cap, ci_dtype, ni_dtype, val_dtype)
    N = out.shape[1]
    lib = _build.load()
    x = out.to(torch.int32).contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16 bytes a load
        x = x.clone()
    ci = torch.empty(cap, dtype=ci_dtype, device=dev)
    ni = torch.empty(cap, dtype=ni_dtype, device=dev)
    vals = torch.empty(cap, dtype=val_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_compact_nonzero(
            x.data_ptr(), x.numel(), N, cap, ci.data_ptr(), ci.element_size(), ni.data_ptr(),
            ni.element_size(), vals.data_ptr(), vals.element_size(),
            _k4_counts(dev).data_ptr(), K4_MAX_BLOCKS, _stream(dev),
        )
    _check(lib, rc, "compact_nonzero")
    compact_nonzero.launches += 1
    return ci, ni, vals


compact_nonzero.launches = 0


def k4_launch_plan(M: int, device) -> Tuple[int, int, bool]:
    """K4's launch for M elements on `device`, as the source plans it:
    (blocks, chunks of 4 096 elements a block, looped form). One block a
    chunk, the chunk held in registers, where the chunks fit the blocks the
    card holds at once; else the looped form, which reads its chunks twice."""
    lib = _build.load()
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        _check(lib, lib.sched_k4_plan(M, plan), "compact_nonzero (plan)")
    return plan[0], plan[1], bool(plan[2])


# ------------------------------------------------------------------- K5 / K6


def _active_columns(demands: torch.Tensor, active_idx) -> Tuple[int, ...]:
    R = demands.shape[1]
    active = tuple(range(R)) if active_idx is None else tuple(int(r) for r in active_idx)
    if any(r < 0 or r >= R for r in active) or len(set(active)) != len(active):
        raise ValueError(f"active_idx {active_idx} is not a set of columns of R={R}")
    return tuple(sorted(active))


def _rounds_core_plain(avail, total, alive, demands, counts, spread_threshold,
                       rounds, active):
    """Plain PyTorch version of the K5/K6 core: kernel_np.schedule_classes_
    rounds op for op over the `active` columns (the columns any class
    demands; the others cannot change a decision). Returns (assigned [C, N]
    int32, avail [N, R] float32); `avail` is not modified."""
    dev = avail.device
    avail = avail.to(torch.float32).clone()
    total = total.to(torch.float32)
    demands = demands.to(torch.float32)
    C = demands.shape[0]
    N = avail.shape[0]
    eps = _f32(EPS).to(dev)
    thr = _f32(spread_threshold).to(dev)
    sat = _f32(SAT).to(dev)
    inf_fit = _f32(float(INF_FIT)).to(dev)
    zero = _f32(0.0).to(dev)
    alive_f = alive.to(torch.bool).to(torch.float32)
    d_div = torch.maximum(demands, _f32(1e-9).to(dev))
    remaining = counts.to(torch.float32)
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)

    def fit_matrix(avail):
        fit = inf_fit.expand(C, N)
        for r in active:
            ratio = torch.floor((avail[:, r][None, :] + eps) / d_div[:, r][:, None])
            fit = torch.where(demands[:, r][:, None] > 0, torch.minimum(fit, ratio), fit)
        return torch.clamp(fit, 0.0, float(INF_FIT)) * alive_f[None, :]

    def threshold_cap_matrix(avail):
        k = inf_fit.expand(C, N)
        for r in active:
            head = thr * total[:, r] - (total[:, r] - avail[:, r])
            cap_r = torch.floor((head[None, :] + eps) / d_div[:, r][:, None])
            k = torch.where(demands[:, r][:, None] > 0, torch.minimum(k, cap_r), k)
        # clip(k, 0, float32(INF_FIT) - 1) + 1; float32(2**30 - 1) == 2**30
        return torch.clamp(k, 0.0, float(INF_FIT)) + 1.0

    def claim_phase(avail_p, remaining, cap):
        capc = torch.minimum(cap, torch.minimum(remaining[:, None], sat))
        # saturating prefix along N: exact int64, clipped, minus the element
        incl = torch.cumsum(capc.to(torch.int64), dim=1).clamp(max=int(SAT))
        prev = incl.to(torch.float32) - capc
        want = torch.minimum(torch.maximum(remaining[:, None] - prev, zero), capc)
        take = want
        for r in active:
            d_r = demands[:, r]
            usage = want * d_r[:, None]
            # earlier classes' usage: float64 prefix over C, clipped at SAT
            prev_r = torch.cumsum(usage.to(torch.float64), dim=0).clamp(max=SAT)
            prev_r = prev_r.to(torch.float32) - usage
            head = avail_p[None, :, r] - prev_r
            fit_r = torch.floor((head + eps) / d_div[:, r][:, None])
            take = torch.where(d_r[:, None] > 0,
                               torch.minimum(take, torch.clamp(fit_r, 0.0, SAT)), take)
        return torch.minimum(torch.maximum(take, zero), want)

    def run_phase(avail, remaining, cap):
        nonlocal assigned
        take = claim_phase(avail, remaining, cap)
        usage = (take.to(torch.float64).T @ demands.to(torch.float64)).to(torch.float32)
        assigned += take.to(torch.int32)
        placed = take.to(torch.int64).sum(dim=1).to(torch.float32)
        return torch.maximum(avail - usage, zero), remaining - placed

    for _ in range(rounds):
        used = total - avail
        frac = torch.where(total > 0, used / torch.maximum(total, eps), zero)
        util = frac.max(dim=1).values
        under = (util < thr).to(torch.float32) * alive_f
        cap_a = torch.minimum(fit_matrix(avail), threshold_cap_matrix(avail))
        avail, remaining = run_phase(avail, remaining, cap_a * under[None, :])
        fit = fit_matrix(avail)
        n_feas = (fit > 0).sum(dim=1).to(torch.float32)
        share = torch.ceil(remaining / torch.maximum(n_feas, _f32(1.0).to(dev)))
        avail, remaining = run_phase(avail, remaining, torch.minimum(fit, share[:, None]))
    return assigned, avail


def _schedule_classes_chunked_plain(avail, total, alive, demands, counts,
                                    spread_threshold=DEFAULT_SPREAD_THRESHOLD,
                                    chunk=16, rounds=2, active_idx=None):
    """Plain version of K6: the rounds core chunk after chunk (a trailing
    partial chunk is allowed, as in kernel_np), avail carried between."""
    active = _active_columns(demands, active_idx)
    C = demands.shape[0]
    parts = []
    for s in range(0, C, chunk):
        a, avail = _rounds_core_plain(avail, total, alive, demands[s:s + chunk],
                                      counts[s:s + chunk], spread_threshold, rounds,
                                      active)
        parts.append(a)
    if not parts:
        return (torch.zeros((0, avail.shape[0]), dtype=torch.int32, device=avail.device),
                avail.to(torch.float32).clone())
    return torch.cat(parts, dim=0), avail


def _schedule_classes_rounds_plain(avail, total, alive, demands, counts,
                                   spread_threshold=DEFAULT_SPREAD_THRESHOLD,
                                   rounds=4, active_idx=None):
    """Plain version of K5: the rounds core over all classes at once."""
    return _rounds_core_plain(avail, total, alive, demands, counts, spread_threshold,
                              rounds, _active_columns(demands, active_idx))


# K6's launch shape (csrc/sched_kernels.cu rounds_plan, which this
# mirrors): one thread-block cluster of the first of ROUNDS_CLUSTER_SIZES the
# card has room for; block r owns nodes [r*Nb, (r+1)*Nb), N padded up to a
# multiple of the cluster with dead nodes; a block holds its nodes' state and
# a tile's caps and segment totals in shared memory beside its exchange buffers
# while they fit in ROUNDS_SMEM_BUDGET, else in global memory.
ROUNDS_CLUSTER_SIZES = (16, 8)
ROUNDS_TILE = 16          # classes a tile
ROUNDS_MAX_GROUP = 256    # classes a placed exchange carries
ROUNDS_SMEM_BUDGET = 216 * 1024


class RoundsPlan(NamedTuple):
    cluster: int           # blocks in the cluster
    nodes_per_block: int   # Nb = ceil(N / cluster)
    stride: int            # of the per-node arrays: Nb in whole 32-node segments
    group: int             # classes a placed exchange carries
    rows_in_smem: bool     # node state in shared memory
    smem_bytes: int        # dynamic shared memory a block
    scratch_words: int     # int32 words of global scratch


def rounds_node_bytes(stride: int, n_active: int) -> int:
    """Bytes of one block's node state: the trim's usage prefix and the
    debit (8 bytes each) and avail and total (4 each) per active column,
    the inactive columns' utilization term (4), the tile's caps (4 a class
    of the tile), each 32-node segment's total and base of each class of
    the tile (4 each a segment, so 4 a node), a node's flags and whether it
    is under the threshold (1 each), each segment's mask of the classes it
    wants (a byte held a node); 16-aligned."""
    b = (24 * n_active + 4 + 4 * ROUNDS_TILE + 4 + 3) * stride
    return (b + 15) & ~15


def rounds_exchange_bytes(cluster: int, group: int) -> int:
    """Bytes of a block's exchange buffers, two of each kind, a slot for
    every block: counts with placed partials (32 words), totals (16), placed
    partials (`group`)."""
    return 2 * cluster * (2 * ROUNDS_TILE + ROUNDS_TILE + group) * 4


def rounds_plan(n_nodes: int, n_active: int, n_classes: int, chunk: int,
                cluster: int) -> RoundsPlan:
    """K6's layout for n_nodes nodes with n_active active columns and
    n_classes classes in chunks of `chunk`, over `cluster` blocks. The
    global scratch holds every block's copy of the classes' remaining
    counts and its placed partials ([cluster, C] each), then, when the node
    state does not fit in shared memory, every block's node state."""
    nb = -(-n_nodes // cluster)
    stride = (nb + 31) & ~31
    group = min(((min(chunk, n_classes) + 15) & ~15), ROUNDS_MAX_GROUP)
    ex = rounds_exchange_bytes(cluster, group)
    node = rounds_node_bytes(stride, n_active)
    rows = ex + node <= ROUNDS_SMEM_BUDGET
    words = 2 * cluster * n_classes + (0 if rows else cluster * node // 4)
    return RoundsPlan(cluster, nb, stride, group, rows, ex + (node if rows else 0), words)


_ROUNDS_CLUSTER = {}  # (device index, N, R, A, C, chunk) -> the cluster size the card takes


def rounds_launch_plan(n_nodes: int, n_res: int, n_active: int, n_classes: int, chunk: int,
                       device) -> RoundsPlan:
    """The layout K6 launches with on `device` (a CUDA device): the first of
    ROUNDS_CLUSTER_SIZES the card has room for, asked of the card once per
    shape."""
    dev = torch.device(device)
    key = (dev.index, n_nodes, n_res, n_active, n_classes, chunk)
    if key not in _ROUNDS_CLUSTER:
        lib = _build.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.sched_rounds_cluster_size(n_nodes, n_res, n_active, n_classes, chunk,
                                               ctypes.addressof(out))
        _check(lib, rc, "schedule_classes_rounds (cluster size)")
        _ROUNDS_CLUSTER[key] = out.value
    return rounds_plan(n_nodes, n_active, n_classes, chunk, _ROUNDS_CLUSTER[key])


def _rounds_args(avail, total, alive, demands, counts, chunk, rounds, kernel):
    """K5's and K6's arguments checked: raises ValueError on a shape
    mismatch or a bad chunk (K6) or round count."""
    N, R = avail.shape
    C = demands.shape[0]
    if total.shape != (N, R) or alive.shape != (N,) or demands.shape != (C, R) \
            or counts.shape != (C,):
        raise ValueError(
            f"shape mismatch: avail {tuple(avail.shape)} total {tuple(total.shape)} "
            f"alive {tuple(alive.shape)} demands {tuple(demands.shape)} "
            f"counts {tuple(counts.shape)}"
        )
    if chunk < 1 or rounds < 0:
        raise ValueError(f"{kernel}: chunk={chunk} rounds={rounds}")


def _launch_rounds(avail, total, alive, demands, counts, spread_threshold, chunk,
                   rounds, active_idx, in_place=False):
    """The CUDA launch of K6: one kernel, one thread-block cluster, on the
    current stream. Returns (assigned, avail, launched)."""
    dev = avail.device
    N, R = avail.shape
    C = demands.shape[0]
    kernel = "schedule_classes_chunked"
    _rounds_args(avail, total, alive, demands, counts, chunk, rounds, kernel)
    active = _active_columns(demands, active_idx)
    new_avail = _round_view(avail, in_place)
    if N == 0 or C == 0 or rounds == 0:
        return torch.zeros((C, N), dtype=torch.int32, device=dev), new_avail, False
    lib = _build.load()
    total = total.to(torch.float32).contiguous()
    alive_u8 = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    plan = rounds_launch_plan(N, R, len(active), C, chunk, dev)
    # every cell is written by the kernel
    assigned = torch.empty((C, N), dtype=torch.int32, device=dev)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_rounds(
            new_avail.data_ptr(), total.data_ptr(), alive_u8.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), sum(1 << r for r in active),
            assigned.data_ptr(), scratch.data_ptr(), plan.scratch_words, N, R, C, chunk,
            plan.cluster, float(np.float32(spread_threshold)), int(rounds), _stream(dev),
        )
    _check(lib, rc, kernel)
    return assigned, new_avail, True


def _launch_rounds_phases(avail, total, alive, demands, counts, spread_threshold, rounds,
                          active_idx, in_place=False):
    """The CUDA launch of K5: three kernels a phase, six a round, on the
    current stream, after the zero fill of `assigned`. Returns (assigned,
    avail, launched)."""
    dev = avail.device
    N, R = avail.shape
    C = demands.shape[0]
    _rounds_args(avail, total, alive, demands, counts, max(C, 1), rounds,
                 "schedule_classes_rounds")
    active = _active_columns(demands, active_idx)
    new_avail = _round_view(avail, in_place)
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    if N == 0 or C == 0 or rounds == 0:
        return assigned, new_avail, False
    lib = _build.load()
    total = total.to(torch.float32).contiguous()
    alive_u8 = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    cap = torch.empty((C, N), dtype=torch.float32, device=dev)
    remaining = torch.empty(C, dtype=torch.float32, device=dev)
    placed = torch.empty(C, dtype=torch.int32, device=dev)
    n_feas = torch.empty(C, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_rounds_phases(
            new_avail.data_ptr(), total.data_ptr(), alive_u8.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), sum(1 << r for r in active),
            assigned.data_ptr(), cap.data_ptr(), remaining.data_ptr(), placed.data_ptr(),
            n_feas.data_ptr(), N, R, C, float(np.float32(spread_threshold)), int(rounds),
            _stream(dev),
        )
    _check(lib, rc, "schedule_classes_rounds")
    return assigned, new_avail, True


def schedule_classes_rounds(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                            demands: torch.Tensor, counts: torch.Tensor,
                            spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                            rounds: int = 4, active_idx=None, _in_place: bool = False):
    """K5. The fully parallel two-phase [C, N] placement, the semantics of
    kernel_np.schedule_classes_rounds (decisions bit-identical on integer-
    granular problems). active_idx: the resource columns any class demands
    (None: all). Same arguments (`_in_place` too) and result as
    schedule_classes. One call
    enqueues the zero fill of the result and six kernels a round (none
    when rounds == 0 or the problem is empty) and counts one launch."""
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_rounds_plain(avail, total, alive, demands, counts,
                                              spread_threshold, rounds, active_idx)
    assigned, new_avail, launched = _launch_rounds_phases(
        avail, total, alive, demands, counts, spread_threshold, rounds, active_idx, _in_place)
    schedule_classes_rounds.launches += launched
    return assigned, new_avail


schedule_classes_rounds.launches = 0


def schedule_classes_chunked(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                             demands: torch.Tensor, counts: torch.Tensor,
                             spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                             chunk: int = 16, rounds: int = 2, active_idx=None,
                             _in_place: bool = False):
    """K6. K5's core over `chunk` classes at a time, the availability carried
    from chunk to chunk (kernel_np.schedule_classes_chunked). One call is one
    launch of one thread-block cluster, whatever the number of chunks.
    `_in_place` as in schedule_classes."""
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_chunked_plain(avail, total, alive, demands, counts,
                                               spread_threshold, chunk, rounds, active_idx)
    assigned, new_avail, launched = _launch_rounds(
        avail, total, alive, demands, counts, spread_threshold, chunk, rounds, active_idx,
        _in_place)
    schedule_classes_chunked.launches += launched
    return assigned, new_avail


schedule_classes_chunked.launches = 0

#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "schedule_classes": schedule_classes,
    "scatter_rows": scatter_rows_,
    "delta_clip": delta_clip,
    "compact_nonzero": compact_nonzero,
    "schedule_classes_rounds": schedule_classes_rounds,
    "schedule_classes_chunked": schedule_classes_chunked,
}

#: scheduler_kernel_algo values and the kernels behind them
ALGOS = ("scan", "rounds", "chunked")


def launch_counts() -> dict:
    """Every kernel's launches by name, and how many of K2's and K3's K1
    applied in its own launch (scatter_rows_fused, delta_clip_fused)."""
    out = {name: fn.launches for name, fn in KERNELS.items()}
    out.update(scatter_rows_fused=scatter_rows_.fused, delta_clip_fused=delta_clip.fused)
    return out


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    scatter_rows_.fused = delta_clip.fused = 0


# --------------------------------------------------------------- scheduler


class TorchScheduler:
    """Device-resident cluster view (twin of kernel_jax.JaxScheduler): the
    host pushes incremental availability updates (dirty rows, deltas) and
    the full view is re-uploaded only on topology change. The view is its
    own (every upload is a copy), so its rounds write it in place.

    A refresh (update_rows, apply_delta) is copied to the device when it is
    pushed and held as pending, at most one at a time: the next scan round
    applies it in K1's own launch; a second refresh, set_available (which
    drops it), the rounds and chunked algorithms and any read of `avail`
    apply it first, by K2/K3 alone."""

    # row-index buckets: the scatter is padded to a few static shapes
    _ROW_BUCKETS = (16, 64, 256, 1024, 4096)
    # cap buckets for the sparse download
    _NONZERO_BUCKETS = (1024, 4096, 16384, 65536, 262144)

    def __init__(self, total: np.ndarray, alive: np.ndarray, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _build.load()
        self.total = self._put(np.asarray(total, np.float32))
        self.alive = self._put(np.asarray(alive, bool))
        self._view = self.total * self.alive[:, None].to(torch.float32)
        self._pending: Optional[Refresh] = None

    @property
    def avail(self) -> torch.Tensor:
        """The view [N, R] float32, with the pending refresh applied."""
        self._flush()
        return self._view

    def _put(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU .to() would alias the caller's array,
        # which update_rows then scatters into
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    def _staged(self, shape, dtype) -> torch.Tensor:
        """A host buffer a refresh's operands are written into: on a card
        page-locked, from PyTorch's caching host allocator (which reuses a
        block only after its copy has completed). NumPy fills it: PyTorch's
        CPU copy_ into it took milliseconds a call inside the stream's host
        loop on an H100's host (PERF.md)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _send(self, host: torch.Tensor) -> torch.Tensor:
        """A staged buffer on the device, copied now, on the current stream,
        without blocking the host (the CPU's view takes the buffer itself)."""
        return host if self.device.type == "cpu" else host.to(self.device, non_blocking=True)

    def _hold(self, mode, idx, src):
        """Make (mode, idx, src), on the device, the pending refresh, after
        applying the one it replaces."""
        self._flush()
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        self._pending = Refresh(mode, idx, src, stream)

    def _take_pending(self) -> Optional[Refresh]:
        """The pending refresh, no longer pending, readable on the current
        stream (its copy was enqueued on the stream it holds)."""
        ref, self._pending = self._pending, None
        if ref is not None and ref.stream is not None:
            cur = torch.cuda.current_stream(self.device)
            if ref.stream != cur:
                cur.wait_stream(ref.stream)
                ref.src.record_stream(cur)  # rows mode: idx shares src's block
        return ref

    def _flush(self) -> None:
        """Apply the pending refresh to the view by K2/K3 alone."""
        ref = self._take_pending()
        if ref is not None:
            ref.apply(self._view, self.total)

    def set_available(self, avail: np.ndarray):
        """The whole view, uploaded; a pending refresh is dropped."""
        self._pending = None
        self._view = self._put(np.asarray(avail, np.float32))

    def apply_delta(self, delta: np.ndarray):
        """avail += delta (negative = allocation), clipped to [0, total]."""
        delta = np.asarray(delta, np.float32)
        host = self._staged(delta.shape, torch.float32)
        np.copyto(host.numpy(), delta)
        self._hold("delta", None, self._send(host))

    def update_rows(self, idx, rows: np.ndarray):
        """Authoritative per-row refresh: avail[idx] = rows (the dirty rows
        of NodeResourceState). Padded indices point one past the end and
        are dropped by the scatter. idx and the rows go to the device in one
        buffer, by one copy."""
        n = len(idx)
        if n == 0:
            return
        N, R = (int(x) for x in self.total.shape)
        if n >= N:
            self.set_available(rows if len(rows) == N else rows[:N])
            return
        pad = next((b for b in self._ROW_BUCKETS if n <= b), n)
        host = self._staged((pad * (1 + R),), torch.int32)  # idx, then the rows' bits
        ii = host.numpy()[:pad]
        ii[:n] = np.asarray(idx, dtype=np.int32)
        ii[n:] = N
        vv = host.numpy()[pad:].view(np.float32).reshape(pad, R)
        vv[:n] = rows
        vv[n:] = 0.0
        buf = self._send(host)
        self._hold("rows", buf[:pad], buf[pad:].view(torch.float32).view(pad, R))

    def _round(self, demands, counts, spread_threshold, algo):
        if algo not in ALGOS:
            raise ValueError(f"scheduler_kernel_algo {algo!r} is not one of {ALGOS}")
        pad = bucket_size(demands.shape[0])
        d, k = pad_problem(np.asarray(demands, np.float32), np.asarray(counts), pad)
        if algo != "scan":
            self._flush()
        args = (self._view, self.total, self.alive, self._put(d), self._put(k),
                spread_threshold)
        kw = {"_in_place": True}  # the round writes the view it replaces
        if algo == "scan":  # K1 applies the pending refresh in its launch
            assigned, self._view = schedule_classes(*args, _refresh=self._take_pending(), **kw)
        else:
            # padded classes demand INF_FIT of resource 0, so they are inert
            # in the matrix passes, but resource 0 must stay in the active
            # set for that guard to execute (as JaxScheduler does)
            active = tuple(int(i) for i in np.flatnonzero((d > 0).any(axis=0)))
            if algo == "rounds":
                assigned, self._view = schedule_classes_rounds(
                    *args, rounds=4, active_idx=active, **kw)
            else:
                assigned, self._view = schedule_classes_chunked(
                    *args, chunk=16, rounds=2, active_idx=active, **kw)
        return assigned[: demands.shape[0]]

    def _download(self, t: torch.Tensor) -> torch.Tensor:
        """Start the device->host copy of t into page-locked memory (from
        PyTorch's caching host allocator, which reuses a block only after
        its copy has completed); the caller records the event."""
        if self.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def schedule_async(self, demands: np.ndarray, counts: np.ndarray,
                       spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                       algo: str = "scan") -> dict:
        """Enqueue one scheduling round with no host<->device sync. The
        narrow-dtyped result is copied into page-locked host buffers with
        non_blocking=True and a CUDA event is recorded after the copies;
        fetch() waits on that event alone."""
        out = self._round(demands, counts, spread_threshold, algo)
        C, N = out.shape
        cap_needed = int(np.sum(counts, dtype=np.int64))
        cap = next((b for b in self._NONZERO_BUCKETS if b >= cap_needed), None)
        m = int(np.max(counts, initial=0))
        if cap is not None and cap * 5 < C * N:
            # sparse (COO) download: the assignment is mostly zeros
            ci, ni, vals = compact_nonzero(
                out, cap,
                ci_dtype=torch.int16 if C < 32768 else torch.int32,
                ni_dtype=torch.int16 if N < 32768 else torch.int32,
                val_dtype=torch.uint8 if m < 256 else torch.int32,
            )
            parts = {k: self._download(v)
                     for k, v in (("ci", ci), ("ni", ni), ("vals", vals))}
            handle = {"sparse": parts, "shape": (C, N)}
        else:
            # dense: narrowed from HOST knowledge (a class places at most
            # its own count on one node); never sync for the exact max
            if m < 256:
                out = out.to(torch.uint8)
            elif m < 32768:
                out = out.to(torch.int16)
            handle = {"out": self._download(out), "shape": (C, N)}
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            handle["event"] = ev
        return handle

    def fetch(self, handle: dict) -> np.ndarray:
        """Force a schedule_async handle to a host int32 [C, N] array."""
        ev = handle.pop("event", None)
        if ev is not None:
            ev.synchronize()
        if "sparse" in handle:
            s = handle["sparse"]
            for k in ("ci", "ni", "vals"):
                if isinstance(s[k], torch.Tensor):
                    s[k] = s[k].numpy()
            ci = s["ci"].astype(np.int64)
            ni = s["ni"].astype(np.int64)
            vals = s["vals"].astype(np.int32)
            dense = np.zeros(handle["shape"], np.int32)
            # plain assignment, not add: every duplicate index pair is a
            # padding replica of cell (0, 0) carrying the same value
            dense[ci, ni] = vals
        else:
            if isinstance(handle["out"], torch.Tensor):
                handle["out"] = handle["out"].numpy()
            dense = handle["out"].reshape(handle["shape"]).astype(np.int32)
        return dense

    def schedule(self, demands: np.ndarray, counts: np.ndarray,
                 spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                 algo: str = "scan") -> np.ndarray:
        out = self._round(demands, counts, spread_threshold, algo)
        if out.shape[0] == 0:
            return out.cpu().numpy()
        # narrow-dtype download: max(counts) bounds every cell host-side;
        # only when it cannot prove uint8 is the exact device max worth a sync
        m = int(np.max(counts, initial=0))
        if m >= 256:
            m = int(out.max())
        if m < 256:
            return out.to(torch.uint8).cpu().numpy().astype(np.int32)
        if m < 32768:
            return out.to(torch.int16).cpu().numpy().astype(np.int32)
        return out.cpu().numpy()


def load_cluster_view(total: np.ndarray, alive: np.ndarray, avail: np.ndarray,
                      device=None) -> TorchScheduler:
    """Build a TorchScheduler holding the given cluster view — e.g. the
    arrays of a JaxScheduler (np.asarray(js.total), np.asarray(js.alive),
    np.asarray(js.avail)) — so both packages can run on one state."""
    sched = TorchScheduler(total, alive, device=device)
    sched.set_available(avail)
    return sched
