"""PyTorch/CUDA twin of the NumPy scheduler kernels — the `policy="torch_cuda"` path.

Counterpart of ray_tpu/sched/kernel_jax.py. The four device programs of a
scheduling round are hand-written CUDA kernels (csrc/sched_kernels.cu, built
by _build.py on first CUDA use); each has a public wrapper here and, beside
it, a plain PyTorch version of the same function:

  K1 schedule_classes  the batched hybrid placement round
  K2 scatter_rows_     dirty-row refresh of the device availability
  K3 delta_clip        clip(avail + delta, 0, total)
  K4 compact_nonzero   COO compaction of the [C, N] assignment for download
  K5 schedule_classes_rounds   the fully parallel two-phase [C, N] round
                               (scheduler_kernel_algo="rounds")
  K6 schedule_classes_chunked  K5's core over chunks of 16 classes
                               (scheduler_kernel_algo="chunked")

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel.

Decisions are bit-identical to kernel_np.schedule_classes (and, for K5/K6,
to kernel_np.schedule_classes_rounds / _chunked on integer-granular
problems), golden-tested in tests/test_torch_sched_kernel.py and
tests/test_torch_sched_rounds.py against kernel_np and kernel_jax: IEEE
float32 division, no fast math, no product-into-sum contraction, and exact
integer prefix sums in the score-ordered fill.

TorchScheduler is the twin of kernel_jax.JaxScheduler: the cluster view
stays resident on the device across rounds, the host pushes dirty rows or
deltas, and schedule_async / fetch pipeline rounds without a host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.sched import _build

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
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch: the scheduler runs on a CUDA device, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(Config key scheduler_device='cpu') to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported scheduler device {dev}")
    return dev


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


def _device_of(*tensors) -> torch.device:
    """The one device all tensors lie on; raise on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.sched_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


# ------------------------------------------------------------------------- K1


def _schedule_classes_plain(avail, total, alive, demands, counts,
                            spread_threshold=DEFAULT_SPREAD_THRESHOLD,
                            max_passes=MAX_PASSES, passes_out=None):
    """Plain PyTorch version of K1: kernel_np.schedule_classes, op for op.
    `passes_out`, a list, receives the number of passes each class ran."""
    dev = avail.device
    avail = avail.to(torch.float32).clone()
    total = total.to(torch.float32)
    alive = alive.to(torch.bool)
    d_host = demands.detach().to("cpu", torch.float32).numpy()
    k_host = counts.detach().to("cpu").numpy()
    demands = demands.to(torch.float32)
    C = d_host.shape[0]
    N = avail.shape[0]
    eps = _f32(EPS).to(dev)
    thr = _f32(spread_threshold).to(dev)
    denom = _f32(max(1e-6, 1.0 - spread_threshold)).to(dev)
    zero = _f32(0.0).to(dev)
    inf_fit = float(INF_FIT)
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
            # _class_fit
            if len(pos) == 0:
                fit = torch.where(alive, INF_FIT, 0).to(torch.int32)
            else:
                ratios = torch.floor((avail[:, pos] + eps) / dpos[None, :])
                fit = torch.clamp(ratios.min(dim=1).values, 0.0, inf_fit)
                fit = torch.where(alive, fit, zero).to(torch.int32)
            n_feasible = int((fit > 0).sum())
            if n_feasible == 0:
                break
            # critical_util
            used = total - avail
            frac = torch.where(total > 0, used / torch.maximum(total, eps), zero)
            util = frac.max(dim=1).values
            # _score_bucket
            over = torch.clamp((util - thr) / denom, 0.0, 1.0)
            b = torch.where(
                util >= thr, 1.0 + torch.floor(over * float(SCORE_BUCKETS - 2)), zero
            )
            bucket = torch.clamp(b, 0, SCORE_BUCKETS - 1).to(torch.int32)
            under = util < thr
            # _threshold_cap
            if len(pos) == 0:
                cap_thresh = torch.full((N,), int(INF_FIT), dtype=torch.int32, device=dev)
            else:
                head = thr * total[:, pos] - used[:, pos]
                k = torch.floor((head + eps) / dpos[None, :]).min(dim=1).values
                k = torch.clamp(k, 0.0, float(np.float32(inf_fit - 1.0)))
                cap_thresh = (k + 1.0).to(torch.int32)
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


def schedule_classes(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                     demands: torch.Tensor, counts: torch.Tensor,
                     spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                     max_passes: int = MAX_PASSES):
    """K1. Batched hybrid placement, the semantics of kernel_np.schedule_classes.

    avail/total [N, R] float32, alive [N] bool, demands [C, R] float32,
    counts [C] int32. Returns (assigned [C, N] int32, new avail [N, R]
    float32); the input `avail` is not modified.
    """
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_plain(
            avail, total, alive, demands, counts, spread_threshold, max_passes
        )
    N, R = avail.shape
    C = demands.shape[0]
    if total.shape != (N, R) or alive.shape != (N,) or demands.shape != (C, R) \
            or counts.shape != (C,):
        raise ValueError(
            f"shape mismatch: avail {tuple(avail.shape)} total {tuple(total.shape)} "
            f"alive {tuple(alive.shape)} demands {tuple(demands.shape)} "
            f"counts {tuple(counts.shape)}"
        )
    lib = _build.load()
    new_avail = avail.to(torch.float32).contiguous().clone()
    total = total.to(torch.float32).contiguous()
    alive_u8 = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.sched_k1_scratch_words(N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_classes(
            new_avail.data_ptr(), total.data_ptr(), alive_u8.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), assigned.data_ptr(),
            scratch.data_ptr(), N, R, C,
            float(np.float32(spread_threshold)),
            float(np.float32(max(1e-6, 1.0 - spread_threshold))),
            int(max_passes), _stream(dev),
        )
    _check(lib, rc, "schedule_classes")
    schedule_classes.launches += 1
    return assigned, new_avail


schedule_classes.launches = 0


# ------------------------------------------------------------------------- K2


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
    in the reference. Indices in range must be distinct. Returns avail."""
    dev = _device_of(avail, idx, rows)
    if dev.type == "cpu":
        return _scatter_rows_plain_(avail, idx, rows)
    N, R = avail.shape
    pad = idx.shape[0]
    if rows.shape != (pad, R) or avail.dtype != torch.float32 \
            or not avail.is_contiguous():
        raise ValueError(
            f"scatter_rows_: avail {tuple(avail.shape)} {avail.dtype} "
            f"(contiguous float32 needed), idx {tuple(idx.shape)}, "
            f"rows {tuple(rows.shape)}"
        )
    lib = _build.load()
    idx = idx.to(torch.int32).contiguous()
    rows = rows.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        rc = lib.sched_scatter_rows(avail.data_ptr(), idx.data_ptr(), rows.data_ptr(),
                                    pad, N, R, _stream(dev))
    _check(lib, rc, "scatter_rows")
    scatter_rows_.launches += 1
    return avail


scatter_rows_.launches = 0


# ------------------------------------------------------------------------- K3


def _delta_clip_plain(avail, delta, total):
    """Plain version of K3 (jnp.clip(avail + delta, 0, total))."""
    x = avail + delta
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), total)


def delta_clip(avail: torch.Tensor, delta: torch.Tensor, total: torch.Tensor):
    """K3. Returns clip(avail + delta, 0, total) as a new [N, R] float32."""
    dev = _device_of(avail, delta, total)
    if dev.type == "cpu":
        return _delta_clip_plain(avail, delta, total)
    if not (avail.shape == delta.shape == total.shape):
        raise ValueError(
            f"delta_clip: shapes {tuple(avail.shape)} {tuple(delta.shape)} "
            f"{tuple(total.shape)} differ"
        )
    lib = _build.load()
    avail = avail.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    total = total.to(torch.float32).contiguous()
    out = torch.empty_like(avail)
    with torch.cuda.device(dev):
        rc = lib.sched_delta_clip(out.data_ptr(), avail.data_ptr(), delta.data_ptr(),
                                  total.data_ptr(), avail.numel(), _stream(dev))
    _check(lib, rc, "delta_clip")
    delta_clip.launches += 1
    return out


delta_clip.launches = 0


# ------------------------------------------------------------------------- K4

_IDX_DTYPES = (torch.int16, torch.int32)
_VAL_DTYPES = (torch.uint8, torch.int32)


def _compact_nonzero_plain(out, cap, ci_dtype, ni_dtype, val_dtype):
    """Plain version of K4: the kernel's count -> scan -> ordered write."""
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
    C, N = out.shape
    lib = _build.load()
    x = out.to(torch.int32).contiguous()
    M = x.numel()
    ci = torch.empty(cap, dtype=ci_dtype, device=dev)
    ni = torch.empty(cap, dtype=ni_dtype, device=dev)
    vals = torch.empty(cap, dtype=val_dtype, device=dev)
    n_tiles = lib.sched_nonzero_tiles(M)
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_offsets = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_compact_nonzero(
            x.data_ptr(), M, N, cap, ci.data_ptr(), ci.element_size(), ni.data_ptr(),
            ni.element_size(), vals.data_ptr(), vals.element_size(),
            tile_counts.data_ptr(), tile_offsets.data_ptr(), _stream(dev),
        )
    _check(lib, rc, "compact_nonzero")
    compact_nonzero.launches += 1
    return ci, ni, vals


compact_nonzero.launches = 0


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


def _launch_rounds(avail, total, alive, demands, counts, spread_threshold, chunk,
                   rounds, active_idx, kernel):
    """The CUDA launch of K5 (chunk >= C) and K6: one C call that enqueues
    six launches per round and chunk on the current stream."""
    dev = avail.device
    N, R = avail.shape
    C = demands.shape[0]
    if total.shape != (N, R) or alive.shape != (N,) or demands.shape != (C, R)             or counts.shape != (C,):
        raise ValueError(
            f"shape mismatch: avail {tuple(avail.shape)} total {tuple(total.shape)} "
            f"alive {tuple(alive.shape)} demands {tuple(demands.shape)} "
            f"counts {tuple(counts.shape)}"
        )
    if chunk < 1 or rounds < 0:
        raise ValueError(f"{kernel}: chunk={chunk} rounds={rounds}")
    mask = sum(1 << r for r in _active_columns(demands, active_idx))
    lib = _build.load()
    new_avail = avail.to(torch.float32).contiguous().clone()
    total = total.to(torch.float32).contiguous()
    alive_u8 = alive.to(torch.bool).contiguous()
    demands = demands.to(torch.float32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    assigned = torch.zeros((C, N), dtype=torch.int32, device=dev)
    cap = torch.empty((min(chunk, max(C, 1)), N), dtype=torch.float32, device=dev)
    remaining = torch.empty(C, dtype=torch.float32, device=dev)
    placed = torch.empty(C, dtype=torch.int32, device=dev)
    n_feas = torch.empty(C, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sched_schedule_rounds(
            new_avail.data_ptr(), total.data_ptr(), alive_u8.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), mask, assigned.data_ptr(),
            cap.data_ptr(), remaining.data_ptr(), placed.data_ptr(), n_feas.data_ptr(),
            N, R, C, chunk, float(np.float32(spread_threshold)), int(rounds), _stream(dev),
        )
    _check(lib, rc, kernel)
    return assigned, new_avail


def schedule_classes_rounds(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                            demands: torch.Tensor, counts: torch.Tensor,
                            spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                            rounds: int = 4, active_idx=None):
    """K5. The fully parallel two-phase [C, N] placement, the semantics of
    kernel_np.schedule_classes_rounds (decisions bit-identical on integer-
    granular problems). active_idx: the resource columns any class demands
    (None: all). Same arguments and result as schedule_classes."""
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_rounds_plain(avail, total, alive, demands, counts,
                                              spread_threshold, rounds, active_idx)
    out = _launch_rounds(avail, total, alive, demands, counts, spread_threshold,
                         max(demands.shape[0], 1), rounds, active_idx,
                         "schedule_classes_rounds")
    schedule_classes_rounds.launches += 1
    return out


schedule_classes_rounds.launches = 0


def schedule_classes_chunked(avail: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
                             demands: torch.Tensor, counts: torch.Tensor,
                             spread_threshold: float = DEFAULT_SPREAD_THRESHOLD,
                             chunk: int = 16, rounds: int = 2, active_idx=None):
    """K6. K5's core over `chunk` classes at a time, the availability carried
    from chunk to chunk (kernel_np.schedule_classes_chunked). One call is one
    count of `launches`, whatever the number of chunks."""
    dev = _device_of(avail, total, alive, demands, counts)
    if dev.type == "cpu":
        return _schedule_classes_chunked_plain(avail, total, alive, demands, counts,
                                               spread_threshold, chunk, rounds, active_idx)
    out = _launch_rounds(avail, total, alive, demands, counts, spread_threshold, chunk,
                         rounds, active_idx, "schedule_classes_chunked")
    schedule_classes_chunked.launches += 1
    return out


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
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# --------------------------------------------------------------- scheduler


class TorchScheduler:
    """Device-resident cluster view (twin of kernel_jax.JaxScheduler): the
    host pushes incremental availability updates (dirty rows, deltas) and
    the full view is re-uploaded only on topology change."""

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
        self.avail = self.total * self.alive[:, None].to(torch.float32)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU .to() would alias the caller's array,
        # which update_rows then scatters into
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    def set_available(self, avail: np.ndarray):
        self.avail = self._put(np.asarray(avail, np.float32))

    def apply_delta(self, delta: np.ndarray):
        """avail += delta (negative = allocation), clipped to [0, total]."""
        d = self._put(np.asarray(delta, np.float32))
        self.avail = delta_clip(self.avail, d, self.total)

    def update_rows(self, idx, rows: np.ndarray):
        """Authoritative per-row refresh: avail[idx] = rows (the dirty rows
        of NodeResourceState). Padded indices point one past the end and
        are dropped by the scatter."""
        n = len(idx)
        if n == 0:
            return
        N = int(self.total.shape[0])
        if n >= N:
            self.set_available(rows if len(rows) == N else rows[:N])
            return
        pad = next((b for b in self._ROW_BUCKETS if n <= b), n)
        ii = np.full(pad, N, dtype=np.int32)
        ii[:n] = np.asarray(idx, dtype=np.int32)
        vv = np.zeros((pad, self.total.shape[1]), dtype=np.float32)
        vv[:n] = rows
        scatter_rows_(self.avail, self._put(ii), self._put(vv))

    def _round(self, demands, counts, spread_threshold, algo):
        if algo not in ALGOS:
            raise ValueError(f"scheduler_kernel_algo {algo!r} is not one of {ALGOS}")
        pad = bucket_size(demands.shape[0])
        d, k = pad_problem(np.asarray(demands, np.float32), np.asarray(counts), pad)
        args = (self.avail, self.total, self.alive, self._put(d), self._put(k),
                spread_threshold)
        if algo == "scan":
            assigned, self.avail = schedule_classes(*args)
        else:
            # padded classes demand INF_FIT of resource 0, so they are inert
            # in the matrix passes, but resource 0 must stay in the active
            # set for that guard to execute (as JaxScheduler does)
            active = tuple(int(i) for i in np.flatnonzero((d > 0).any(axis=0)))
            if algo == "rounds":
                assigned, self.avail = schedule_classes_rounds(
                    *args, rounds=4, active_idx=active)
            else:
                assigned, self.avail = schedule_classes_chunked(
                    *args, chunk=16, rounds=2, active_idx=active)
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
