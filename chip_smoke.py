#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase's exception is
caught):

0. the card's name and power limit; build the CUDA kernels from
   ray_tpu_torch/sched/csrc and ray_tpu_torch/models/csrc (three sources),
   one nvcc each, started together (build seconds printed).
1. every kernel against its plain PyTorch version on the card, with exact
   equality: K1 on the golden problem of the kernel tests, on seeded random
   problems (dead nodes, masked custom resources, over-subscribed classes)
   and on the 10k-node x 256-class stream problem; K2, K3 and K4 at the
   bucket edges; K5 (rounds) and K6 (chunked) on the rounds kernels' golden
   problems, the random problems and the stream problem. K1, K5 and K6 are
   also held against the NumPy reference (kernel_np). Median device times
   of each kernel and its plain version.
2. the 1M-task stream over 10k nodes (20% of the fleet held back, an
   autoscale flip, completions releasing resources) through
   TorchScheduler.schedule_async / fetch / apply_delta / update_rows, with
   the standing invariants asserted on every fetched round; once for each
   scheduler_kernel_algo (scan K1, rounds K5, chunked K6).
3. a torch_cuda policy on CUDA and one on the CPU, in lockstep on
   identical 10k-node states, over synchronous and pipelined rounds;
   decisions must be equal every round and the invariant guard silent.
4. the user entry points: ray_tpu_torch.init / @remote / get with
   dependencies and an actor, scheduled through the CUDA kernel.
5. the GCS scheduling loop (cluster/gcs.py) over 10k fake nodes and 256
   task classes, for each algorithm: (a) a torch_cuda GCS on CUDA and a
   hybrid (NumPy) GCS in lockstep on one submission sequence, placements
   equal task for task; (b) a pipelined torch_cuda GCS draining every task
   with nothing leaked; (c) a GCS built with the default config, its
   scheduler loop live, fed over an RPC connection as a driver feeds it.

6. the flagship transformer's forward (ray_tpu_torch.models, the default
   TransformerConfig in bf16, weights from a numpy seed): (a) K8 (both
   forms), K10a and K10b against their plain versions at the forward's
   shapes, in bf16 and f32, with times, bounds and the library yardsticks
   (scaled_dot_product_attention, rms_norm); (b) make_forward_step on
   [8, 2048] tokens, finite logits, timed; (c) the model held by an actor
   of ray_tpu_torch.init(), answering 8 requests; (d) the checks of what
   (b) and (c) gave: two sequences against the plain forward on the CPU,
   the loss at [8, 2049], both dtypes against the JAX package's golden
   (tests/data/transformer_golden.npz), each served answer equal to the
   direct call, and the ring's schedule of K8 block steps on one card
   against the whole-sequence kernel.
7. the expert layer (ray_tpu_torch.models.moe, MoEConfig(): d_model 256,
   d_ff 512, 8 experts, capacity factor 1.25, bf16; weights from the MoE
   golden's numpy seed; tokens skewed toward expert 0 so that the capacity
   drops some): (a) K9a routing, K9b dispatch and K9c combine against their
   plain versions at the main path's shapes (bit-equal; gate within 1e-6),
   in bf16 and f32, with times, bounds and the gather alone
   (index_select) as the yardstick; (b) moe_ffn on x [8, 2048, 256] bf16,
   timed, with a dropped share above 0; (c) the layer held by an actor of
   ray_tpu_torch.init(), answering 8 requests of assorted [G, S]; (d) the
   checks: K9a on the JAX golden's logits gives JAX's routing, moe_ffn in
   both dtypes against the golden (tests/data/moe_golden.npz) over the
   groups free of near-ties, two groups against the plain moe_ffn on the
   CPU, each served answer equal to the direct call.

Launch counters are set to 0 just before phase 2 and read after phase 5,
the model kernels' just before 6b and after 6c, and the expert kernels'
just before 7b and after 7c: every kernel of each path must have launched
in its run. K8's block form runs on no ported
path yet (the ring across cards is still to port); its launches in (d)'s
check are printed on a line of their own, not among the kernels. The
JSON line before the card's name and power limit lists the kernels; the
last line is the result.
Exits non-zero without a result when no CUDA device is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
R = 16
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor) op/s
# and bf16 dense tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
CU_SOURCE = "ray_tpu_torch/sched/csrc/sched_kernels.cu"
MODEL_CU_SOURCE = "ray_tpu_torch/models/csrc/model_kernels.cu"
MOE_CU_SOURCE = "ray_tpu_torch/models/csrc/moe_kernels.cu"
GOLDEN_PATH = os.path.join(HERE, "tests", "data", "transformer_golden.npz")
MOE_GOLDEN_PATH = os.path.join(HERE, "tests", "data", "moe_golden.npz")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ problems


def build_stream_problem(rng, n_nodes=10_000, n_classes=256, n_tasks=1_000_000):
    """The stream cluster of bench.py's headline configuration:
    heterogeneous, CPU-bound at ~80% of one wave."""
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(128, 513, n_nodes)  # CPU
    total[:, 2] = np.where(rng.random(n_nodes) < 0.2, 8.0, 0.0)  # accelerator
    total[:, 3] = rng.integers(512, 4097, n_nodes)  # memory (GB-ish)
    alive = np.ones(n_nodes, bool)

    demands = np.zeros((n_classes, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, n_classes)
    heavy = rng.random(n_classes) < 0.3
    demands[heavy, 3] = rng.integers(1, 9, heavy.sum())
    acc = rng.random(n_classes) < 0.1
    demands[acc, 2] = rng.integers(1, 3, acc.sum())
    counts = rng.multinomial(
        n_tasks, np.ones(n_classes) / n_classes
    ).astype(np.int32)
    cpu_demand = float((demands[:, 0] * counts).sum())
    total[:, 0] *= np.float32(cpu_demand / 0.8 / total[:, 0].sum())
    total[:, 0] = np.maximum(np.round(total[:, 0]), 1)
    return total, alive, demands, counts


def golden_problem():
    """The golden problem of tests/test_sched_kernel.py (seed 42)."""
    from ray_tpu_torch.sched.resources import (
        NodeResourceState, ResourceSpace, pack_demands,
    )

    rng = np.random.default_rng(42)
    N, C = 64, 7
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = st.available * rng.uniform(
        0.3, 1.0, size=st.available.shape).astype(np.float32)
    st.available = np.floor(st.available)
    demand_maps = []
    for _ in range(C):
        d = {"CPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            d["TPU"] = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            d["memory"] = float(rng.integers(1, 8))
        demand_maps.append(d)
    demands = pack_demands(space, demand_maps)
    counts = rng.integers(1, 200, size=C).astype(np.int32)
    return st.available, st.total, st.alive, demands, counts


def random_problem(seed, N=2048, C=48):
    """Dead nodes, a masked custom resource, over-subscribed classes."""
    rng = np.random.default_rng(seed)
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(1, 65, N)
    total[:, 3] = rng.integers(4, 257, N)
    total[:, 5] = np.where(rng.random(N) < 0.1, rng.integers(1, 5, N), 0)
    alive = rng.random(N) > 0.1
    avail = np.floor(total * rng.uniform(0.0, 1.0, total.shape)).astype(np.float32)
    avail *= alive[:, None]
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 9, C)
    demands[:, 3] = np.where(rng.random(C) < 0.5, rng.integers(1, 17, C), 0)
    demands[:, 5] = np.where(rng.random(C) < 0.2, 1, 0)
    counts = rng.integers(0, 4000, C).astype(np.int32)
    return avail, total, alive, demands, counts


def rounds_problem(seed, N=96, C=9):
    """The problems of the rounds kernels' golden tests
    (tests/test_sched_rounds.py _random_problem)."""
    from ray_tpu_torch.sched.resources import (
        NodeResourceState, ResourceSpace, pack_demands,
    )

    rng = np.random.default_rng(seed)
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = np.floor(
        st.available * rng.uniform(0.3, 1.0, size=st.available.shape)
    ).astype(np.float32)
    demand_maps = []
    for _ in range(C):
        d = {"CPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            d["TPU"] = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            d["memory"] = float(rng.integers(1, 8))
        demand_maps.append(d)
    demands = pack_demands(space, demand_maps)
    counts = rng.integers(1, 200, size=C).astype(np.int32)
    return st.available, st.total, st.alive, demands, counts


# ------------------------------------------------------------------- timing


def time_ms(torch, fn, reps=7, warm=2):
    """Median device time of fn(): the GPU is kept busy with a sleep kernel
    while the host enqueues the events and fn's launches, so the interval
    between the events is device time, not host launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(bytes_moved, ops, peak_ops_per_s=PEAK_F32_OPS_PER_S):
    """The least time for the work: bytes at the HBM rate or operations at
    the peak rate of their type (float32 unless given), whichever is larger."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------- phases


def phase1_kernels(torch, KT, kernel_np, dev):
    """Each kernel against its plain version on the card, exact equality."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rec = {name: {"max_abs_err": 0.0} for name in KT.KERNELS}

    def err(name, a, b):
        d = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
            if a.numel() else 0.0
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel != plain (max abs err {d})")

    # K1 on golden, random and stream problems
    problems = [("golden", golden_problem())]
    problems += [(f"random{s}", random_problem(s)) for s in (1, 2, 3)]
    total5, alive5, demands5, counts5 = build_stream_problem(np.random.default_rng(5))
    alive_s = alive5.copy()
    alive_s[int(len(alive_s) * 0.8):] = False
    first = np.floor(counts5 / 10).astype(np.int32)
    problems.append(("stream_first_round", (total5 * alive_s[:, None], total5,
                                            alive_s, demands5, first)))
    problems.append(("stream_full_backlog", (total5.copy(), total5, alive5,
                                             demands5, counts5)))
    for name, (avail, total, alive, demands, counts) in problems:
        args = (T(avail), T(total), T(alive), T(demands), T(counts))
        a_k, v_k = KT.schedule_classes(*args)
        passes = []
        a_p, v_p = KT._schedule_classes_plain(*args, passes_out=passes)
        err("schedule_classes", a_k, a_p)
        err("schedule_classes", v_k, v_p)
        a_n, v_n = kernel_np.schedule_classes(avail, total, alive, demands, counts)
        if not np.array_equal(a_n, a_k.cpu().numpy()):
            raise AssertionError(f"K1 {name}: kernel != kernel_np")
        if not np.allclose(v_n, v_k.cpu().numpy(), atol=1e-3):
            raise AssertionError(f"K1 {name}: avail differs from kernel_np")
        log(f"K1 {name}: N={len(total)} C={len(demands)} placed={int(a_k.sum())} "
            f"passes={sum(passes)} == plain == kernel_np")
    # time K1 at the stream's first-round shape (the main path's shape)
    avail, total, alive, demands, counts = problems[-2][1]
    d_pad, k_pad = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    args = (T(avail), T(total), T(alive), T(d_pad), T(k_pad))
    passes = []
    KT._schedule_classes_plain(*args, passes_out=passes)
    N, C = len(total), len(d_pad)
    npos = (d_pad > 0).sum(axis=1)
    # per pass and node: 3 ops per column for utilization, 11 per demanded
    # column for fit and threshold cap, ~10 for bucket, cap and fill
    ops = sum(p * N * (3 * R + 11 * int(q) + 10) for p, q in zip(passes, npos))
    bytes_k1 = 3 * N * R * 4 + N + C * R * 4 + C * 4 + C * N * 4
    rec["schedule_classes"].update(
        ms=time_ms(torch, lambda: KT.schedule_classes(*args)),
        plain_ms=time_ms(torch, lambda: KT._schedule_classes_plain(*args), reps=3, warm=1),
        library_ms=None, bound=bound(bytes_k1, ops),
    )

    # K2 at the row buckets' edges, N = 10k
    rng = np.random.default_rng(7)
    N = len(total5)
    base = T(total5)
    for n_dirty, pad in ((1, 16), (16, 16), (17, 64), (64, 64), (200, 256),
                         (1000, 1024), (4096, 4096)):
        idx = np.full(pad, N, np.int32)
        idx[:n_dirty] = rng.choice(N, n_dirty, replace=False)
        rows = rng.integers(0, 100, (pad, R)).astype(np.float32)
        ak = KT.scatter_rows_(base.clone(), T(idx), T(rows))
        ap = KT._scatter_rows_plain_(base.clone(), T(idx), T(rows))
        err("scatter_rows", ak, ap)
    # time at the autoscale flip's shape: 1000 rows -> pad 1024
    idx = np.full(1024, N, np.int32)
    idx[:1000] = np.arange(8000, 9000)
    rows = total5[8000:9000]
    ti, tr = T(idx), T(np.concatenate([rows, np.zeros((24, R), np.float32)]))
    work = base.clone()
    rec["scatter_rows"].update(
        ms=time_ms(torch, lambda: KT.scatter_rows_(work, ti, tr), reps=21),
        plain_ms=time_ms(torch, lambda: KT._scatter_rows_plain_(work, ti, tr), reps=21),
        library_ms=None, bound=bound(1024 * 4 + 1024 * R * 4 + 1000 * R * 4, 0),
    )
    log("K2 scatter_rows: pads 16..4096 with pad index N == plain")

    # K3 on [10k, 16]: deltas of both signs, clipping at 0 and at total
    av = T(np.floor(total5 * rng.uniform(0, 1, total5.shape)).astype(np.float32))
    delta = T(rng.integers(-300, 300, total5.shape).astype(np.float32))
    tt = T(total5)
    err("delta_clip", KT.delta_clip(av, delta, tt), KT._delta_clip_plain(av, delta, tt))
    rec["delta_clip"].update(
        ms=time_ms(torch, lambda: KT.delta_clip(av, delta, tt), reps=21),
        plain_ms=time_ms(torch, lambda: KT._delta_clip_plain(av, delta, tt), reps=21),
        library_ms=None, bound=bound(4 * total5.size * 4, 2 * total5.size),
    )
    log("K3 delta_clip: [10000, 16] == plain")

    # K4 on the stream's first-round assignment, every cap bucket and dtype
    out = KT.schedule_classes(*args)[0][: len(demands)].contiguous()
    nnz = int((out != 0).sum())
    for cap in KT.TorchScheduler._NONZERO_BUCKETS + (nnz, max(nnz - 3, 1)):
        for dts in ((torch.int16, torch.int16, torch.uint8),
                    (torch.int32, torch.int16, torch.int32),
                    (torch.int16, torch.int32, torch.uint8),
                    (torch.int32, torch.int32, torch.int32)):
            vt = dts[2]
            src = out if vt == torch.int32 else out.clamp(max=255)
            for a, b in zip(KT.compact_nonzero(src, cap, *dts),
                            KT._compact_nonzero_plain(src, cap, *dts)):
                err("compact_nonzero", a, b)
    # timed with the cap and dtypes the stream's first round uses
    cap = next(b for b in KT.TorchScheduler._NONZERO_BUCKETS if b >= int(first.sum()))
    vt = torch.uint8 if int(first.max()) < 256 else torch.int32
    dts = (torch.int16, torch.int16, vt)
    C_, N_ = out.shape
    rec["compact_nonzero"].update(
        ms=time_ms(torch, lambda: KT.compact_nonzero(out, cap, *dts), reps=21),
        plain_ms=time_ms(torch, lambda: KT._compact_nonzero_plain(out, cap, *dts), reps=21),
        library_ms=time_ms(torch, lambda: torch.nonzero(out), reps=21),
        bound=bound(C_ * N_ * 4 + cap * (4 + (1 if vt == torch.uint8 else 4)), C_ * N_),
    )
    log(f"K4 compact_nonzero: [{C_}, {N_}] nnz={nnz}, caps "
        f"{KT.TorchScheduler._NONZERO_BUCKETS} + edges, 4 dtype sets == plain")

    phase1_rounds(torch, KT, kernel_np, dev, rec, err, problems)
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]})")
    return rec


def phase1_rounds(torch, KT, kernel_np, dev, rec, err, k1_problems):
    """K5 and K6 against their plain versions (assignments and availability
    exact) and against kernel_np (assignments exact, availability within
    1e-3), then timed at the stream's first-round shape as TorchScheduler
    calls them: padded to 256 classes, the demanded columns active."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    algos = (
        ("schedule_classes_rounds", KT.schedule_classes_rounds,
         KT._schedule_classes_rounds_plain, kernel_np.schedule_classes_rounds, 4, {}),
        ("schedule_classes_chunked", KT.schedule_classes_chunked,
         KT._schedule_classes_chunked_plain, kernel_np.schedule_classes_chunked, 2,
         {"chunk": 16}),
    )
    problems = [(f"rounds_golden{s}", rounds_problem(s)) for s in range(4)]
    problems += [(n, p) for n, p in k1_problems if n.startswith(("random", "stream"))]
    for name, (avail, total, alive, demands, counts) in problems:
        args = (T(avail), T(total), T(alive), T(demands), T(counts))
        for kname, kern, plain, ref, _, _ in algos:
            a_k, v_k = kern(*args)
            a_p, v_p = plain(*args)
            err(kname, a_k, a_p)
            err(kname, v_k, v_p)
            a_n, v_n = ref(avail, total, alive, demands, counts)
            if not np.array_equal(a_n, a_k.cpu().numpy()):
                raise AssertionError(f"{kname} {name}: kernel != kernel_np")
            if not np.allclose(v_n, v_k.cpu().numpy(), atol=1e-3):
                raise AssertionError(f"{kname} {name}: avail differs from kernel_np")
        log(f"K5/K6 {name}: N={len(total)} C={len(demands)} placed "
            f"{int(a_k.sum())} (chunked) == plain == kernel_np")
    avail, total, alive, demands, counts = next(
        p for n, p in k1_problems if n == "stream_first_round")
    d_pad, k_pad = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    active = tuple(int(i) for i in np.flatnonzero((d_pad > 0).any(axis=0)))
    args = (T(avail), T(total), T(alive), T(d_pad), T(k_pad))
    N, C = len(total), len(d_pad)
    A = len(active)
    # each input read once, each output written once
    bytes_rounds = 3 * N * R * 4 + N + C * R * 4 + C * 4 + C * N * 4
    for kname, kern, plain, _, rounds, kw in algos:
        kw = {**kw, "rounds": rounds, "active_idx": active}
        # per round and (class, node) cell: fit and threshold cap in phase
        # A (9 per active column), fit in phase B (4 per column), the
        # class-priority trim in both phases (9 per column), ~8 per cell
        # per phase for the cap, prefix fill and clip
        ops = rounds * C * N * (9 * A + 4 * A + 2 * 9 * A + 2 * 8)
        rec[kname].update(
            ms=time_ms(torch, lambda: kern(*args, **kw)),
            plain_ms=time_ms(torch, lambda: plain(*args, **kw), reps=3, warm=1),
            library_ms=None, bound=bound(bytes_rounds, ops),
        )


def phase2_stream(torch, KT, dev, n_nodes=10_000, n_tasks=1_000_000, algo="scan"):
    """The 1M-task stream through TorchScheduler (bench.py's headline)."""
    rng = np.random.default_rng(5)
    total, alive, demands, counts = build_stream_problem(
        rng, n_nodes=n_nodes, n_tasks=n_tasks)
    n_nodes = total.shape[0]
    alive = np.ones(n_nodes, bool)
    alive[int(n_nodes * 0.8):] = False
    sched = KT.TorchScheduler(total, alive, device=dev)
    sched.set_available(total * alive[:, None])
    host_avail = (total * alive[:, None]).astype(np.float32)
    chunks = 10
    arrivals = [np.floor(counts / chunks).astype(np.int32)] * (chunks - 1)
    arrivals.append((counts - np.sum(arrivals, axis=0)).astype(np.int32))
    backlog = np.zeros_like(counts)
    inflight = []  # (complete_round, assigned)
    pipe_depth = 6
    pipe = []  # (handle, submitted)
    inflight_counts = np.zeros_like(backlog)
    round_times = []
    st = {"decisions": 0, "rnd": 0, "host_avail": host_avail,
          "backlog": backlog, "inflight_counts": inflight_counts}
    scaled_up_at = None

    def fetch_oldest():
        handle, submitted = pipe.pop(0)
        assigned = sched.fetch(handle)
        placed_c = assigned.sum(axis=1).astype(np.int32)
        assert (placed_c <= submitted).all(), "stream overplaced a class"
        used_round = assigned.astype(np.float32).T @ demands
        assert (used_round <= st["host_avail"] + 1e-2).all(), "stream exceeded capacity"
        st["host_avail"] = np.maximum(st["host_avail"] - used_round, 0.0)
        st["backlog"] = st["backlog"] - placed_c
        st["inflight_counts"] = st["inflight_counts"] - submitted
        st["decisions"] += int(placed_c.sum())
        if placed_c.sum() > 0:
            inflight.append((st["rnd"] + 2, assigned))

    sync(torch, dev)
    t0 = time.perf_counter()
    while st["rnd"] < len(arrivals) or st["backlog"].sum() > 0 or inflight or pipe:
        rnd = st["rnd"]
        t_round0 = time.perf_counter()
        due = [a for r0, a in inflight if r0 <= rnd]
        inflight[:] = [(r0, a) for r0, a in inflight if r0 > rnd]
        if due:
            release = np.zeros_like(total)
            for a in due:
                release += a.astype(np.float32).T @ demands
            sched.apply_delta(release)
            st["host_avail"] = np.minimum(st["host_avail"] + release, total)
        if rnd < len(arrivals):
            st["backlog"] = st["backlog"] + arrivals[rnd]
        if st["backlog"].sum() > 0.15 * n_tasks and not alive.all():
            first_down = int(np.argmin(alive))
            up = slice(first_down, min(first_down + n_nodes // 10, n_nodes))
            alive[up] = True
            sched.alive = torch.from_numpy(alive.copy()).to(sched.device)
            idx = list(range(up.start, up.stop))
            sched.update_rows(idx, total[idx])
            st["host_avail"][idx] = total[idx]
            scaled_up_at = rnd
        submit = np.maximum(st["backlog"] - st["inflight_counts"], 0).astype(np.int32)
        did_work = False
        if submit.sum() > 0:
            pipe.append((sched.schedule_async(demands, submit, algo=algo), submit))
            st["inflight_counts"] = st["inflight_counts"] + submit
            did_work = True
        if pipe and (len(pipe) > pipe_depth or submit.sum() == 0):
            fetch_oldest()
            did_work = True
        if did_work:
            round_times.append(time.perf_counter() - t_round0)
        st["rnd"] += 1
        if st["rnd"] > 250:
            break
    sync(torch, dev)
    t_stream = time.perf_counter() - t0
    placed = st["decisions"]
    assert placed == int(counts.sum()), (placed, int(counts.sum()))
    assert np.isfinite(st["host_avail"]).all()
    res = {
        "algo": algo,
        "rounds": len(round_times),
        "round_ms_median": float(np.median(round_times)) * 1e3,
        "decisions": placed,
        "decisions_per_sec": placed / t_stream,
        "stream_s": t_stream,
        "autoscaled_at_round": scaled_up_at,
        "loop_rounds": st["rnd"],
    }
    log(f"phase 2 stream: {json.dumps(res)}")
    return res


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lockstep_state(n_nodes, seed):
    from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace

    rng = np.random.default_rng(seed)
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(8, 65, n_nodes)
    total[:, 3] = rng.integers(32, 257, n_nodes)
    ids = [f"n{i}" for i in range(n_nodes)]
    st = NodeResourceState(
        space=ResourceSpace(), node_ids=ids, total=total.copy(),
        available=total.copy(), alive=np.ones(n_nodes, bool),
        draining=np.zeros(n_nodes, bool), labels=[{} for _ in ids],
    )
    return st


def phase3_policy_lockstep(torch, policy_mod, Config, n=10_000, gpu="cuda"):
    """CUDA and CPU torch_cuda policies on identical 10k-node states."""
    base = {"scheduling_policy": "torch_cuda", "jax_policy_min_cells": 0,
            "jax_policy_pipeline_depth": 2}
    pol_gpu = policy_mod.make_policy_from_config(Config({**base, "scheduler_device": gpu}))
    pol_cpu = policy_mod.make_policy_from_config(Config({**base, "scheduler_device": "cpu"}))
    assert pol_gpu.device.type == gpu and pol_cpu.device.type == "cpu"
    st_g, st_c = _lockstep_state(n, 11), _lockstep_state(n, 11)
    rng = np.random.default_rng(12)
    C = 24
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    demands[:, 3] = np.where(rng.random(C) < 0.4, rng.integers(1, 9, C), 0)
    running_g, running_c = [], []

    def release_some(k):
        for _ in range(min(k, len(running_g))):
            j = int(rng.integers(0, len(running_g)))
            (ng, dg), (nc, dc) = running_g.pop(j), running_c.pop(j)
            st_g.release(ng, dg)
            st_c.release(nc, dc)

    def record(plan_g, plan_c, rnd):
        tags_g, dem_g, a_g = plan_g
        tags_c, dem_c, a_c = plan_c
        assert list(tags_g) == list(tags_c), f"round {rnd}: tags differ"
        if not np.array_equal(a_g, a_c):
            raise AssertionError(f"round {rnd}: CUDA and CPU decisions differ")
        for c in range(a_g.shape[0]):
            for node in np.flatnonzero(a_g[c]):
                for _ in range(int(a_g[c, node])):
                    running_g.append((int(node), dem_g[c]))
                    running_c.append((int(node), dem_c[c]))
        return int(a_g.sum())

    placed = 0
    # synchronous rounds (the local runtime's path)
    for rnd in range(4):
        counts = rng.integers(0, n // 5, C).astype(np.int32)
        a_g = pol_gpu.schedule(st_g, demands, counts)
        a_c = pol_cpu.schedule(st_c, demands, counts)
        placed += record((range(C), demands, a_g), (range(C), demands, a_c), rnd)
        assert np.allclose(st_g.available, st_c.available, atol=1e-4)
        release_some(n // 3)
    # pipelined rounds, driven as the live control plane drives them
    queues = np.zeros(C, np.int64)
    tags = [f"class{c}" for c in range(C)]
    rnd = 0
    while rnd < 8 or queues.sum() > 0 or pol_gpu.has_inflight():
        assert rnd < 60, "pipelined rounds did not drain"
        if rnd < 8:
            queues += rng.integers(0, n // 30, C)
        keys = [c for c in range(C) if queues[c] > 0]
        dem = demands[keys] if keys else np.zeros((0, R), np.float32)
        cnt = queues[keys].astype(np.int32)
        ktags = [tags[c] for c in keys]
        plan_g = pol_gpu.schedule_pipelined(st_g, dem, cnt, ktags)
        plan_c = pol_cpu.schedule_pipelined(st_c, dem, cnt, ktags)
        assert (plan_g is None) == (plan_c is None), f"pipelined round {rnd}"
        if plan_g is not None:
            placed += record(plan_g, plan_c, 100 + rnd)
            for c, t in enumerate(plan_g[0]):
                queues[tags.index(t)] -= int(plan_g[2][c].sum())
        release_some(n // 5)
        rnd += 1
    assert (queues >= 0).all()
    assert not pol_cpu.has_inflight()
    log(f"phase 3 policy lockstep: 4 sync + {rnd} pipelined rounds on {n} nodes, "
        f"{placed} placements, CUDA == CPU every round")
    return placed


def phase4_entry_points(torch, KT):
    import ray_tpu_torch as rt

    before = KT.schedule_classes.launches
    rt.init(num_cpus=8, _system_config={
        "scheduling_policy": "torch_cuda", "jax_policy_min_cells": 0,
    })
    try:
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self, k):
                self.n += k
                return self.n

        sq = [square.remote(i) for i in range(200)]
        sums = [add.remote(sq[i], sq[i + 1]) for i in range(0, 200, 2)]
        got = rt.get(sums, timeout=120)
        want = [i * i + (i + 1) * (i + 1) for i in range(0, 200, 2)]
        assert got == want, "task results differ"
        c = Counter.remote()
        vals = rt.get([c.incr.remote(k) for k in range(1, 51)], timeout=120)
        assert vals[-1] == sum(range(1, 51)), vals[-1]
        rt_obj = rt.core.api._runtime
        assert rt_obj.policy.name == "torch_cuda"
        assert rt_obj.policy.device.type == "cuda"
    finally:
        rt.shutdown()
    k1 = KT.schedule_classes.launches - before
    assert k1 > 0, "init/remote/get never reached the CUDA kernel"
    log(f"phase 4 entry points: 300 tasks + 1 actor (50 calls) correct, "
        f"K1 launches {k1}")
    return k1


# the GCS phase's 256 task classes: CPU 1..16 x memory 0..15
GCS_CLASSES = [(cpu, mem) for cpu in range(1, 17) for mem in range(16)]


def gcs_submissions(n_tasks, seed, n_classes=len(GCS_CLASSES), deps=None, prefix="t"):
    """Task metas as a driver submits them, classes drawn uniformly."""
    rng = np.random.default_rng(seed)
    metas = []
    for i, c in enumerate(rng.integers(0, n_classes, n_tasks)):
        cpu, mem = GCS_CLASSES[int(c)]
        res = {"CPU": cpu}
        if mem:
            res["memory"] = mem
        meta = {"task_id": f"{prefix}-{i}", "class_key": (("CPU", cpu), ("memory", mem)),
                "resources": res, "num_returns": 1}
        if deps is not None:
            meta["deps"] = [dict(d) for d in deps]
        metas.append(meta)
    return metas


def register_gcs_nodes(testing, gcs, n_nodes):
    """10k fake nodes, CPU 8..64 and memory 32..256, drawn as the JAX
    package's GCS policy tests draw them."""
    rng = np.random.default_rng(42)
    cpus = rng.integers(8, 65, n_nodes)
    mems = rng.integers(32, 257, n_nodes)
    testing.register_fake_nodes(
        gcs, n_nodes, lambda i: {"CPU": int(cpus[i]), "memory": int(mems[i])})


def assert_gcs_drained(gcs):
    with gcs._lock:
        assert not gcs.pending, "GCS: pending not empty"
        assert not gcs.waiting_tasks, "GCS: waiting_tasks not empty"
        assert not gcs.active_outputs, "GCS: active_outputs not empty"
        assert not gcs._class_buckets, "GCS: queued tasks left"


def phase5_gcs(torch, KT, n_nodes=10_000, n_lockstep=25_000, n_pipelined=100_000,
               n_wire=4_000, gpu="cuda"):
    """The GCS scheduling loop at 10k nodes x 256 classes, per algorithm:
    (a) torch_cuda on the card in lockstep with hybrid (NumPy), (b) the
    pipelined torch_cuda GCS, and (c) the wire path into a default GCS."""
    from ray_tpu_torch.cluster import testing
    from ray_tpu_torch.cluster.gcs import GcsServer
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.object_ref import ObjectRef

    out = {}
    for algo in KT.ALGOS:
        # (a) lockstep: synchronous rounds, every round on the device
        base = {"scheduler_kernel_algo": algo, "scheduler_round_interval_ms": 60_000.0,
                "jax_policy_min_cells": 0, "jax_policy_pipeline_depth": 0}
        placements, secs = {}, {}
        for pol in ("torch_cuda", "hybrid"):
            cfg = {**base, "scheduling_policy": pol, "scheduler_device": gpu}
            gcs = GcsServer(config=Config(cfg))
            try:
                testing.park_scheduler_loop(gcs)
                if pol == "torch_cuda":
                    assert gcs.policy.device.type == gpu
                register_gcs_nodes(testing, gcs, n_nodes)
                conn = testing.FakeConn()
                for meta in gcs_submissions(n_lockstep, seed=7):
                    gcs.rpc_submit_task(meta, conn)
                t0 = time.perf_counter()
                placements[pol] = testing.run_rounds_to_quiescence(gcs, max_rounds=400)
                secs[pol] = time.perf_counter() - t0
                assert_gcs_drained(gcs)
            finally:
                gcs.shutdown()
        p_dev, p_np = placements["torch_cuda"], placements["hybrid"]
        assert len(p_dev) == len(p_np) == n_lockstep, (len(p_dev), len(p_np))
        differ = sum(1 for t in p_np if p_dev[t] != p_np[t])
        if differ:
            raise AssertionError(f"GCS lockstep {algo}: {differ} placements differ")
        rec = {"lockstep_tasks": n_lockstep,
               "lockstep_decisions_per_sec": n_lockstep / secs["torch_cuda"],
               "lockstep_numpy_decisions_per_sec": n_lockstep / secs["hybrid"]}

        # (b) pipelined at the default window and size threshold, as
        # bench.py's gcs_loop_bench drives it
        cfg = {"scheduler_kernel_algo": algo, "scheduler_round_interval_ms": 60_000.0,
               "scheduler_device": gpu}
        gcs = GcsServer(config=Config(cfg))
        try:
            testing.park_scheduler_loop(gcs)
            assert gcs.policy.name == "torch_cuda" and gcs.policy.pipelined
            register_gcs_nodes(testing, gcs, n_nodes)
            conn = testing.FakeConn()
            metas = gcs_submissions(n_pipelined, seed=8)
            t0 = time.perf_counter()
            for meta in metas:
                gcs.rpc_submit_task(meta, conn)
            t_submit = time.perf_counter() - t0
            t0 = time.perf_counter()
            placed = testing.run_rounds_to_quiescence(gcs, max_rounds=2000,
                                                      drain_fraction=1.0)
            t_sched = time.perf_counter() - t0
            assert len(placed) == n_pipelined, (len(placed), n_pipelined)
            assert_gcs_drained(gcs)
            with gcs._lock:
                assert not gcs.policy.has_inflight(), "GCS: rounds left in flight"
                assert not gcs.running
                st = gcs.state
                assert np.allclose(st.available, st.total * st.alive[:, None], atol=1e-3)
        finally:
            gcs.shutdown()
        rec.update(tasks=n_pipelined, placed=len(placed),
                   submit_per_sec=n_pipelined / t_submit,
                   decisions_per_sec=len(placed) / t_sched)
        out[algo] = rec
        log(f"phase 5 GCS {algo}: {json.dumps(rec)}")

    # (c) the wire path: a GCS with the default config (torch_cuda on
    # CUDA), its scheduler loop live, fed over an RPC connection. A
    # producer task runs first; the consumers wait at the dependency gate
    # on its output, and the report of that output (as the producer's
    # node sends it) releases all of them into one round, which the
    # policy solves on the card.
    before = KT.schedule_classes.launches
    gcs = GcsServer() if gpu == "cuda" else GcsServer(config=Config({"scheduler_device": gpu}))
    try:
        assert gcs.policy.name == "torch_cuda" and gcs.policy.device.type == gpu
        register_gcs_nodes(testing, gcs, n_nodes)
        client = RpcClient("127.0.0.1", gcs.port, name="driver", peer="gcs")
        try:
            driver = "chip-smoke-driver"
            client.call("register_driver", {"driver_id": driver, "worker": False,
                                            "logs": False})
            producer = gcs_submissions(1, seed=0, prefix="producer")[0]
            producer["owner"] = driver
            assert client.call("submit_task", producer).get("ok")
            deadline = time.monotonic() + 60
            while producer["task_id"] not in gcs.running:
                assert time.monotonic() < deadline, "wire path: producer never placed"
                time.sleep(0.01)
            oid = ObjectRef.for_task_output(producer["task_id"], 0).id
            consumers = gcs_submissions(n_wire, seed=9, n_classes=64,
                                        deps=[{"id": oid}], prefix="consumer")
            futs = []
            for meta in consumers:
                meta["owner"] = driver
                futs.append(client.call_async("submit_task", meta))
            for f in futs:
                reply = f.result(timeout=60)
                assert reply.get("ok") and not reply.get("deps_lost"), reply
            with gcs._lock:
                assert len(gcs.waiting_tasks) == n_wire, len(gcs.waiting_tasks)
            node = gcs.running[producer["task_id"]]["node_id"]
            t0 = time.perf_counter()
            client.call("add_object_location", {"object_id": oid, "node_id": node})
            deadline = time.monotonic() + 120
            while True:
                with gcs._lock:
                    n_running = sum(1 for m in consumers if m["task_id"] in gcs.running)
                if n_running == n_wire:
                    break
                assert time.monotonic() < deadline, f"wire path: {n_running}/{n_wire} placed"
                time.sleep(0.005)
            t_place = time.perf_counter() - t0
        finally:
            client.close()
    finally:
        gcs.shutdown()
    k1 = KT.schedule_classes.launches - before
    assert k1 > 0 or gpu != "cuda", "wire path never reached the CUDA kernel"
    out["wire"] = {"tasks": n_wire, "classes": 64, "placed_s": t_place, "k1_launches": k1}
    log(f"phase 5 GCS wire path: {json.dumps(out['wire'])}")
    return out


# ------------------------------------------------------------ phase 6: model

# kernel vs plain on the card: (rtol, atol). float32 results: the same
# arithmetic summed in another order; a result rounded to bf16 may differ
# by one rounding (2**-8 relative). block_update's state (o, l) is an
# unnormalised sum over up to 4 096 weighted keys, so its rounding follows
# the largest entry, not each one: there atol is rtol x max |state|.
KERNEL_TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-3)}
# the model kernels that the forward runs; K8's block form belongs to the
# ring across cards, not written yet, and is checked here on its own
FORWARD_KERNELS = ("attention", "rmsnorm", "rope_split")
MODEL_REPLACES = {
    "block_update": "ray_tpu/parallel/ring_attention.py:41",
    "attention": "ray_tpu/models/transformer.py:113",
    "rmsnorm": "ray_tpu/models/transformer.py:93",
    "rope_split": "ray_tpu/models/transformer.py:98",
}


def phase6a_model_kernels(torch, MK, dev, S=2048):
    """Each model kernel against its plain version on the card at the
    flagship's shapes (B 8, S 2048, H 8, Dh 64, D 512), in bf16 and f32,
    then timed in bf16 at the shapes the forward gives it."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(6)
    B, H, Dh = 8, 8, 64
    D = H * Dh
    rec = {name: {"max_abs_err": 0.0} for name in MK.KERNELS}
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dt)

    def check(name, got, want, what, sum_state=False):
        rtol, atol = KERNEL_TOL["f32" if want.dtype == torch.float32 else "bf16"]
        got, want = got.double(), want.double()
        if sum_state:
            atol = max(atol, rtol * float(want.abs().max()))
        d = float((got - want).abs().max())
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        bad = (got - want).abs() > atol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {d}, "
                                 f"tolerance rtol {rtol} atol {atol})")

    for dt in (torch.bfloat16, torch.float32):
        for s_len in (S, S - 1):
            q, k, v = (rnd((B, s_len, H, Dh), dt) for _ in range(3))
            check("attention", MK.attention(q, k, v), MK._attention_plain(q, k, v),
                  f"{names[dt]} S={s_len}")
        # a fully visible block sets the state, then the diagonal block, then
        # one wholly above the diagonal (must leave the state as it is)
        q, k, v = (rnd((B, S, H, Dh), dt) for _ in range(3))
        state = (torch.zeros((B, S, H, Dh), device=dev),
                 torch.full((B, H, S), MK.NEG_INF, device=dev),
                 torch.zeros((B, H, S), device=dev))
        for q_off, k_off, what in ((S, 0, "visible"), (S, S, "diagonal"),
                                   (S, 2 * S, "fully masked")):
            got = MK.block_update(q, k, v, *state, q_off, k_off, True, 1.0 / np.sqrt(Dh))
            want = MK._block_update_plain(q, k, v, *state, q_off, k_off, True,
                                          1.0 / np.sqrt(Dh))
            for part, a, b in zip("oml", got, want):
                check("block_update", a, b, f"{names[dt]} {what} block, {part}",
                      sum_state=True)
            if what == "fully masked" and not all(torch.equal(a, b)
                                                  for a, b in zip(got, state)):
                raise AssertionError("block_update: a fully masked block changed the state")
            state = want
        x, scale = rnd((B * S, D), dt, 3.0), rnd((D,), torch.float32)
        check("rmsnorm", MK.rmsnorm(x, scale), MK._rmsnorm_plain(x, scale), names[dt])
        qkv = rnd((B, S, 3 * D), dt)
        for part, a, b in zip("qkv", MK.rope_split(qkv, H, 1e4),
                              MK._rope_split_plain(qkv, H, 1e4)):
            check("rope_split", a, b, f"{names[dt]} {part}")

    bf = torch.bfloat16
    # K8, whole form, as the forward calls it: causal, [8, 2048, 8, 64] bf16
    q, k, v = (rnd((B, S, H, Dh), bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (S + 1) // 2  # causal (query, key) pairs a head
    rec["attention"].update(
        ms=time_ms(torch, lambda: MK.attention(q, k, v)),
        plain_ms=time_ms(torch, lambda: MK._attention_plain(q, k, v), reps=3, warm=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound=bound(4 * B * S * H * Dh * 2, 4 * B * H * Dh * pairs, PEAK_BF16_OPS_PER_S))
    # K8, block form, as the ring schedule of (d) calls it: a visible
    # [8, 512, 8, 64] block (4 shards of 2048) against a running state
    Sb = S // 4
    qb, kb, vb = (rnd((B, Sb, H, Dh), bf) for _ in range(3))
    st = (rnd((B, Sb, H, Dh), torch.float32), rnd((B, H, Sb), torch.float32),
          rnd((B, H, Sb), torch.float32).abs() + 1)
    args = (qb, kb, vb, *st, Sb, 0, True, 1.0 / np.sqrt(Dh))
    rec["block_update"].update(
        ms=time_ms(torch, lambda: MK.block_update(*args)),
        plain_ms=time_ms(torch, lambda: MK._block_update_plain(*args), reps=3, warm=1),
        library_ms=None,
        bound=bound(3 * B * Sb * H * Dh * 2 + 2 * (B * Sb * H * Dh + 2 * B * H * Sb) * 4,
                    4 * B * H * Dh * Sb * Sb, PEAK_BF16_OPS_PER_S))
    x, scale = rnd((B * S, D), bf), rnd((D,), torch.float32)
    scale_bf = scale.to(bf)
    rec["rmsnorm"].update(
        ms=time_ms(torch, lambda: MK.rmsnorm(x, scale), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rmsnorm_plain(x, scale), reps=21),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), scale_bf, 1e-6), reps=21),
        bound=bound(2 * B * S * D * 2 + D * 4, 4 * B * S * D))
    qkv = rnd((B, S, 3 * D), bf)
    rec["rope_split"].update(
        ms=time_ms(torch, lambda: MK.rope_split(qkv, H, 1e4), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rope_split_plain(qkv, H, 1e4), reps=21),
        library_ms=None,
        bound=bound(2 * B * S * 3 * D * 2, 6 * B * S * D))
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}")
    return rec


def _golden_check(torch, PT, tree, golden, dt_name, dev):
    """The forward and loss on the card at the golden's tokens [2, 513]
    against the JAX package's numbers (models.transformer.GOLDEN_TOL)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
    model = PT.params_from_numpy(tree, PT.TransformerConfig(dtype=dt), device=dev)
    tokens = torch.from_numpy(golden["tokens"]).to(dev)
    pos = [int(p) for p in golden["positions"]]
    logits = PT.forward(model, tokens[:, :-1])
    loss = float(PT.loss_fn(model, {"tokens": tokens}))
    atol_logits, atol_loss, agree = PT.GOLDEN_TOL[dt_name]
    err = float(np.abs(logits[:, pos].cpu().numpy() - golden[f"logits_{dt_name}"]).max())
    share = float((logits.argmax(-1).cpu().numpy() == golden[f"argmax_{dt_name}"]).mean())
    loss_err = abs(loss - float(golden[f"loss_{dt_name}"]))
    if not (err <= atol_logits and share >= agree and loss_err <= atol_loss):
        raise AssertionError(
            f"golden {dt_name}: logits err {err} (atol {atol_logits}), argmax agree "
            f"{share} (>= {agree}), loss err {loss_err} (atol {atol_loss})")
    return {"logits_err": err, "argmax_agree": share, "loss_err": loss_err}


def ring_schedule(torch, MK, q, k, v, n_shards):
    """The ring's block steps on one card, as check code (the port's
    ring_attention across cards is not written yet): query block idx meets,
    at ring step t, the KV block of shard (idx - t) mod n_shards, through
    K8's block form; then o / max(l, 1e-30) in q's dtype."""
    B, S, H, Dh = q.shape
    Sb = S // n_shards
    outs = []
    for idx in range(n_shards):
        qb = q[:, idx * Sb:(idx + 1) * Sb].contiguous()
        o = torch.zeros((B, Sb, H, Dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Sb), MK.NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Sb), dtype=torch.float32, device=q.device)
        for t in range(n_shards):
            src = (idx - t) % n_shards
            kb, vb = (x[:, src * Sb:(src + 1) * Sb].contiguous() for x in (k, v))
            o, m, l = MK.block_update(qb, kb, vb, o, m, l, idx * Sb, src * Sb, True,
                                      1.0 / np.sqrt(Dh))
        outs.append((o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def phase6b_forward(torch, PT, make_forward_step, dev, batch=8, seq=2048, cfg=None):
    """The main path, called directly: make_forward_step on [batch, seq]
    tokens, its logits finite and of the right shape, then timed. The
    weights come from the golden's numpy seed (checksum checked first)."""
    flagship = PT.TransformerConfig()
    cfg = cfg or flagship
    golden = np.load(GOLDEN_PATH)
    seed = int(golden["weight_seed"])
    golden_tree = PT.numpy_params(flagship, seed)
    checksum = PT.weights_checksum(golden_tree)
    if checksum != str(golden["checksum"]):
        raise AssertionError(
            f"numpy_params gave other weights than the golden's (checksum {checksum[:16]} "
            f"!= {str(golden['checksum'])[:16]}): this numpy draws other numbers from "
            "the seed, so the golden does not apply")
    tree = golden_tree if cfg == flagship else PT.numpy_params(cfg, seed)
    model = PT.params_from_numpy(tree, cfg, device=dev)
    fwd = make_forward_step(cfg) if dev.type == "cuda" else make_forward_step(cfg, dev)
    rng = np.random.default_rng(60)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    logits = fwd(model, tokens[:, :-1])
    sync(torch, dev)
    if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} {logits.dtype}, "
                             "or not finite")
    fwd_ms = time_ms(torch, lambda: fwd(model, tokens[:, :-1]), reps=5, warm=1) \
        if dev.type == "cuda" else float("nan")
    res = {"batch": batch, "seq": seq, "forward_ms": fwd_ms,
           "tokens_per_s": batch * seq / (fwd_ms / 1e3)}
    log(f"phase 6b forward: {json.dumps(res)}")
    ctx = {"cfg": cfg, "golden": golden, "golden_tree": golden_tree, "tree": tree,
           "model": model, "fwd": fwd, "tokens": tokens, "logits": logits}
    return res, ctx


def phase6c_serve(torch, PT, make_forward_step, ctx, sizes=None):
    """The main path, served: an actor of ray_tpu_torch.init() (default
    config: the torch_cuda policy on the card) holds the model and answers
    8 requests with the last position's logits. Checked in 6d."""
    import ray_tpu_torch as rt

    cfg, tree, dev = ctx["cfg"], ctx["tree"], ctx["model"].device
    sizes = sizes or [(8, 2048), (4, 1024), (1, 2048), (2, 17), (8, 512), (3, 1000),
                      (1, 1), (6, 2047)]
    rng = np.random.default_rng(61)
    requests = [rng.integers(0, cfg.vocab_size, s).astype(np.int32) for s in sizes]
    if dev.type == "cuda":
        rt.init(num_cpus=8)  # the default config: torch_cuda on the card
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        @rt.remote
        class ModelServer:
            """User code: holds the model on the card, answers requests."""

            def __init__(self, weights):
                self.model = PT.params_from_numpy(weights, cfg, device=dev)
                self.fwd = make_forward_step(cfg) if dev.type == "cuda" \
                    else make_forward_step(cfg, dev)

            def last_logits(self, tokens):
                return self.fwd(self.model, tokens)[:, -1].cpu().numpy()

        server = ModelServer.remote(tree)
        t0 = time.perf_counter()
        answers = rt.get([server.last_logits.remote(t) for t in requests], timeout=600)
        t_serve = time.perf_counter() - t0
        policy = rt.core.api._runtime.policy
        assert policy.name == "torch_cuda" and policy.device.type == dev.type, policy.name
    finally:
        rt.shutdown()
    res = {"requests": len(requests), "tokens": int(sum(t.size for t in requests)),
           "serve_s": t_serve}
    log(f"phase 6c served: {json.dumps(res)}")
    return res, requests, answers


def phase6d_checks(torch, PT, MK, ctx, requests, answers):
    """The main path's results checked, outside its counting window: two
    sequences against the port's plain forward on the CPU, the loss at
    [batch, seq + 1], both dtypes against the JAX golden, each served
    answer against the direct call, and the ring's schedule of K8 block
    steps against the whole-sequence kernel."""
    cfg, model, fwd, logits = ctx["cfg"], ctx["model"], ctx["fwd"], ctx["logits"]
    dev = model.device
    tokens = ctx["tokens"]
    cpu_model = PT.params_from_numpy(ctx["tree"], cfg, device="cpu")
    cpu_logits = PT.forward(cpu_model, torch.from_numpy(tokens[:2, :-1]))
    atol_logits, atol_loss, agree = PT.GOLDEN_TOL[
        "bf16" if cfg.dtype == torch.bfloat16 else "f32"]
    cpu_err = float((logits[:2].cpu() - cpu_logits).abs().max())
    cpu_agree = float((logits[:2].argmax(-1).cpu() == cpu_logits.argmax(-1)).float().mean())
    if cpu_err > atol_logits or cpu_agree < agree:
        raise AssertionError(f"forward: card vs CPU logits err {cpu_err} (atol "
                             f"{atol_logits}), argmax agree {cpu_agree} (>= {agree})")
    # the loss at [batch, seq + 1], held against the cross-entropy of the
    # forward's logits
    tok = torch.from_numpy(tokens).to(dev)
    loss = float(PT.loss_fn(model, {"tokens": tok}))
    ce = float(torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), tok[:, 1:].reshape(-1).long()))
    if not np.isfinite(loss) or abs(loss - ce) > 1e-4:
        raise AssertionError(f"loss_fn {loss} != cross-entropy of the forward {ce}")
    golden_res = {dt: _golden_check(torch, PT, ctx["golden_tree"], ctx["golden"], dt, dev)
                  for dt in PT.GOLDEN_TOL}
    for t, a in zip(requests, answers):
        want = fwd(model, t)[:, -1].cpu().numpy()
        if a.shape != want.shape or not np.array_equal(a, want):
            raise AssertionError(f"served answer for {t.shape} differs from the direct call")
    # the ring's schedule (4 shards: 16 block steps, 6 of them fully masked)
    # on layer 0's q, k, v against the whole-sequence kernel
    blk = model.blocks[0]
    x = torch.nn.functional.embedding(tok[:, :-1], model.embed).to(cfg.dtype)
    qkv = torch.matmul(MK.rmsnorm(x, blk.ln1), blk.wqkv.to(cfg.dtype))
    q, k, v = MK.rope_split(qkv, cfg.n_heads, cfg.rope_theta)
    before = MK.block_update.launches
    ring = ring_schedule(torch, MK, q, k, v, n_shards=4)
    ring_launches = MK.block_update.launches - before
    whole = MK.attention(q, k, v, causal=True)
    rtol, atol = KERNEL_TOL["bf16" if cfg.dtype == torch.bfloat16 else "f32"]
    ring_err = float((ring.double() - whole.double()).abs().max())
    if bool(((ring.double() - whole.double()).abs() > atol + rtol * whole.double().abs()).any()):
        raise AssertionError(f"ring schedule != whole attention (max abs err {ring_err})")
    if dev.type == "cuda" and ring_launches != 16:
        raise AssertionError(f"ring schedule: {ring_launches} block_update launches, not 16")
    res = {"cpu_logits_err": cpu_err, "cpu_argmax_agree": cpu_agree, "loss": loss,
           "golden": golden_res, "served_equal_direct": len(answers),
           "ring_vs_whole_err": ring_err, "ring_block_update_launches": ring_launches}
    log(f"phase 6d checks: {json.dumps(res)}")
    return res


# ------------------------------------------------------------ phase 7: experts

# the expert layer's main path: MoEConfig() (d_model 256, d_ff 512, 8
# experts, capacity factor 1.25, bf16) on x [8, 2048, 256] bf16, C = 320
MOE_SHAPE = (8, 2048, 256)
MOE_X_SEED = 70
MOE_REPLACES = {
    "moe_route": "ray_tpu/models/moe.py:70",
    "moe_dispatch": "ray_tpu/models/moe.py:83",
    "moe_combine": "ray_tpu/models/moe.py:110",
}
# K9a's gate and probability sums against the plain version's: expf and
# the order of the sums (relative)
ROUTE_TOL = 1e-6


def _route_err(torch, got, want, what):
    """K9a's outputs against another's: expert, slot, token_of_slot and the
    token counts equal, gate and the probability sums within ROUTE_TOL
    relative. Returns the largest gate / sum difference."""
    names = ("expert", "gate", "slot", "token_of_slot", "stats")
    for name, a, b in zip(names, got, want):
        if name in ("gate", "stats"):
            continue
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"moe_route {what}: {name} differs "
                                 f"({int((a.cpu() != b.cpu()).sum())} entries)")
    if not torch.equal(got[4][:, 0].cpu(), want[4][:, 0].cpu()):
        raise AssertionError(f"moe_route {what}: token counts differ")
    err = 0.0
    for a, b in ((got[1], want[1]), (got[4][:, 1], want[4][:, 1])):
        a, b = a.double().cpu(), b.double().cpu()
        d = (a - b).abs()
        if bool((d > ROUTE_TOL * b.abs()).any()):
            raise AssertionError(f"moe_route {what}: gate or sums off by {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def _moe_layer(torch, PM, dev):
    """The main path's weights (the golden's numpy seed, checksum checked)
    and its skewed tokens [8, 2048, 256] float32 on `dev`."""
    golden = np.load(MOE_GOLDEN_PATH)
    cfg = PM.MoEConfig()
    tree = PM.numpy_moe_params(cfg, int(golden["weight_seed"]))
    checksum = PM.moe_weights_checksum(tree)
    if checksum != str(golden["checksum"]):
        raise AssertionError(
            f"numpy_moe_params gave other weights than the golden's (checksum "
            f"{checksum[:16]} != {str(golden['checksum'])[:16]}): this numpy draws "
            "other numbers from the seed, so the golden does not apply")
    x = PM.numpy_moe_inputs(tree, MOE_SHAPE, MOE_X_SEED, float(golden["skew"]))
    return cfg, tree, golden, torch.from_numpy(x).to(dev)


def phase7a_moe_kernels(torch, PM, EK, dev):
    """Each expert-layer kernel against its plain version on the card at the
    main path's shapes (logits [8, 2048, 8], C 320, rows of 256), the
    routing and both copies in bf16 and f32, then timed as the main path
    calls them (bf16 tokens and experts)."""
    cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
    G, S, D = MOE_SHAPE
    E, C = cfg.n_experts, PM._capacity(cfg, S)
    logits = torch.matmul(x32, torch.from_numpy(tree["router"]).to(dev))
    rec = {name: {"max_abs_err": 0.0} for name in EK.KERNELS}
    got = EK.moe_route(logits, C)
    rec["moe_route"]["max_abs_err"] = _route_err(torch, got, EK._route_plain(logits, C),
                                                 "main path")
    _, gate, slot, tos, _ = got
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    for x_name, x_dt in dt.items():
        x = x32.to(x_dt)
        for o_name, o_dt in dt.items():
            if not torch.equal(EK.moe_dispatch(x, tos, o_dt), EK._dispatch_plain(x, tos, o_dt)):
                raise AssertionError(f"moe_dispatch x {x_name} -> {o_name}: kernel != plain")
    out = torch.randn((E, G, C, D), generator=torch.Generator(dev).manual_seed(7), device=dev)
    for y_name, y_dt in dt.items():
        if not torch.equal(EK.moe_combine(out, slot, gate, y_dt),
                           EK._combine_plain(out, slot, gate, y_dt)):
            raise AssertionError(f"moe_combine -> {y_name}: kernel != plain")

    bf = torch.bfloat16
    x = x32.to(bf)
    kept = int((tos >= 0).sum())
    rec["moe_route"].update(
        ms=time_ms(torch, lambda: EK.moe_route(logits, C), reps=21),
        plain_ms=time_ms(torch, lambda: EK._route_plain(logits, C), reps=7),
        library_ms=None,
        # logits read; expert, gate, slot, token_of_slot and stats written;
        # a token: E subtractions, exps, additions, divisions, comparisons
        bound=bound(G * S * E * 4 + G * S * 12 + E * G * C * 4 + G * 2 * E * 4,
                    5 * G * S * E))
    # the gather alone as the library yardstick: the same rows of x in one
    # index_select (no cast, no zero fill)
    flat = x.reshape(G * S, D)
    rows = (torch.arange(G, device=dev)[None, :, None] * S + tos.clamp_min(0)).reshape(-1)
    rec["moe_dispatch"].update(
        ms=time_ms(torch, lambda: EK.moe_dispatch(x, tos, bf), reps=21),
        plain_ms=time_ms(torch, lambda: EK._dispatch_plain(x, tos, bf), reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(flat, 0, rows), reps=21),
        bound=bound(E * G * C * 4 + kept * D * 2 + E * G * C * D * 2, 0))
    out_flat = out.reshape(E * G * C, D)
    src = torch.where(slot >= 0, (slot // C * G + torch.arange(G, device=dev)[:, None]) * C
                      + slot % C, 0).reshape(-1).long()
    rec["moe_combine"].update(
        ms=time_ms(torch, lambda: EK.moe_combine(out, slot, gate, bf), reps=21),
        plain_ms=time_ms(torch, lambda: EK._combine_plain(out, slot, gate, bf), reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(out_flat, 0, src), reps=21),
        bound=bound(G * S * 8 + kept * D * 4 + G * S * D * 2, kept * D))
    log(f"  {kept} of {E * G * C} slots full")
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, gather alone "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}")
    return rec


def phase7b_moe(torch, PM, dev):
    """The expert layer's main path, called directly: moe_ffn on the skewed
    x [8, 2048, 256] bf16, y finite, in bf16, with some tokens dropped;
    then timed (CUDA events, and the host clock over 21 calls)."""
    cfg, tree, golden, x32 = _moe_layer(torch, PM, dev)
    model = PM.moe_params_from_numpy(tree, cfg, device=dev)
    x = x32.to(torch.bfloat16)
    y, aux = PM.moe_ffn(model, x)
    sync(torch, dev)
    if tuple(y.shape) != MOE_SHAPE or y.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(y).all()) or aux.dim() != 0 \
            or not np.isfinite(float(aux)):
        raise AssertionError(f"moe_ffn: y {tuple(y.shape)} {y.dtype}, aux {aux}")
    dropped = float((y == 0).all(-1).float().mean())
    if not dropped > 0:
        raise AssertionError("moe_ffn: the skewed routing dropped no token")
    G, S, _ = MOE_SHAPE
    res = {"shape": list(MOE_SHAPE), "capacity": PM._capacity(cfg, S),
           "dropped_share": dropped, "aux": float(aux)}
    if dev.type == "cuda":
        ms = time_ms(torch, lambda: PM.moe_ffn(model, x), reps=21)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(21):
            PM.moe_ffn(model, x)
        sync(torch, dev)
        res.update(ms=ms, tokens_per_s=G * S / (ms / 1e3),
                   wall_ms=(time.perf_counter() - t0) / 21 * 1e3)
    log(f"phase 7b moe_ffn: {json.dumps(res)}")
    ctx = {"cfg": cfg, "tree": tree, "golden": golden, "model": model, "x": x, "y": y,
           "aux": aux}
    return res, ctx


def phase7c_moe_serve(torch, PM, ctx, sizes=None):
    """The expert layer served: an actor of ray_tpu_torch.init() (default
    config: the torch_cuda policy on the card) holds the layer and answers
    8 requests of assorted [G, S] (S = 1, a ragged S and G = 1 among them)
    with y and aux. Checked in 7d."""
    import ray_tpu_torch as rt

    cfg, tree, dev = ctx["cfg"], ctx["tree"], ctx["model"].device
    sizes = sizes or [(8, 2048), (4, 1024), (1, 2048), (2, 17), (8, 512), (3, 1000),
                      (1, 1), (6, 2047)]
    rng = np.random.default_rng(71)
    requests = [PM.numpy_moe_inputs(tree, (g, s, cfg.d_model), int(rng.integers(1 << 30)))
                for g, s in sizes]
    if dev.type == "cuda":
        rt.init(num_cpus=8)  # the default config: torch_cuda on the card
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        @rt.remote
        class ExpertServer:
            """User code: holds the expert layer on the card, answers requests."""

            def __init__(self, weights):
                self.layer = PM.moe_params_from_numpy(weights, cfg, device=dev)

            def forward(self, x):
                y, aux = self.layer(torch.from_numpy(x).to(dev, torch.bfloat16))
                return y.float().cpu().numpy(), float(aux)

        server = ExpertServer.remote(tree)
        t0 = time.perf_counter()
        answers = rt.get([server.forward.remote(r) for r in requests], timeout=600)
        t_serve = time.perf_counter() - t0
        policy = rt.core.api._runtime.policy
        assert policy.name == "torch_cuda" and policy.device.type == dev.type, policy.name
    finally:
        rt.shutdown()
    res = {"requests": len(requests), "tokens": int(sum(r.shape[0] * r.shape[1]
                                                        for r in requests)),
           "serve_s": t_serve}
    log(f"phase 7c served: {json.dumps(res)}")
    return res, requests, answers


def phase7d_moe_checks(torch, PM, EK, ctx, requests, answers):
    """The expert layer's results checked, outside its counting window: K9a
    on the golden's JAX logits against JAX's routing; moe_ffn on the
    golden's x in both expert dtypes against the golden's y and aux, over
    the groups free of near-ties; two groups of 7b against the port's plain
    moe_ffn on the CPU; each served answer against the direct call."""
    cfg, model, golden, dev = ctx["cfg"], ctx["model"], ctx["golden"], ctx["model"].device
    S = golden["logits"].shape[1]
    C = PM._capacity(cfg, S)
    expert, gate, slot, _, _ = EK.moe_route(torch.from_numpy(golden["logits"]).to(dev), C)
    if not (np.array_equal(expert.cpu().numpy(), golden["expert"])
            and np.array_equal(slot.cpu().numpy(), golden["slot"])):
        raise AssertionError("moe_route on the golden's logits: routing != JAX's")
    gate_err = float(np.abs(gate.cpu().numpy() - golden["gate"]).max())
    if gate_err > ROUTE_TOL:
        raise AssertionError(f"moe_route on the golden's logits: gate off by {gate_err}")

    tree = ctx["tree"]
    xg = torch.from_numpy(PM.numpy_moe_inputs(tree, golden["logits"].shape[:2] + (cfg.d_model,),
                                              int(golden["x_seed"]), float(golden["skew"])))
    clean = golden["gap"].min(axis=1) >= PM.MOE_TIE_GAP
    if not clean.any():
        raise AssertionError("every golden group holds a near-tie: nothing to compare")
    pos = golden["positions"]
    golden_res = {"groups_left_out": int((~clean).sum()), "routing_equal": True,
                  "gate_err": gate_err}
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        layer = PM.moe_params_from_numpy(tree, PM.MoEConfig(dtype=dt), device=dev)
        y, aux = PM.moe_ffn(layer, xg.to(dev))
        y = y.cpu().numpy()
        got = np.stack([y[i, pos[i]] for i in range(len(pos))])[clean]
        want = golden[f"y_{dt_name}"][clean]
        y_tol, aux_tol = PM.MOE_GOLDEN_TOL[dt_name]
        err = float(np.abs(got - want).max())
        aux_err = abs(float(aux) - float(golden[f"aux_{dt_name}"]))
        zeros_equal = np.array_equal((got == 0).all(-1), (want == 0).all(-1))
        if err > y_tol or aux_err > aux_tol or not zeros_equal:
            raise AssertionError(f"golden {dt_name}: y err {err} (atol {y_tol}), aux err "
                                 f"{aux_err} (atol {aux_tol}), dropped rows equal {zeros_equal}")
        golden_res[dt_name] = {"y_err": err, "aux_err": aux_err}

    # two groups of 7b free of near-ties against the plain moe_ffn on the CPU
    x = ctx["x"]
    probs = EK.softmax_plain(torch.matmul(x.float(), model.router)).cpu()
    top2 = probs.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).amin(-1)
    groups = [int(g) for g in torch.nonzero(gaps >= PM.MOE_TIE_GAP).flatten()[:2]]
    if len(groups) < 2:
        raise AssertionError(f"fewer than two groups of 7b free of near-ties: {gaps.tolist()}")
    cpu_layer = PM.moe_params_from_numpy(tree, cfg, device="cpu")
    y_cpu, _ = PM.moe_ffn(cpu_layer, x[groups].cpu())
    y_dev = ctx["y"][groups].cpu()
    cpu_err = float((y_dev.float() - y_cpu.float()).abs().max())
    bad = (y_dev.float() - y_cpu.float()).abs() > \
        PM.MOE_GOLDEN_TOL["bf16"][0] + 2 ** -7 * y_cpu.float().abs()
    if bool(bad.any()) or not torch.equal((y_dev == 0).all(-1), (y_cpu == 0).all(-1)):
        raise AssertionError(f"moe_ffn: card vs CPU on groups {groups}: max err {cpu_err}")

    for r, (y_ans, aux_ans) in zip(requests, answers):
        y, aux = model(torch.from_numpy(r).to(dev, torch.bfloat16))
        if not (np.array_equal(y_ans, y.float().cpu().numpy()) and aux_ans == float(aux)):
            raise AssertionError(f"served answer for {r.shape} differs from the direct call")
    res = {"golden": golden_res, "cpu_groups": groups, "cpu_y_err": cpu_err,
           "served_equal_direct": len(answers)}
    log(f"phase 7d checks: {json.dumps(res)}")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: the ray_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.sched import _build, kernel_np, policy as policy_mod
    from ray_tpu_torch.sched import kernel_torch as KT
    from ray_tpu_torch.models import kernels as MK, transformer as PT
    from ray_tpu_torch.models import moe as PM, moe_kernels as EK
    from ray_tpu_torch.parallel import make_forward_step
    from ray_tpu_torch.util import cuda_build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libraries = [_build.LIBRARY, MK.LIBRARY, EK.LIBRARY]
    cuda_build.build_all(libraries)  # one nvcc each, together
    log(f"phase 0 build: {time.perf_counter() - t0:.2f} s (" + "; ".join(
        f"nvcc {lib.build_seconds:.2f} s -> {lib.library_path().name}"
        for lib in libraries) + ")")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    rec = phase1_kernels(torch, KT, kernel_np, dev)
    log(f"phase 1: {time.perf_counter() - t0:.1f} s")

    # the main path: counters from 0, read after phase 4
    guard_records = []

    class _Guard(logging.Handler):
        def emit(self, record):
            if "violated scheduling invariant" in record.getMessage():
                guard_records.append(record.getMessage())

    plog = logging.getLogger(policy_mod.__name__)
    plog.addHandler(_Guard(level=logging.WARNING))
    KT.reset_launch_counts()
    t0 = time.perf_counter()
    stream = {algo: phase2_stream(torch, KT, dev, algo=algo) for algo in KT.ALGOS}
    after2 = KT.launch_counts()
    log(f"phase 2: {time.perf_counter() - t0:.1f} s, launches {after2}")
    t0 = time.perf_counter()
    phase3_policy_lockstep(torch, policy_mod, Config)
    after3 = KT.launch_counts()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s, launches {after3}")
    t0 = time.perf_counter()
    phase4_entry_points(torch, KT)
    after4 = KT.launch_counts()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s, launches {after4}")
    t0 = time.perf_counter()
    gcs = phase5_gcs(torch, KT)
    launches = KT.launch_counts()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s, launches {launches}")
    if guard_records:
        raise AssertionError(f"invariant guard fired: {guard_records}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # the model payload: its kernels against their plain versions, then its
    # main path (the forward, direct and served) with the counters from 0,
    # then the checks of what it gave, outside the counting window
    t0 = time.perf_counter()
    model_rec = phase6a_model_kernels(torch, MK, dev)
    log(f"phase 6a: {time.perf_counter() - t0:.1f} s")
    MK.reset_launch_counts()
    t0 = time.perf_counter()
    fwd_res, ctx = phase6b_forward(torch, PT, make_forward_step, dev)
    log(f"phase 6b: {time.perf_counter() - t0:.1f} s, launches {MK.launch_counts()}")
    log(f"forward [8, 2048] bf16 on {card}: {fwd_res['forward_ms']:.3f} ms, "
        f"{fwd_res['tokens_per_s']:.0f} tokens/s")
    t0 = time.perf_counter()
    serve_res, requests, answers = phase6c_serve(torch, PT, make_forward_step, ctx)
    model_launches = MK.launch_counts()
    log(f"phase 6c: {time.perf_counter() - t0:.1f} s, launches {model_launches}")
    missing = [k for k in FORWARD_KERNELS if model_launches[k] == 0]
    if missing:
        raise AssertionError(f"model kernels never launched on the forward's path: {missing}")
    t0 = time.perf_counter()
    check_res = phase6d_checks(torch, PT, MK, ctx, requests, answers)
    log(f"phase 6d: {time.perf_counter() - t0:.1f} s")

    # the expert layer: its kernels against their plain versions, then its
    # main path (moe_ffn, direct and served) with the counters from 0, then
    # the checks of what it gave, outside the counting window
    t0 = time.perf_counter()
    moe_rec = phase7a_moe_kernels(torch, PM, EK, dev)
    log(f"phase 7a: {time.perf_counter() - t0:.1f} s")
    EK.reset_launch_counts()
    t0 = time.perf_counter()
    moe_res, moe_ctx = phase7b_moe(torch, PM, dev)
    log(f"phase 7b: {time.perf_counter() - t0:.1f} s, launches {EK.launch_counts()}")
    log(f"moe_ffn [8, 2048, 256] bf16 on {card}: {moe_res['ms']:.4f} ms, "
        f"{moe_res['tokens_per_s']:.0f} tokens/s, dropped {moe_res['dropped_share']:.4f}")
    t0 = time.perf_counter()
    moe_serve, moe_requests, moe_answers = phase7c_moe_serve(torch, PM, moe_ctx)
    moe_launches = EK.launch_counts()
    log(f"phase 7c: {time.perf_counter() - t0:.1f} s, launches {moe_launches}")
    missing = [k for k, v in moe_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"expert kernels never launched on the expert path: {missing}")
    t0 = time.perf_counter()
    moe_checks = phase7d_moe_checks(torch, PM, EK, moe_ctx, moe_requests, moe_answers)
    log(f"phase 7d: {time.perf_counter() - t0:.1f} s")

    replaces = {
        "schedule_classes": "ray_tpu/sched/kernel_jax.py:154",
        "scatter_rows": "ray_tpu/sched/kernel_jax.py:451",
        "delta_clip": "ray_tpu/sched/kernel_jax.py:474",
        "compact_nonzero": "ray_tpu/sched/kernel_jax.py:546",
        "schedule_classes_rounds": "ray_tpu/sched/kernel_jax.py:317",
        "schedule_classes_chunked": "ray_tpu/sched/kernel_jax.py:367",
    }
    kernels = []
    for name, r in rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    off_path = []
    for name, r in model_rec.items():
        entry = {
            "name": name, "route": "cuda", "source": MODEL_CU_SOURCE,
            "replaces": MODEL_REPLACES[name], "launches": model_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        }
        if name in FORWARD_KERNELS:
            kernels.append(entry)
        else:  # no ported path runs it yet: its launches are the ring check's
            entry["check_launches"] = check_res["ring_block_update_launches"]
            off_path.append(entry)
    for name, r in moe_rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": MOE_CU_SOURCE,
            "replaces": MOE_REPLACES[name], "launches": moe_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(json.dumps({"stream": stream, "gcs": gcs, "forward": fwd_res, "serve": serve_res,
                    "checks": check_res, "moe": moe_res, "moe_serve": moe_serve,
                    "moe_checks": moe_checks, "card": card}))
    log(json.dumps({"kernels_off_main_path": off_path}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
