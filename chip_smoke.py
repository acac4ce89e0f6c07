#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase's exception is
caught):

0. the card's name and power limit; build the CUDA kernels from
   ray_tpu_torch/sched/csrc (build seconds printed).
1. every kernel against its plain PyTorch version on the card, with exact
   equality: K1 on the golden problem of the kernel tests, on seeded random
   problems (dead nodes, masked custom resources, over-subscribed classes)
   and on the 10k-node x 256-class stream problem; K2, K3 and K4 at the
   bucket edges. K1 is also held against the NumPy reference (kernel_np).
   Median device times of each kernel and its plain version.
2. the 1M-task stream over 10k nodes (20% of the fleet held back, an
   autoscale flip, completions releasing resources) through
   TorchScheduler.schedule_async / fetch / apply_delta / update_rows, with
   the standing invariants asserted on every fetched round.
3. a torch_cuda policy on CUDA and one on the CPU, in lockstep on
   identical 10k-node states, over synchronous and pipelined rounds;
   decisions must be equal every round and the invariant guard silent.
4. the user entry points: ray_tpu_torch.init / @remote / get with
   dependencies and an actor, scheduled through the CUDA kernel.

Launch counters are set to 0 just before phase 2 and read after phase 4:
every kernel of the path must have launched in that run. The second to
last JSON line lists the kernels; the last line is the result.
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor) op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
CU_SOURCE = "ray_tpu_torch/sched/csrc/sched_kernels.cu"


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


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
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
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]})")
    return rec


def phase2_stream(torch, KT, dev, n_nodes=10_000, n_tasks=1_000_000):
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
            pipe.append((sched.schedule_async(demands, submit), submit))
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

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 0 build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s) -> {_build.library_path().name}")
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
    stream = phase2_stream(torch, KT, dev)
    after2 = KT.launch_counts()
    log(f"phase 2: {time.perf_counter() - t0:.1f} s, launches {after2}")
    t0 = time.perf_counter()
    phase3_policy_lockstep(torch, policy_mod, Config)
    after3 = KT.launch_counts()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s, launches {after3}")
    t0 = time.perf_counter()
    phase4_entry_points(torch, KT)
    launches = KT.launch_counts()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s, launches {launches}")
    if guard_records:
        raise AssertionError(f"invariant guard fired: {guard_records}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    replaces = {
        "schedule_classes": "ray_tpu/sched/kernel_jax.py:154",
        "scatter_rows": "ray_tpu/sched/kernel_jax.py:451",
        "delta_clip": "ray_tpu/sched/kernel_jax.py:474",
        "compact_nonzero": "ray_tpu/sched/kernel_jax.py:546",
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
    log(json.dumps({"stream": stream, "card": card}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
