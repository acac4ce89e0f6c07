"""Where the scheduling round's time goes on the card.

    python -m ray_tpu_torch.scripts.profile_sched k1      # from the repo root
    python -m ray_tpu_torch.scripts.profile_sched k7
    python -m ray_tpu_torch.scripts.profile_sched k5
    python -m ray_tpu_torch.scripts.profile_sched k6
    python -m ray_tpu_torch.scripts.profile_sched stream
    python -m ray_tpu_torch.scripts.profile_sched ab DIR [DIR ...]
    python -m ray_tpu_torch.scripts.profile_sched e2e DIR [DIR ...]
    python -m ray_tpu_torch.scripts.profile_sched profiler [SCENARIO]
    python -m ray_tpu_torch.scripts.profile_sched putwait
    python -m ray_tpu_torch.scripts.profile_sched sass DIR DIR

``k1``: builds the kernels with ``-DSCHED_K1_PROFILE`` (thread 0 of every
block sums clock64 cycles per pass phase) and runs K1 at the stream
problem's two shapes (first round: ~100k tasks, 8 000 of 10 000 nodes
alive; full backlog: 1M tasks, all nodes): for every block of the cluster,
cycles per pass in exchange 1 (the bounded cluster barrier and the
feasible counts), the sweep (caps, bucket totals), exchange 2 (the
barrier, the peers' bucket totals, offsets and take modes), the fill with
the next pass's phase 1, and the tail; and the slowest block, the one with
the most cycles outside the exchanges (the others wait for it there).

``k7``: the same build and problems through K7 (kernel_shard), which runs
K1's kernel on a cluster of 1, 2, 4 and 8 blocks: K1's phases for every
block of each cluster, and the slowest block.

``k5``, ``k6``: the same build; K5 (4 rounds) or K6 (chunks of 16, 2
rounds) at the stream's first round as TorchScheduler calls them (padded to
256 classes, the demanded columns active): under torch.profiler, one call's
kernels summed by name (launches, device ms) and the gaps between its
launches; and, for K6's cluster kernel, every block's cycles by phase
(caps; the feasible-count exchange; totals: phase B's equal-share caps and
the segments' and block's totals; the totals exchange; want, the prefix
taken a warp a segment, and the trim; the debit at a phase's end; the
placed-count exchange), with the tiles each block ran and skipped (K5's
three kernels a phase stamp nothing).

``stream``: runs chip_smoke.py's 1M-task stream (phase 2) under
torch.profiler and reports the device's busy and idle share of the
stream's wall time and device time by kernel name.

``ab``: K1 alone, K1 with a refresh in its launch where the tree's K1
takes one (1 000 dirty rows of pad 1 024, or a delta [10 000, 16]) and the
pair a round ran before (K2 or K3 alone, then K1 in place), K5, K6 and K7
(p = 1, 2, 4, 8, without the wrapper's checks) and
K4 (on K1's assignment, with the cap and widths TorchScheduler picks) at
the stream's first round, K10a' at the train step's [16 384, 512] in bf16
and f32, K10b at the forward's [8, 2048, 1536] bf16, K10b' at the train
step's [8, 2048, 8, 64] in bf16 and f32, K9a and K9a' at the expert
layer's logits [8, 2048, 8] with C 320, K8's block form on a visible
[8, 512, 8, 64] block in bf16 and f32, a round's view build as the tree's
TorchScheduler makes it (K3 on [10 000, 16], K2 at 1 000 rows of pad
1 024, each followed by the clone of the view where the tree's rounds
copy it), a pipelined scan round's launch and copy calls alone and
after apply_delta or update_rows, and that round's host ms on an idle card
(the refresh call and schedule_async; and to the fetched result), from
each of the given checkouts of this
repo, in turns (the trees in order, then in reverse), each run a process
of its own that builds that tree's kernels: whether each equals its plain
version (K7: K1; K9a: its integers, and the largest difference of its gate
and sums; K10a', K10b, K10b', K9a', K8's block form: the largest
difference), and the CUDA-event
medians of three sets of calls
(chip_smoke.time_ms), beside that of one empty kernel (the timing's
floor). For comparing versions of the kernels on one card.

``e2e``: in the same turns, chip_smoke.py's end-to-end paths from each
tree: the stream's decisions/s and median loop-iteration ms under each
algorithm (phase 2), the
pipelined GCS's (phase 5b, 100 000 tasks over 10 000 nodes; 5a's
lockstep cut to 1 000 tasks), the
forward's ms (6b), the train step's (9b), and the expert layer's (7b) and
its train step's (10b), each by events and by the host clock.

``putwait``: whether TorchScheduler.schedule_async waits for the work
already on the stream: its host ms with the stream idle and behind a sleep
kernel of ~25 ms, and, in one torch.profiler session of the busy case, the
host µs of each runtime call it makes that copies or waits (cudaMemcpy*,
cuda*Synchronize: the demands and counts from pageable memory are blocking
copies, which synchronise the stream), in order, with the µs from the
call's start.

``sass``: K1's kernel without a refresh (schedule_classes_kernel's REF =
kRefreshNone instantiations, K7's included) compiled from the first tree's
source and from the second's, with the build's flags, and their SASS
compared instruction for instruction (cuobjdump; the parameters' constant
bank offsets masked): each form's instruction counts and differing lines;
and, in the second tree, each refresh instantiation's count beside the one
without. The source is compiled only, nothing runs.

``profiler``: whether torch.profiler records device activity after what
preceded its silence in chip_smoke.py (profiler_scenario), each scenario
in a process of its own: a session's device events beside the launch
calls CUPTI's runtime callbacks saw in the same window.

Each prints one JSON line; the problems come from chip_smoke.py (seeded).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _need_cuda():
    if not torch.cuda.is_available():
        print("profile_sched: needs a CUDA device", file=sys.stderr)
        sys.exit(2)


#: the phases of a pass of K1's kernel (K1, and K7 on p blocks)
K1_PHASES = ("exchange1", "sweep", "exchange2", "fill_next", "tail")


def _profile_phases(calls) -> dict:
    """Run each of `calls` (label -> (fn(args), blocks(args))), each a launch
    of K1's kernel, at the stream problem's two shapes in the
    -DSCHED_K1_PROFILE build, reading its cycle sums by block (K1_PHASES,
    then the pass count; the exchanges wait for the peers) around one timed
    call."""
    import ctypes

    import chip_smoke
    from ray_tpu_torch.sched import _build, kernel_torch as KT

    lib = _build.load(extra_flags=("-DSCHED_K1_PROFILE",))
    read = lib.sched_k1_profile
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    rows = 16  # blocks the profile array holds
    fields, exchanges = K1_PHASES, ("exchange1", "exchange2")
    width = len(fields) + 1
    dev = torch.device("cuda", 0)
    total, alive_all, demands, counts = chip_smoke.build_stream_problem(
        np.random.default_rng(5))
    alive_first = alive_all.copy()
    alive_first[int(len(alive_first) * 0.8):] = False
    out = {}
    for label, k, alive in (
        ("first_round", np.floor(counts / 10).astype(np.int32), alive_first),
        ("full_backlog", counts, alive_all),
    ):
        d, kk = KT.pad_problem(demands, k, KT.bucket_size(len(demands)))
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (total * alive[:, None], total, alive, d, kk)]
        for call, (fn, blocks) in calls.items():
            buf = (ctypes.c_ulonglong * (rows * width))()
            fn(args)  # warm
            torch.cuda.synchronize()
            read(buf, 1)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(args)
            e.record()
            torch.cuda.synchronize()
            if read(buf, 1) != 0:
                raise RuntimeError("reading the K1 profile failed")
            nblocks = blocks(args)
            by_block = []
            for r in range(nblocks):
                row = buf[r * width:(r + 1) * width]
                passes = max(int(row[-1]), 1)
                by_block.append({name: row[i] / passes for i, name in enumerate(fields)})
            work = [sum(v for f, v in b.items() if f not in exchanges) for b in by_block]
            slowest = int(np.argmax(work))
            out[f"{label}{call}"] = {
                "ms": s.elapsed_time(e),
                "passes": int(buf[width - 1]),
                "blocks": nblocks,
                "slowest_block": slowest,
                "cycles_per_pass_slowest_block": by_block[slowest],
                "cycles_per_pass_mean": {f: float(np.mean([b[f] for b in by_block]))
                                         for f in fields},
                "cycles_per_pass_by_block": by_block,
            }
    return out


def profile_k1() -> dict:
    from ray_tpu_torch.sched import kernel_torch as KT

    return _profile_phases(
        {"": (lambda a: KT.schedule_classes(*a),
              lambda a: KT.k1_launch_plan(*a[0].shape, a[0].device).cluster)})


def profile_k7() -> dict:
    from ray_tpu_torch.sched import kernel_shard as KS

    return _profile_phases(
        {f"_p{p}": ((lambda a, p=p: KS.schedule_classes_sharded(*a, shards=p)),
                    (lambda a, p=p: p))
         for p in KS.SHARDS})


#: the phases of K6 that the profile build stamps, in its order
ROUNDS_PHASES = ("caps", "count_exchange", "totals", "totals_exchange", "want_trim",
                 "debit", "placed_exchange")


def profile_rounds(which: str) -> dict:
    """K5 or K6 at the stream's first round: one call's launches and device
    time by kernel name under torch.profiler, the gaps between them, and
    every block's cycles by phase."""
    import ctypes

    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.sched import _build, kernel_torch as KT

    lib = _build.load(extra_flags=("-DSCHED_K1_PROFILE",))
    dev = torch.device("cuda", 0)
    total, alive, demands, counts = chip_smoke.build_stream_problem(np.random.default_rng(5))
    alive = alive.copy()
    alive[int(len(alive) * 0.8):] = False
    first = np.floor(counts / 10).astype(np.int32)
    d, k = KT.pad_problem(demands, first, KT.bucket_size(len(demands)))
    active = tuple(int(i) for i in np.flatnonzero((d > 0).any(axis=0)))
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (total * alive[:, None], total, alive, d, k)]
    if which == "k5":
        run = lambda: KT.schedule_classes_rounds(*args, rounds=4, active_idx=active)  # noqa: E731
    else:
        run = lambda: KT.schedule_classes_chunked(  # noqa: E731
            *args, chunk=16, rounds=2, active_idx=active)
    reader = lib.sched_rounds_profile
    reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
    reader.restype = ctypes.c_int
    width = len(ROUNDS_PHASES) + 2  # the phases, tiles run, tiles skipped
    buf = (ctypes.c_ulonglong * (16 * width))()
    run()  # warm
    torch.cuda.synchronize()
    if reader(buf, 1) != 0:  # reset
        raise RuntimeError("resetting the K6 profile failed")
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    kernels = [x for x in spans if "Memset" not in x[2] and "Memcpy" not in x[2]]
    by_name = {}
    for a, b, name in kernels:
        n, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, ms + (b - a) / 1e3)
    gaps = [max(0.0, kernels[i + 1][0] - kernels[i][1]) / 1e3 for i in range(len(kernels) - 1)]
    out = {
        "shape": {"N": int(len(total)), "C": int(len(d)), "active": list(active)},
        "event_ms": s.elapsed_time(e),
        "launches": len(kernels),
        "device_ms": sum(ms for _, ms in by_name.values()),
        "gap_ms": sum(gaps),
        "span_ms": (kernels[-1][1] - kernels[0][0]) / 1e3 if kernels else 0.0,
        "by_kernel": {name: {"launches": n, "ms": ms} for name, (n, ms) in by_name.items()},
        "note": "the -DSCHED_K1_PROFILE build (stamps cost some cycles where present)",
    }
    if reader(buf, 1) != 0:
        raise RuntimeError("reading the K6 profile failed")
    blocks = []
    for r in range(16):
        row = buf[r * width:(r + 1) * width]
        tiles = int(row[-2])
        if tiles == 0 and int(row[-1]) == 0:
            continue
        blocks.append({"rank": r, "tiles_run": tiles, "tiles_skipped": int(row[-1]),
                       "cycles": {f: int(row[i]) for i, f in enumerate(ROUNDS_PHASES)}})
    out["cycles_by_block"] = blocks
    if blocks:
        out["cycles_mean"] = {f: float(np.mean([b["cycles"][f] for b in blocks]))
                              for f in ROUNDS_PHASES}
        busy = [sum(v for f, v in b["cycles"].items() if "exchange" not in f)
                for b in blocks]
        out["slowest_block"] = blocks[int(np.argmax(busy))]["rank"]
    return out


# Run in a tree's root by `ab`, with only what every version of the port
# has: chip_smoke.stream_first_round, time_ms and LAUNCH_CALLS,
# TorchScheduler, kernel_torch's K2/K3, K5/K6, K4
# (compact_nonzero) and their plain versions, kernel_shard._launch (K7
# without the wrapper's checks), the model kernels' rmsnorm_bwd (K10a'),
# rope_split (K10b) and rope_split_bwd (K10b') and their plain versions,
# block_update (K8's block form) and its plain version, and the expert
# layer's moe_route (K9a) and moe_route_bwd (K9a') on chip_smoke's
# main-path logits.
_AB = """
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as CS
from ray_tpu_torch.sched import kernel_shard as KS, kernel_torch as KT
from ray_tpu_torch.models import kernels as MK, moe as PM, moe_kernels as EK
dev = torch.device("cuda", 0)
avail, total, alive, demands, counts = CS.stream_first_round()
d, k = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
active = tuple(int(i) for i in np.flatnonzero((d > 0).any(axis=0)))
args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (avail, total, alive, d, k)]
out = {}
# a pipelined scan round's launch and copy calls (torch.profiler's runtime
# records), alone and after apply_delta or update_rows; first, since the
# profiler loses records once a process has gone a minute without a session
from torch.profiler import ProfilerActivity, profile
def enqueued(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CPU]
    return {"launches": sum(n.startswith(CS.LAUNCH_CALLS) for n in names),
            "copies": sum(n.startswith("cudaMemcpy") for n in names)}
sched = KT.TorchScheduler(total, alive, device=dev)
sched.set_available(avail)
dirty = np.arange(8000, 9000)
rnd = lambda: sched.fetch(sched.schedule_async(demands, counts))
out["enqueued_round"] = enqueued(rnd)
out["enqueued_delta_round"] = enqueued(lambda: (sched.apply_delta(np.zeros_like(total)), rnd()))
out["enqueued_rows_round"] = enqueued(lambda: (sched.update_rows(dirty, total[dirty]), rnd()))
# the host's ms for a pipelined scan round on an idle card, alone and after
# apply_delta or update_rows: to the return of schedule_async (the refresh
# call and the round's enqueue) and to its fetched result; the view reset
# before each, three sets of interleaved calls, the median of each
import time
host_delta = np.random.default_rng(4).integers(-300, 300, total.shape).astype(np.float32)
pushes = {"round": lambda: None,
          "delta_round": lambda: sched.apply_delta(host_delta),
          "rows_round": lambda: sched.update_rows(dirty, total[dirty])}
host = {k: ([], []) for k in pushes}
for _ in range(3):
    sets = {k: ([], []) for k in pushes}
    for i in range(103):
        for k, push in pushes.items():
            sched.set_available(avail)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            push()
            h = sched.schedule_async(demands, counts)
            t1 = time.perf_counter()
            sched.fetch(h)
            t2 = time.perf_counter()
            if i >= 3:  # warm
                sets[k][0].append((t1 - t0) * 1e3)
                sets[k][1].append((t2 - t0) * 1e3)
    for k, (a, b) in sets.items():
        host[k][0].append(float(np.median(a)))
        host[k][1].append(float(np.median(b)))
for k, (a, b) in host.items():
    out[f"host_{k}_enqueue_ms"], out[f"host_{k}_result_ms"] = a, b
# a round's view build at the main path's shapes, as this tree's
# TorchScheduler makes it: the refresh, then a clone of the view where the
# tree's round wrappers copy it (no private _in_place)
import inspect
copies_view = "_in_place" not in inspect.signature(KT.schedule_classes).parameters
rng = np.random.default_rng(3)
av, tt = args[0], args[1]
delta = torch.from_numpy(rng.integers(-300, 300, total.shape).astype(np.float32)).to(dev)
ti = np.full(1024, len(total), np.int32)
ti[:1000] = dirty
tr = np.concatenate([total[dirty], np.zeros((24, total.shape[1]), np.float32)])
ti, tr = torch.from_numpy(ti).to(dev), torch.from_numpy(tr).to(dev)
work = av.clone()
view = (lambda v: v.clone()) if copies_view else (lambda v: v)
out["round_copies_view"] = copies_view
for name, fn in (("k3", lambda: KT.delta_clip(av, delta, tt)),
                 ("k2", lambda: KT.scatter_rows_(work, ti, tr))):
    out[f"{name}_ms"] = [CS.time_ms(torch, fn, reps=21) for _ in range(3)]
    out[f"view_{name}_ms"] = [CS.time_ms(torch, lambda: view(fn()), reps=21) for _ in range(3)]
for name, fn, plain, kw in (
        ("k5", KT.schedule_classes_rounds, KT._schedule_classes_rounds_plain, {"rounds": 4}),
        ("k6", KT.schedule_classes_chunked, KT._schedule_classes_chunked_plain,
         {"chunk": 16, "rounds": 2})):
    kw = dict(kw, active_idx=active)
    a, v = fn(*args, **kw)
    a_p, v_p = plain(*args, **kw)
    out[name + "_exact"] = bool(torch.equal(a, a_p) and torch.equal(v, v_p))
    out[name + "_ms"] = [CS.time_ms(torch, lambda: fn(*args, **kw), reps=11) for _ in range(3)]
k1_a, k1_v = KT.schedule_classes(*args)
# K1 as a round's wrapper calls it: alone (on a copy of the view), with the
# refresh in its launch where this tree's K1 takes one, and the pair (K2 on
# a copy, or K3 into a new view, then K1 in place where the tree's K1 can)
fused = "_refresh" in inspect.signature(KT.schedule_classes).parameters
in_place = {} if copies_view else {"_in_place": True}
def k2_pair():
    v = av.clone()
    KT.scatter_rows_(v, ti, tr)
    return KT.schedule_classes(v, *args[1:], **in_place)
runs = {"k1": lambda: KT.schedule_classes(*args), "k2_then_k1": k2_pair,
        "k3_then_k1": lambda: KT.schedule_classes(KT.delta_clip(av, delta, tt), *args[1:],
                                                  **in_place)}
# K1 alone on the view each refresh makes (what the fused round adds to)
views = {"rows": KT.scatter_rows_(av.clone(), ti, tr), "delta": KT.delta_clip(av, delta, tt)}
runs["k1_on_rows"] = lambda: KT.schedule_classes(views["rows"], *args[1:])
runs["k1_on_delta"] = lambda: KT.schedule_classes(views["delta"], *args[1:])
runs["k1_no_pass"] = lambda: KT.schedule_classes(*args, max_passes=0)
if fused:
    refs = {"rows": KT.Refresh("rows", ti, tr), "delta": KT.Refresh("delta", None, delta)}
    runs["k1_rows"] = lambda: KT.schedule_classes(*args, _refresh=refs["rows"])
    runs["k1_delta"] = lambda: KT.schedule_classes(*args, _refresh=refs["delta"])
    runs["k1_no_pass_rows"] = lambda: KT.schedule_classes(*args, max_passes=0,
                                                          _refresh=refs["rows"])
    runs["k1_no_pass_delta"] = lambda: KT.schedule_classes(*args, max_passes=0,
                                                           _refresh=refs["delta"])
    for m, pair in (("rows", "k2_then_k1"), ("delta", "k3_then_k1")):
        a_f, v_f = runs["k1_" + m]()
        a_s, v_s = runs[pair]()
        out[f"k1_{m}_exact"] = bool(torch.equal(a_f, a_s) and torch.equal(v_f, v_s))
out["k1_takes_a_refresh"] = fused
for name, fn in runs.items():
    out[name + "_ms"] = [CS.time_ms(torch, fn, reps=11) for _ in range(3)]
thr, passes = KT.DEFAULT_SPREAD_THRESHOLD, KT.MAX_PASSES
for p in KS.SHARDS:
    a, v = KS._launch(*args, thr, passes, p)
    out[f"k7_p{p}_exact"] = bool(torch.equal(a, k1_a) and torch.equal(v, k1_v))
    out[f"k7_p{p}_ms"] = [CS.time_ms(torch, lambda: KS._launch(*args, thr, passes, p))
                          for _ in range(3)]
g = torch.Generator().manual_seed(9)
for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    x = (torch.randn((16384, 512), generator=g) * 3.0).to(dev, dt)
    dy = torch.randn((16384, 512), generator=g).to(dev, dt)
    sc = torch.randn((512,), generator=g).to(dev)
    dx, ds = MK.rmsnorm_bwd(x, sc, dy)
    pdx, pds = MK._rmsnorm_bwd_plain(x, sc, dy)
    out[f"k10a_bwd_{name}_max_abs_err"] = [float((dx.double() - pdx.double()).abs().max()),
                                           float((ds.double() - pds.double()).abs().max())]
    out[f"k10a_bwd_{name}_ms"] = [CS.time_ms(torch, lambda: MK.rmsnorm_bwd(x, sc, dy), reps=21)
                                  for _ in range(3)]
assign = k1_a[: len(demands)]
cap = next(b for b in KT.TorchScheduler._NONZERO_BUCKETS if b >= int(counts.sum()))
dts = (torch.int16, torch.int16, torch.uint8 if int(counts.max()) < 256 else torch.int32)
out["k4_exact"] = all(torch.equal(a, b) for a, b in zip(
    KT.compact_nonzero(assign, cap, *dts), KT._compact_nonzero_plain(assign, cap, *dts)))
out["k4_ms"] = [CS.time_ms(torch, lambda: KT.compact_nonzero(assign, cap, *dts), reps=21)
                for _ in range(3)]
# the floor of this timing: one empty kernel between the two events
out["empty_kernel_ms"] = CS.time_ms(torch, lambda: torch.cuda._sleep(0), reps=21)
qkv = torch.randn((8, 2048, 1536), generator=g).to(dev, torch.bfloat16)
out["k10b_max_abs_err"] = max(float((a.double() - b.double()).abs().max()) for a, b in zip(
    MK.rope_split(qkv, 8, 1e4), MK._rope_split_plain(qkv, 8, 1e4)))
out["k10b_ms"] = [CS.time_ms(torch, lambda: MK.rope_split(qkv, 8, 1e4), reps=21)
                  for _ in range(3)]
for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    dq, dk, dv = (torch.randn((8, 2048, 8, 64), generator=g).to(dev, dt) for _ in range(3))
    out[f"k10b_bwd_{name}_max_abs_err"] = float(
        (MK.rope_split_bwd(dq, dk, dv, 1e4).double()
         - MK._rope_split_bwd_plain(dq, dk, dv, 1e4).double()).abs().max())
    out[f"k10b_bwd_{name}_ms"] = [CS.time_ms(torch, lambda: MK.rope_split_bwd(dq, dk, dv, 1e4),
                                             reps=21) for _ in range(3)]
cfg, tree, _, x32 = CS._moe_layer(torch, PM, dev)
logits = torch.matmul(x32, torch.from_numpy(tree["router"]).to(dev))
C = PM._capacity(cfg, logits.shape[1])
got, want = EK.moe_route(logits, C), EK._route_plain(logits, C)
out["k9a_exact"] = all(torch.equal(got[i], want[i]) for i in (0, 2, 3)) and bool(
    torch.equal(got[4][:, 0], want[4][:, 0]))
out["k9a_max_abs_err"] = max(float((a.double() - b.double()).abs().max()) for a, b in (
    (got[1], want[1]), (got[4][:, 1], want[4][:, 1])))
out["k9a_ms"] = [CS.time_ms(torch, lambda: EK.moe_route(logits, C), reps=21) for _ in range(3)]
# K9a' on the same logits, as phase 10a times it
frac = EK.aux_loss(got[4], logits.shape[0] * logits.shape[1])[0]
d_gate = torch.randn(logits.shape[:2], generator=g).to(dev)
d_aux = torch.full((), 0.01, device=dev)
bwd = (logits, d_gate, frac, d_aux)
out["k9a_bwd_max_abs_err"] = float((EK.moe_route_bwd(*bwd).double()
                                    - EK._route_bwd_plain(*bwd).double()).abs().max())
out["k9a_bwd_ms"] = [CS.time_ms(torch, lambda: EK.moe_route_bwd(*bwd), reps=21)
                     for _ in range(3)]
# K8's block form as phase 6a times it: a visible [8, 512, 8, 64] block
# against a running state, bf16 and f32
st = (torch.randn((8, 512, 8, 64), generator=g).to(dev),
      torch.randn((8, 8, 512), generator=g).to(dev),
      (torch.randn((8, 8, 512), generator=g).abs() + 1).to(dev))
qkv_b = [torch.randn((8, 512, 8, 64), generator=g).to(dev, torch.bfloat16) for _ in range(3)]
for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    blk = (*(t.to(dt) for t in qkv_b), *st, 512, 0, True, 0.125)
    out[f"k8_block_{name}_max_abs_err"] = max(
        float((a.double() - b.double()).abs().max())
        for a, b in zip(MK.block_update(*blk), MK._block_update_plain(*blk)))
    out[f"k8_block_{name}_ms"] = [CS.time_ms(torch, lambda: MK.block_update(*blk))
                                  for _ in range(3)]
print(json.dumps(out))
"""


# Run in a tree's root by `e2e`: the end-to-end paths through chip_smoke's
# phase functions, which every version of the port has with these arguments.
_E2E = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as CS
from ray_tpu_torch.models import kernels as MK, moe as PM, moe_kernels as EK
from ray_tpu_torch.models import transformer as PT
from ray_tpu_torch.parallel import make_forward_step, tpu_train as TT
from ray_tpu_torch.sched import _build, kernel_torch as KT
from ray_tpu_torch.util import cuda_build
cuda_build.build_all([_build.LIBRARY, MK.LIBRARY, MK.LIBRARY_SM90, EK.LIBRARY])
dev = torch.device("cuda", 0)
out = {}
for algo in KT.ALGOS:
    res = CS.phase2_stream(torch, KT, dev, algo=algo)
    out[f"stream_{algo}_decisions_per_s"] = res["decisions_per_sec"]
    out[f"stream_{algo}_round_ms_median"] = res["round_ms_median"]
gcs = CS.phase5_gcs(torch, KT, n_lockstep=1000, n_wire=500)
for algo in KT.ALGOS:
    out[f"gcs_{algo}_decisions_per_s"] = gcs[algo]["decisions_per_sec"]
out["forward_ms"] = CS.phase6b_forward(torch, PT, make_forward_step, dev)[0]["forward_ms"]
out["train_step_ms"] = CS.phase9b_train(torch, PT, TT, dev)[0]["step_ms_median"]
res = CS.phase7b_moe(torch, PM, dev)[0]
out["moe_ms"], out["moe_wall_ms"] = res["ms"], res["wall_ms"]
res = CS.phase10b_moe_train(torch, PM, TT, dev)[0]
out["moe_train_step_ms"] = res["step_ms_median"]
out["moe_train_wall_ms"] = res["wall_ms_median"]
print(json.dumps(out))
"""


def ab(trees, script=_AB) -> dict:
    """`script` (_AB: K4-K7, K8's block form, K9a, K9a', K10a', K10b and
    K10b', the view builds, a round's calls; _E2E: the end-to-end paths) in
    each tree in turns,
    forward then backward."""
    import os
    import subprocess

    runs = []
    for tree in list(trees) + list(reversed(trees)):
        res = subprocess.run([sys.executable, "-c", script], cwd=os.path.abspath(tree),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"ab {tree}: {res.stderr[-2000:]}")
        runs.append({"tree": tree, **json.loads(res.stdout.strip().splitlines()[-1])})
    return {"runs": runs}


def profile_put_wait() -> dict:
    """putwait (module docstring): schedule_async's host ms at the stream's
    first round, the stream idle and behind a sleep kernel, and its copy
    calls' host µs in one profiled busy call."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.sched import _build, kernel_torch as KT

    _build.load()
    dev = torch.device("cuda", 0)
    avail, total, alive, demands, counts = chip_smoke.stream_first_round()
    sched = KT.TorchScheduler(total, alive, device=dev)
    sched.set_available(avail)
    sleep_cycles = 50_000_000
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(sleep_cycles)
    e.record()
    torch.cuda.synchronize()
    out = {"sleep_ms": s.elapsed_time(e), "idle_ms": [], "busy_ms": []}
    for _ in range(2):  # warm
        sched.fetch(sched.schedule_async(demands, counts))
    for _ in range(5):
        for key in ("idle_ms", "busy_ms"):
            torch.cuda.synchronize()
            if key == "busy_ms":
                torch.cuda._sleep(sleep_cycles)
            t0 = time.perf_counter()
            h = sched.schedule_async(demands, counts)
            out[key].append((time.perf_counter() - t0) * 1e3)
            sched.fetch(h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(sleep_cycles)
        h = sched.schedule_async(demands, counts)
    sched.fetch(h)
    calls = sorted((ev for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CPU
                    and ev.name.startswith("cuda") and ("Memcpy" in ev.name
                                                        or "Synchronize" in ev.name)),
                   key=lambda ev: ev.time_range.start)
    t0 = calls[0].time_range.start if calls else 0
    out["copy_and_wait_calls_host_us"] = [
        {"name": ev.name, "at_us": ev.time_range.start - t0,
         "us": ev.time_range.end - ev.time_range.start} for ev in calls]
    return out


def sass_compare(old_tree: str, new_tree: str) -> dict:
    """sass (module docstring): K1's instantiations without a refresh in
    two trees' sources, instruction for instruction."""
    import difflib
    import os
    import re
    import subprocess
    import tempfile

    from ray_tpu_torch.sched import _build
    from ray_tpu_torch.util import cuda_build

    src = os.path.join("ray_tpu_torch", "sched", "csrc", "sched_kernels.cu")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    objdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")

    def functions(tree):
        with tempfile.TemporaryDirectory() as tmp:
            cubin = os.path.join(tmp, "k.cubin")
            subprocess.run([cuda_build.nvcc(), *flags, "-cubin", "-o", cubin,
                            os.path.join(tree, src)], check=True, capture_output=True)
            text = subprocess.run([objdump, "-sass", cubin], check=True, capture_output=True,
                                  text=True).stdout
        out, cur = {}, None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = out.setdefault(m.group(1), [])
            elif cur is not None and "/*" in line and ";" in line:
                ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
                cur.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins))
        return out

    def pick(fs, rows, threads, ref=None):
        tail = "E" if ref is None else f"ELi{ref}E"
        pat = rf"schedule_classes_kernelILb{rows}ELi{threads}{tail}E"
        return next((v for k, v in fs.items() if re.search(pat, k)), None)

    def differ(a, b):
        return sum(1 for l in difflib.unified_diff(a, b, lineterm="", n=0)
                   if l[:1] in "+-" and not l.startswith(("+++", "---")))

    old, new = functions(old_tree), functions(new_tree)
    res = {}
    for rows, threads in (("1", "512"), ("0", "512"), ("0", "1024")):
        a = pick(old, rows, threads) or pick(old, rows, threads, 0)
        b = pick(new, rows, threads, 0)
        if a is not None and b is not None:
            res[f"rows{rows}_{threads}"] = {"old": len(a), "new": len(b),
                                            "differing_lines": differ(a, b)}
        for ref in (1, 2):
            c = pick(new, rows, threads, ref)
            if c is not None and b is not None:
                res[f"rows{rows}_{threads}_ref{ref}"] = {"instructions": len(c),
                                                         "without_refresh": len(b)}
    return res


def profile_stream() -> dict:
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.sched import _build, kernel_torch as KT

    _build.load()
    dev = torch.device("cuda", 0)
    chip_smoke.phase2_stream(torch, KT, dev, n_nodes=1000, n_tasks=100_000)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream = chip_smoke.phase2_stream(torch, KT, dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    spans.sort()
    busy, cur_a, cur_b = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    first, last = spans[0][0], max(b for _, b in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "stream": stream,
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share_of_wall": busy / 1e3 / (wall_s * 1e3),
        "device_busy_share_of_span": busy / max(last - first, 1e-9),
        "device_ms_by_kernel": dict(top),
    }


#: profiler's scenarios, each run in a fresh process: what came before the
#: sessions that recorded no device activity in chip_smoke.py (PERF.md)
PROFILER_SCENARIOS = ("baseline", "thread_exit", "many_sessions", "idle", "idle_padded",
                      "stream", "stream_thread", "gcs")


def _session(fn, pad_s: float = 0.0) -> dict:
    """One torch.profiler session (CPU and CUDA) around fn() and a
    synchronise, idle for pad_s seconds before and after them: its device
    events, the CPU-side launch calls that CUPTI's runtime callbacks saw in
    the same window, and the first kernel's start less its launch call's
    start (µs; a few µs where the two clocks agree)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    kernels = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    launches = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(("cudaLaunch", "cuLaunch"))]
    offset = (kernels[0].time_range.start - launches[0].time_range.start
              if kernels and launches else None)
    return {"device_events": len(kernels), "runtime_launches": len(launches),
            "kernel_minus_launch_us": offset}


def profiler_scenario(name: str) -> dict:
    """Sessions around K3 (delta_clip, one launch) before and after what a
    scenario does: nothing (baseline); a thread that launched kernels and
    exited (thread_exit); forty sessions in a row (many_sessions); a minute
    idle, then sessions as usual (idle) or idle 0.25 s before and after
    the call inside the session (idle_padded); chip_smoke.py's stream at 1 000 nodes and 100 000 tasks,
    its rounds' results copied to pinned host memory behind events, in this
    thread (stream) or in a thread that then exits (stream_thread); the GCS
    phase of chip_smoke.py at 10 000 nodes and fewer tasks, whose
    scheduler loop threads run the round on the card and exit at shutdown
    (gcs)."""
    import threading

    import chip_smoke
    from ray_tpu_torch.sched import kernel_torch as KT

    dev = torch.device("cuda", 0)
    a = torch.rand((10_000, 16), device=dev)
    step = lambda: KT.delta_clip(a, a, a)  # noqa: E731
    step()
    torch.cuda.synchronize()
    before = [_session(step)]
    if name == "thread_exit":
        t = threading.Thread(target=lambda: (step(), torch.cuda.synchronize()))
        t.start()
        t.join()
    elif name == "many_sessions":
        before += [_session(step) for _ in range(40)]
    elif name in ("idle", "idle_padded"):
        time.sleep(60)
    elif name in ("stream", "stream_thread"):
        run = lambda: chip_smoke.phase2_stream(torch, KT, dev, n_nodes=1000,  # noqa: E731
                                               n_tasks=100_000)
        if name == "stream":
            run()
        else:
            t = threading.Thread(target=run)
            t.start()
            t.join()
    elif name == "gcs":
        chip_smoke.phase5_gcs(torch, KT, n_lockstep=1000, n_pipelined=2000, n_wire=500)
    pad = 0.25 if name == "idle_padded" else 0.0
    after = [_session(step, pad) for _ in range(3)] + [_session(step)]  # the last unpadded
    return {"scenario": name, "before": before, "after": after,
            "silent_sessions": sum(1 for x in before + after if x["device_events"] == 0)}


def profiler_hunt() -> dict:
    """Each of PROFILER_SCENARIOS in a process of its own."""
    import subprocess

    runs = []
    for name in PROFILER_SCENARIOS:
        res = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.profile_sched",
                              "profiler", name], capture_output=True, text=True, timeout=900)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0
                    else {"scenario": name, "error": res.stderr[-2000:]})
    return {"runs": runs}


def main(argv) -> int:
    _need_cuda()
    what = argv[1] if len(argv) > 1 else "k1"
    if what == "k1":
        res = profile_k1()
    elif what == "k7":
        res = profile_k7()
    elif what in ("k5", "k6"):
        res = profile_rounds(what)
    elif what == "stream":
        res = profile_stream()
    elif what == "ab" and len(argv) > 2:
        res = ab(argv[2:])
    elif what == "e2e" and len(argv) > 2:
        res = ab(argv[2:], _E2E)
    elif what == "profiler":
        res = profiler_scenario(argv[2]) if len(argv) > 2 else profiler_hunt()
    elif what == "putwait":
        res = profile_put_wait()
    elif what == "sass" and len(argv) == 4:
        res = sass_compare(argv[2], argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps({"profile": what, "card": _card(), **res}))
    return 0


def _card() -> str:
    import chip_smoke

    return chip_smoke.card_line()


if __name__ == "__main__":
    sys.exit(main(sys.argv))
