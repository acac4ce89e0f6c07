"""Where the scheduling round's time goes on the card.

    python -m ray_tpu_torch.scripts.profile_sched k1      # from the repo root
    python -m ray_tpu_torch.scripts.profile_sched stream

``k1``: builds the kernels with ``-DSCHED_K1_PROFILE`` (K1's thread 0 sums
clock64 cycles per pass phase) and runs K1 at the stream problem's two
shapes (first round: ~100k tasks, 8 000 of 10 000 nodes alive; full
backlog: 1M tasks, all nodes): cycles per pass for phase 1 (fit, score
bucket, threshold cap), phase 2 (caps, bucket totals), phase 3 (the fill)
and the tail (clamp sweep, barrier).

``stream``: runs chip_smoke.py's 1M-task stream (phase 2) under
torch.profiler and reports the device's busy and idle share of the
stream's wall time and device time by kernel name.

Both print one JSON line; the problems come from chip_smoke.py (seeded).
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


def profile_k1() -> dict:
    import ctypes

    import chip_smoke
    from ray_tpu_torch.sched import _build, kernel_torch as KT

    lib = _build.load(extra_flags=("-DSCHED_K1_PROFILE",))
    lib.sched_k1_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sched_k1_profile.restype = ctypes.c_int
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
        buf = (ctypes.c_ulonglong * 5)()
        KT.schedule_classes(*args)  # warm
        torch.cuda.synchronize()
        lib.sched_k1_profile(buf, 1)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        KT.schedule_classes(*args)
        e.record()
        torch.cuda.synchronize()
        if lib.sched_k1_profile(buf, 1) != 0:
            raise RuntimeError("reading the K1 profile failed")
        passes = max(int(buf[4]), 1)
        out[label] = {
            "ms": s.elapsed_time(e),
            "passes": int(buf[4]),
            "cycles_per_pass": {
                name: buf[i] / passes
                for i, name in enumerate(("phase1", "phase2", "phase3", "tail"))
            },
        }
    return out


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


def main(argv) -> int:
    _need_cuda()
    what = argv[1] if len(argv) > 1 else "k1"
    if what == "k1":
        res = profile_k1()
    elif what == "stream":
        res = profile_stream()
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
