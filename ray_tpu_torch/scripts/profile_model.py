"""Where the flagship transformer's forward, or the expert layer, spends its
time on the card.

    python -m ray_tpu_torch.scripts.profile_model [--batch 8] [--seq 2048] [--steps 5]
    python -m ray_tpu_torch.scripts.profile_model --moe [--batch 8] [--seq 2048] [--steps 20]

Default: make_forward_step at the default TransformerConfig (bf16, weights
from a numpy seed). --moe: moe_ffn at MoEConfig() (d_model 256, 8 experts,
bf16) on x [batch, seq, 256] bf16 skewed toward expert 0, as chip_smoke.py
phase 7b runs it. Prints one JSON line: the card's name and power limit,
the step's device ms (CUDA events, median) and host ms, and, from
torch.profiler over `steps` steps, the device busy share of the window
and the device ms a step by kernel, the port's kernels (K8, K9a-c, K10a,
K10b) named as such; with --moe also by kind (the port's kernels, the
cuBLAS products, GELU, casts and copies). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# the port's kernels by their CUDA symbol
_OURS = {"attention_kernel": "K8", "rmsnorm_kernel": "K10a", "rope_split_kernel": "K10b",
         "route_kernel": "K9a", "dispatch_kernel": "K9b", "combine_kernel": "K9c"}


def _label(name: str) -> str:
    for sym, k in _OURS.items():
        if sym in name:
            return f"{k} {sym}"
    return name


def _kind(label: str) -> str:
    """The kind of a device kernel, by its label."""
    low = label.lower()
    if label[:2] in ("K8", "K9", "K1"):
        return label.split()[0]
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "cuBLAS products"
    if "gelu" in low:
        return "GELU"
    if any(k in low for k in ("copy", "cast", "convert")):
        return "casts and copies"
    return "other"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def _profile(step, steps: int) -> dict:
    """Device ms of step() (CUDA events, median), host ms a step, and the
    device ms a step by kernel over `steps` steps under torch.profiler."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        step()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA") and dev_us > 0:
            by_kernel[_label(evt.key)] = by_kernel.get(_label(evt.key), 0.0) + dev_us / 1e3
    busy_ms = sum(by_kernel.values())
    return {"card": _card(), "step_ms_median": float(np.median(times)),
            "host_ms_per_step": host_ms, "profiled_window_ms": window_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / window_ms if window_ms else None,
            "by_kernel": {k: v / steps for k, v in by_kernel.items()}}


def profile_forward(batch: int = 8, seq: int = 2048, steps: int = 5) -> dict:
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_forward_step

    cfg = PT.TransformerConfig()
    model = PT.params_from_numpy(PT.numpy_params(cfg, 0), cfg)
    fwd = make_forward_step(cfg)
    tokens = np.random.default_rng(60).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tok = torch.from_numpy(tokens).to(model.device)
    r = _profile(lambda: fwd(model, tok), steps)
    top = sorted(r.pop("by_kernel").items(), key=lambda kv: -kv[1])[:15]
    return {"card": r["card"], "batch": batch, "seq": seq,
            "forward_ms_median": r["step_ms_median"],
            "tokens_per_s": batch * seq / (r["step_ms_median"] / 1e3),
            "host_ms_per_forward": r["host_ms_per_step"],
            "profiled_window_ms": r["profiled_window_ms"],
            "device_busy_ms": r["device_busy_ms"],
            "device_busy_share": r["device_busy_share"],
            "device_ms_per_forward_by_kernel": dict(top)}


def profile_moe(batch: int = 8, seq: int = 2048, steps: int = 20) -> dict:
    from ray_tpu_torch.models import moe as PM

    cfg = PM.MoEConfig()
    tree = PM.numpy_moe_params(cfg, 0)
    layer = PM.moe_params_from_numpy(tree, cfg)
    x = torch.from_numpy(PM.numpy_moe_inputs(tree, (batch, seq, cfg.d_model), 70)) \
        .to(layer.device, torch.bfloat16)
    r = _profile(lambda: PM.moe_ffn(layer, x), steps)
    by_kernel = r.pop("by_kernel")
    by_kind = {}
    for label, ms in by_kernel.items():
        by_kind[_kind(label)] = by_kind.get(_kind(label), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {"card": r["card"], "shape": [batch, seq, cfg.d_model],
            "moe_ms_median": r["step_ms_median"],
            "tokens_per_s": batch * seq / (r["step_ms_median"] / 1e3),
            "host_ms_per_call": r["host_ms_per_step"],
            "tokens_per_s_host": batch * seq / (r["host_ms_per_step"] / 1e3),
            "profiled_window_ms": r["profiled_window_ms"],
            "device_busy_ms": r["device_busy_ms"],
            "device_busy_share": r["device_busy_share"],
            "device_ms_per_call_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "device_ms_per_call_by_kernel": dict(top)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--moe", action="store_true", help="profile the expert layer")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_model: needs a CUDA device", file=sys.stderr)
        return 2
    if args.moe:
        out = profile_moe(args.batch, args.seq, args.steps or 20)
    else:
        out = profile_forward(args.batch, args.seq, args.steps or 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
