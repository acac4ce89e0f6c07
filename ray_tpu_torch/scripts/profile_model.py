"""Where the flagship transformer's forward spends its time on the card.

    python -m ray_tpu_torch.scripts.profile_model [--batch 8] [--seq 2048] [--steps 5]

Runs make_forward_step at the default TransformerConfig (bf16, weights
from a numpy seed) and prints one JSON line: the card's name and power
limit, the forward's device ms (CUDA events, median), and, from
torch.profiler over `steps` forwards, the device busy share of the window
and the device ms a forward by kernel, the port's kernels (K8, K10a,
K10b) named as such. Needs a CUDA device.
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
_OURS = {"attention_kernel": "K8", "rmsnorm_kernel": "K10a", "rope_split_kernel": "K10b"}


def _label(name: str) -> str:
    for sym, k in _OURS.items():
        if sym in name:
            return f"{k} {sym}"
    return name


def profile_forward(batch: int = 8, seq: int = 2048, steps: int = 5) -> dict:
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_forward_step

    cfg = PT.TransformerConfig()
    model = PT.params_from_numpy(PT.numpy_params(cfg, 0), cfg)
    fwd = make_forward_step(cfg)
    tokens = np.random.default_rng(60).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tok = torch.from_numpy(tokens).to(model.device)
    for _ in range(2):
        fwd(model, tok)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fwd(model, tok)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd(model, tok)
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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    return {
        "card": card, "batch": batch, "seq": seq,
        "forward_ms_median": float(np.median(times)),
        "tokens_per_s": batch * seq / (float(np.median(times)) / 1e3),
        "profiled_window_ms": window_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / window_ms if window_ms else None,
        "device_ms_per_forward_by_kernel": {k: v / steps for k, v in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_model: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(profile_forward(args.batch, args.seq, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
