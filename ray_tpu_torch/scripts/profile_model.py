"""Where the flagship transformer's forward, its train step, or the expert
layer spends its time on the card.

    python -m ray_tpu_torch.scripts.profile_model [--batch 8] [--seq 2048] [--steps 5]
    python -m ray_tpu_torch.scripts.profile_model --train [--batch 8] [--seq 2048] [--steps 3]
    python -m ray_tpu_torch.scripts.profile_model --moe [--batch 8] [--seq 2048] [--steps 20]
    python -m ray_tpu_torch.scripts.profile_model --moe --train [--steps 10]
    python -m ray_tpu_torch.scripts.profile_model --attention [--batch 8] [--seq 2048] [--steps 5]

Default: make_forward_step at the default TransformerConfig (bf16, weights
from a numpy seed). --train: make_train_step at the same config on one
seeded [batch, seq + 1] batch (make_train_state, seed 0), as chip_smoke.py
phase 9b runs it. --moe: moe_ffn at MoEConfig() (d_model 256, 8 experts,
bf16) on x [batch, seq, 256] bf16 skewed toward expert 0, as chip_smoke.py
phase 7b runs it. --moe --train: the expert layer's train step on the same
weights and tokens (x requiring a gradient), the loss of
tests/test_parallel.py::test_moe_grads_flow, its backward and AdamW (lr
3e-4, weight decay 0.01), as chip_smoke.py phase 10b runs it. Prints one
JSON line: the card's name and power limit, the step's device ms (CUDA
events, median) and host ms, and, from torch.profiler over `steps` steps,
the device busy share of the window and the device ms a step by kernel,
the port's kernels (K8, K8', K9a-c, K9a'-c', K10a, K10a', K10b, K10b';
K8 and K8' on the tensor cores marked "wgmma") named as such; with --moe and --train also by kind (the port's kernels,
the cuBLAS products, GELU, casts and copies). --attention: the tensor-core
K8 and K8' (attention_sm90.cu) at [batch, seq, 8, 64] causal bf16, built
with -DATTN_SM90_PROFILE: each kernel's clock64() cycles by phase (waiting
for TMA tiles, the first products, the elementwise softmax or dS work, the
second products, the block barrier), summed over its blocks as thread 0
sees them, and each phase's share of the kernel's cycles. Needs a CUDA
device.
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
# (backward kernels first: their names contain the forward's)
_OURS = {"attention_sm90_bwd_dq_kernel": "K8' launch 1 (wgmma)",
         "attention_sm90_bwd_dkv_kernel": "K8' launch 2 (wgmma)",
         "attention_sm90_fwd_kernel": "K8 (wgmma)",
         "attention_bwd_dq_kernel": "K8' launch 1", "attention_bwd_dkv_kernel": "K8' launch 2",
         "route_bwd_kernel": "K9a'", "dispatch_bwd_kernel": "K9b'",
         "combine_bwd_rows_kernel": "K9c' launch 1", "combine_bwd_gate_kernel": "K9c' launch 2",
         "rmsnorm_bwd_kernel": "K10a'", "rope_split_bwd_rows_kernel": "K10b' (rows)",
         "rope_split_bwd_kernel": "K10b' (scalar)",
         "rope_split_rows_kernel": "K10b (rows)", "rope_split_kernel": "K10b (scalar)",
         "attention_kernel": "K8", "rmsnorm_kernel": "K10a",
         "route_kernel": "K9a (a block a chunk)", "dispatch_kernel": "K9b", "combine_kernel": "K9c"}


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
    if any(k in low for k in ("softmax", "nll", "gather", "scatter", "index")):
        return "log-softmax, gather, scatter"
    if any(k in low for k in ("mul", "add", "div", "sqrt", "lerp", "foreach")):
        return "elementwise (residuals, AdamW)"
    return "other"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms_by_kernel(prof) -> dict:
    """The device ms of a finished torch.profiler window by kernel label."""
    by_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA") and dev_us > 0:
            by_kernel[_label(evt.key)] = by_kernel.get(_label(evt.key), 0.0) + dev_us / 1e3
    return by_kernel


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
    by_kernel = device_ms_by_kernel(prof)
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


def profile_train(batch: int = 8, seq: int = 2048, steps: int = 3) -> dict:
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_train_state, make_train_step

    cfg = PT.TransformerConfig()
    params, opt_state, tx, shardings = make_train_state(cfg, seed=0)
    step, _ = make_train_step(cfg, None, tx, shardings)
    tokens = np.random.default_rng(90).integers(0, cfg.vocab_size, (batch, seq + 1)) \
        .astype(np.int32)
    tok = torch.from_numpy(tokens).to(params.device)
    r = _profile(lambda: step(params, opt_state, {"tokens": tok}), steps)
    by_kernel = r.pop("by_kernel")
    by_kind = {}
    for label, ms in by_kernel.items():
        by_kind[_kind(label)] = by_kind.get(_kind(label), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]
    return {"card": r["card"], "batch": batch, "seq": seq,
            "step_ms_median": r["step_ms_median"],
            "tokens_per_s": batch * seq / (r["step_ms_median"] / 1e3),
            "host_ms_per_step": r["host_ms_per_step"],
            "profiled_window_ms": r["profiled_window_ms"],
            "device_busy_ms": r["device_busy_ms"],
            "device_busy_share": r["device_busy_share"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device_ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "device_ms_per_step_by_kernel": dict(top)}


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


def profile_moe_train(batch: int = 8, seq: int = 2048, steps: int = 10) -> dict:
    from ray_tpu_torch.models import moe as PM
    from ray_tpu_torch.parallel import make_optimizer

    cfg = PM.MoEConfig()
    tree = PM.numpy_moe_params(cfg, 0)
    layer = PM.moe_params_from_numpy(tree, cfg).requires_grad_(True)
    x = torch.from_numpy(PM.numpy_moe_inputs(tree, (batch, seq, cfg.d_model), 70)) \
        .to(layer.device, torch.bfloat16).requires_grad_(True)
    tx = make_optimizer(3e-4, 0.01)
    state = tx.init(layer)

    def step():
        layer.zero_grad(set_to_none=True)
        x.grad = None
        y, aux = PM.moe_ffn(layer, x)
        ((y.float() ** 2).mean() + 0.01 * aux).backward()
        tx.update(layer, state)

    r = _profile(step, steps)
    by_kernel = r.pop("by_kernel")
    by_kind = {}
    for label, ms in by_kernel.items():
        by_kind[_kind(label)] = by_kind.get(_kind(label), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]
    return {"card": r["card"], "shape": [batch, seq, cfg.d_model],
            "step_ms_median": r["step_ms_median"],
            "tokens_per_s": batch * seq / (r["step_ms_median"] / 1e3),
            "host_ms_per_step": r["host_ms_per_step"],
            "tokens_per_s_host": batch * seq / (r["host_ms_per_step"] / 1e3),
            "profiled_window_ms": r["profiled_window_ms"],
            "device_busy_ms": r["device_busy_ms"],
            "device_busy_share": r["device_busy_share"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device_ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "device_ms_per_step_by_kernel": dict(top)}


_PHASES = ("wait_tiles", "products_1", "elementwise", "products_2", "barrier", "whole")
_PROFILED = ("K8 forward", "K8' launch 1 (dQ)", "K8' launch 2 (dK, dV)")


def profile_attention(batch: int = 8, seq: int = 2048, steps: int = 5) -> dict:
    """K8's and K8''s cycles by phase, from a build of attention_sm90.cu with
    -DATTN_SM90_PROFILE whose entry points are called here directly (the
    wrappers and their counters keep the default build)."""
    import ctypes
    import math

    from ray_tpu_torch.models import kernels as K
    from ray_tpu_torch.util import cuda_build

    sigs = dict(K._SIGNATURES_SM90)
    sigs["attention_sm90_profile"] = ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int)
    dll = cuda_build.CudaLibrary("attention_sm90_profile", K._SRC_SM90,
                                 K.NVCC_FLAGS + ("-DATTN_SM90_PROFILE",), sigs).load()
    g = torch.Generator().manual_seed(6)
    H, Dh = 8, 64
    q, k, v, do = (torch.randn((batch, seq, H, Dh), generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    m, l, dsum = (torch.empty((batch, H, seq), dtype=torch.float32, device="cuda")
                  for _ in range(3))
    shape = (batch, seq, seq, H, Dh, 1, 1.0 / math.sqrt(Dh),
             torch.cuda.current_stream().cuda_stream)

    def step():  # the arguments attention / attention_bwd pass, causal
        rc = dll.attention_sm90_forward(*(t.data_ptr() for t in (q, k, v, out, m, l)), *shape)
        K._check(dll, rc, "attention", "attention_sm90_error_string")
        rc = dll.attention_sm90_backward(
            *(t.data_ptr() for t in (q, k, v, do, m, l, dsum, dq, dk, dv)), *shape)
        K._check(dll, rc, "attention_bwd", "attention_sm90_error_string")

    step()
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * (3 * len(_PHASES)))()
    if dll.attention_sm90_profile(ctypes.addressof(sums), 1):  # warm-up's counts dropped
        raise RuntimeError("attention_sm90_profile failed")
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    if dll.attention_sm90_profile(ctypes.addressof(sums), 1):
        raise RuntimeError("attention_sm90_profile failed")
    res = {"card": _card(), "shape": [batch, seq, H, Dh], "steps": steps}
    for i, kernel in enumerate(_PROFILED):
        cyc = {ph: sums[i * len(_PHASES) + j] / steps for j, ph in enumerate(_PHASES)}
        whole = cyc["whole"] or 1
        res[kernel] = {"cycles_per_call": cyc,
                       "share_of_whole": {ph: cyc[ph] / whole for ph in _PHASES[:-1]}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--moe", action="store_true", help="profile the expert layer")
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--attention", action="store_true",
                    help="K8 and K8' on the tensor cores, cycles by phase")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_model: needs a CUDA device", file=sys.stderr)
        return 2
    if args.attention:
        out = profile_attention(args.batch, args.seq, args.steps or 5)
    elif args.moe and args.train:
        out = profile_moe_train(args.batch, args.seq, args.steps or 10)
    elif args.moe:
        out = profile_moe(args.batch, args.seq, args.steps or 20)
    elif args.train:
        out = profile_train(args.batch, args.seq, args.steps or 3)
    else:
        out = profile_forward(args.batch, args.seq, args.steps or 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
