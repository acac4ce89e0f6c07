"""Tracing hookup: driver-side task spans.

Reference: python/ray/util/tracing/ (opt-in span wrappers around _remote
when RAY_TRACING_ENABLED). enable_task_spans() monkey-wraps
RemoteFunction.remote with span bookkeeping; spans land in an in-process
buffer exportable as chrome-trace JSON. profile_device is the
torch.profiler counterpart of the JAX package's device-profile capture.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

# bounded ring: long-running traced drivers must not grow without limit
_MAX_SPANS = 100_000
from collections import deque  # noqa: E402

_spans: "deque" = deque(maxlen=_MAX_SPANS)
_lock = threading.Lock()
_installed = False

#: per-operation RPC profiler seam (analysis/rpcflow.RpcProfiler installs
#: itself here). Same zero-overhead discipline as rpc.TRACE: driver entry
#: points guard with a module-global `is None` check, so the hot paths
#: (dag execute, serve fast-path submit) pay one attribute load when off.
PROFILE = None


@contextlib.contextmanager
def op_span(name: str):
    """Profiler operation span for driver entry points. No-op (one global
    load) when no profiler is installed; hot loops that can't afford the
    generator frame use the explicit `PROFILE is None` guard instead."""
    p = PROFILE
    if p is None:
        yield
        return
    frame = p.op_begin(name)
    try:
        yield
    finally:
        p.op_end(frame)


def tracing_enabled() -> bool:
    return os.environ.get("RAY_TPU_TRACING_ENABLED", "0").lower() in (
        "1", "true", "yes", "on"
    )


def record_span(name: str, start: float, end: float, **meta) -> None:
    from ray_tpu_torch.util.chrome_trace import complete_event

    with _lock:
        _spans.append(complete_event(
            name, start, end, pid=os.getpid(),
            tid=threading.get_ident() % 1_000_000, cat="driver", args=meta,
        ))


def get_spans() -> List[Dict[str, Any]]:
    with _lock:
        return list(_spans)


def clear_spans() -> None:
    with _lock:
        _spans.clear()


def export_chrome_trace(path: str) -> str:
    """Write collected spans as a chrome://tracing JSON array — the SAME
    renderer `ray_tpu timeline` uses (util/chrome_trace.py), so the two
    files merge by list concatenation into one coherent view."""
    from ray_tpu_torch.util.chrome_trace import write_trace

    return write_trace(path, get_spans())


def enable_task_spans() -> None:
    """Wrap RemoteFunction.remote with submit spans (idempotent).
    Reference: the _remote monkey-wrap in python/ray/util/tracing/."""
    global _installed
    if _installed:
        return
    from ray_tpu_torch.core import api

    orig = api.RemoteFunction.remote

    def traced(self, *args, **kwargs):
        t0 = time.time()
        out = orig(self, *args, **kwargs)
        record_span(
            f"submit:{getattr(self._func, '__name__', 'task')}",
            t0, time.time(),
        )
        return out

    api.RemoteFunction.remote = traced
    _installed = True


@contextlib.contextmanager
def span(name: str, **meta):
    """User-facing span context manager."""
    t0 = time.time()
    try:
        yield
    finally:
        record_span(name, t0, time.time(), **meta)


#: each launch counter of the port's kernel wrappers and the CUDA kernels
#: (symbols) one of its launches runs (K2 and K3 run alone or in K1's launch)
_COUNTER_KERNELS = {
    "schedule_classes": ("schedule_classes_kernel",),
    "schedule_classes_sharded": ("schedule_classes_kernel",),
    "rank_pass": ("k7r_kernel",),
    "scatter_rows": ("refresh_view_kernel", "schedule_classes_kernel"),
    "delta_clip": ("refresh_view_kernel", "schedule_classes_kernel"),
    "scatter_rows_fused": ("schedule_classes_kernel",),
    "delta_clip_fused": ("schedule_classes_kernel",),
    "compact_nonzero": ("compact_nonzero_kernel",),
    "schedule_classes_rounds": ("rounds_caps_kernel", "rounds_prefix_kernel",
                                "rounds_trim_kernel"),
    "schedule_classes_chunked": ("schedule_rounds_kernel",),
    "attention": ("attention_sm90_fwd_kernel", "attention_kernel"),
    "block_update": ("attention_sm90_block_kernel", "attention_kernel"),
    "rmsnorm": ("rmsnorm_kernel",),
    "rope_split": ("rope_split_kernel", "rope_split_rows_kernel"),
    "attention_bwd": ("attention_sm90_bwd_dq_kernel", "attention_sm90_bwd_dkv_kernel",
                      "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel"),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel",),
    "rope_split_bwd": ("rope_split_bwd_kernel", "rope_split_bwd_rows_kernel"),
    "moe_route": ("route_kernel",),
    "moe_dispatch": ("dispatch_kernel",),
    "moe_combine": ("combine_kernel",),
    "moe_route_bwd": ("route_bwd_kernel",),
    "moe_dispatch_bwd": ("dispatch_bwd_kernel",),
    "moe_combine_bwd": ("combine_bwd_fused_kernel", "combine_bwd_rows_kernel",
                        "combine_bwd_gate_kernel"),
}


def launch_counts() -> Dict[str, int]:
    """Every launch counter of the port's kernel wrappers, by kernel name."""
    from ray_tpu_torch.models import kernels, moe_kernels
    from ray_tpu_torch.sched import kernel_shard, kernel_torch

    out: Dict[str, int] = {}
    for mod in (kernel_torch, kernel_shard, kernels, moe_kernels):
        out.update(mod.launch_counts())
    return out


class LostDeviceRecordsError(RuntimeError):
    """profile_device's window launched kernels of the port that its trace
    holds no device record of."""


def device_records_missing(moved: Dict[str, int], kernel_names: List[str]) -> Dict[str, int]:
    """The counters in `moved` (name -> launches in the window) none of
    whose CUDA kernels has a record among `kernel_names`."""
    import re

    missing = {}
    for name, n in moved.items():
        symbols = _COUNTER_KERNELS.get(name, (name,))
        if not any(re.search(rf"\b{sym}\b", k) for sym in symbols for k in kernel_names):
            missing[name] = n
    return missing


@contextlib.contextmanager
def profile_device(logdir: str):
    """Capture a device profile with torch.profiler (the counterpart of the
    JAX package's ``jax.profiler`` trace): ``with profile_device(d):`` runs
    the block under a session of CPU and, with a card, CUDA activities, and
    writes a Chrome trace to ``d/trace_<pid>_<n>.json`` (chrome://tracing,
    Perfetto); it yields `logdir`.

    torch.profiler can lose the device records of a window, in a process
    that has gone a while without a session. So the port's launch counters
    (``launch_counts``) are read before and after the block: if a kernel
    of the port launched in the window and the trace holds no record of
    any of its CUDA kernels, it raises LostDeviceRecordsError with the
    numbers, after writing the trace; it never hands back a partial trace
    quietly."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = launch_counts()
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    after = launch_counts()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    missing = device_records_missing(moved, names)
    if missing:
        raise LostDeviceRecordsError(
            f"profile_device: the port launched {missing} in the window, and the trace "
            f"{path} holds no device record of them ({len(names)} device records in all; "
            f"launches in the window {moved})")
