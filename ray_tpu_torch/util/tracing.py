"""Tracing hookup: driver-side task spans.

Reference: python/ray/util/tracing/ (opt-in span wrappers around _remote
when RAY_TRACING_ENABLED). enable_task_spans() monkey-wraps
RemoteFunction.remote with span bookkeeping; spans land in an in-process
buffer exportable as chrome-trace JSON. (A torch.profiler counterpart of
the JAX package's device-profile capture is a later slice of the port.)
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
