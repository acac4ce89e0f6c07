"""Always-on flight recorder: a bounded in-memory ring of control-plane
protocol events, dumped as a ProtocolTracer-compatible JSONL "black box"
when something goes wrong.

The :class:`ProtocolTracer` (analysis/invariants.py) is opt-in and
file-backed — exactly right for CI soaks, wrong for production: nobody
re-runs a flake with tracing on. The recorder duck-types the tracer's
interface (``on_send``/``on_recv``/``on_push``/``apply``/``merge_clock``)
and installs as the default ``rpc.TRACE``, so EVERY existing
instrumentation site (frame sends/recvs, pushes, GCS/daemon/client apply
events, dag channel clock words) feeds it with zero new hot-path code.
Per event it pays one lock + one tuple append into a ``deque(maxlen=cap)``
— no dict building beyond what callers already allocate, no JSON until a
dump — cheap enough to leave ON by default (gated by config
``flight_recorder_enabled``; ``bench.py obs_overhead`` holds the compiled
dag loop to <3% overhead with it running).

Dumps land in ``$RAY_TPU_FLIGHTREC_DIR`` (default ``artifacts/``) as
``flightrec-<pid>-<reason>-<n>.jsonl`` in the exact format
``python -m ray_tpu.analysis --check-trace`` accepts, so every crash dump
can be replayed through the offline invariant checker. Trigger surfaces:
unhandled rpc-handler crashes (``rpc.flight_dump``), scheduler-loop
crashes, invariant-sanitizer violations (tests/conftest.py), and
chaos-soak errors (scripts/chaos_soak.py).

When a real file-backed tracer is installed (``invariants.install``), the
recorder steps aside and is restored on ``uninstall`` — the two share the
single ``rpc.TRACE`` hook.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

ENV_DIR = "RAY_TPU_FLIGHTREC_DIR"


class FlightRecorder:
    """Tracer-compatible bounded ring (see module docstring)."""

    is_flight_recorder = True

    def __init__(self, cap: int = 4096, out_dir: Optional[str] = None):
        self.cap = int(cap)
        self._ring: deque = deque(maxlen=self.cap)
        self._lock = threading.Lock()
        self._clock = 0
        self._pid = os.getpid()
        self._last_dump = 0.0
        self._dump_seq = 0
        self.out_dir = out_dir or os.environ.get(ENV_DIR, "artifacts")
        self.closed = False

    # ------------------------------------------------ tracer interface

    def on_send(self, src: str, dst: str, method: Optional[str]) -> int:
        with self._lock:
            self._clock += 1
            self._ring.append(("send", self._clock, src, dst, method))
            return self._clock

    def on_recv(self, src: str, dst: str, method: Optional[str],
                remote_clock: Optional[int]) -> None:
        with self._lock:
            if remote_clock is not None and remote_clock > self._clock:
                self._clock = int(remote_clock)
            self._clock += 1
            self._ring.append(("recv", self._clock, src, dst, method))

    def on_push(self, src: str, dst: str, channel: Optional[str]) -> None:
        with self._lock:
            self._clock += 1
            self._ring.append(("push", self._clock, src, dst, channel))

    def apply(self, kind: str, **fields: Any) -> int:
        with self._lock:
            self._clock += 1
            self._ring.append(("apply", self._clock, kind, fields))
            return self._clock

    def merge_clock(self, remote_clock: Optional[int]) -> None:
        if not remote_clock:
            return
        with self._lock:
            if remote_clock > self._clock:
                self._clock = int(remote_clock)

    def close(self) -> None:
        self.closed = True

    # ------------------------------------------------------- dumping

    def snapshot(self) -> List[tuple]:
        with self._lock:
            return list(self._ring)

    def to_events(self) -> List[Dict[str, Any]]:
        """Ring contents as ProtocolTracer-format event dicts (the shape
        ``invariants.read_trace`` parses)."""
        out: List[Dict[str, Any]] = []
        for rec in self.snapshot():
            t = rec[0]
            if t == "apply":
                ev: Dict[str, Any] = {"t": "apply", "k": rec[2]}
                ev.update(rec[3])
            elif t == "push":
                ev = {"t": "push", "src": rec[2], "dst": rec[3], "ch": rec[4]}
            else:  # send / recv
                ev = {"t": t, "src": rec[2], "dst": rec[3], "m": rec[4]}
            ev["c"] = rec[1]
            ev["pid"] = self._pid
            out.append(ev)
        return out

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write the ring as check-trace-compatible JSONL; returns the
        path. The ring keeps recording — a dump is a copy, not a drain."""
        if path is None:
            os.makedirs(self.out_dir, exist_ok=True)
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = os.path.join(
                self.out_dir,
                f"flightrec-{self._pid}-{reason}-{seq}.jsonl",
            )
        else:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for ev in self.to_events():
                f.write(json.dumps(ev, default=str) + "\n")
        return path

    def maybe_dump(self, reason: str,
                   min_interval_s: float = 5.0) -> Optional[str]:
        """Rate-limited crash dump: at most one per ``min_interval_s`` per
        process, so a crash loop cannot flood the artifacts dir."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < min_interval_s:
                return None
            self._last_dump = now
        return self.dump(reason=reason)


# ------------------------------------------------------------ activation


def install_default(cap: Optional[int] = None) -> Optional[FlightRecorder]:
    """Install a process-wide recorder as ``rpc.TRACE`` unless a tracer is
    already active (env-file tracer wins). Called from cluster/rpc.py at
    import when ``flight_recorder_enabled``."""
    from ray_tpu_torch.cluster import rpc as _rpc

    if _rpc.TRACE is not None:
        return _rpc.TRACE if getattr(
            _rpc.TRACE, "is_flight_recorder", False) else None
    if cap is None:
        from ray_tpu_torch.core import config as _cfg

        cap = _cfg.GLOBAL_CONFIG.flight_recorder_cap
    rec = FlightRecorder(cap=cap)
    _rpc.TRACE = rec
    return rec


def get_recorder() -> Optional[FlightRecorder]:
    """The active flight recorder, or None (disabled, or displaced by a
    file-backed ProtocolTracer)."""
    from ray_tpu_torch.cluster import rpc as _rpc

    t = _rpc.TRACE
    return t if t is not None and getattr(
        t, "is_flight_recorder", False) else None


def dump_flight_recorder(reason: str = "manual",
                         path: Optional[str] = None) -> Optional[str]:
    """Dump the active recorder's ring (no-op when none is active)."""
    rec = get_recorder()
    if rec is None:
        return None
    return rec.dump(path=path, reason=reason)


def save_trace_tail(trace_path: str, reason: str, max_lines: int = 4096,
                    out_dir: Optional[str] = None) -> Optional[str]:
    """Black box for FILE-TRACED runs: while a ProtocolTracer owns the
    ``rpc.TRACE`` hook the displaced recorder's ring is empty, so the
    crash surfaces that run under tracing (the invariant-sanitizer
    fixture, chaos soaks) save the TAIL of the file trace into the same
    ``flightrec-*`` artifact location instead — same format, same
    bounded size, same ``--check-trace``-ability."""
    out_dir = out_dir or os.environ.get(ENV_DIR, "artifacts")
    try:
        with open(trace_path, "r", encoding="utf-8") as f:
            tail = deque(f, maxlen=max_lines)
    except OSError:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"flightrec-{os.getpid()}-{reason}-tail.jsonl"
    )
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(tail)
    return path
