"""Structured cluster events (reference: the RAY_EVENT framework —
src/ray/util/event.cc writing severity-leveled JSON event records that the
dashboard aggregates; python/ray/_private/event/event_logger.py).

One process-wide bounded ring plus an optional JSONL file sink. Control
plane components record lifecycle transitions (node up/dead, actor
restart, PG state, job submit); the dashboard head serves the ring at
/api/events, and the GCS snapshots carry no events (they are telemetry,
not state).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")

_MAX_EVENTS = 10_000
_events: "deque" = deque(maxlen=_MAX_EVENTS)
_lock = threading.Lock()
# JSONL sink: RAY_TPU_EVENT_LOG=<path> (reference: the event framework's
# per-session event_*.log files), or configure_sink() programmatically
_sink_path: Optional[str] = os.environ.get("RAY_TPU_EVENT_LOG") or None
# sink paths that already produced a write-failure warning: one warning
# per path, not one per event (a bad path would otherwise either spam
# stderr at event rate or — as before — swallow every failure silently)
_sink_warned: set = set()


def configure_sink(path: Optional[str]) -> None:
    """Also append events as JSON lines to `path` (None disables)."""
    global _sink_path
    _sink_path = path
    if path is not None:
        _sink_warned.discard(path)  # a reconfigured sink may warn again


def record_event(
    label: str,
    message: str = "",
    severity: str = "INFO",
    source: str = "",
    **fields: Any,
) -> Dict[str, Any]:
    """Record one structured event; returns the record."""
    if severity not in SEVERITIES:
        severity = "INFO"
    ev = {
        "timestamp": time.time(),
        "severity": severity,
        "label": label,
        "message": message,
        "source": source or "ray_tpu",
        "pid": os.getpid(),
        **fields,
    }
    with _lock:
        _events.append(ev)
        path = _sink_path
    if path:
        try:
            with open(path, "a") as f:
                f.write(json.dumps(ev, default=str) + "\n")
        except OSError as e:
            # warn ONCE per sink path — telemetry loss must be visible,
            # but a misconfigured path must not print per event (and must
            # never break the recording caller)
            with _lock:
                warn = path not in _sink_warned
                _sink_warned.add(path)
            if warn:
                import sys

                print(
                    f"[ray_tpu] event sink {path!r} unwritable ({e}); "
                    "events keep recording to the in-memory ring",
                    file=sys.stderr,
                )
    return ev


def list_events(
    limit: int = 1000,
    severity: Optional[str] = None,
    label: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Most-recent-first view of the ring, optionally filtered."""
    with _lock:
        evs = list(_events)
    evs.reverse()
    if severity:
        evs = [e for e in evs if e["severity"] == severity]
    if label:
        evs = [e for e in evs if e["label"] == label]
    return evs[:limit]


def clear_events() -> None:
    with _lock:
        _events.clear()
