"""The ONE chrome://tracing ("trace event") renderer.

Both span producers — driver-side task spans (util/tracing.py) and the
cluster timeline (util/state/timeline.py) — used to hand-roll their own
event dicts and had drifted: the tracing spans carried no ``cat`` and no
minimum duration, the timeline rounded nothing, and their files only
merged by luck. Every complete ("X") event now goes through
:func:`complete_event`, so the two exports concatenate into one coherent
Perfetto view and the format is pinned by a golden test
(tests/test_obs.py::test_chrome_trace_golden_format).

Canonical event shape (Trace Event Format, "X" = complete event)::

    {"name": str, "cat": str, "ph": "X",
     "ts": float,   # start, MICROseconds, rounded to 0.001us
     "dur": float,  # duration, MICROseconds, >= 1.0 (zero-width events
                    # vanish in viewers)
     "pid": str|int,   # top-level lane (node / process)
     "tid": str|int,   # row within the lane
     "args": dict}
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def complete_event(name: str, start_s: float, end_s: float, *,
                   pid: Any, tid: Any, cat: str = "task",
                   args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render one complete ("X") event from wall-clock seconds."""
    return {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": round(start_s * 1e6, 3),
        "dur": max(round((end_s - start_s) * 1e6, 3), 1.0),
        "pid": pid,
        "tid": tid,
        "args": dict(args or {}),
    }


def write_trace(path: str, events: List[Dict[str, Any]]) -> str:
    """Write a JSON array of trace events (the top-level shape both
    chrome://tracing and Perfetto accept; files merge by list concat)."""
    with open(path, "w") as f:
        json.dump(events, f)
    return path
