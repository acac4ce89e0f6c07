"""Chrome-trace timeline export.

Reference: `ray timeline` (python/ray/scripts/scripts.py timeline command)
— task events rendered in the chrome://tracing / Perfetto "trace events"
JSON format, one row per node/actor lane. Event rendering goes through
the shared renderer in util/chrome_trace.py (the same one driver-side
spans use), so `timeline` output and `export_chrome_trace` files
concatenate into a single coherent view.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.core import api as _api
from ray_tpu_torch.util.chrome_trace import complete_event, write_trace


def chrome_trace(events: Optional[List[dict]] = None) -> List[dict]:
    """Convert task events to Chrome trace 'X' (complete) events."""
    if events is None:
        events = _api._get_runtime().timeline()
    trace = []
    for e in events:
        start = e.get("start")
        end = e.get("end")
        if start is None or end is None:
            continue
        # compiled-DAG iteration spans (gcs rpc_dag_spans) carry a "stage"
        # lane so the hot loop renders as per-stage occupancy rows instead
        # of disappearing into one "tasks" lane
        lane = (e.get("actor_id") or e.get("stage") or e.get("worker_id")
                or "tasks")
        trace.append(complete_event(
            e.get("name") or e.get("task_id", "task"), start, end,
            pid=e.get("node") or e.get("node_id") or "node",
            tid=lane,
            cat="dag_stage" if e.get("stage")
            else "actor_task" if e.get("actor_id") else "task",
            args={"task_id": e.get("task_id"), "status": e.get("status")},
        ))
    return trace


def dump_timeline(path: str, events: Optional[List[dict]] = None) -> str:
    return write_trace(path, chrome_trace(events))
