"""State API: programmatic cluster introspection.

Reference: python/ray/util/state/ (api.py list_tasks/list_actors/... and
summary; served by the dashboard StateHead reading GCS task events —
src/ray/gcs/gcs_server/gcs_task_manager.cc).
"""

from ray_tpu_torch.util.state.api import (
    list_actors,
    list_cluster_events,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    summarize_tasks,
    summary,
)
from ray_tpu_torch.util.state.timeline import chrome_trace, dump_timeline

__all__ = [
    "chrome_trace",
    "dump_timeline",
    "list_actors",
    "list_cluster_events",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_tasks",
    "summarize_tasks",
    "summary",
]
