"""State listing functions (reference: python/ray/util/state/api.py)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core import api as _api


def _rt():
    return _api._get_runtime()


def list_tasks(limit: int = 1000, filters: Optional[Dict] = None) -> List[dict]:
    tasks = _rt().list_tasks(limit)
    if filters:
        tasks = [
            t for t in tasks
            if all(t.get(k) == v for k, v in filters.items())
        ]
    return tasks


def list_actors() -> List[dict]:
    return _rt().list_actors()


def list_nodes() -> List[dict]:
    return _rt().nodes()


def list_objects(limit: int = 1000) -> List[dict]:
    return _rt().list_objects(limit)


def list_placement_groups() -> List[dict]:
    return _rt().list_placement_groups()


def list_cluster_events(
    limit: int = 1000, severity: Optional[str] = None,
    label: Optional[str] = None,
) -> List[dict]:
    """Structured cluster events (reference: `ray list cluster-events`).
    Cluster mode pulls the GCS process's ring over rpc; local mode reads
    the in-process ring directly."""
    rt = _rt()
    gcs = getattr(rt, "gcs", None)
    if gcs is not None:
        # no silent local fallback here: in cluster mode the local ring is
        # empty, so masking an RPC failure would present as "no events"
        return gcs.call(
            "list_events",
            {"limit": limit, "severity": severity, "label": label},
        )["events"]
    from ray_tpu_torch.util.events import list_events

    return list_events(limit=limit, severity=severity, label=label)


def summary() -> dict:
    return _rt().summary()


def summarize_tasks() -> Dict[str, dict]:
    """Per-task-name counts by status (reference: `ray summary tasks`).
    Served from the runtime's incremental aggregates — exact over the full
    history even past the in-memory event window."""
    return _rt().summarize_tasks()["by_name"]
