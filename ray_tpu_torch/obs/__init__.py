"""ray_tpu.obs — the cluster observability plane.

Three connected layers (see README "Observability"):

1. **Metrics pipeline** (util/metrics.py): instrumented control-plane hot
   paths feed per-process Counter/Gauge/Histogram registries; deltas ride
   worker→daemon pushes and the daemon→GCS heartbeat into a cluster-wide
   :class:`~ray_tpu.util.metrics.MetricsAggregator`, served at
   ``/metrics`` + ``/api/metrics`` on the dashboard head and by the
   ``ray_tpu metrics`` CLI.
2. **RPC time attribution**: every GCS/daemon ``rpc_*`` handler is timed
   into a per-method histogram; :func:`rank_handler_time` (the engine of
   ``ray_tpu metrics --top``) ranks where control-plane CPU goes.
3. **Flight recorder** (:mod:`ray_tpu.obs.flightrec`): an always-on
   bounded ring of protocol events dumped on crash surfaces in
   ``--check-trace`` format — every flake comes with a black box.
"""

from __future__ import annotations

from typing import Dict, List

from ray_tpu_torch.obs.flightrec import (  # noqa: F401
    FlightRecorder,
    dump_flight_recorder,
    get_recorder,
    install_default,
    save_trace_tail,
)


def rank_handler_time(agg_json: Dict[str, dict], limit: int = 20) -> List[dict]:
    """Rank rpc-handler self-time from a ``MetricsAggregator.to_json()``
    aggregate: one row per (surface, method[, node]) histogram series,
    sorted by total handler seconds — the direct answer to "where do the
    per-task GCS and daemon milliseconds go"."""
    rows: List[dict] = []
    for name, m in (agg_json or {}).items():
        if m.get("kind") != "histogram" or not name.endswith("_rpc_handler_s"):
            continue
        surface = "gcs" if "_gcs_" in name else "daemon"
        for s in m.get("series", ()):
            tags = s.get("tags", {})
            count = int(s.get("count", 0))
            total = float(s.get("sum", 0.0))
            rows.append({
                "surface": surface,
                "method": tags.get("method", "?"),
                "node": tags.get("node", ""),
                "calls": count,
                "total_s": round(total, 6),
                "mean_us": round(total / count * 1e6, 1) if count else 0.0,
            })
    rows.sort(key=lambda r: -r["total_s"])
    return rows[:limit]
