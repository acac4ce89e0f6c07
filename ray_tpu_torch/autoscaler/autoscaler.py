"""Autoscaler: demand-driven node launch/termination.

Reference: python/ray/autoscaler/_private/autoscaler.py
(StandardAutoscaler.update) + resource_demand_scheduler.py
(ResourceDemandScheduler.get_nodes_to_launch / get_bin_pack_residual) and
the monitor process (monitor.py) polling demand from the GCS.

The launch decision is the scheduler's class placement: candidate nodes
of each type are appended as hypothetical rows to the cluster matrix and
one `kernel_np.schedule_classes` call, on the host, at spread threshold
1.0 (pure packing), reveals which candidates the pending demand actually
lands on (the vectorized analog of the reference's per-task bin-pack
residual loop). K1 (`sched.kernel_torch.schedule_classes`) gives the same
`assigned` on the same matrix at every threshold, so the decision could
move to the card unchanged; it stays on the host, as in ray_tpu. The
cluster's own rounds, as autoscaled nodes join and leave, run in the GCS's
policy (on the card by default).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.autoscaler.provider import NodeProvider
from ray_tpu_torch.cluster.rpc import RpcClient
from ray_tpu_torch.sched import kernel_np
from ray_tpu_torch.sched.resources import ResourceSpace


@dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


def get_nodes_to_launch(
    space: ResourceSpace,
    avail: np.ndarray,
    total: np.ndarray,
    alive: np.ndarray,
    demand_classes: List[dict],
    node_types: List[NodeTypeConfig],
    current_counts: Dict[str, int],
) -> Dict[str, int]:
    """Pure launch-decision function (unit-testable like the reference's
    ResourceDemandScheduler tests, SURVEY §4): hypothetical candidate rows +
    one kernel call -> per-type launch counts."""
    if not demand_classes:
        return {}
    demands = np.stack([space.vector(d["resources"]) for d in demand_classes])
    counts = np.array([int(d["count"]) for d in demand_classes], dtype=np.int32)

    candidates: List[tuple] = []  # (type_name,)
    cand_rows = []
    for nt in node_types:
        headroom = max(0, nt.max_workers - current_counts.get(nt.name, 0))
        # never need more candidates than pending tasks
        for _ in range(min(headroom, int(counts.sum()))):
            candidates.append(nt.name)
            cand_rows.append(space.vector(nt.resources))
    if not candidates:
        return {}

    hyp_avail = np.vstack([avail, np.stack(cand_rows)])
    hyp_total = np.vstack([total, np.stack(cand_rows)])
    hyp_alive = np.concatenate([alive, np.ones(len(candidates), bool)])
    # threshold 1.0 = pure packing: launches should be as few/full as
    # possible (the reference's bin-packing is utilization-greedy too),
    # unlike the runtime policy's pack-then-spread.
    assigned, _ = kernel_np.schedule_classes(
        hyp_avail, hyp_total, hyp_alive, demands, counts, spread_threshold=1.0
    )
    n_existing = avail.shape[0]
    launch: Dict[str, int] = {}
    used = assigned.sum(axis=0)  # tasks per hypothetical node
    for j, type_name in enumerate(candidates):
        if used[n_existing + j] > 0:
            launch[type_name] = launch.get(type_name, 0) + 1
    return launch


class Autoscaler:
    """Monitor loop against a running GCS (reference: monitor.py driving
    StandardAutoscaler.update)."""

    def __init__(
        self,
        gcs_addr,
        provider: NodeProvider,
        node_types: List[NodeTypeConfig],
        idle_timeout_s: float = 5.0,
        update_interval_s: float = 0.5,
        quarantine_replace_s: float = 30.0,
    ):
        self.gcs = RpcClient(gcs_addr[0], gcs_addr[1])
        self.provider = provider
        self.node_types = {nt.name: nt for nt in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.quarantine_replace_s = quarantine_replace_s
        self.space = ResourceSpace()
        self._idle_since: Dict[str, float] = {}
        self._launched: Dict[str, str] = {}  # node_id -> type (incl. still-starting)
        self._replaced: set = set()  # chronically-quarantined nodes already replaced
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="autoscaler"
        )

    def start(self):
        # satisfy min_workers up front
        for nt in self.node_types.values():
            for _ in range(nt.min_workers):
                self._create(nt)
        self._thread.start()
        return self

    def _create(self, nt: NodeTypeConfig):
        node_id = self.provider.create_node(nt.name, nt.resources)
        self._launched[node_id] = nt.name
        return node_id

    def _loop(self):
        while not self._stopped:
            try:
                self.update()
            except Exception:
                import traceback

                traceback.print_exc()
            time.sleep(self.update_interval_s)

    def update(self):
        state = self.gcs.call("autoscaler_state")
        self._replace_chronic(state)
        self._scale_up(state)
        self._scale_down(state)

    def _replace_chronic(self, state):
        """Replace-don't-wait for gray failures: a node the GCS has kept
        quarantined past ``quarantine_replace_s`` is treated like failed
        hardware — launch a same-type replacement immediately and
        terminate the sick node instead of waiting out probation."""
        if self.quarantine_replace_s <= 0:
            return
        managed = set(self.provider.non_terminated_nodes())
        self._replaced &= managed  # forget terminated nodes
        for node_id, n in state.get("nodes", {}).items():
            if node_id not in managed or not n.get("alive"):
                continue
            if not n.get("quarantined") or node_id in self._replaced or \
                    n.get("quarantined_for", 0.0) < self.quarantine_replace_s:
                continue
            self._replaced.add(node_id)
            t = n.get("labels", {}).get("node_type")
            nt = self.node_types.get(t)
            if nt is not None:
                self._create(nt)
            self.provider.terminate_node(node_id)
            self._idle_since.pop(node_id, None)

    def _scale_up(self, state):
        from ray_tpu_torch.autoscaler.instance_manager import pg_demand_classes

        demand = list(state.get("pending_demand", []))
        demand += pg_demand_classes(state.get("pending_pgs", []))
        if not demand:
            return
        # drop terminated launches from the in-flight record first
        provider_alive = set(self.provider.non_terminated_nodes())
        for nid in list(self._launched):
            if nid not in provider_alive:
                self._launched.pop(nid, None)
        nodes = state["nodes"]
        live = [n for n in nodes.values() if n["alive"]]
        # launched-but-unregistered nodes count as full capacity-in-flight so
        # their share of the demand doesn't trigger another launch
        starting = [
            self.space.vector(self.node_types[t].resources)
            for nid, t in self._launched.items()
            if (nid not in nodes or not nodes[nid]["alive"]) and t in self.node_types
        ]
        rows_a = [self.space.vector(n["available"]) for n in live] + starting
        rows_t = [self.space.vector(n["resources"]) for n in live] + starting
        if rows_a:
            avail = np.stack(rows_a)
            total = np.stack(rows_t)
            alive = np.ones(len(rows_a), bool)
        else:
            R = self.space.max_resources
            avail = np.zeros((0, R), np.float32)
            total = np.zeros((0, R), np.float32)
            alive = np.zeros((0,), bool)
        # count launched-but-not-yet-registered nodes too, else the same
        # demand re-launches every cycle until registration and blows past
        # max_workers (the reference tracks pending launches the same way)
        current_counts: Dict[str, int] = {}
        for t in self._launched.values():
            current_counts[t] = current_counts.get(t, 0) + 1
        for nid, n in state["nodes"].items():
            t = n.get("labels", {}).get("node_type")
            if t and n["alive"] and nid not in self._launched:
                current_counts[t] = current_counts.get(t, 0) + 1
        launch = get_nodes_to_launch(
            self.space, avail, total, alive, demand,
            list(self.node_types.values()), current_counts,
        )
        for type_name, k in launch.items():
            nt = self.node_types[type_name]
            for _ in range(k):
                self._create(nt)

    def _scale_down(self, state):
        now = time.time()
        managed = set(self.provider.non_terminated_nodes())
        counts: Dict[str, int] = {}
        for n in state["nodes"].values():
            t = n.get("labels", {}).get("node_type")
            if t and n["alive"]:
                counts[t] = counts.get(t, 0) + 1
        for node_id, n in state["nodes"].items():
            if node_id not in managed or not n["alive"]:
                self._idle_since.pop(node_id, None)
                continue
            # vector comparison with tolerance: the available dict is a
            # float32 round-trip of the registration dict, so exact dict
            # equality would never fire for non-float32-exact amounts
            free = self.space.vector(n["available"])
            cap = self.space.vector(n["resources"])
            idle = n.get("running", 0) == 0 and bool(
                np.all(np.abs(free - cap) <= 1e-3 * np.maximum(cap, 1.0))
            )
            if not idle:
                self._idle_since.pop(node_id, None)
                continue
            self._idle_since.setdefault(node_id, now)
            t = n.get("labels", {}).get("node_type")
            nt = self.node_types.get(t)
            if nt is None or counts.get(t, 0) <= nt.min_workers:
                continue
            if now - self._idle_since[node_id] > self.idle_timeout_s:
                counts[t] -= 1
                self._idle_since.pop(node_id, None)
                self.provider.terminate_node(node_id)

    def shutdown(self):
        self._stopped = True
        try:
            self.gcs.close()
        except Exception:
            pass
