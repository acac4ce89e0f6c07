"""Vectorized resource model: struct-of-arrays cluster resource views.

Reference equivalents:
- NodeResources / ResourceRequest: src/ray/common/scheduling/cluster_resource_data.h
- string->int resource-ID interning: src/ray/common/scheduling/scheduling_ids.h

The reference stores per-node resource maps and iterates them per scheduling
decision. Here the cluster view is a pair of float32 matrices
``total[N, R]`` / ``available[N, R]`` with resource names interned to fixed
column indices, so feasibility and scoring are elementwise array ops that lower
to the TPU VPU/MXU without reshapes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

# Predefined resource columns, mirroring the reference's PredefinedResources
# enum (src/ray/common/scheduling/scheduling_ids.h: CPU/MEM/GPU/OBJECT_STORE_MEM).
# "TPU" is first-class here, where the reference models accelerators as "GPU"
# plus accelerator-type custom resources.
PREDEFINED_RESOURCES: tuple = ("CPU", "GPU", "TPU", "memory", "object_store_memory")

# Feasibility tolerance: resource quantities in the reference are fixed-point
# (FixedPoint, 1e-4 granularity); we use float32 + epsilon.
EPS = 1e-4


class ResourceSpace:
    """Interns resource names to column indices in a fixed-width float32 space.

    The width is padded up front (default 16 columns) so adding a custom
    resource never changes array shapes under jit — mirroring the reference's
    int-interned resource IDs (scheduling_ids.h) but with a static bound, which
    is what XLA needs for stable compiled shapes.
    """

    def __init__(self, max_resources: int = 16):
        if max_resources < len(PREDEFINED_RESOURCES):
            raise ValueError("max_resources must cover predefined resources")
        self.max_resources = max_resources
        self._name_to_idx: Dict[str, int] = {
            name: i for i, name in enumerate(PREDEFINED_RESOURCES)
        }
        self._idx_to_name: List[str] = list(PREDEFINED_RESOURCES)
        self._lock = threading.Lock()

    @property
    def names(self) -> List[str]:
        return list(self._idx_to_name)

    def intern(self, name: str) -> int:
        with self._lock:
            idx = self._name_to_idx.get(name)
            if idx is None:
                idx = len(self._idx_to_name)
                if idx >= self.max_resources:
                    raise ValueError(
                        f"resource space exhausted ({self.max_resources} columns); "
                        f"raise max_resources"
                    )
                self._name_to_idx[name] = idx
                self._idx_to_name.append(name)
            return idx

    def index(self, name: str) -> Optional[int]:
        return self._name_to_idx.get(name)

    def vector(self, resources: Mapping[str, float]) -> np.ndarray:
        """Pack a {name: amount} map into a padded float32 demand vector."""
        v = np.zeros(self.max_resources, dtype=np.float32)
        for name, amount in resources.items():
            if amount == 0:
                continue
            v[self.intern(name)] = float(amount)
        return v

    def unvector(self, vec: np.ndarray) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for i, val in enumerate(np.asarray(vec)):
            if val != 0 and i < len(self._idx_to_name):
                out[self._idx_to_name[i]] = float(val)
        return out


def pack_demands(
    space: ResourceSpace, demands: Sequence[Mapping[str, float]]
) -> np.ndarray:
    """Pack a list of per-task resource maps into a [T, R] demand matrix."""
    out = np.zeros((len(demands), space.max_resources), dtype=np.float32)
    for t, d in enumerate(demands):
        out[t] = space.vector(d)
    return out


@dataclass
class NodeResourceState:
    """Mutable cluster resource view: the scheduler's input matrices.

    Reference: ClusterResourceManager's map of NodeResources
    (src/ray/raylet/scheduling/cluster_resource_manager.cc), flattened to
    struct-of-arrays. Row order is stable; node 0 is conventionally the local
    node so "prefer local" tiebreaks fall out of stable argmin.
    """

    space: ResourceSpace
    node_ids: List[str] = field(default_factory=list)
    total: np.ndarray = None  # [N, R] float32
    available: np.ndarray = None  # [N, R] float32
    alive: np.ndarray = None  # [N] bool
    # [N] bool: live daemons marked unschedulable (graceful drain). A
    # draining row reads alive=False so every kernel/allocation path
    # masks it out with zero new code, but release() still credits it —
    # running tasks bleed off normally instead of leaking debits.
    draining: np.ndarray = None
    labels: List[Dict[str, str]] = field(default_factory=list)

    def __post_init__(self):
        r = self.space.max_resources
        if self.total is None:
            self.total = np.zeros((0, r), dtype=np.float32)
        if self.available is None:
            self.available = np.zeros((0, r), dtype=np.float32)
        if self.alive is None:
            self.alive = np.zeros((0,), dtype=bool)
        if self.draining is None:
            self.draining = np.zeros((0,), dtype=bool)
        self._index: Dict[str, int] = {nid: i for i, nid in enumerate(self.node_ids)}
        # Row indices whose availability changed since the last consume_dirty()
        # — the incremental-upload feed for device-resident scheduler views
        # (kernel_jax.JaxScheduler.update_rows). Mirrors the role of the
        # reference's resource-sync deltas (ray_syncer.cc): ship only what
        # changed, not the whole cluster view, every round.
        self.dirty_rows: set = set()
        # Opt-in availability DELTA log (enable_delta_log): accumulates
        # (new - old) per mutation so a device view that is mid-pipeline
        # (holding in-flight debits the host hasn't applied yet) can be
        # updated INCREMENTALLY — absolute row uploads would erase those
        # debits. Consumers: HybridPolicy.schedule_pipelined ->
        # JaxScheduler.apply_delta. Disabled by default: zero overhead for
        # every other user of this class.
        self._delta_enabled = False
        self._delta_log: Optional[np.ndarray] = None
        # bumped on any node add/remove/revive: O(1) topology identity for
        # per-round cache keys (serializing total/alive with tobytes() at
        # 10k nodes costs ~640KB of memcpy per check)
        self.topology_version = 0

    def enable_delta_log(self) -> None:
        self._delta_enabled = True

    def _log_delta(self, idx: int, applied: np.ndarray) -> None:
        if not self._delta_enabled:
            return
        if (
            self._delta_log is None
            or self._delta_log.shape != self.available.shape
        ):
            old = self._delta_log
            self._delta_log = np.zeros_like(self.available)
            if old is not None and old.size:
                self._delta_log[: old.shape[0]] = old
        self._delta_log[idx] += applied

    def consume_delta(self) -> Optional[np.ndarray]:
        """Return-and-clear the accumulated availability delta matrix, or
        None when nothing changed since the last consume."""
        if self._delta_log is None:
            return None
        out = self._delta_log
        self._delta_log = None
        return out if out.any() else None

    def __len__(self) -> int:
        return len(self.node_ids)

    def node_index(self, node_id: str) -> Optional[int]:
        return self._index.get(node_id)

    def add_node(
        self,
        node_id: str,
        resources: Mapping[str, float],
        labels: Optional[Dict[str, str]] = None,
    ) -> int:
        if node_id in self._index:
            raise ValueError(f"duplicate node {node_id}")
        vec = self.space.vector(resources)
        self.total = np.vstack([self.total, vec[None, :]])
        self.available = np.vstack([self.available, vec[None, :]])
        self.alive = np.append(self.alive, True)
        self.draining = np.append(self.draining, False)
        idx = len(self.node_ids)
        self.node_ids.append(node_id)
        self.labels.append(dict(labels or {}))
        self._index[node_id] = idx
        self.topology_version += 1
        return idx

    def remove_node(self, node_id: str) -> None:
        idx = self._index.get(node_id)
        if idx is None:
            return
        # Keep row (stable indices for in-flight decisions); mark dead and zero
        # availability so the kernels mask it out — same effect as the
        # reference erasing the node from the cluster view.
        self.alive[idx] = False
        self.draining[idx] = False
        self.available[idx] = 0.0
        self.total[idx] = 0.0
        self.topology_version += 1

    def revive_node(self, node_id: str, resources: Mapping[str, float]) -> None:
        """Bring a dead row back (a daemon re-registered with the same id)."""
        idx = self._index[node_id]
        vec = self.space.vector(resources)
        self.total[idx] = vec
        self.available[idx] = vec.copy()
        self.alive[idx] = True
        self.draining[idx] = False
        self.topology_version += 1

    def drain_node(self, node_id: str) -> None:
        """Mark a LIVE node unschedulable (graceful drain): kernels and
        allocate() see alive=False so nothing new lands, but the row's
        capacity/debits are preserved and release() keeps crediting it —
        running tasks bleed off instead of being killed."""
        idx = self._index.get(node_id)
        if idx is None or self.draining[idx]:
            return
        self.draining[idx] = True
        self.alive[idx] = False
        self.topology_version += 1

    def undrain_node(self, node_id: str) -> None:
        """Cancel a drain (demand returned before the terminate)."""
        idx = self._index.get(node_id)
        if idx is None or not self.draining[idx]:
            return
        self.draining[idx] = False
        self.alive[idx] = True
        self.topology_version += 1

    def update_available(self, node_id: str, available: Mapping[str, float]) -> None:
        """Overwrite a node's availability from a sync report (ray_syncer-style)."""
        idx = self._index[node_id]
        old = self.available[idx].copy() if self._delta_enabled else None
        self.available[idx] = self.space.vector(available)
        if old is not None:
            self._log_delta(idx, self.available[idx] - old)
        self.dirty_rows.add(idx)

    def allocate(self, node_idx: int, demand: np.ndarray) -> bool:
        """Try to deduct `demand` from node `node_idx`. Returns False if it no
        longer fits (the caller treats that as a failed lease → reschedule)."""
        if not self.alive[node_idx]:
            return False
        if np.any(self.available[node_idx] + EPS < demand):
            return False
        old = self.available[node_idx].copy() if self._delta_enabled else None
        self.available[node_idx] -= demand
        np.maximum(self.available[node_idx], 0.0, out=self.available[node_idx])
        if old is not None:
            self._log_delta(int(node_idx), self.available[node_idx] - old)
        self.dirty_rows.add(int(node_idx))
        return True

    def release(self, node_idx: int, demand: np.ndarray) -> None:
        if not self.alive[node_idx] and not self.draining[node_idx]:
            return
        old = self.available[node_idx].copy() if self._delta_enabled else None
        self.available[node_idx] = np.minimum(
            self.available[node_idx] + demand, self.total[node_idx]
        )
        if old is not None:
            self._log_delta(int(node_idx), self.available[node_idx] - old)
        self.dirty_rows.add(int(node_idx))

    def replace_available(self, new_avail: np.ndarray) -> None:
        """Wholesale availability swap (bundle packing returns a full new
        matrix) that keeps the dirty-row contract: every changed row is
        marked so device-view consumers stay in sync."""
        changed = np.flatnonzero((self.available != new_avail).any(axis=1))
        if self._delta_enabled:
            for i in changed:
                self._log_delta(int(i), new_avail[i] - self.available[i])
        self.dirty_rows.update(int(i) for i in changed)
        self.available = new_avail

    def consume_dirty(self) -> List[int]:
        """Return-and-clear the changed row indices (sorted). The device view
        consumer uploads exactly these rows, then the set starts fresh."""
        out = sorted(self.dirty_rows)
        self.dirty_rows.clear()
        return out

    def feasible_anywhere(self, demand: np.ndarray) -> bool:
        """Is there any node whose *total* resources cover the demand?
        (Reference: ClusterResourceScheduler::IsSchedulableOnNode on totals —
        infeasible-forever vs just-currently-full.)"""
        if len(self.node_ids) == 0:
            return False
        ok = np.all(self.total + EPS >= demand[None, :], axis=1) & self.alive
        return bool(ok.any())

    def snapshot(self) -> "NodeResourceState":
        s = NodeResourceState(
            space=self.space,
            node_ids=list(self.node_ids),
            total=self.total.copy(),
            available=self.available.copy(),
            alive=self.alive.copy(),
            draining=self.draining.copy(),
            labels=[dict(l) for l in self.labels],
        )
        return s

    def available_map(self) -> Dict[str, Dict[str, float]]:
        return {
            nid: self.space.unvector(self.available[i])
            for i, nid in enumerate(self.node_ids)
            if self.alive[i]
        }

    def total_map(self) -> Dict[str, Dict[str, float]]:
        return {
            nid: self.space.unvector(self.total[i])
            for i, nid in enumerate(self.node_ids)
            if self.alive[i]
        }
