"""Autoscaler v2: explicit instance lifecycle, reconciled against the provider.

Reference: python/ray/autoscaler/v2/instance_manager/ — the v2 redesign
replaces v1's implicit "launched dict + idle timers" bookkeeping with an
INSTANCE MANAGER holding one record per instance, each walking an explicit
state machine:

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                 |             |            |
                 v             v            v
          ALLOCATION_FAILED  TERMINATED   RAY_STOPPING -> TERMINATING
                                                             -> TERMINATED

and a RECONCILER that converges three views every tick: desired state
(demand-driven target counts), the cloud provider's actual nodes, and the
GCS's live node table. All transitions validate against an allowed-set and
append to a per-instance history — the debugging surface v1 lacked.

v2's scheduler also folds PENDING placement groups into the demand it
sizes for; here STRICT_PACK bundles sum into one class (they must co-land
on one node) while other strategies contribute per-bundle classes
(STRICT_SPREAD's distinct-node constraint is approximated per-bundle — a
candidate node can satisfy at most one bundle in the kernel's packing
only when bundle demand exceeds half a node; documented approximation).
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig, get_nodes_to_launch
from ray_tpu_torch.autoscaler.provider import NodeProvider
from ray_tpu_torch.cluster.rpc import RpcClient
from ray_tpu_torch.sched.resources import ResourceSpace


# ------------------------------------------------------------- state machine

class InstanceStatus:
    QUEUED = "QUEUED"                      # decided, not yet asked of provider
    REQUESTED = "REQUESTED"                # provider.create_node in flight
    ALLOCATED = "ALLOCATED"                # provider returned a cloud node
    RAY_RUNNING = "RAY_RUNNING"            # registered + alive in the GCS
    RAY_STOPPING = "RAY_STOPPING"          # draining (idle scale-down)
    TERMINATING = "TERMINATING"            # provider.terminate in flight
    TERMINATED = "TERMINATED"              # gone (terminal)
    ALLOCATION_FAILED = "ALLOCATION_FAILED"  # provider launch failed (terminal)


# reference: instance_manager/common.py InstanceUtil.get_valid_transitions
_TRANSITIONS: Dict[str, set] = {
    InstanceStatus.QUEUED: {InstanceStatus.REQUESTED},
    InstanceStatus.REQUESTED: {
        InstanceStatus.ALLOCATED, InstanceStatus.ALLOCATION_FAILED,
    },
    InstanceStatus.ALLOCATED: {
        InstanceStatus.RAY_RUNNING,
        # cloud node vanished / never registered in time
        InstanceStatus.TERMINATING, InstanceStatus.TERMINATED,
    },
    InstanceStatus.RAY_RUNNING: {
        InstanceStatus.RAY_STOPPING,
        InstanceStatus.TERMINATING, InstanceStatus.TERMINATED,
    },
    InstanceStatus.RAY_STOPPING: {
        InstanceStatus.TERMINATING, InstanceStatus.TERMINATED,
        InstanceStatus.RAY_RUNNING,  # drain cancelled (demand returned)
    },
    InstanceStatus.TERMINATING: {InstanceStatus.TERMINATED},
    InstanceStatus.TERMINATED: set(),
    InstanceStatus.ALLOCATION_FAILED: set(),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    resources: Dict[str, float]
    status: str = InstanceStatus.QUEUED
    cloud_node_id: Optional[str] = None  # provider's id
    ray_node_id: Optional[str] = None    # GCS node id once registered
    created_at: float = field(default_factory=time.time)
    status_since: float = field(default_factory=time.time)
    history: List[tuple] = field(default_factory=list)  # (ts, from, to, why)


class InvalidTransition(RuntimeError):
    pass


class InstanceManager:
    """Authoritative instance table with validated transitions
    (reference: instance_manager/instance_manager.py InstanceManager)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}

    def create_instance(self, node_type: str,
                        resources: Dict[str, float]) -> Instance:
        inst = Instance(
            instance_id=uuid.uuid4().hex[:12], node_type=node_type,
            resources=dict(resources),
        )
        inst.history.append((inst.created_at, None, InstanceStatus.QUEUED,
                             "created"))
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def update_status(self, instance_id: str, new: str,
                      reason: str = "") -> Instance:
        with self._lock:
            inst = self._instances[instance_id]
            if new not in _TRANSITIONS[inst.status]:
                raise InvalidTransition(
                    f"instance {instance_id}: {inst.status} -> {new} "
                    f"({reason or 'no reason'}) is not a legal transition"
                )
            inst.history.append((time.time(), inst.status, new, reason))
            inst.status = new
            inst.status_since = time.time()
            return inst

    def instances(self, statuses: Optional[set] = None) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if statuses is not None:
            out = [i for i in out if i.status in statuses]
        return out

    def get(self, instance_id: str) -> Optional[Instance]:
        with self._lock:
            return self._instances.get(instance_id)

    def by_cloud_id(self, cloud_node_id: str) -> Optional[Instance]:
        with self._lock:
            for i in self._instances.values():
                if i.cloud_node_id == cloud_node_id:
                    return i
        return None

    def counts_by_type(self, statuses: set) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i in self.instances(statuses):
            out[i.node_type] = out.get(i.node_type, 0) + 1
        return out


_ACTIVE = {
    InstanceStatus.QUEUED, InstanceStatus.REQUESTED,
    InstanceStatus.ALLOCATED, InstanceStatus.RAY_RUNNING,
    InstanceStatus.RAY_STOPPING,
}


def pg_demand_classes(pending_pgs: List[dict]) -> List[dict]:
    """Strategy-aware demand classes for PENDING placement groups
    (reference: v2/scheduler.py folding gang requests into the bin-pack).
    STRICT_PACK bundles must co-land: one summed class. Everything else
    contributes per-bundle classes."""
    out: List[dict] = []
    for pg in pending_pgs:
        bundles = pg.get("bundles") or []
        if not bundles:
            continue
        if pg.get("strategy") == "STRICT_PACK":
            total: Dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + float(v)
            out.append({"resources": total, "count": 1})
        else:
            for b in bundles:
                out.append({"resources": dict(b), "count": 1})
    return out


class AutoscalerV2:
    """Reconciler loop (reference: v2/autoscaler.py + reconciler.py):
    each tick converges instance records against the provider's node list
    and the GCS node table, then sizes new QUEUED instances from pending
    task + placement-group demand."""

    def __init__(self, gcs_addr, provider: NodeProvider,
                 node_types: List[NodeTypeConfig],
                 idle_timeout_s: float = 5.0,
                 update_interval_s: float = 0.5,
                 allocation_timeout_s: float = 60.0,
                 launch_retries: int = 2,
                 launch_workers: int = 2):
        self.gcs = RpcClient(gcs_addr[0], gcs_addr[1])
        self.provider = provider
        self.node_types = {nt.name: nt for nt in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.allocation_timeout_s = allocation_timeout_s
        self.launch_retries = launch_retries
        self.im = InstanceManager()
        self.space = ResourceSpace()
        self._retries: Dict[str, int] = {}  # instance_id -> retries left
        self._idle_since: Dict[str, float] = {}  # ray node_id -> ts
        # provider.create_node runs OFF the reconciler tick (reference:
        # the v2 launcher's background thread pool): one hanging cloud
        # call must not stall reconcile/sizing/drain. REQUESTED models
        # the in-flight launch; results land here and reconcile on a
        # later tick.
        self._launch_pool = ThreadPoolExecutor(
            max_workers=launch_workers, thread_name_prefix="as-launch"
        )
        self._launch_lock = threading.Lock()
        # (instance_id, cloud_id | Exception) completions to reconcile
        self._launch_results: List[tuple] = []
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="autoscaler-v2"
        )

    # ------------------------------------------------------------ lifecycle

    def start(self):
        for nt in self.node_types.values():
            for _ in range(nt.min_workers):
                self.im.create_instance(nt.name, nt.resources)
        self._thread.start()
        return self

    def shutdown(self):
        self._stopped = True
        self._launch_pool.shutdown(wait=False)
        try:
            self.gcs.close()
        except Exception:  # noqa: BLE001
            pass

    def _loop(self):
        while not self._stopped:
            try:
                self.update()
            except Exception:
                traceback.print_exc()
            time.sleep(self.update_interval_s)

    # ------------------------------------------------------------- one tick

    def update(self):
        state = self.gcs.call("autoscaler_state")
        provider_nodes = set(self.provider.non_terminated_nodes())
        self._reconcile(state, provider_nodes)
        self._launch_queued()
        self._size_for_demand(state)
        self._drain_idle(state)

    # ---------------------------------------------------------- reconciler

    def _reconcile(self, state, provider_nodes: set):
        """Converge instance records with the provider + GCS views
        (reference: v2 Reconciler.sync_from)."""
        gcs_nodes = state["nodes"]
        for inst in self.im.instances():
            if inst.status == InstanceStatus.ALLOCATED:
                if inst.cloud_node_id not in provider_nodes:
                    self.im.update_status(
                        inst.instance_id, InstanceStatus.TERMINATED,
                        "cloud node disappeared before ray registered",
                    )
                    continue
                n = gcs_nodes.get(inst.cloud_node_id)
                if n is not None and n["alive"]:
                    inst.ray_node_id = inst.cloud_node_id
                    self.im.update_status(
                        inst.instance_id, InstanceStatus.RAY_RUNNING,
                        "registered with GCS",
                    )
                elif (
                    time.time() - inst.status_since
                    > self.allocation_timeout_s
                ):
                    self.im.update_status(
                        inst.instance_id, InstanceStatus.TERMINATING,
                        "never registered with GCS in time",
                    )
                    self._terminate(inst)
            elif inst.status == InstanceStatus.RAY_RUNNING:
                n = gcs_nodes.get(inst.ray_node_id)
                if inst.cloud_node_id not in provider_nodes or (
                    n is not None and not n["alive"]
                ):
                    self.im.update_status(
                        inst.instance_id, InstanceStatus.TERMINATED,
                        "node died",
                    )
            elif inst.status == InstanceStatus.RAY_STOPPING:
                n = gcs_nodes.get(inst.ray_node_id)
                if n is None or not n["alive"] or n.get("running", 0) == 0:
                    self.im.update_status(
                        inst.instance_id, InstanceStatus.TERMINATING,
                        "drained",
                    )
                    self._terminate(inst)

    def _do_launch(self, instance_id: str, node_type: str,
                   resources: Dict[str, float]) -> None:
        """Pool thread: ONE provider call; the outcome (cloud id or the
        exception) is reconciled by a later tick. A provider that hangs
        pins only this pool thread — the reconciler keeps ticking."""
        try:
            outcome = self.provider.create_node(node_type, resources)
        except Exception as e:  # noqa: BLE001 - provider fault
            outcome = e
        with self._launch_lock:
            self._launch_results.append((instance_id, outcome))

    def _launch_queued(self):
        # reconcile completed background launches first
        with self._launch_lock:
            done, self._launch_results = self._launch_results, []
        for iid, outcome in done:
            inst = self.im.get(iid)
            if inst is None or inst.status != InstanceStatus.REQUESTED:
                # terminated/cleaned up while the launch was in flight:
                # the cloud node (if any) is reaped by reconcile against
                # provider.non_terminated_nodes on later ticks
                continue
            if isinstance(outcome, Exception):
                # launch-retry budget CARRIES to the replacement record
                # (*_FAILED is terminal, so the retry is a fresh record):
                # a persistently failing provider exhausts the budget
                # instead of retrying forever and growing the tables
                # without bound
                left = self._retries.pop(iid, self.launch_retries)
                if left > 0:
                    self.im.update_status(
                        iid, InstanceStatus.ALLOCATION_FAILED,
                        f"{outcome!r} (will retry, {left - 1} left after "
                        "the replacement)",
                    )
                    new = self.im.create_instance(
                        inst.node_type, inst.resources
                    )
                    self._retries[new.instance_id] = left - 1
                else:
                    self.im.update_status(
                        iid, InstanceStatus.ALLOCATION_FAILED,
                        f"{outcome!r} (retries exhausted)",
                    )
                continue
            self._retries.pop(iid, None)  # budget no longer needed
            inst.cloud_node_id = outcome
            self.im.update_status(
                iid, InstanceStatus.ALLOCATED, outcome
            )
        # dispatch new launches to the pool; REQUESTED models in-flight
        for inst in self.im.instances({InstanceStatus.QUEUED}):
            self.im.update_status(
                inst.instance_id, InstanceStatus.REQUESTED, "launching"
            )
            self._launch_pool.submit(
                self._do_launch, inst.instance_id, inst.node_type,
                dict(inst.resources),
            )

    # ------------------------------------------------------------- sizing

    def _size_for_demand(self, state):
        demand = list(state.get("pending_demand", []))
        demand += pg_demand_classes(state.get("pending_pgs", []))
        if not demand:
            return
        nodes = state["nodes"]
        live = [n for n in nodes.values() if n["alive"]]
        # instances between REQUESTED and RAY_RUNNING count as full
        # in-flight capacity so one demand burst launches once, not every
        # tick until registration
        starting = [
            self.space.vector(self.node_types[i.node_type].resources)
            for i in self.im.instances({
                InstanceStatus.QUEUED, InstanceStatus.REQUESTED,
                InstanceStatus.ALLOCATED,
            })
            if i.node_type in self.node_types
        ]
        rows_a = [self.space.vector(n["available"]) for n in live] + starting
        rows_t = [self.space.vector(n["resources"]) for n in live] + starting
        if rows_a:
            avail, total = np.stack(rows_a), np.stack(rows_t)
            alive = np.ones(len(rows_a), bool)
        else:
            R = self.space.max_resources
            avail = np.zeros((0, R), np.float32)
            total = np.zeros((0, R), np.float32)
            alive = np.zeros((0,), bool)
        counts = self.im.counts_by_type(_ACTIVE)
        launch = get_nodes_to_launch(
            self.space, avail, total, alive, demand,
            list(self.node_types.values()), counts,
        )
        for type_name, k in launch.items():
            nt = self.node_types[type_name]
            for _ in range(k):
                self.im.create_instance(nt.name, nt.resources)

    # --------------------------------------------------------- scale-down

    def _drain_idle(self, state):
        now = time.time()
        counts = self.im.counts_by_type(
            {InstanceStatus.RAY_RUNNING, InstanceStatus.RAY_STOPPING}
        )
        for inst in self.im.instances({InstanceStatus.RAY_RUNNING}):
            n = state["nodes"].get(inst.ray_node_id)
            if n is None:
                continue
            free = self.space.vector(n["available"])
            cap = self.space.vector(n["resources"])
            idle = n.get("running", 0) == 0 and bool(
                np.all(np.abs(free - cap) <= 1e-3 * np.maximum(cap, 1.0))
            )
            if not idle:
                self._idle_since.pop(inst.instance_id, None)
                continue
            self._idle_since.setdefault(inst.instance_id, now)
            nt = self.node_types.get(inst.node_type)
            if nt is None or counts.get(inst.node_type, 0) <= nt.min_workers:
                continue
            if now - self._idle_since[inst.instance_id] > self.idle_timeout_s:
                # GCS-side drain BEFORE entering RAY_STOPPING: the node
                # is marked unschedulable server-side, so a task
                # dispatched between this tick's idle observation and
                # the terminate can no longer land on it — the
                # scale-down race is closed at the scheduler, not
                # papered over by task retries. Running tasks bleed off;
                # the reconciler terminates only once running == 0.
                # Drain state mutates only AFTER the call succeeds: a
                # failed/timed-out drain keeps the idle clock, so the
                # retry happens next tick (drain_node is idempotent —
                # a lost reply just re-drains).
                try:
                    self.gcs.call(
                        "drain_node", {"node_id": inst.ray_node_id},
                        timeout=5.0,
                    )
                except Exception:  # noqa: BLE001 - node/GCS mid-churn
                    continue  # retry the drain next tick, stay RUNNING
                counts[inst.node_type] -= 1
                self._idle_since.pop(inst.instance_id, None)
                self.im.update_status(
                    inst.instance_id, InstanceStatus.RAY_STOPPING,
                    "idle past timeout (drained in GCS)",
                )

    def _terminate(self, inst: Instance):
        try:
            if inst.cloud_node_id:
                self.provider.terminate_node(inst.cloud_node_id)
        except Exception:  # noqa: BLE001 - provider fault; reconcile retries
            traceback.print_exc()
            return
        self.im.update_status(
            inst.instance_id, InstanceStatus.TERMINATED, "terminated"
        )
