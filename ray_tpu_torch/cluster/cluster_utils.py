"""Test/dev cluster harness.

Reference: python/ray/cluster_utils.py (Cluster / AutoscalingCluster) — the
fixture that makes "multi-node" testable on one machine: one GCS plus N node
daemons with *declarative* fake resources (SURVEY §4). Daemons run in-process
(each is its own threads + rpc server); workers are real subprocesses, so
task execution still crosses process boundaries like production.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ray_tpu_torch.core.config import Config
from ray_tpu_torch.cluster.gcs import GcsServer
from ray_tpu_torch.cluster.node_daemon import NodeDaemon


class Cluster:
    def __init__(self, config: Optional[Config] = None, host: str = "127.0.0.1",
                 persistence_path: Optional[str] = None):
        self.config = config or Config()
        self.host = host
        self.persistence_path = persistence_path
        self.gcs = GcsServer(
            host=host, config=self.config, persistence_path=persistence_path
        )
        self.daemons = []
        # chaos kill hooks: registered unconditionally in the PROCESS-level
        # registry (not on a schedule instance), so a fault plane installed
        # before OR after cluster construction finds its targets
        # (reference: the node-killer utilities behind test_chaos.py)
        from ray_tpu_torch.chaos import schedule as _chaos_sched

        self._chaos_sched = _chaos_sched
        # (name, fn) pairs: shutdown removes exactly what THIS cluster
        # registered (a later cluster reusing a name keeps its entry)
        self._kill_targets: list = [("gcs-restart", self.restart_gcs)]
        _chaos_sched.register_kill("gcs-restart", self.restart_gcs)

    def restart_gcs(self):
        """Kill and restart the GCS at the SAME port from its persisted
        tables (reference: GCS fault tolerance with Redis persistence;
        test_gcs_fault_tolerance.py). Daemons and drivers reconnect via
        their on_close reconnect loops."""
        port = self.gcs.port
        self.gcs.shutdown()
        time.sleep(0.3)  # let the port free + disconnects propagate
        self.gcs = GcsServer(
            host=self.host, port=port, config=self.config,
            persistence_path=self.persistence_path,
        )
        return self.gcs

    @property
    def address(self) -> str:
        return f"{self.host}:{self.gcs.port}"

    def add_node(
        self,
        num_cpus: float = 4,
        num_tpus: float = 0,
        memory: float = 2**31,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        node_id: Optional[str] = None,
    ) -> NodeDaemon:
        res = {"CPU": float(num_cpus), "memory": float(memory)}
        if num_tpus:
            res["TPU"] = float(num_tpus)
        res.update(resources or {})
        daemon = NodeDaemon(
            (self.host, self.gcs.port), res,
            node_id=node_id, config=self.config, host=self.host, labels=labels,
        )
        self.daemons.append(daemon)
        # each node becomes a kill target for kill/kill_at rules
        kill_fn = lambda d=daemon: self.kill_node(d)  # noqa: E731
        self._chaos_sched.register_kill(daemon.node_id, kill_fn)
        self._kill_targets.append((daemon.node_id, kill_fn))
        return daemon

    def remove_node(self, daemon: NodeDaemon):
        daemon.shutdown()
        if daemon in self.daemons:
            self.daemons.remove(daemon)

    def kill_node(self, daemon: NodeDaemon):
        """Hard kill for fault-injection tests (reference: test_utils node
        killer used by test_chaos.py): drop the GCS connection and all
        workers without cleanup."""
        with daemon._lock:
            workers = list(daemon.workers.values())
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
        daemon.gcs.close()
        daemon.server.stop()
        daemon._stopped = True
        if daemon in self.daemons:
            self.daemons.remove(daemon)

    def wait_for_nodes(self, n: int, timeout: float = 10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self.gcs._lock:
                alive = sum(
                    1 for v in self.gcs.nodes.values() if v["alive"]
                )
            if alive >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {n} nodes")

    def shutdown(self):
        for target, fn in self._kill_targets:
            self._chaos_sched.unregister_kill(target, fn)
        self._kill_targets.clear()
        for d in list(self.daemons):
            d.shutdown()
        self.daemons.clear()
        self.gcs.shutdown()
