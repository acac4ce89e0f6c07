"""Node providers: the cloud-plugin interface the autoscaler drives.

Reference: python/ray/autoscaler/node_provider.py (NodeProvider interface)
and the fake in-process provider used by autoscaler tests
(python/ray/autoscaler/_private/fake_multi_node/node_provider.py
FakeMultiNodeProvider). Cloud providers (AWS/GCP/...) are out of scope
(SURVEY §7 'deliberately out of scope'); the interface is the parity point.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class NodeProvider:
    """Launch/terminate nodes of declared types."""

    def create_node(self, node_type: str, resources: Dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Starts real NodeDaemons in-process against a running GCS — scaled-down
    nodes are real daemons with real subprocess workers, so autoscaling is
    tested end-to-end on one machine (reference: FakeMultiNodeProvider)."""

    def __init__(self, gcs_addr, config=None):
        self.gcs_addr = gcs_addr
        self.config = config
        self._lock = threading.Lock()
        self._daemons: Dict[str, "NodeDaemon"] = {}
        self._counter = 0

    def create_node(self, node_type: str, resources: Dict[str, float]) -> str:
        from ray_tpu_torch.cluster.node_daemon import NodeDaemon

        with self._lock:
            self._counter += 1
            node_id = f"auto-{node_type}-{self._counter}"
        daemon = NodeDaemon(
            self.gcs_addr, dict(resources), node_id=node_id, config=self.config,
            labels={"node_type": node_type},
        )
        with self._lock:
            self._daemons[node_id] = daemon
        return node_id

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            daemon = self._daemons.pop(node_id, None)
        if daemon is not None:
            daemon.shutdown()

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._daemons)

    def shutdown(self):
        for nid in self.non_terminated_nodes():
            self.terminate_node(nid)
