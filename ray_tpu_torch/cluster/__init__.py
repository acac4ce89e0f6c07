"""Multi-process cluster runtime.

Reference architecture (SURVEY §1): GCS (src/ray/gcs/gcs_server/) + per-node
raylet (src/ray/raylet/) + per-process core workers, all talking gRPC.

Placement is centralized in the head process as batched kernel rounds: the
whole pending queue becomes one [classes x nodes] assignment per round,
solved by the torch_cuda policy on the CUDA kernels of sched/kernel_torch.py
(or the NumPy twin below its size threshold), instead of Ray's per-raylet
local schedulers with spillback. The submitter-side lease cache (reuse a
leased worker for same-class tasks, reference normal_task_submitter.cc) is
kept — that's the latency fast path that bypasses rounds entirely.

Processes:
  head:    GcsServer — tables (nodes/actors/jobs/PGs), object directory,
           pubsub, health checks, THE scheduler.
  node:    NodeDaemon — worker pool (subprocess workers,
           ``python -m ray_tpu_torch.cluster.worker``), the node's native
           shm object store, object transfer, lease execution.
  client:  ClusterClient — the driver runtime behind
           ray_tpu_torch.init(address=...) and init(cluster=True).

The daemon's compiled-DAG handlers and serve fast-path pairs, and the
worker's DAG loop and serve attach, raise NotImplementedError until the DAG
layer and serve are ported (ROADMAP.md, queue 1, items 6 and 9).
"""

from ray_tpu_torch.cluster.cluster_utils import Cluster

__all__ = ["Cluster"]
