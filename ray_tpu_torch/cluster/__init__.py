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

Compiled graphs and Serve's fast path ride the same processes: the daemon
pins a worker to each compiled-DAG stage, owns the channel files under its
``chan_dir`` (``ray_tpu_torch.dag.channel``) and relays cross-node frames
(``rpc_dag_push`` / ``rpc_dag_pull``); it builds each fast-path pair's
request and response channels and hands them to the worker hosting the
replica (``rpc_serve_attach``). The worker runs a stage's exec loop
(``dag_loop``) and a replica's ``ReplicaFastPath`` (``serve_attach``); a
worker's death flags every channel of its stages and pairs closed and
errored, so a parked driver or client raises ``ChannelClosedError``.
"""

from ray_tpu_torch.cluster.cluster_utils import Cluster

__all__ = ["Cluster"]
