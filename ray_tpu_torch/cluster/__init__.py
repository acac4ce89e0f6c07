"""Multi-process cluster runtime (the GCS head so far).

Placement is centralized in the head process as batched kernel rounds: the
whole pending queue becomes one [classes x nodes] assignment per round,
solved by the torch_cuda policy on the CUDA kernels of sched/kernel_torch.py
(or the NumPy twin below its size threshold).

Ported so far: ``gcs.GcsServer`` with its RPC layer (``rpc``), execution
seam (``runtime``) and test/bench harness (``testing``). The node daemon,
workers, client, shared-memory store and ``cluster_utils.Cluster`` are the
next slice (ROADMAP.md, queue 1), so this package exports nothing yet and
``init(cluster=True)`` / ``init(address=...)`` still raise.
"""
