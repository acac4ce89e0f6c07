"""Scheduling layer: the batched-assignment reformulation of Ray's schedulers.

The reference implements cluster-level placement as per-task C++ loops:
- raylet hot path: src/ray/raylet/scheduling/cluster_resource_scheduler.cc
  (ClusterResourceScheduler::GetBestSchedulableNode) dispatching to
  src/ray/raylet/scheduling/policy/*.cc per-request policies;
- GCS placement groups: src/ray/gcs/gcs_server/gcs_placement_group_scheduler.cc
  over policy/bundle_scheduling_policy.cc;
- autoscaler bin-packing: python/ray/autoscaler/_private/resource_demand_scheduler.py.

Here all three consume the same kernel: pending work is grouped into
*scheduling classes* (identical resource-demand vectors — the same notion the
reference's NormalTaskSubmitter uses for lease reuse, see
src/ray/core_worker/transport/normal_task_submitter.cc), producing a
[classes x nodes] assignment-count problem solved by vectorized scoring —
NumPy on CPU, identical math in hand-written CUDA kernels (kernel_torch).
"""

from ray_tpu_torch.sched.resources import (
    PREDEFINED_RESOURCES,
    ResourceSpace,
    NodeResourceState,
    pack_demands,
)
from ray_tpu_torch.sched.policy import (
    SchedulingPolicy,
    HybridPolicy,
    SpreadPolicy,
    NodeAffinityPolicy,
    make_policy,
)
from ray_tpu_torch.sched import kernel_np


def __getattr__(name):
    # kernel_torch is imported lazily so the pure-NumPy policy path never
    # imports torch at package import time.
    if name == "kernel_torch":
        import ray_tpu_torch.sched.kernel_torch as m

        return m
    raise AttributeError(name)

__all__ = [
    "PREDEFINED_RESOURCES",
    "ResourceSpace",
    "NodeResourceState",
    "pack_demands",
    "SchedulingPolicy",
    "HybridPolicy",
    "SpreadPolicy",
    "NodeAffinityPolicy",
    "make_policy",
    "kernel_np",
]
