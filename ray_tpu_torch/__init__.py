"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` is the reference; this package mirrors its
module paths and names (``ray_tpu_torch/core/runtime.py`` is the
counterpart of ``ray_tpu/core/runtime.py``) and imports nothing of it.
The scheduling path runs in local mode (init/remote/get ->
LocalRuntime._schedule_round) and in cluster mode (init(address=...) or
init(cluster=True): a GCS, node daemons with a native shm object store,
tasks and actors in worker processes; GcsServer._schedule_round), both
through HybridPolicy (policy ``"torch_cuda"``) -> TorchScheduler ->
hand-written CUDA kernels for Hopper (sched/csrc/sched_kernels.cu), each
beside its plain PyTorch version. The cluster scheduler is a *batched
assignment kernel*, not a per-task C++ loop (reference:
src/ray/raylet/scheduling/cluster_resource_scheduler.cc).

Public API surface mirrors the reference's Python core API
(python/ray/_private/worker.py: init/get/put/wait; python/ray/remote_function.py
and python/ray/actor.py: @remote).
"""

from ray_tpu_torch._version import __version__

from ray_tpu_torch.core.api import (
    init,
    shutdown,
    is_initialized,
    remote,
    get,
    put,
    wait,
    cancel,
    kill,
    get_runtime_context,
    method,
    get_actor,
    nodes,
    cluster_resources,
    available_resources,
    timeline,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.exceptions import (
    RayTpuError,
    TaskError,
    ActorError,
    ActorDiedError,
    ClusterOverloadedError,
    DeadlineExceededError,
    ObjectLostError,
    GetTimeoutError,
)

__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "cancel",
    "kill",
    "method",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "timeline",
    "ObjectRef",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ClusterOverloadedError",
    "DeadlineExceededError",
    "ObjectLostError",
    "GetTimeoutError",
]
