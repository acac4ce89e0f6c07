"""ray_tpu_torch.dag — lazy DAGs compiled into pinned-worker pipelines.

Reference: ray.dag / Ray Compiled Graphs (aDAG). ``fn.bind(...)`` /
``actor.method.bind(...)`` build a lazy :class:`DAGNode` graph;
``dag.execute(x)`` eager-interprets it through the normal task layer;
``dag.compile()`` pins each stage to a worker, preallocates one seqlock
shm channel per edge (:mod:`ray_tpu_torch.dag.channel`), and drives iterations
with zero per-call control-plane traffic (:mod:`ray_tpu_torch.dag.compiled`).
"""

from ray_tpu_torch.dag.api import (  # noqa: F401 - public API
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.channel import (  # noqa: F401 - public API
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
from ray_tpu_torch.dag.compiled import CompiledDAG  # noqa: F401 - public API

__all__ = [
    "DAGNode",
    "InputNode",
    "FunctionNode",
    "ClassMethodNode",
    "MultiOutputNode",
    "Channel",
    "ChannelClosedError",
    "ChannelTimeoutError",
    "CompiledDAG",
]
