"""ray_tpu_torch.util.collective — host-side tensor collectives.

Reference: python/ray/util/collective/. Device collectives over a mesh are
torch.distributed's (ray_tpu_torch.parallel.mesh); this module is the host
path (the reference's GLOO role), numpy tensors through a rendezvous actor.
"""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    recv,
    reducescatter,
    send,
)

__all__ = [
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_rank",
    "init_collective_group",
    "recv",
    "reducescatter",
    "send",
]
