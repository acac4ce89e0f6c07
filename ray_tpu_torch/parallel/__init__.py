from ray_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.ring_attention import reference_attention
from ray_tpu_torch.parallel.tpu_train import (
    make_forward_step,
    make_optimizer,
    make_train_state,
    make_train_step,
)
from ray_tpu_torch.parallel.ulysses import ulysses_attention

# ring_attention stays a submodule: exporting the function of that name
# would shadow it (ray_tpu.parallel's does; ROADMAP queue 3)
__all__ = [
    "make_forward_step",
    "make_mesh",
    "make_optimizer",
    "make_train_state",
    "make_train_step",
    "mesh_shape_for",
    "pipeline_apply",
    "reference_attention",
    "ulysses_attention",
]
