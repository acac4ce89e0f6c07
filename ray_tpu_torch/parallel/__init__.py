from ray_tpu_torch.parallel.ring_attention import reference_attention
from ray_tpu_torch.parallel.tpu_train import (
    make_forward_step,
    make_optimizer,
    make_train_state,
    make_train_step,
)

__all__ = [
    "make_forward_step",
    "make_optimizer",
    "make_train_state",
    "make_train_step",
    "reference_attention",
]
