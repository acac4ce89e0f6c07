from ray_tpu_torch.parallel.ring_attention import reference_attention
from ray_tpu_torch.parallel.tpu_train import make_forward_step

__all__ = [
    "make_forward_step",
    "reference_attention",
]
