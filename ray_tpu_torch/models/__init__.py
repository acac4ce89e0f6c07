from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    forward,
    grads_to_numpy,
    init_params,
    loss_fn,
    params_from_numpy,
    to_numpy,
)

__all__ = [
    "Transformer",
    "TransformerConfig",
    "init_params",
    "forward",
    "grads_to_numpy",
    "loss_fn",
    "params_from_numpy",
    "to_numpy",
]
