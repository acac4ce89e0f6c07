from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    forward,
    gather_params,
    grads_to_numpy,
    init_params,
    loss_fn,
    param_partition_specs,
    params_from_numpy,
    shard_params,
    to_numpy,
)

__all__ = [
    "Transformer",
    "TransformerConfig",
    "init_params",
    "forward",
    "gather_params",
    "grads_to_numpy",
    "loss_fn",
    "param_partition_specs",
    "params_from_numpy",
    "shard_params",
    "to_numpy",
]
