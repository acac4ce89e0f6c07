"""The compute payload the framework orchestrates: the port of
ray_tpu/parallel/tpu_train.py.

This slice ports the single-device forward step. The sharded training
state and step (``make_train_state``, ``make_train_step``) wait for the
training and multi-card slices.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import Transformer, TransformerConfig, forward
from ray_tpu_torch.util.device import resolve_device


def make_forward_step(cfg: TransformerConfig, device=None):
    """Single-device forward (the reference's jitted forward step):
    returns fwd(params, tokens) -> logits [B, S, V] float32. Runs on the
    card unless `device` says otherwise; raises without one. Tokens may be
    a numpy array or a tensor; params must be a Transformer on that
    device."""
    dev = resolve_device(device, what="make_forward_step")

    def fwd(params: Transformer, tokens) -> torch.Tensor:
        if params.device != dev:
            raise ValueError(f"params on {params.device}, the step runs on {dev}")
        tokens = torch.as_tensor(tokens, device=dev)
        return forward(params, tokens, cfg)

    return fwd
