"""Ring attention's arithmetic, the port of ray_tpu/parallel/ring_attention.py.

The reference shards the sequence over a mesh axis and rotates KV blocks
around the ring, folding each into an online softmax with _block_update
(K8's block form, models/kernels.py here). ``ring_attention`` itself, a
shard_map over the mesh that moves the blocks between cards, waits for the
multi-card slice; until then the block step and the unsharded reference
are what this module holds.

Layout: q, k, v [B, S, H, Dh]; the softmax state m, l [B, H, S].
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.models import kernels

_NEG_INF = kernels.NEG_INF


def _block_update(q, k, v, o, m, l, q_off, k_off, causal, scale):
    """One online-softmax accumulation step against a single KV block.

    q: [B, Sq, H, Dh]   k,v: [B, Sk, H, Dh]
    o: [B, Sq, H, Dh] f32 accumulator; m,l: [B, H, Sq] f32 running max/sum.
    Returns updated (o, m, l). K8's block form on a CUDA tensor.
    """
    return kernels.block_update(q, k, v, o, m, l, q_off, k_off, causal, scale)


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Unsharded O(S^2) reference for tests. Same math, one block, plain
    PyTorch (no kernel)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
