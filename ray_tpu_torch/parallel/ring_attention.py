"""Ring attention: sequence parallelism over a mesh axis, the port of
ray_tpu/parallel/ring_attention.py.

The sequence is split over the ranks of a mesh axis ("sp"): each rank holds
one Q block and the K and V blocks move one hop around the ring a step
(``Mesh.ppermute``), each folded into an online softmax by _block_update,
K8's block form (models/kernels.py: the tensor cores in bf16, the CUDA
cores in float32). Causality comes from global positions rebuilt from the
ring step and the rank's coordinate, as the reference's.

Layout: q, k, v [B, S, H, Dh]; the softmax state m, l [B, H, S]. Across
ranks each rank passes and gets back its [B, S/p, H, Dh] block, the block
the reference's shard_map body sees.
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


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True):
    """Sequence-parallel attention over `axis_name` of `mesh`
    (parallel.mesh.make_mesh). q, k, v: this rank's [B, S/p, H, Dh] block
    of the sequence, the block at this rank's coordinate on the axis.
    Returns this rank's block of the output, in q's dtype.

    Each of the p steps is one kernels.block_update against the K and V
    block held, which arrived from coordinate (idx - t) mod p; between
    steps both move one hop (coordinate i to i + 1). The last hop, whose
    blocks no step would use, is left out."""
    B, Sq, H, Dh = q.shape
    p = mesh.shape[axis_name]
    idx = mesh.axis_index(axis_name)
    scale = 1.0 / math.sqrt(Dh)
    perm = [(i, (i + 1) % p) for i in range(p)]
    o = torch.zeros((B, Sq, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    for t in range(p):
        k_off = ((idx - t) % p) * Sq
        o, m, l = _block_update(q, kb, vb, o, m, l, idx * Sq, k_off, causal, scale)
        if t + 1 < p:
            kb = mesh.ppermute(kb, axis_name, perm)
            vb = mesh.ppermute(vb, axis_name, perm)
    # causal rows always see their own position, so l > 0; kept as the
    # reference keeps it
    l = torch.clamp_min(l, 1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


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
