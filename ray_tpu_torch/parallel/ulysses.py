"""Ulysses sequence parallelism: all-to-all head-scatter attention, the port
of ray_tpu/parallel/ulysses.py.

Where ring attention keeps heads whole and moves K and V blocks around the
ring (ring_attention.py), Ulysses re-shards at the attention boundary: the
sequence-sharded q, k, v are exchanged all-to-all so that each rank holds
the FULL sequence for a SLICE of heads, attends over it locally with K8's
whole form (models/kernels.py ``attention(..., round_probs=False)``, equal
to ``reference_attention``), and a second all-to-all brings the output
back to sequence sharding. The axis size must divide the head count.

Layout: q, k, v [B, S, H, Dh]; each rank passes and gets back its
[B, S/p, H, Dh] block of the sequence.
"""

from __future__ import annotations

from ray_tpu_torch.models import kernels
from ray_tpu_torch.parallel.ring_attention import reference_attention


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True):
    """Sequence-parallel attention via head-scatter all-to-all over
    `axis_name` of `mesh` (parallel.mesh.make_mesh). q, k, v: this rank's
    [B, S/p, H, Dh] block; H must divide by the axis size. Returns this
    rank's block of the output, in q's dtype."""
    p = mesh.shape[axis_name]
    if q.shape[2] % p:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by mesh axis "
            f"{axis_name!r} ({p}); use ring_attention otherwise"
        )
    # scatter heads (dim 2), gather the sequence (dim 1): [B, S, H/p, Dh]
    q_h, k_h, v_h = (mesh.all_to_all(x, axis_name, split_axis=2, concat_axis=1)
                     for x in (q, k, v))
    o = kernels.attention(q_h, k_h, v_h, causal=causal, round_probs=False)
    # gather heads back, scatter the sequence again: [B, S/p, H, Dh]
    return mesh.all_to_all(o, axis_name, split_axis=1, concat_axis=2)


__all__ = ["ulysses_attention", "reference_attention"]
