"""The expert layer's device programs: hand-written CUDA kernels
(csrc/moe_kernels.cu, built on first CUDA use) each beside its plain
PyTorch version.

  K9a moe_route     ray_tpu/models/moe.py :70-82 and :112-114: softmax,
                    top-1 expert, gate, position in expert, capacity drop,
                    and the per-group sums behind the aux loss; one launch
                    of a block a chunk of 256 tokens (``route_plan``), with
                    a scratch kept a stream
  K9b moe_dispatch  moe.py :83-89, :99: each kept token's row gathered into
                    its expert's slot, cast to the expert dtype
  K9c moe_combine   moe.py :86, :110: each token's expert row scaled by its
                    gate, cast to x's dtype; zeros for a dropped token

and their backward, the gradient of moe.py :57-116 ``moe_ffn`` as its
jax.grad jaxpr forms it (``tests/test_parallel.py:179``):

  K9a' moe_route_bwd     d_logits from the gate's and the aux loss's
                         cotangents: jnp.max's tie split, the aux term's
                         true division by G*S, the softmax's backward; one
                         lane a (token, expert)
  K9b' moe_dispatch_bwd  dispatch's transpose: a gather by ``slot``
  K9c' moe_combine_bwd   combine's transpose: a gather by ``token_of_slot``
                         times the gate, and the gate's cotangent, a row
                         dot product, in one launch

``_Route``, ``_Dispatch`` and ``_Combine`` are autograd Functions whose
forwards are K9a-c and whose backwards are K9a'-c'; the layer on one device
uses them only when it is trained, its mesh form always (``_Route`` takes
the mesh then: the aux loss's sums are psummed over "dp" and its
cotangent too, the psum's transpose).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel. Layouts are the JAX package's: logits
[G, S, E], x and y [G, S, D], the experts' rows [E, G, C, D].

The routing's integers (expert, slot, token_of_slot) and the dispatch and
combine are equal to their plain versions bit for bit; gate and the
probability sums are within 1e-6 relative (expf and the sum's order against
PyTorch's): tests/test_torch_moe_kernels.py and chip_smoke.py hold them.
The backward's gathers are bit-equal too; d_gate and d_logits are sums
taken in another order than the plain versions' (BWD_TOL):
tests/test_torch_moe_grads.py and chip_smoke.py hold them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "moe_kernels.cu"
#: --fmad=false: the routing must equal its plain version bit for bit
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "moe_route_plan": ([_I, _I, _I, _P], _I),
    "moe_route": ([_P] * 7 + [_LL] + [_I] * 4 + [_P], _I),
    "moe_dispatch": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "moe_combine": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "moe_route_bwd": ([_P] * 5 + [_I] * 3 + [_F, _P], _I),
    "moe_dispatch_bwd": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "moe_combine_bwd": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "moe_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("moe", _SRC, NVCC_FLAGS, _SIGNATURES)

MAX_EXPERTS = 64
MAX_GROUPS = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: K9a' and K9c''s float32 sums against their plain versions' (relative to
#: the largest entry): d_gate is a dot product over D taken in another
#: order; d_logits repeats the softmax with expf against torch.exp and sums
#: over E. The gathers (d_out, dx) are bit-equal.
BWD_TOL = 1e-5


def _dtype_code(dtype: torch.dtype, what: str) -> int:
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"{what}: dtype {dtype} (float32 or bfloat16 needed)")
    return code


def _check_contiguous(what: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _check(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.moe_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


# ------------------------------------------------------------------ K9a


def softmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """The reference's softmax over the last axis, step for step:
    exp(l - max), summed in expert order, divided (torch.softmax multiplies
    by the reciprocal instead)."""
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    total = p[..., 0]
    for e in range(1, p.shape[-1]):
        total = total + p[..., e]
    return p / total[..., None]


def _route_plain(logits: torch.Tensor, capacity: int):
    """Plain version of K9a, line for line moe.py :70-82 with the slots
    written as indices instead of one-hot tensors."""
    G, S, E = logits.shape
    probs = softmax_plain(logits)
    expert = probs.argmax(-1)  # the first index on equal values
    gate = probs.gather(-1, expert[..., None])[..., 0]
    onehot = F.one_hot(expert, E).to(torch.int32)
    pos = onehot.cumsum(1, dtype=torch.int32).gather(-1, expert[..., None])[..., 0] - 1
    keep = pos < capacity
    expert = expert.to(torch.int32)
    slot = torch.where(keep, expert * capacity + pos, -1)
    token_of_slot = torch.full((E, G, capacity), -1, dtype=torch.int32, device=logits.device)
    g_idx, s_idx = torch.nonzero(keep, as_tuple=True)
    token_of_slot[expert[g_idx, s_idx].long(), g_idx, pos[g_idx, s_idx].long()] = \
        s_idx.to(torch.int32)
    stats = torch.stack([onehot.sum(1).float(), probs.double().sum(1).float()], dim=1)
    return expert, gate, slot, token_of_slot, stats


def _check_route_args(logits: torch.Tensor, capacity: int) -> None:
    if logits.dim() != 3 or logits.dtype != torch.float32 or min(logits.shape) == 0:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)} {logits.dtype} "
                         "(float32 [G, S, E] needed)")
    G, _, E = logits.shape
    if E > MAX_EXPERTS or G > MAX_GROUPS or capacity < 1:
        raise ValueError(f"moe_route: {E} experts (at most {MAX_EXPERTS}), {G} groups "
                         f"(at most {MAX_GROUPS}), capacity {capacity} (at least 1)")


#: tokens a block of K9a (the source's kRouteThreads): one chunk of a group
ROUTE_TOKENS_A_BLOCK = 256


class RoutePlan(NamedTuple):
    chunks: int         # blocks a group: ceil(S / ROUTE_TOKENS_A_BLOCK)
    blocks: int         # G * chunks, one launch
    scratch_words: int  # int32 words of the scratch kept a stream


def route_plan(G: int, S: int, E: int) -> RoutePlan:
    """K9a's launch for logits [G, S, E], the host-side mirror of the
    source's route_layout (its C entry moe_route_plan; the `cuda` test
    holds the two together): a block a chunk of 256 tokens; the scratch
    holds the ticket, each group's count of finished blocks, and each
    chunk's E token counts (int32) and probability sums (float64)."""
    chunks = -(-S // ROUTE_TOKENS_A_BLOCK)
    n = G * chunks * E
    agg = 2 + G + (G & 1)
    part = agg + n + (n & 1)
    return RoutePlan(chunks, G * chunks, part + 2 * n)


#: K9a's scratch: one zeroed int32 array a (device, stream), made at the
#: stream's first call and grown only for a larger shape, so that no call
#: of a steady shape allocates and no two streams share; each launch leaves
#: it zeros
_route_scratch = {}


def _route_scratch_for(dev, words: int) -> torch.Tensor:
    key = (dev.index, current_stream(dev))
    buf = _route_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = _route_scratch[key] = torch.zeros(words, dtype=torch.int32, device=dev)
    return buf


def moe_route(logits: torch.Tensor, capacity: int):
    """K9a. logits [G, S, E] float32 and the capacity C a (group, expert) ->
    expert [G, S] int32 (top-1, the first index on ties), gate [G, S]
    float32 (its probability), slot [G, S] int32 (e * C + position in
    expert, -1 if past the capacity), token_of_slot [E, G, C] int32 (the
    token in each slot, -1 if empty) and stats [G, 2, E] float32 (tokens
    and summed probability per expert and group)."""
    capacity = int(capacity)
    _check_route_args(logits, capacity)
    dev = device_of(logits)
    if dev.type == "cpu":
        return _route_plain(logits, capacity)
    _check_contiguous("moe_route", logits)
    G, S, E = logits.shape
    lib = LIBRARY.load()
    expert = torch.empty((G, S), dtype=torch.int32, device=dev)
    gate = torch.empty((G, S), dtype=torch.float32, device=dev)
    slot = torch.empty((G, S), dtype=torch.int32, device=dev)
    token_of_slot = torch.empty((E, G, capacity), dtype=torch.int32, device=dev)
    stats = torch.empty((G, 2, E), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        scratch = _route_scratch_for(dev, route_plan(G, S, E).scratch_words)
        rc = lib.moe_route(logits.data_ptr(), expert.data_ptr(), gate.data_ptr(),
                           slot.data_ptr(), token_of_slot.data_ptr(), stats.data_ptr(),
                           scratch.data_ptr(), scratch.numel(), G, S, E, capacity,
                           current_stream(dev))
    _check(lib, rc, "moe_route")
    moe_route.launches += 1
    return expert, gate, slot, token_of_slot, stats


moe_route.launches = 0


# ------------------------------------------------------------------ K9b


def _rows_by_slot(src: torch.Tensor, token_of_slot: torch.Tensor):
    """src [G, S, ...] gathered into the slots: (full [E, G, C], src[g,
    token_of_slot[e, g, c]] [E, G, C, ...]), an empty slot (a token outside
    [0, S)) reading token 0."""
    G, S = src.shape[:2]
    full = (token_of_slot >= 0) & (token_of_slot < S)
    tok = torch.where(full, token_of_slot, 0).long()
    return full, src[torch.arange(G, device=src.device)[None, :, None], tok]


def _rows_by_token(src: torch.Tensor, slot: torch.Tensor):
    """src [E, G, C, ...] gathered back to the tokens: (keep [G, S], src[e,
    g, pos] [G, S, ...] for slot = e * C + pos), a dropped token (a slot
    outside [0, E * C)) reading slot 0."""
    E, G, C = src.shape[:3]
    keep = (slot >= 0) & (slot < E * C)
    e = torch.where(keep, slot // C, 0).long()
    pos = torch.where(keep, slot % C, 0).long()
    return keep, src[e, torch.arange(G, device=src.device)[:, None], pos]


def _dispatch_plain(x: torch.Tensor, token_of_slot: torch.Tensor, dtype: torch.dtype):
    """Plain version of K9b: the gather, widened to float32 and rounded to
    `dtype`, zeros in empty slots (einsum("gsec,gsd->egcd") of the one-hot
    dispatch, then .astype(dtype))."""
    full, rows = _rows_by_slot(x, token_of_slot)
    return torch.where(full[..., None], rows.float(), 0.0).to(dtype)


def moe_dispatch(x: torch.Tensor, token_of_slot: torch.Tensor, dtype: torch.dtype):
    """K9b. x [G, S, D] (float32 or bfloat16), token_of_slot [E, G, C] int32
    (from moe_route) -> expert_in [E, G, C, D] in `dtype`:
    x[g, token_of_slot[e, g, c]] rounded to `dtype`, zeros where the slot is
    empty (an entry outside [0, S))."""
    dev = device_of(x, token_of_slot)
    out_code = _dtype_code(dtype, "moe_dispatch")
    x_code = _dtype_code(x.dtype, "moe_dispatch")
    if x.dim() != 3 or token_of_slot.dim() != 3 or token_of_slot.dtype != torch.int32 \
            or token_of_slot.shape[1] != x.shape[0] or min(x.shape) == 0 \
            or min(token_of_slot.shape) == 0:
        raise ValueError(f"moe_dispatch: x {tuple(x.shape)}, token_of_slot "
                         f"{tuple(token_of_slot.shape)} {token_of_slot.dtype} "
                         "(x [G, S, D], int32 [E, G, C] needed)")
    if dev.type == "cpu":
        return _dispatch_plain(x, token_of_slot, dtype)
    _check_contiguous("moe_dispatch", x, token_of_slot)
    G, S, D = x.shape
    E, _, C = token_of_slot.shape
    lib = LIBRARY.load()
    out = torch.empty((E, G, C, D), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.moe_dispatch(x.data_ptr(), token_of_slot.data_ptr(), out.data_ptr(),
                              E, G, S, C, D, x_code, out_code, current_stream(dev))
    _check(lib, rc, "moe_dispatch")
    moe_dispatch.launches += 1
    return out


moe_dispatch.launches = 0


# ------------------------------------------------------------------ K9c


def _combine_plain(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
                   dtype: torch.dtype):
    """Plain version of K9c: gate * the token's expert row in float32, cast
    to `dtype`; zeros for a dropped token (einsum("gsec,egcd->gsd") with
    one non-zero term a sum)."""
    keep, rows = _rows_by_token(out, slot)
    return torch.where(keep[..., None], gate[..., None] * rows, 0.0).to(dtype)


def moe_combine(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
                dtype: torch.dtype):
    """K9c. out [E, G, C, D] float32 (the experts' outputs), slot and gate
    [G, S] (from moe_route) -> y [G, S, D] in `dtype`: gate * out[e, g, pos]
    as one float32 product, rounded; zeros for a dropped token (a slot
    outside [0, E * C))."""
    dev = device_of(out, slot, gate)
    y_code = _dtype_code(dtype, "moe_combine")
    if out.dim() != 4 or out.dtype != torch.float32 or slot.dim() != 2 \
            or slot.dtype != torch.int32 or gate.shape != slot.shape \
            or gate.dtype != torch.float32 or slot.shape[0] != out.shape[1] \
            or min(out.shape) == 0 or min(slot.shape) == 0:
        raise ValueError(f"moe_combine: out {tuple(out.shape)} {out.dtype}, slot "
                         f"{tuple(slot.shape)} {slot.dtype}, gate {tuple(gate.shape)} "
                         f"{gate.dtype} (float32 [E, G, C, D], int32 and float32 [G, S] "
                         "needed)")
    if dev.type == "cpu":
        return _combine_plain(out, slot, gate, dtype)
    _check_contiguous("moe_combine", out, slot, gate)
    E, G, C, D = out.shape
    S = slot.shape[1]
    lib = LIBRARY.load()
    y = torch.empty((G, S, D), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.moe_combine(out.data_ptr(), slot.data_ptr(), gate.data_ptr(), y.data_ptr(),
                             E, G, S, C, D, y_code, current_stream(dev))
    _check(lib, rc, "moe_combine")
    moe_combine.launches += 1
    return y


moe_combine.launches = 0


def aux_loss(stats: torch.Tensor, n_tokens: int):
    """frac_tokens [E] and the Switch load-balancing loss E * sum_e
    frac_tokens_e * mean_prob_e (moe.py :112-114) from K9a's per-group
    sums stats [G, 2, E] over `n_tokens` tokens."""
    frac_tokens = stats[:, 0].sum(0) / n_tokens
    mean_prob = stats[:, 1].sum(0) / n_tokens
    return frac_tokens, stats.shape[2] * torch.sum(frac_tokens * mean_prob)


# ------------------------------------------------------------------ K9a'


def _route_bwd_plain(logits: torch.Tensor, d_gate: torch.Tensor, frac_tokens: torch.Tensor,
                     d_aux: torch.Tensor, n_tokens: Optional[int] = None) -> torch.Tensor:
    """Plain version of K9a', the jaxpr of jax.vjp(moe_ffn) from the gate's
    and aux's cotangents back to the logits, step for step: e = exp(l -
    max) and u = sum_e e as softmax_plain; the gate's cotangent d_gate /
    count on each expert tied at the max (jnp.max's rule); the aux term
    (frac_tokens * (E * d_aux)) / n_tokens, a true division, added to it;
    then d_logits = (dp / u + -(sum_e (dp * (1 / (u*u))) * e)) * e."""
    G, S, E = logits.shape
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    u = e[..., 0]
    for k in range(1, E):
        u = u + e[..., k]
    u = u[..., None]
    probs = e / u
    tie = (probs == probs.amax(-1, keepdim=True)).float()
    # a device tensor, so that the division is a true division on the card
    n = torch.full((), float(G * S if n_tokens is None else n_tokens), dtype=torch.float32,
                   device=logits.device)
    z = d_aux.reshape(()) * float(E)
    dp = (frac_tokens * z) / n + (d_gate[..., None] / tie.sum(-1, keepdim=True)) * tie
    t = (dp * (1.0 / (u * u))) * e
    total = t[..., 0]
    for k in range(1, E):
        total = total + t[..., k]
    return (dp / u + (-total)[..., None]) * e


def moe_route_bwd(logits: torch.Tensor, d_gate: torch.Tensor, frac_tokens: torch.Tensor,
                  d_aux: torch.Tensor, n_tokens: Optional[int] = None) -> torch.Tensor:
    """K9a'. The gradient of K9a's gate and of the aux loss through the
    softmax: logits [G, S, E] float32 (the forward's), d_gate [G, S]
    float32, frac_tokens [E] float32 (the aux loss's token shares, no
    gradient) and d_aux (one float32 element, on the device) -> d_logits
    [G, S, E] float32. `n_tokens`: the tokens the aux loss averages over,
    G*S unless they span more groups than these (the mesh form's). One
    launch on the card: a group of the next power
    of two >= E lanes a token (lanes past E idle), one lane an expert; past
    32 experts one warp a token, two experts a lane."""
    dev = device_of(logits, d_gate, frac_tokens, d_aux)
    _check_route_args(logits, 1)
    G, S, E = logits.shape
    if d_gate.shape != (G, S) or frac_tokens.shape != (E,) or d_aux.numel() != 1 \
            or {d_gate.dtype, frac_tokens.dtype, d_aux.dtype} != {torch.float32}:
        raise ValueError(f"moe_route_bwd: d_gate {tuple(d_gate.shape)}, frac_tokens "
                         f"{tuple(frac_tokens.shape)}, d_aux {tuple(d_aux.shape)} (float32 "
                         f"[{G}, {S}], [{E}] and one element needed)")
    n_tokens = G * S if n_tokens is None else int(n_tokens)
    if dev.type == "cpu":
        return _route_bwd_plain(logits, d_gate, frac_tokens, d_aux, n_tokens)
    _check_contiguous("moe_route_bwd", logits, d_gate, frac_tokens, d_aux)
    lib = LIBRARY.load()
    d_logits = torch.empty_like(logits)
    with torch.cuda.device(dev):
        rc = lib.moe_route_bwd(logits.data_ptr(), d_gate.data_ptr(), frac_tokens.data_ptr(),
                               d_aux.data_ptr(), d_logits.data_ptr(), G, S, E, float(n_tokens),
                               current_stream(dev))
    _check(lib, rc, "moe_route_bwd")
    moe_route_bwd.launches += 1
    return d_logits


moe_route_bwd.launches = 0


# ------------------------------------------------------------------ K9b'


def _dispatch_bwd_plain(d_in: torch.Tensor, slot: torch.Tensor, dtype: torch.dtype):
    """Plain version of K9b': each kept token's slot row of d_in, rounded to
    `dtype`; zeros for a dropped token (the transpose of
    einsum("gsec,gsd->egcd"), one non-zero term a sum)."""
    keep, rows = _rows_by_token(d_in, slot)
    return torch.where(keep[..., None], rows.float(), 0.0).to(dtype)


def moe_dispatch_bwd(d_in: torch.Tensor, slot: torch.Tensor, dtype: torch.dtype):
    """K9b'. d_in [E, G, C, D] (float32 or bfloat16, the cotangent of
    moe_dispatch's output), slot [G, S] int32 (from moe_route) -> dx
    [G, S, D] in `dtype` (x's): d_in[e, g, pos] rounded to `dtype` for
    slot = e * C + pos, zeros for a dropped token (a slot outside
    [0, E * C))."""
    dev = device_of(d_in, slot)
    in_code = _dtype_code(d_in.dtype, "moe_dispatch_bwd")
    dx_code = _dtype_code(dtype, "moe_dispatch_bwd")
    if d_in.dim() != 4 or slot.dim() != 2 or slot.dtype != torch.int32 \
            or slot.shape[0] != d_in.shape[1] or min(d_in.shape) == 0 or min(slot.shape) == 0:
        raise ValueError(f"moe_dispatch_bwd: d_in {tuple(d_in.shape)}, slot "
                         f"{tuple(slot.shape)} {slot.dtype} ([E, G, C, D] and int32 [G, S] "
                         "needed)")
    if dev.type == "cpu":
        return _dispatch_bwd_plain(d_in, slot, dtype)
    _check_contiguous("moe_dispatch_bwd", d_in, slot)
    E, G, C, D = d_in.shape
    S = slot.shape[1]
    lib = LIBRARY.load()
    dx = torch.empty((G, S, D), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.moe_dispatch_bwd(d_in.data_ptr(), slot.data_ptr(), dx.data_ptr(),
                                  E, G, S, C, D, in_code, dx_code, current_stream(dev))
    _check(lib, rc, "moe_dispatch_bwd")
    moe_dispatch_bwd.launches += 1
    return dx


moe_dispatch_bwd.launches = 0


# ------------------------------------------------------------------ K9c'


def _combine_bwd_plain(dy: torch.Tensor, out: torch.Tensor, slot: torch.Tensor,
                       gate: torch.Tensor, token_of_slot: torch.Tensor):
    """Plain version of K9c': d_out = gate * dy of each slot's token as one
    float32 product, zeros in an empty slot; d_gate = each kept token's
    dot product of dy with its expert row, 0 for a dropped one."""
    full, rows = _rows_by_slot(dy, token_of_slot)
    d_out = torch.where(full[..., None],
                        _rows_by_slot(gate, token_of_slot)[1][..., None] * rows.float(), 0.0)
    keep, out_rows = _rows_by_token(out, slot)
    d_gate = torch.where(keep, (dy.float() * out_rows).sum(-1), 0.0)
    return d_out, d_gate


def combine_bwd_one_launch(dy: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether K9c' runs as one launch on these inputs, as moe_combine_bwd
    in csrc/moe_kernels.cu decides: D a multiple of 8 and dy and out
    16-byte aligned (d_out is allocated, so aligned)."""
    return dy.shape[-1] % 8 == 0 and dy.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def moe_combine_bwd(dy: torch.Tensor, out: torch.Tensor, slot: torch.Tensor,
                    gate: torch.Tensor, token_of_slot: torch.Tensor):
    """K9c'. dy [G, S, D] (float32 or bfloat16, the cotangent of y), out
    [E, G, C, D] float32 (the experts' outputs), slot and gate [G, S] and
    token_of_slot [E, G, C] (from moe_route) -> d_out [E, G, C, D] float32
    (gate * dy of the slot's token; zeros in an empty slot) and d_gate
    [G, S] float32 (sum_d dy * out[slot]; 0 for a dropped token). One
    launch, one warp a slot, where D is a multiple of 8 and dy, out and
    d_out are 16-byte aligned; else two: the rows, then one warp a token
    for d_gate."""
    dev = device_of(dy, out, slot, gate, token_of_slot)
    dy_code = _dtype_code(dy.dtype, "moe_combine_bwd")
    if out.dim() != 4 or out.dtype != torch.float32 or dy.dim() != 3 \
            or dy.shape[2] != out.shape[3] or slot.shape != dy.shape[:2] \
            or slot.dtype != torch.int32 or gate.shape != slot.shape \
            or gate.dtype != torch.float32 or token_of_slot.dtype != torch.int32 \
            or token_of_slot.shape != out.shape[:3] or slot.shape[0] != out.shape[1] \
            or min(out.shape) == 0 or min(slot.shape) == 0:
        raise ValueError(f"moe_combine_bwd: dy {tuple(dy.shape)}, out {tuple(out.shape)} "
                         f"{out.dtype}, slot {tuple(slot.shape)} {slot.dtype}, gate "
                         f"{tuple(gate.shape)} {gate.dtype}, token_of_slot "
                         f"{tuple(token_of_slot.shape)} (dy [G, S, D], float32 [E, G, C, D], "
                         "int32 and float32 [G, S], int32 [E, G, C] needed)")
    if dev.type == "cpu":
        return _combine_bwd_plain(dy, out, slot, gate, token_of_slot)
    _check_contiguous("moe_combine_bwd", dy, out, slot, gate, token_of_slot)
    E, G, C, D = out.shape
    S = slot.shape[1]
    lib = LIBRARY.load()
    d_out = torch.empty_like(out)
    d_gate = torch.empty_like(gate)
    with torch.cuda.device(dev):
        rc = lib.moe_combine_bwd(dy.data_ptr(), out.data_ptr(), slot.data_ptr(),
                                 gate.data_ptr(), token_of_slot.data_ptr(), d_out.data_ptr(),
                                 d_gate.data_ptr(), E, G, S, C, D, dy_code, current_stream(dev))
    _check(lib, rc, "moe_combine_bwd")
    moe_combine_bwd.launches += 1
    return d_out, d_gate


moe_combine_bwd.launches = 0


# --------------------------------------------------------- autograd Functions


class _Route(torch.autograd.Function):
    """K9a and the aux loss, with K9a' as the backward. The outputs with a
    gradient are the gate and the aux loss itself (not the probability
    sums), so that the backward sees aux's cotangent and takes the
    reference's true division by the tokens; slot and token_of_slot carry
    none. With a mesh (axis "dp"), logits are this rank's groups: the
    sums over every group are a psum over "dp" of the rank's, and the
    backward psums aux's cotangent over "dp", the psum's transpose."""

    @staticmethod
    def forward(ctx, logits, capacity, mesh=None):
        _, gate, slot, token_of_slot, stats = moe_route(logits, capacity)
        n = logits.shape[0] * logits.shape[1]
        if mesh is not None:
            stats = mesh.psum(stats.sum(0, keepdim=True), "dp")  # [1, 2, E], every group
            n *= mesh.shape["dp"]
        frac_tokens, aux = aux_loss(stats, n)
        ctx.save_for_backward(logits, frac_tokens)
        ctx.mesh, ctx.n = mesh, n
        ctx.mark_non_differentiable(slot, token_of_slot)
        return gate, aux, slot, token_of_slot

    @staticmethod
    def backward(ctx, d_gate, d_aux, _slot, _token_of_slot):
        logits, frac_tokens = ctx.saved_tensors
        d_aux = d_aux.reshape(1).contiguous()
        if ctx.mesh is not None:
            d_aux = ctx.mesh.psum(d_aux, "dp")
        return moe_route_bwd(logits, d_gate.contiguous(), frac_tokens, d_aux,
                             ctx.n), None, None


class _Dispatch(torch.autograd.Function):
    """K9b, with K9b' (a gather by slot) as the backward."""

    @staticmethod
    def forward(ctx, x, token_of_slot, slot, dtype):
        ctx.save_for_backward(slot)
        ctx.x_dtype = x.dtype
        return moe_dispatch(x, token_of_slot, dtype)

    @staticmethod
    def backward(ctx, d_in):
        (slot,) = ctx.saved_tensors
        return moe_dispatch_bwd(d_in.contiguous(), slot, ctx.x_dtype), None, None, None


class _Combine(torch.autograd.Function):
    """K9c, with K9c' (d_out and d_gate) as the backward."""

    @staticmethod
    def forward(ctx, out, gate, slot, token_of_slot, dtype):
        ctx.save_for_backward(out, gate, slot, token_of_slot)
        return moe_combine(out, slot, gate, dtype)

    @staticmethod
    def backward(ctx, dy):
        out, gate, slot, token_of_slot = ctx.saved_tensors
        d_out, d_gate = moe_combine_bwd(dy.contiguous(), out, slot, gate, token_of_slot)
        return d_out, d_gate, None, None, None


#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "moe_route": moe_route,
    "moe_dispatch": moe_dispatch,
    "moe_combine": moe_combine,
    "moe_route_bwd": moe_route_bwd,
    "moe_dispatch_bwd": moe_dispatch_bwd,
    "moe_combine_bwd": moe_combine_bwd,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
