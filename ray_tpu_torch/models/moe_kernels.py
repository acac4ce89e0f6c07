"""The expert layer's device programs: hand-written CUDA kernels
(csrc/moe_kernels.cu, built on first CUDA use) each beside its plain
PyTorch version.

  K9a moe_route     ray_tpu/models/moe.py :70-82 and :112-114: softmax,
                    top-1 expert, gate, position in expert, capacity drop,
                    and the per-group sums behind the aux loss
  K9b moe_dispatch  moe.py :83-89, :99: each kept token's row gathered into
                    its expert's slot, cast to the expert dtype
  K9c moe_combine   moe.py :86, :110: each token's expert row scaled by its
                    gate, cast to x's dtype; zeros for a dropped token

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel. Layouts are the JAX package's: logits
[G, S, E], x and y [G, S, D], the experts' rows [E, G, C, D].

The routing's integers (expert, slot, token_of_slot) and the dispatch and
combine are equal to their plain versions bit for bit; gate and the
probability sums are within 1e-6 relative (expf and the sum's order against
PyTorch's): tests/test_torch_moe_kernels.py and chip_smoke.py hold them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "moe_kernels.cu"
#: --fmad=false: the routing must equal its plain version bit for bit
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "moe_route": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "moe_dispatch": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "moe_combine": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "moe_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("moe", _SRC, NVCC_FLAGS, _SIGNATURES)

MAX_EXPERTS = 64
MAX_GROUPS = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
        rc = lib.moe_route(logits.data_ptr(), expert.data_ptr(), gate.data_ptr(),
                           slot.data_ptr(), token_of_slot.data_ptr(), stats.data_ptr(),
                           G, S, E, capacity, current_stream(dev))
    _check(lib, rc, "moe_route")
    moe_route.launches += 1
    return expert, gate, slot, token_of_slot, stats


moe_route.launches = 0


# ------------------------------------------------------------------ K9b


def _dispatch_plain(x: torch.Tensor, token_of_slot: torch.Tensor, dtype: torch.dtype):
    """Plain version of K9b: the gather, widened to float32 and rounded to
    `dtype`, zeros in empty slots (einsum("gsec,gsd->egcd") of the one-hot
    dispatch, then .astype(dtype))."""
    G, S, _ = x.shape
    full = (token_of_slot >= 0) & (token_of_slot < S)
    tok = torch.where(full, token_of_slot, 0).long()
    rows = x[torch.arange(G, device=x.device)[None, :, None], tok]
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
    E, G, C, D = out.shape
    keep = (slot >= 0) & (slot < E * C)
    e = torch.where(keep, slot // C, 0).long()
    pos = torch.where(keep, slot % C, 0).long()
    rows = out[e, torch.arange(G, device=out.device)[:, None], pos]
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

#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "moe_route": moe_route,
    "moe_dispatch": moe_dispatch,
    "moe_combine": moe_combine,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
