"""The flagship transformer's device programs: hand-written CUDA kernels
(csrc/model_kernels.cu, built on first CUDA use) each beside its plain
PyTorch version.

  K8  attention     causal (or full) attention over the whole sequence, in
                    online-softmax form: ring_attention._ring_attention_local
                    on one device, = reference_attention
      block_update  one online-softmax step of (o, m, l) against one KV
                    block: ray_tpu/parallel/ring_attention.py _block_update
  K10a rmsnorm      ray_tpu/models/transformer.py _rmsnorm
  K10b rope_split   transformer.py _rope on q and k, with the qkv split

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel. Layouts are the JAX package's: q, k, v
[B, S, H, Dh]; the softmax state m, l [B, H, S]. Types: bfloat16 or
float32 activations, float32 state and norm scales.

The kernels compute in float32 and are held to their plain versions within
a tolerance (summation order, and expf / cosf / sinf against PyTorch's),
not bit for bit: tests/test_torch_model_kernels.py and chip_smoke.py
state each tolerance.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "model_kernels.cu"
#: no --fmad=false here (see the source's note): held to a tolerance
NVCC_FLAGS = cuda_build.BASE_FLAGS

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "model_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
    "model_block_update": (
        [_P] * 9 + [_I] * 5 + [_LL, _LL, _I, _F, _I, _P], _I),
    "model_rmsnorm": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "model_rope_split": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "model_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("model", _SRC, NVCC_FLAGS, _SIGNATURES)

NEG_INF = -1e30  # ring_attention._NEG_INF: the mask value, never -inf
RMS_EPS = 1e-6
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{what}: dtype {t.dtype} (float32 or bfloat16 needed)")
    return code


def _check_layout(what: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and 16-byte aligned")


def _check(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.model_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


# ------------------------------------------------------------------ K8


def _block_update_plain(q, k, v, o, m, l, q_off, k_off, causal, scale):
    """Plain version of K8's block form, line for line the reference's
    _block_update."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    if causal:
        q_pos = q_off + torch.arange(Sq, device=q.device)
        k_pos = k_off + torch.arange(Sk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
        pmask = mask[None, None].float()
    else:
        pmask = 1.0
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # exp(finite - m_new) with fully-masked blocks handled by the explicit
    # pmask multiply (exp(-1e30 - (-1e30)) = 1 would otherwise leak weight)
    p = torch.exp(logits - m_new[..., None]) * pmask
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, m_new, l


def _check_attention_shapes(what, q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (q [B,Sq,H,Dh], k and v [B,Sk,H,Dh])")
    B, Sq, H, Dh = q.shape
    if Dh % 16 or not 16 <= Dh <= 128:
        raise ValueError(f"{what}: head width {Dh} (a multiple of 16 up to 128 needed)")
    if min(B, Sq, k.shape[1], H) == 0 or B * H > 65535:
        raise ValueError(f"{what}: shapes {tuple(q.shape)} / {tuple(k.shape)} out of range")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"{what}: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    return _dtype_code(q, what)


def block_update(q, k, v, o, m, l, q_off, k_off, causal, scale):
    """K8, block form. One online-softmax step of the state (o, m, l)
    against the KV block k, v, whose first key sits at position k_off; the
    first query at q_off. q [B,Sq,H,Dh], k and v [B,Sk,H,Dh] (bf16 or f32);
    o [B,Sq,H,Dh], m and l [B,H,Sq], float32, with m >= -1e30 (as every
    state that starts from -1e30 is). Returns the new (o, m, l); the inputs
    are not modified. A fully masked block leaves the state as it is."""
    dev = device_of(q, k, v, o, m, l)
    q_off, k_off = int(q_off), int(k_off)
    if dev.type == "cpu":
        return _block_update_plain(q, k, v, o, m, l, q_off, k_off, causal, scale)
    dt = _check_attention_shapes("block_update", q, k, v)
    B, Sq, H, Dh = q.shape
    if o.shape != q.shape or m.shape != (B, H, Sq) or l.shape != (B, H, Sq) \
            or {o.dtype, m.dtype, l.dtype} != {torch.float32}:
        raise ValueError(f"block_update: state o {tuple(o.shape)} {o.dtype}, m "
                         f"{tuple(m.shape)} {m.dtype}, l {tuple(l.shape)} {l.dtype} "
                         f"(float32 [B,Sq,H,Dh] and [B,H,Sq] needed)")
    _check_layout("block_update", q, k, v, o, m, l)
    lib = LIBRARY.load()
    o_out, m_out, l_out = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    with torch.cuda.device(dev):
        rc = lib.model_block_update(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), o_out.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
            B, Sq, k.shape[1], H, Dh, q_off, k_off, int(bool(causal)), float(scale), dt,
            current_stream(dev))
    _check(lib, rc, "block_update")
    block_update.launches += 1
    return o_out, m_out, l_out


block_update.launches = 0


def _attention_plain(q, k, v, causal=True):
    """Plain version of K8's whole form: _ring_attention_local on one
    device (one block step from the empty state, then o / max(l, 1e-30))."""
    B, Sq, H, Dh = q.shape
    o = torch.zeros((B, Sq, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o, m, l = _block_update_plain(q, k, v, o, m, l, 0, 0, causal, 1.0 / math.sqrt(Dh))
    l = torch.clamp_min(l, 1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def attention(q, k, v, causal=True):
    """K8, whole form. Attention of q [B,Sq,H,Dh] over k, v [B,Sk,H,Dh]
    (queries and keys both from position 0; causal: query i sees keys
    <= i), scale 1/sqrt(Dh), softmax in float32; the result in q's dtype.
    Equal to reference_attention."""
    dev = device_of(q, k, v)
    if dev.type == "cpu":
        return _attention_plain(q, k, v, causal)
    dt = _check_attention_shapes("attention", q, k, v)
    _check_layout("attention", q, k, v)
    B, Sq, H, Dh = q.shape
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.model_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1],
            H, Dh, int(bool(causal)), 1.0 / math.sqrt(Dh), dt, current_stream(dev))
    _check(lib, rc, "attention")
    attention.launches += 1
    return out


attention.launches = 0


# ------------------------------------------------------------------ K10a


def _rmsnorm_plain(x, scale):
    """Plain version of K10a, the reference's two roundings included."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + RMS_EPS)).to(x.dtype) * scale.to(x.dtype)


def rmsnorm(x, scale):
    """K10a. x [..., D] (bf16 or f32), scale [D] float32:
    (x * rsqrt(mean(x_f32 ** 2) + 1e-6)).astype(x.dtype) * scale.astype(x.dtype)."""
    dev = device_of(x, scale)
    if dev.type == "cpu":
        return _rmsnorm_plain(x, scale)
    dt = _dtype_code(x, "rmsnorm")
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32 or D % 4 or x.numel() == 0:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, scale {tuple(scale.shape)} "
                         f"{scale.dtype} (float32 [D], D a multiple of 4, needed)")
    _check_layout("rmsnorm", x, scale)
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.model_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               x.numel() // D, D, dt, current_stream(dev))
    _check(lib, rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


# ------------------------------------------------------------------ K10b


def _rope_plain(x, theta: float):
    """The reference's _rope: rotate-half rotary embedding over the last dim
    of x [B, S, H, Dh], positions 0..S-1, cos and sin rounded to x's dtype."""
    _, S, _, Dh = x.shape
    half = Dh // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    pos = torch.arange(S, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_split_plain(qkv, n_heads: int, theta: float):
    """Plain version of K10b: the split of qkv and _rope on q and k."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    shape = (B, S, n_heads, D // n_heads)
    q, k, v = torch.split(qkv, D, dim=-1)
    return _rope_plain(q.reshape(shape), theta), _rope_plain(k.reshape(shape), theta), \
        v.reshape(shape)


def rope_split(qkv, n_heads: int, theta: float):
    """K10b. qkv [B, S, 3D] (bf16 or f32) -> q, k, v [B, S, H, Dh] with the
    rotary embedding applied to q and k (rotate-half: x1 the first half of
    each head's dims), positions 0..S-1."""
    dev = device_of(qkv)
    if dev.type == "cpu":
        return _rope_split_plain(qkv, n_heads, theta)
    dt = _dtype_code(qkv, "rope_split")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * n_heads) or (qkv.shape[2] // (3 * n_heads)) % 2 \
            or qkv.numel() == 0:
        raise ValueError(f"rope_split: qkv {tuple(qkv.shape)} with {n_heads} heads "
                         "([B, S, 3 * H * Dh] with Dh even needed)")
    _check_layout("rope_split", qkv)
    B, S, D3 = qkv.shape
    Dh = D3 // 3 // n_heads
    lib = LIBRARY.load()
    q, k, v = (torch.empty((B, S, n_heads, Dh), dtype=qkv.dtype, device=dev)
               for _ in range(3))
    with torch.cuda.device(dev):
        rc = lib.model_rope_split(qkv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  B, S, n_heads, Dh, -math.log(theta), dt,
                                  current_stream(dev))
    _check(lib, rc, "rope_split")
    rope_split.launches += 1
    return q, k, v


rope_split.launches = 0

#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "block_update": block_update,
    "attention": attention,
    "rmsnorm": rmsnorm,
    "rope_split": rope_split,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
