"""The flagship transformer's device programs: hand-written CUDA kernels
(csrc/model_kernels.cu and, for K8 and K8' in bf16 with rounded
probabilities and K8's block form in bf16, the tensor-core
csrc/attention_sm90.cu; each built on first CUDA use) each beside its plain
PyTorch version.

  K8  attention     causal (or full) attention over the whole sequence.
                    round_probs=False: online-softmax form, = the reference's
                    reference_attention (ring_attention._ring_attention_local
                    on one device); round_probs=True: the reference's
                    transformer._attention, whose softmax probabilities are
                    rounded to the dtype before P·V
      block_update  one online-softmax step of (o, m, l) against one KV
                    block: ray_tpu/parallel/ring_attention.py _block_update
  K10a rmsnorm      ray_tpu/models/transformer.py _rmsnorm
  K10b rope_split   transformer.py _rope on q and k, with the qkv split
  K8'  attention_bwd   the gradient of _attention (round_probs=True)
  K10a' rmsnorm_bwd    the gradient of _rmsnorm
  K10b' rope_split_bwd the gradient of _rope and the split

K10b and K10b' each have two forms, picked by the C entry: 16-byte rows
where a half-head is whole 16-byte vectors and every pointer is aligned
(``rope_split_form``, ``rope_split_bwd_form``), else one scalar pair a
thread; the two give the same bits. ``rope_split_bwd`` counts its rows-form
launches in ``launches_rows``.

Which kernel serves K8 and K8' on the card is ``_attention_route``'s
choice: bf16 with the probabilities rounded (the forward's and the train
step's path) goes to the wgmma kernels of attention_sm90.cu; float32, and
bf16 with ``round_probs=False``, to the CUDA-core kernels of
model_kernels.cu. K8's block form goes to attention_sm90.cu in bf16, its
float32 P·V taken as two bf16 parts of P, and to model_kernels.cu in
float32 (``_block_update_route``). ``block_update``, ``attention`` and
``attention_bwd`` count the launches of the tensor-core kernels in
``launches_tc`` beside ``launches``.

``attention(..., round_probs=True)``, ``rmsnorm`` and ``rope_split`` are
``torch.autograd.Function``s whose backward is the matching backward
wrapper. A plain backward is the gradient written out in torch ops with the
roundings of the reference's ``jax.grad`` jaxpr, not autograd through the
plain forward.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback from one to the other.
Each wrapper carries a plain integer ``launches`` counter, bumped once per
call that launched its kernel. Layouts are the JAX package's: q, k, v
[B, S, H, Dh]; the softmax state m, l [B, H, S]. Types: bfloat16 or
float32 activations, float32 state and norm scales.

The kernels compute in float32 and are held to their plain versions within
a tolerance (summation order, and expf / cosf / sinf against PyTorch's),
not bit for bit: tests/test_torch_model_kernels.py,
tests/test_torch_model_grads.py and chip_smoke.py state each tolerance.
Every kernel is deterministic: two launches on the same inputs give the
same bits.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.device import current_stream, device_of

_SRC = Path(__file__).resolve().parent / "csrc" / "model_kernels.cu"
_SRC_SM90 = Path(__file__).resolve().parent / "csrc" / "attention_sm90.cu"
#: no --fmad=false here (see the source's note): held to a tolerance
NVCC_FLAGS = cuda_build.BASE_FLAGS

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "model_attention": ([_P] * 6 + [_I] * 6 + [_F, _I, _P], _I),
    "model_attention_bwd": ([_P] * 10 + [_I] * 6 + [_F, _I, _P], _I),
    "model_block_update": (
        [_P] * 9 + [_I] * 5 + [_LL, _LL, _I, _F, _I, _P], _I),
    "model_rmsnorm": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "model_rmsnorm_bwd": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "model_rmsnorm_bwd_blocks": ([_I, _I, _I, _P], _I),
    "model_rope_split": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "model_rope_split_form": ([_P, _P, _P, _P, _I, _I], _I),
    "model_rope_split_bwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "model_rope_split_bwd_form": ([_P, _P, _P, _P, _I, _I], _I),
    "model_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("model", _SRC, NVCC_FLAGS, _SIGNATURES)

_SIGNATURES_SM90 = {
    "attention_sm90_forward": ([_P] * 6 + [_I] * 6 + [_F, _P], _I),
    "attention_sm90_backward": ([_P] * 10 + [_I] * 6 + [_F, _P], _I),
    "attention_sm90_block_update": ([_P] * 9 + [_I] * 5 + [_LL, _LL, _I, _F, _P], _I),
    "attention_sm90_error_string": ([_I], ctypes.c_char_p),
}

#: K8 and K8' on the tensor cores (bf16, rounded probabilities), and K8's
#: block form in bf16
LIBRARY_SM90 = cuda_build.CudaLibrary("attention_sm90", _SRC_SM90, NVCC_FLAGS,
                                      _SIGNATURES_SM90)

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


def _check(lib, rc: int, kernel: str, error_string: str = "model_error_string") -> None:
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode(errors="replace")
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
    are not modified. A fully masked block leaves the state as it is. On
    the card bf16 goes to the tensor cores (``_block_update_route``), each
    such launch also counted in ``launches_tc``."""
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
    tc = _block_update_route(q) == "wgmma"
    lib = LIBRARY_SM90.load() if tc else LIBRARY.load()
    o_out, m_out, l_out = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), o_out.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
            B, Sq, k.shape[1], H, Dh, q_off, k_off, int(bool(causal)), float(scale))
    with torch.cuda.device(dev):
        if tc:
            rc = lib.attention_sm90_block_update(*args, current_stream(dev))
        else:
            rc = lib.model_block_update(*args, dt, current_stream(dev))
    _check(lib, rc, "block_update",
           "attention_sm90_error_string" if tc else "model_error_string")
    block_update.launches += 1
    block_update.launches_tc += tc
    return o_out, m_out, l_out


block_update.launches = 0
block_update.launches_tc = 0


def _block_update_route(q) -> str:
    """Which kernel serves K8's block form for q on the card: "wgmma"
    (attention_sm90.cu, the tensor cores) for bf16, whose float32 P·V it
    takes as two bf16 parts of P (_split_bf16), their products with V
    summed in float32; "cuda_core" (model_kernels.cu) for float32, whose products
    the reference takes in full float32."""
    return "wgmma" if q.dtype == torch.bfloat16 else "cuda_core"


def _causal_mask(Sq, Sk, device):
    return torch.arange(Sq, device=device)[:, None] >= torch.arange(Sk, device=device)[None, :]


def _attention_rounded_plain(q, k, v, causal):
    """The reference's _attention step by step, returning (out, m, l): the
    logits in float32 times the scale, -1e30 where masked, m their row max,
    e = exp(logits - m), l = sum(e), p = e / l rounded to q's dtype, and
    p·V summed in float32 and rounded once (a bf16 product with a bf16
    result)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        logits = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), logits, NEG_INF)
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    p = (e / l[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    return out, m, l


def _attention_plain(q, k, v, causal=True, round_probs=False):
    """Plain version of K8's whole form. round_probs=False:
    _ring_attention_local on one device (one block step from the empty
    state, then o / max(l, 1e-30)); round_probs=True: the reference's
    _attention (_attention_rounded_plain)."""
    if round_probs:
        return _attention_rounded_plain(q, k, v, causal)[0]
    B, Sq, H, Dh = q.shape
    o = torch.zeros((B, Sq, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o, m, l = _block_update_plain(q, k, v, o, m, l, 0, 0, causal, 1.0 / math.sqrt(Dh))
    l = torch.clamp_min(l, 1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _attention_route(q, round_probs) -> str:
    """Which kernel serves K8 (and, with round_probs=True, K8') for q on
    the card: "wgmma" (attention_sm90.cu, the tensor cores) for bf16 with
    the probabilities rounded, whose products are exactly bf16 operands
    summed in float32; "cuda_core" (model_kernels.cu) for float32, whose
    products the reference takes in full float32, and for bf16 with
    round_probs=False, whose P·V is a float32 product."""
    return "wgmma" if q.dtype == torch.bfloat16 and round_probs else "cuda_core"


def _attention_launch(q, k, v, causal, round_probs, stats):
    """K8's whole form on the card: the output, and with `stats` the rows'
    m and l ([B, H, Sq] float32) for the backward."""
    dev = q.device
    dt = _check_attention_shapes("attention", q, k, v)
    _check_layout("attention", q, k, v)
    B, Sq, H, Dh = q.shape
    tc = _attention_route(q, round_probs) == "wgmma"
    lib = LIBRARY_SM90.load() if tc else LIBRARY.load()
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr() if stats else None, l.data_ptr() if stats else None,
            B, Sq, k.shape[1], H, Dh, int(bool(causal)), 1.0 / math.sqrt(Dh))
    with torch.cuda.device(dev):
        if tc:
            rc = lib.attention_sm90_forward(*args, current_stream(dev))
        else:
            rc = lib.model_attention(*args, dt, current_stream(dev))
    _check(lib, rc, "attention", "attention_sm90_error_string" if tc else "model_error_string")
    attention.launches += 1
    attention.launches_tc += tc
    return out, m, l


class _Attention(torch.autograd.Function):
    """K8 with round_probs=True and K8' as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, m, l = _attention_rounded_plain(q, k, v, causal)
        else:
            out, m, l = _attention_launch(q, k, v, causal, True, stats=True)
        ctx.save_for_backward(q, k, v, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, dout.contiguous(), m, l, ctx.causal)
        return dq, dk, dv, None


def attention(q, k, v, causal=True, round_probs=False):
    """K8, whole form. Attention of q [B,Sq,H,Dh] over k, v [B,Sk,H,Dh]
    (queries and keys both from position 0; causal: query i sees keys
    <= i), scale 1/sqrt(Dh), softmax in float32; the result in q's dtype.
    round_probs=False: equal to reference_attention, no gradient.
    round_probs=True: the reference's transformer._attention, the
    probabilities rounded to q's dtype before P·V; differentiable, its
    backward K8' (attention_bwd)."""
    dev = device_of(q, k, v)
    causal = bool(causal)
    if round_probs:
        return _Attention.apply(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("attention: the gradient is written for round_probs=True only")
    if dev.type == "cpu":
        return _attention_plain(q, k, v, causal)
    return _attention_launch(q, k, v, causal, False, stats=False)[0]


attention.launches = 0
attention.launches_tc = 0


def _attention_bwd_plain(q, k, v, dout, m, l, causal):
    """Plain version of K8': the gradient of the reference's _attention as
    its jax.grad jaxpr computes it, from the forward's m and l. dP = dO·V^T
    rounded to the dtype; Dt = sum_j (dP * (1 / (l * l))) * e; dS = ((dP / l)
    - Dt) * e, zero where masked, times the scale; dV = round(p)^T·dO, dQ =
    dS·K, dK = dS^T·Q, each summed in float32 and rounded once."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    if causal:
        logits = torch.where(mask, logits, NEG_INF)
    e = torch.exp(logits - m[..., None])
    pb = (e / l[..., None]).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float()).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb.float(), dout.float()).to(dt)
    rinv2 = 1.0 / (l * l)
    dsum = ((dp * rinv2[..., None]) * e).sum(dim=-1)
    ds = (dp / l[..., None] - dsum[..., None]) * e
    if causal:
        ds = torch.where(mask, ds, 0.0)
    ds = ds * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dt)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dt)
    return dq, dk, dv


def _split_bf16(x):
    """Plain version of the tensor-core K8''s split of the float32 dS
    before its products with K and Q: hi = bf16(x), lo = bf16(x - hi), so
    that hi + lo is x within 2**-16 of |x| and hi·K + lo·K, both bf16
    products summed in float32, is x·K within float32 rounding."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def attention_bwd(q, k, v, dout, m, l, causal=True):
    """K8'. The gradient of attention(q, k, v, causal, round_probs=True)
    for the cotangent dout (q's shape and dtype), from the forward's m and
    l ([B, H, Sq] float32). Returns dq, dk, dv in q's dtype."""
    dev = device_of(q, k, v, dout, m, l)
    if dev.type == "cpu":
        return _attention_bwd_plain(q, k, v, dout, m, l, causal)
    dt = _check_attention_shapes("attention_bwd", q, k, v)
    B, Sq, H, Dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or m.shape != (B, H, Sq) \
            or l.shape != (B, H, Sq) or {m.dtype, l.dtype} != {torch.float32}:
        raise ValueError(f"attention_bwd: dout {tuple(dout.shape)} {dout.dtype}, m "
                         f"{tuple(m.shape)} {m.dtype}, l {tuple(l.shape)} {l.dtype} "
                         "(dout as q, float32 [B,H,Sq] m and l needed)")
    if Dh not in (16, 32, 64, 128):
        raise ValueError(f"attention_bwd: head width {Dh} (16, 32, 64 or 128 needed)")
    _check_layout("attention_bwd", q, k, v, dout, m, l)
    tc = _attention_route(q, True) == "wgmma"
    lib = LIBRARY_SM90.load() if tc else LIBRARY.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(m)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), m.data_ptr(),
            l.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, k.shape[1], H, Dh, int(bool(causal)), 1.0 / math.sqrt(Dh))
    with torch.cuda.device(dev):
        if tc:
            rc = lib.attention_sm90_backward(*args, current_stream(dev))
        else:
            rc = lib.model_attention_bwd(*args, dt, current_stream(dev))
    _check(lib, rc, "attention_bwd", "attention_sm90_error_string" if tc else "model_error_string")
    attention_bwd.launches += 1
    attention_bwd.launches_tc += tc
    return dq, dk, dv


attention_bwd.launches = 0
attention_bwd.launches_tc = 0


# ------------------------------------------------------------------ K10a


def _rmsnorm_plain(x, scale):
    """Plain version of K10a, the reference's two roundings included."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + RMS_EPS)).to(x.dtype) * scale.to(x.dtype)


def _check_rmsnorm(what, x, scale):
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32 or D % 4 or x.numel() == 0:
        raise ValueError(f"{what}: x {tuple(x.shape)}, scale {tuple(scale.shape)} "
                         f"{scale.dtype} (float32 [D], D a multiple of 4, needed)")
    return _dtype_code(x, what)


def _rmsnorm_launch(x, scale):
    dev = x.device
    dt = _check_rmsnorm("rmsnorm", x, scale)
    _check_layout("rmsnorm", x, scale)
    D = x.shape[-1]
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.model_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               x.numel() // D, D, dt, current_stream(dev))
    _check(lib, rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


class _RmsNorm(torch.autograd.Function):
    """K10a and K10a' as its backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _rmsnorm_plain(x, scale) if x.device.type == "cpu" else _rmsnorm_launch(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return rmsnorm_bwd(x, scale, dy.contiguous())


def rmsnorm(x, scale):
    """K10a. x [..., D] (bf16 or f32), scale [D] float32:
    (x * rsqrt(mean(x_f32 ** 2) + 1e-6)).astype(x.dtype) * scale.astype(x.dtype).
    Differentiable in x and scale; the backward is K10a' (rmsnorm_bwd)."""
    device_of(x, scale)
    return _RmsNorm.apply(x, scale)


rmsnorm.launches = 0


def _rmsnorm_bwd_plain(x, scale, dy):
    """Plain version of K10a': the gradient of _rmsnorm with its jaxpr's
    roundings. With j = mean(x_f32 ** 2) + 1e-6 and r = rsqrt(j): dn =
    round(dy * round(scale)); dx = round(round(dn * r) + round(((sum(x *
    dn) * (-0.5 * (r / j))) / D) * (2 x))); dscale = the sum over rows of
    round(round(x * r) * dy). The reference types that sum in the dtype
    and XLA accumulates it in an order of its own; here it is taken in
    float32 and rounded once to the dtype, then widened."""
    dt, D = x.dtype, x.shape[-1]
    xf = x.float()
    j = xf.square().sum(dim=-1, keepdim=True) / D + RMS_EPS
    r = torch.rsqrt(j)
    mm = -0.5 * (r / j)
    dn = (dy.float() * scale.to(dt).float()).to(dt).float()
    coef = ((xf * dn).sum(dim=-1, keepdim=True) * mm) / D
    dx = ((dn * r).to(dt).float() + (coef * (2.0 * xf)).to(dt).float()).to(dt)
    n = (xf * r).to(dt).float()
    dscale = (n * dy.float()).to(dt).float().reshape(-1, D).sum(dim=0).to(dt).float()
    return dx, dscale


_NORM_BWD_BLOCKS = {}  # (device index, rows, D, dtype) -> the grid of K10a', asked once


def rmsnorm_bwd_blocks(rows: int, D: int, dtype: torch.dtype, device) -> int:
    """The blocks of K10a' (one cooperative launch) for rows x D in `dtype`
    on `device` (a CUDA device): as many as the card holds at once, no more
    than the rows need (8 a block)."""
    dev = torch.device(device)
    key = (dev.index, rows, D, dtype)
    if key not in _NORM_BWD_BLOCKS:
        lib = LIBRARY.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.model_rmsnorm_bwd_blocks(rows, D, _DTYPE_CODES[dtype],
                                              ctypes.addressof(out))
        _check(lib, rc, "rmsnorm_bwd (grid)")
        _NORM_BWD_BLOCKS[key] = out.value
    return _NORM_BWD_BLOCKS[key]


def rmsnorm_bwd(x, scale, dy):
    """K10a'. The gradient of rmsnorm(x, scale) for the cotangent dy (x's
    shape and dtype): dx in x's dtype, dscale [D] float32. One kernel a
    call on the card."""
    dev = device_of(x, scale, dy)
    if dev.type == "cpu":
        return _rmsnorm_bwd_plain(x, scale, dy)
    dt = _check_rmsnorm("rmsnorm_bwd", x, scale)
    D = x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or D > 4096:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype} (dy as x, D <= 4096, needed)")
    _check_layout("rmsnorm_bwd", x, scale, dy)
    rows = x.numel() // D
    blocks = rmsnorm_bwd_blocks(rows, D, x.dtype, dev)
    lib = LIBRARY.load()
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, D), dtype=torch.float32, device=dev)
    dscale = torch.empty((D,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.model_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                                   dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                                   rows, D, blocks, dt, current_stream(dev))
    _check(lib, rc, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0


# ------------------------------------------------------------------ K10b


def _rope_cos_sin(S, Dh, theta, dtype, device):
    """cos and sin [1, S, 1, Dh / 2] rounded to dtype, as the reference's
    _rope computes them."""
    half = Dh // 2
    i = -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=device)
    # divided by a tensor: on CUDA a division by a Python number multiplies by
    # its reciprocal, which is not the IEEE quotient where half is no power of 2
    freqs = torch.exp(i / torch.full_like(i, half))
    pos = torch.arange(S, dtype=torch.float32, device=device)
    angles = pos[:, None] * freqs[None, :]
    return (torch.cos(angles)[None, :, None, :].to(dtype),
            torch.sin(angles)[None, :, None, :].to(dtype))


def _rope_plain(x, theta: float):
    """The reference's _rope: rotate-half rotary embedding over the last dim
    of x [B, S, H, Dh], positions 0..S-1, cos and sin rounded to x's dtype."""
    _, S, _, Dh = x.shape
    half = Dh // 2
    cos, sin = _rope_cos_sin(S, Dh, theta, x.dtype, x.device)
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


def _check_rope(what, qkv, n_heads):
    if qkv.dim() != 3 or qkv.shape[2] % (3 * n_heads) or (qkv.shape[2] // (3 * n_heads)) % 2 \
            or qkv.numel() == 0:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} with {n_heads} heads "
                         "([B, S, 3 * H * Dh] with Dh even needed)")


def _rope_split_launch(qkv, n_heads, theta):
    dev = qkv.device
    dt = _dtype_code(qkv, "rope_split")
    _check_rope("rope_split", qkv, n_heads)
    if not qkv.is_contiguous():
        raise ValueError("rope_split: qkv must be contiguous")
    B, S, D3 = qkv.shape
    Dh = D3 // 3 // n_heads
    lib = LIBRARY.load()
    q, k, v = (torch.empty((B, S, n_heads, Dh), dtype=qkv.dtype, device=dev)
               for _ in range(3))
    # the C entry picks the form: 16-byte rows where the head width and
    # every pointer allow (rope_split_form), else one scalar pair a thread
    with torch.cuda.device(dev):
        rc = lib.model_rope_split(qkv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  B, S, n_heads, Dh, -math.log(theta), dt,
                                  current_stream(dev))
    _check(lib, rc, "rope_split")
    rope_split.launches += 1
    return q, k, v


class _RopeSplit(torch.autograd.Function):
    """K10b and K10b' as its backward."""

    @staticmethod
    def forward(ctx, qkv, n_heads, theta):
        ctx.theta = theta
        if qkv.device.type == "cpu":
            q, k, v = _rope_split_plain(qkv, n_heads, theta)
            return q, k, v.contiguous()  # a copy, as the kernel's, not a view of qkv
        return _rope_split_launch(qkv, n_heads, theta)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        grads = [torch.zeros_like(g) if g is None else g.contiguous() for g in (dq, dk, dv)]
        return rope_split_bwd(*grads, ctx.theta), None, None


def rope_split_form(qkv, n_heads: int) -> str:
    """The form of K10b that rope_split launches for this CUDA qkv: "rows"
    (16-byte vectors, a row's cos and sin computed once) where a half-head
    is a whole number of 16-byte vectors and qkv is 16-byte aligned (the
    outputs always are), else "scalar"."""
    _check_rope("rope_split", qkv, n_heads)
    Dh = qkv.shape[2] // 3 // n_heads
    rows = LIBRARY.load().model_rope_split_form(  # the outputs: fresh, so aligned
        qkv.data_ptr(), None, None, None, Dh, _dtype_code(qkv, "rope_split"))
    return "rows" if rows else "scalar"


def rope_split(qkv, n_heads: int, theta: float):
    """K10b. qkv [B, S, 3D] (bf16 or f32) -> q, k, v [B, S, H, Dh] with the
    rotary embedding applied to q and k (rotate-half: x1 the first half of
    each head's dims), positions 0..S-1. Differentiable in qkv; the
    backward is K10b' (rope_split_bwd)."""
    device_of(qkv)
    return _RopeSplit.apply(qkv, n_heads, theta)


rope_split.launches = 0


def _rope_bwd_plain(dy, theta: float):
    """The gradient of _rope for dy [B, S, H, Dh]: dx1 = dy2 sin + dy1 cos,
    dx2 = dy2 cos - dy1 sin, each product and sum rounded to the dtype."""
    _, S, _, Dh = dy.shape
    half = Dh // 2
    cos, sin = _rope_cos_sin(S, Dh, theta, dy.dtype, dy.device)
    d1, d2 = dy[..., :half], dy[..., half:]
    return torch.cat([d2 * sin + d1 * cos, d2 * cos - d1 * sin], dim=-1)


def _rope_split_bwd_plain(dq, dk, dv, theta: float):
    """Plain version of K10b': dq, dk, dv [B, S, H, Dh] -> dqkv [B, S, 3D]."""
    B, S, H, Dh = dq.shape
    return torch.cat([_rope_bwd_plain(dq, theta).reshape(B, S, H * Dh),
                      _rope_bwd_plain(dk, theta).reshape(B, S, H * Dh),
                      dv.reshape(B, S, H * Dh)], dim=-1)


def _check_rope_bwd(dq, dk, dv) -> int:
    dt = _dtype_code(dq, "rope_split_bwd")
    if dq.dim() != 4 or dk.shape != dq.shape or dv.shape != dq.shape or dq.shape[3] % 2 \
            or dq.numel() == 0 or dk.dtype != dq.dtype or dv.dtype != dq.dtype:
        raise ValueError(f"rope_split_bwd: dq {tuple(dq.shape)}, dk {tuple(dk.shape)}, dv "
                         f"{tuple(dv.shape)} (one [B, S, H, Dh] shape and dtype, Dh even)")
    return dt


#: the widest half-head K10b's and K10b''s rows forms take (kRopeMaxHalf)
ROPE_MAX_HALF = 256


def rope_split_bwd_form(dq, dk, dv) -> str:
    """The form of K10b' that rope_split_bwd launches for these cotangents:
    "rows" (16-byte vectors, a row's cos and sin computed once) where a
    half-head is a whole number of 16-byte vectors no wider than
    ROPE_MAX_HALF and dq, dk, dv are 16-byte aligned (dqkv always is), else
    "scalar". The host-side mirror of the source's rule
    (model_rope_split_bwd_form), so it answers for CPU tensors too; the
    `cuda` test holds the two together."""
    _check_rope_bwd(dq, dk, dv)
    half = dq.shape[3] // 2
    rows = (half * dq.element_size()) % 16 == 0 and half <= ROPE_MAX_HALF \
        and all(t.data_ptr() % 16 == 0 for t in (dq, dk, dv))
    return "rows" if rows else "scalar"


def rope_split_bwd(dq, dk, dv, theta: float):
    """K10b'. The gradient of rope_split for the cotangents dq, dk, dv
    [B, S, H, Dh]: dqkv [B, S, 3 H Dh] in their dtype. ``launches_rows``
    counts the launches that took the rows form."""
    dev = device_of(dq, dk, dv)
    if dev.type == "cpu":
        return _rope_split_bwd_plain(dq, dk, dv, theta)
    dt = _check_rope_bwd(dq, dk, dv)
    for t in (dq, dk, dv):  # a misaligned view takes the scalar form
        if not t.is_contiguous():
            raise ValueError("rope_split_bwd: dq, dk, dv must be contiguous")
    B, S, H, Dh = dq.shape
    lib = LIBRARY.load()
    dqkv = torch.empty((B, S, 3 * H * Dh), dtype=dq.dtype, device=dev)
    ptrs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqkv.data_ptr())
    # the C entry picks the form: 16-byte rows where the head width and
    # every pointer allow (rope_split_bwd_form), else one scalar pair a thread
    rows = lib.model_rope_split_bwd_form(*ptrs, Dh, dt)
    with torch.cuda.device(dev):
        rc = lib.model_rope_split_bwd(*ptrs, B, S, H, Dh, -math.log(theta), dt,
                                      current_stream(dev))
    _check(lib, rc, "rope_split_bwd")
    rope_split_bwd.launches += 1
    rope_split_bwd.launches_rows += bool(rows)
    return dqkv


rope_split_bwd.launches = 0
rope_split_bwd.launches_rows = 0

#: the kernels of this module by name, each with its `launches` counter
KERNELS = {
    "block_update": block_update,
    "attention": attention,
    "rmsnorm": rmsnorm,
    "rope_split": rope_split,
    "attention_bwd": attention_bwd,
    "rmsnorm_bwd": rmsnorm_bwd,
    "rope_split_bwd": rope_split_bwd,
}


#: the kernels that count their tensor-core launches in `launches_tc`
TC_KERNELS = ("block_update", "attention", "attention_bwd")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def tc_launch_counts() -> dict:
    """The launches of K8 (both forms) and K8' that went to the tensor-core
    kernels."""
    return {name: KERNELS[name].launches_tc for name in TC_KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in TC_KERNELS:
        KERNELS[name].launches_tc = 0
    rope_split_bwd.launches_rows = 0
