"""The backward of ray_tpu_torch's model kernels (plain versions, on the CPU)
held against jax.vjp of ray_tpu.models.transformer's _attention, _rmsnorm,
and _rope with the qkv split, on the same numpy-seeded inputs and
cotangents; and repair A.1, the forward's probabilities rounded to bf16 as
the reference's _attention rounds them.

Each plain backward is the gradient written out with the roundings of the
reference's jax.grad jaxpr. Tolerances, as measured here:
- float32: rtol 1e-5, atol 1e-5 (measured: within 2e-7 of the largest
  entry; the same arithmetic summed in another order).
- bfloat16: a share of outputs bit-equal to JAX's and a max abs error.
  Attention dq / dk / dv: >= 99.9 % equal, max 1e-4 (measured 99.98 % /
  99.98 % / 100 %, max 7.6e-6: a last-bit flip of dP before its rounding).
  RMSNorm dx and RoPE dqkv: >= 99.9 % equal, max 1e-2 (measured 100 %).
  RMSNorm dscale: the jaxpr sums it in bf16 and XLA accumulates that sum in
  an order of its own, which no float32 sum reproduces; the port sums in
  float32 and rounds once. Within 2 % of the largest entry (measured 0.6 %).
The autograd Functions (attention with round_probs=True, rmsnorm,
rope_split) give the plain backward's values bit for bit. The
`cuda`-marked test holds each kernel against its plain version on the card
and two launches against each other bit for bit; it skips here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu_torch.models import kernels as K
from test_torch_model_kernels import ROPE_HEAD_WIDTHS

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
# bf16: (share of outputs bit-equal to JAX's, max abs error)
ATTN_BF16 = (0.999, 1e-4)
ELEMENTWISE_BF16 = (0.999, 1e-2)
DSCALE_BF16_REL = 0.02


def _np(x):
    if isinstance(x, jax.Array):
        return np.asarray(x.astype(jnp.float32))
    return x.detach().float().numpy()


def _pair(a, dt):
    """The same numbers as a JAX array and a torch tensor of dtype dt."""
    jd, td = DTYPES[dt]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(got, want, dt, bf16_tol, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    if dt == "f32":
        np.testing.assert_allclose(g, w, err_msg=what, **TOL_F32)
        return
    share, max_abs = bf16_tol
    assert (g == w).mean() >= share, f"{what}: {(g == w).mean()} bit-equal"
    assert np.abs(g - w).max() <= max_abs, f"{what}: max abs {np.abs(g - w).max()}"


def _jax_attention(dt):
    cfg = JT.TransformerConfig(dtype=DTYPES[dt][0])
    return lambda q, k, v: JT._attention(q, k, v, cfg)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [64, 37])
def test_attention_grads_match_jax(S, dt):
    rng = np.random.default_rng(20 + S)
    q, k, v, do = (rng.standard_normal((2, S, 2, 32)).astype(np.float32) for _ in range(4))
    (qj, qt), (kj, kt), (vj, vt), (dj, dot) = (_pair(a, dt) for a in (q, k, v, do))
    out_j, vjp = jax.vjp(_jax_attention(dt), qj, kj, vj)
    want = vjp(dj)
    out, m, l = K._attention_rounded_plain(qt, kt, vt, True)
    _close(out, out_j, dt, ATTN_BF16, "forward")
    got = K.attention_bwd(qt, kt, vt, dot, m, l, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == qt.dtype, name
        _close(g, w, dt, ATTN_BF16, name)
    # the autograd Function: the same bits as the plain backward
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    y = K.attention(*leaves, causal=True, round_probs=True)
    assert torch.equal(y.detach(), out)
    y.backward(dot)
    for name, leaf, g in zip(("dq", "dk", "dv"), leaves, got):
        assert torch.equal(leaf.grad, g), name


def test_attention_softmax_gradient_keeps_the_reference_form():
    """Dt = sum_j (dP * l**-2) * e, JAX's form on the rounded dP, and not
    rowsum(dO * O): with the probabilities rounded to bf16, O is no longer
    P·V in float32, and the rowsum form moves dq off JAX's by ~1e-2
    (measured: 72 % bit-equal against 99.99 % for the kept form)."""
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32) for _ in range(4))
    (qj, qt), (kj, kt), (vj, vt), (dj, dot) = (_pair(a, "bf16") for a in (q, k, v, do))
    want = _np(jax.vjp(_jax_attention("bf16"), qj, kj, vj)[1](dj)[0])
    out, m, l = K._attention_rounded_plain(qt, kt, vt, True)
    kept = _np(K.attention_bwd(qt, kt, vt, dot, m, l)[0])
    scale = 1.0 / math.sqrt(32)
    mask = K._causal_mask(64, 64, qt.device)
    logits = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qt.float(), kt.float()) * scale,
                         K.NEG_INF)
    p = torch.exp(logits - m[..., None]) / l[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dot.float(), vt.float()).bfloat16().float()
    rowsum = (dot.float() * out.float()).sum(-1).transpose(1, 2)
    ds = torch.where(mask, p * (dp - rowsum[..., None]), 0.0) * scale
    other = _np(torch.einsum("bhqk,bkhd->bqhd", ds, kt.float()).bfloat16())
    assert (kept == want).mean() >= 0.999
    assert (other == want).mean() < 0.9
    assert np.abs(kept - want).max() * 100 < np.abs(other - want).max()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rmsnorm_grads_match_jax(dt):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((64, 64)) * 3).astype(np.float32)
    scale = (1.0 + 0.5 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((64, 64)).astype(np.float32)
    (xj, xt), (dyj, dyt) = _pair(x, dt), _pair(dy, dt)
    sj, st = jnp.asarray(scale), torch.from_numpy(scale)
    want_dx, want_ds = jax.vjp(JT._rmsnorm, xj, sj)[1](dyj)
    dx, ds = K.rmsnorm_bwd(xt, st, dyt)
    assert dx.dtype == xt.dtype and ds.dtype == torch.float32 and ds.shape == (64,)
    _close(dx, want_dx, dt, ELEMENTWISE_BF16, "dx")
    if dt == "f32":
        np.testing.assert_allclose(_np(ds), _np(want_ds), **TOL_F32)
    else:
        w = _np(want_ds)
        assert np.abs(_np(ds) - w).max() <= DSCALE_BF16_REL * np.abs(w).max()
    xl, sl = xt.clone().requires_grad_(True), st.clone().requires_grad_(True)
    K.rmsnorm(xl, sl).backward(dyt)
    assert torch.equal(xl.grad, dx) and torch.equal(sl.grad, ds)


def _jax_rope_split(H, Dh):
    def f(qkv):
        B, S, _ = qkv.shape
        q, k, v = jnp.split(qkv, 3, axis=-1)
        return (JT._rope(q.reshape(B, S, H, Dh), 10000.0),
                JT._rope(k.reshape(B, S, H, Dh), 10000.0), v.reshape(B, S, H, Dh))
    return f


# (S, Dh): every head width the card's test runs (K10b''s rows form where a
# half-head is whole 16-byte vectors, the scalar form at Dh = 20) at S = 31
# and 300, but Dh = 128 at S = 31 only. There the reference's frequency
# table is not the port's: XLA:CPU's exp misses the correctly rounded value
# in 10 of the 64 frequencies (torch's in 1), by up to 2.98e-8, which moves
# an f32 gradient by ~1.2e-7 a position: past the 1e-5 tolerance from
# position ~80 (measured 3.7e-5 at S = 300). The card's test holds K10b' to
# the plain version at Dh = 128, S = 2047.
ROPE_GRAD_CASES = [(S, Dh) for S in (300, 31) for Dh in ROPE_HEAD_WIDTHS
                   if (S, Dh) != (300, 128)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S,Dh", ROPE_GRAD_CASES)
def test_rope_split_grads_match_jax(S, Dh, dt):
    """Positions up to S - 1: angles reach ~300 rad in the fastest pair."""
    rng = np.random.default_rng(22 + S + Dh)
    B, H = 2, 2
    qkv = rng.standard_normal((B, S, 3 * H * Dh)).astype(np.float32)
    cot = [rng.standard_normal((B, S, H, Dh)).astype(np.float32) for _ in range(3)]
    qkvj, qkvt = _pair(qkv, dt)
    pairs = [_pair(c, dt) for c in cot]
    want = jax.vjp(_jax_rope_split(H, Dh), qkvj)[1](tuple(p[0] for p in pairs))[0]
    got = K.rope_split_bwd(*(p[1] for p in pairs), 10000.0)
    assert got.dtype == qkvt.dtype
    _close(got, want, dt, ELEMENTWISE_BF16, "dqkv")
    leaf = qkvt.clone().requires_grad_(True)
    outs = K.rope_split(leaf, H, 10000.0)
    torch.autograd.backward(outs, [p[1] for p in pairs])
    assert torch.equal(leaf.grad, got)
    # an unused output (no cotangent) counts as zeros
    leaf = qkvt.clone().requires_grad_(True)
    K.rope_split(leaf, H, 10000.0)[0].backward(pairs[0][1])
    zeros = torch.zeros_like(pairs[0][1])
    assert torch.equal(leaf.grad, K.rope_split_bwd(pairs[0][1], zeros, zeros, 10000.0))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_rope_split_bwd_form_follows_head_width_and_alignment(dt):
    """K10b''s form as the source picks it (rope_split_bwd_form is its
    host-side mirror; the `cuda` test holds the two together): rows where a
    half-head is whole 16-byte vectors no wider than 256 and dq, dk, dv are
    16-byte aligned; scalar at Dh = 20, past 256 a half, for bf16 at
    Dh = 8 (an 8-byte half) and for any view one element into its
    storage."""
    def grads(Dh, offset=0):
        n = 2 * 3 * 2 * Dh
        bufs = [torch.zeros(n + 16, dtype=dt) for _ in range(3)]
        return [b[offset:offset + n].view(2, 3, 2, Dh) for b in bufs]

    assert all(t.data_ptr() % 16 == 0 for t in grads(64))
    for Dh in (16, 32, 64, 128, 512):
        assert K.rope_split_bwd_form(*grads(Dh)) == "rows", Dh
        assert K.rope_split_bwd_form(*grads(Dh, offset=1)) == "scalar", Dh
        g = grads(Dh)
        g[2] = grads(Dh, offset=1)[2]  # one misaligned cotangent is enough
        assert K.rope_split_bwd_form(*g) == "scalar", Dh
    for Dh in (20, 2 * (K.ROPE_MAX_HALF + 8)):
        assert K.rope_split_bwd_form(*grads(Dh)) == "scalar", Dh
    assert K.rope_split_bwd_form(*grads(8)) == ("scalar" if dt == torch.bfloat16 else "rows")
    with pytest.raises(ValueError, match="Dh even"):
        K.rope_split_bwd_form(*grads(7))


def test_repaired_attention_rounds_probabilities_as_the_reference():
    """Repair A.1 at [2, 512, 8, 64] bf16, standard normal x 2 from seed 0:
    the port's transformer._attention bit-equal to JAX's _attention on at
    least 99.9 % of outputs, mean abs diff at most 1e-5 (measured 99.96 %,
    1.8e-6). The float32-probability form (round_probs=False, the
    reference's reference_attention) meets neither (measured 66.1 %,
    1.3e-3)."""
    from ray_tpu_torch.models import transformer as PT

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 512, 8, 64)) * 2 for _ in range(3))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bf16") for a in (q, k, v))
    want = _np(JT._attention(qj, kj, vj, JT.TransformerConfig()))
    got = _np(PT._attention(qt, kt, vt, PT.TransformerConfig()))
    assert (got == want).mean() >= 0.999
    assert np.abs(got - want).mean() <= 1e-5
    old = _np(K.attention(qt, kt, vt, causal=True, round_probs=False))
    assert (old == want).mean() < 0.9 and np.abs(old - want).mean() > 1e-4


def test_unrounded_attention_has_no_gradient():
    q = torch.zeros((1, 8, 1, 16), requires_grad=True)
    with pytest.raises(ValueError, match="round_probs=True"):
        K.attention(q, q, q)
    with torch.no_grad():
        K.attention(q, q, q)


# kernel vs plain on the card: (rtol, atol as a share of the largest
# entry). float32: summation order; bfloat16: one rounding of the output,
# and dP's own rounding, which a last-bit difference in its float32 sum can
# flip
CUDA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2e-3)}


def _assert_kernel_close(got, want, what):
    rtol, share = CUDA_TOL[want.dtype]
    got, want = got.double(), want.double()
    atol = share * float(want.abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bool(bad.any()), f"{what}: max abs {float((got - want).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_cuda_backward_kernels_equal_plain_and_are_deterministic(Dh):
    """On the card: K8 (round_probs=True, with its m and l), K8', K10a' and
    K10b' against their plain versions at small shapes (ragged S = 100 and
    2047, causal and not), in bf16 (K8 and K8' on the tensor cores, every
    launch counted there) and f32 (the CUDA cores, none counted there); a
    second launch of K8 and of K8' gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)

    def rnd(shape, td, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev, td)

    for td in (torch.float32, torch.bfloat16):
        tc_each = 1 if td == torch.bfloat16 else 0
        for B, S, H in ((2, 100, 3), (1, 2047, 2)):
            q, k, v, do = (rnd((B, S, H, Dh), td) for _ in range(4))
            for causal in (True, False):
                tc0 = K.tc_launch_counts()
                out, m, l = K._attention_launch(q, k, v, causal, True, stats=True)
                again = K._attention_launch(q, k, v, causal, True, stats=True)
                p_out, p_m, p_l = K._attention_rounded_plain(q, k, v, causal)
                for name, g, w, a in zip(("attention", "m", "l"), (out, m, l), (p_out, p_m, p_l),
                                         again):
                    _assert_kernel_close(g, w, f"{name} S={S} causal={causal}")
                    assert torch.equal(g, a), name
                got = K.attention_bwd(q, k, v, do, m, l, causal)
                want = K._attention_bwd_plain(q, k, v, do, m, l, causal)
                again = K.attention_bwd(q, k, v, do, m, l, causal)
                for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                    _assert_kernel_close(g, w, f"attention_bwd {name} S={S} causal={causal}")
                    assert torch.equal(g, a), name
                tc1 = K.tc_launch_counts()
                assert tc1["attention"] - tc0["attention"] == 2 * tc_each
                assert tc1["attention_bwd"] - tc0["attention_bwd"] == 2 * tc_each
        if Dh != 64:
            continue
        x, dy = rnd((130, 512), td, 3.0), rnd((130, 512), td)
        s = rnd((512,), torch.float32)
        got = K.rmsnorm_bwd(x, s, dy)
        for g, w, a in zip(got, K._rmsnorm_bwd_plain(x, s, dy), K.rmsnorm_bwd(x, s, dy)):
            _assert_kernel_close(g, w, "rmsnorm_bwd")
            assert torch.equal(g, a)
        dq, dk, dv = (rnd((2, 100, 8, 64), td) for _ in range(3))
        got = K.rope_split_bwd(dq, dk, dv, 10000.0)
        _assert_kernel_close(got, K._rope_split_bwd_plain(dq, dk, dv, 10000.0), "rope_split_bwd")
        assert torch.equal(got, K.rope_split_bwd(dq, dk, dv, 10000.0))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", ROPE_HEAD_WIDTHS)
def test_cuda_rope_split_bwd_forms_equal_plain_and_each_other(Dh):
    """On the card: K10b' at S = 2047 in bf16 and f32 against its plain
    version. The rows form (16-byte vectors; counted in launches_rows)
    where a half-head is whole vectors and dq, dk, dv are aligned; the
    scalar form at Dh = 20 and for views one element into their storage,
    which gives the rows form's bits; rope_split_bwd_form agrees with the
    source's model_rope_split_bwd_form; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(60 + Dh)
    B, S, H = 2, 2047, 4
    n = B * S * H * Dh
    lib = K.LIBRARY.load()
    for td in (torch.bfloat16, torch.float32):
        bufs = [torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(dev, td)
                for _ in range(3)]
        grads = [b[:n].view(B, S, H, Dh) for b in bufs]
        shifted = [b[1:].view(B, S, H, Dh) for b in bufs]
        for sh, g in zip(shifted, grads):
            sh.copy_(g.clone())  # the same values, one element further on
        whole = (Dh // 2) * grads[0].element_size() % 16 == 0
        assert K.rope_split_bwd_form(*grads) == ("rows" if whole else "scalar")
        assert K.rope_split_bwd_form(*shifted) == "scalar"
        for ts in (grads, shifted):
            src = lib.model_rope_split_bwd_form(*(t.data_ptr() for t in ts), None, Dh,
                                                K._DTYPE_CODES[td])
            assert (K.rope_split_bwd_form(*ts) == "rows") == bool(src)
        grads = [sh.clone() for sh in shifted]  # aligned again
        rows0 = K.rope_split_bwd.launches_rows
        got = K.rope_split_bwd(*grads, 10000.0)
        assert K.rope_split_bwd.launches_rows == rows0 + whole
        _assert_kernel_close(got, K._rope_split_bwd_plain(*grads, 10000.0),
                             f"rope_split_bwd Dh={Dh} {td}")
        again = K.rope_split_bwd(*grads, 10000.0)
        other = K.rope_split_bwd(*shifted, 10000.0)
        assert K.rope_split_bwd.launches_rows == rows0 + 2 * whole
        assert torch.equal(got, again) and torch.equal(got, other)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 512, 1024, 4096])
@pytest.mark.parametrize("td", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_bwd_one_launch_equals_plain_and_is_deterministic(td, D):
    """On the card: K10a' (one cooperative launch; chip_smoke.py phase 9a
    counts its kernels) at rows {1, 63, 64, 65, 131, 16 384, 16 385} (a
    warp's row, a block's 8 and their ragged edges, the train step's rows
    and one more) against its plain version within the bound above, in the
    register form (D <= 1 024) and the looped one (D = 4 096); a second
    launch gives the same bits. dscale is compared in the dtype it was
    rounded to: in bf16 a float32 sum taken in another order may round to
    the neighbouring bf16 value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(D)
    for rows in (1, 63, 64, 65, 131, 16_384, 16_385):
        x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32) * 3).to(dev, td)
        dy = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).to(dev, td)
        s = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(dev)
        got = K.rmsnorm_bwd(x, s, dy)
        again = K.rmsnorm_bwd(x, s, dy)
        for name, g, w, a in zip(("dx", "dscale"), got, K._rmsnorm_bwd_plain(x, s, dy), again):
            assert torch.equal(g, a), f"{name} rows={rows} D={D}"
            _assert_kernel_close(g.to(td), w.to(td), f"rmsnorm_bwd {name} rows={rows} D={D}")
