"""ray_tpu_torch's model kernels (plain PyTorch versions, on the CPU) held
against ray_tpu's functions on the same numpy-seeded inputs.

K8 block_update against ray_tpu.parallel.ring_attention._block_update (the
state set by a first block, then a causal block below, on and above the
diagonal, a non-causal one, Sq != Sk); K8 attention against
reference_attention; the ring's schedule of block steps on one device
(_ring_schedule below; the port's ring_attention across ranks is
tests/test_torch_parallel.py's) against ray_tpu's ring_attention over a
4-device CPU mesh; K10a rmsnorm against
transformer._rmsnorm; K10b rope_split against the split and _rope.

Tolerances. float32: 1e-5 relative and absolute — the same arithmetic
summed in another order. bfloat16 activations: the float32 state of
block_update keeps 1e-5 (bf16 inputs widen exactly); an output rounded to
bfloat16 may differ by one rounding (2**-8 relative), so rtol 2**-7 with
atol 1e-3 (2e-2 for RoPE, whose cos and sin are themselves rounded). The
CUDA kernels are held against these plain versions on the card by
chip_smoke.py and by the `cuda`-marked test here.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.models import transformer as JT
from ray_tpu_torch.models import kernels as K
from ray_tpu_torch.parallel import ring_attention as PR

JR = importlib.import_module("ray_tpu.parallel.ring_attention")

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16_OUT = dict(rtol=2**-7, atol=1e-3)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def _pair(a, dt):
    """The same numpy array as a JAX array and a torch tensor of dtype dt."""
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _ring_schedule(q, k, v, n_shards, causal=True):
    """The ring's block steps on one device: the sequence cut into
    `n_shards` blocks; query block idx meets, at ring step t, the KV block
    of shard (idx - t) mod n_shards, as device idx of ray_tpu's ring does,
    through the port's _block_update; then o / max(l, 1e-30) in q's dtype."""
    B, S, H, Dh = q.shape
    Sb = S // n_shards
    scale = 1.0 / math.sqrt(Dh)
    outs = []
    for idx in range(n_shards):
        qb = q[:, idx * Sb:(idx + 1) * Sb].contiguous()
        o = torch.zeros((B, Sb, H, Dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Sb), K.NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Sb), dtype=torch.float32, device=q.device)
        for t in range(n_shards):
            src = (idx - t) % n_shards
            kb, vb = (x[:, src * Sb:(src + 1) * Sb].contiguous() for x in (k, v))
            o, m, l = PR._block_update(qb, kb, vb, o, m, l, idx * Sb, src * Sb, causal, scale)
        outs.append((o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def _qkv(rng, B, Sq, Sk, H, Dh):
    return (rng.standard_normal((B, Sq, H, Dh)).astype(np.float32),
            rng.standard_normal((B, Sk, H, Dh)).astype(np.float32),
            rng.standard_normal((B, Sk, H, Dh)).astype(np.float32))


# (q_off, k_off, causal, Sq, Sk) of the block under test; a first, fully
# visible block at k_off = -Sk0 sets m before it
BLOCK_CASES = {
    "causal_below_diagonal": (96, 32, True, 48, 40),
    "causal_on_diagonal": (40, 40, True, 48, 48),
    "causal_fully_masked": (10, 80, True, 48, 40),
    "not_causal": (0, 500, False, 48, 40),
    "sq_ne_sk": (64, 16, True, 33, 70),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_update_matches_reference(case, dt):
    q_off, k_off, causal, Sq, Sk = BLOCK_CASES[case]
    rng = np.random.default_rng(11)
    B, H, Dh, Sk0 = 2, 3, 16, 24
    q, k0, v0 = _qkv(rng, B, Sq, Sk0, H, Dh)
    _, k, v = _qkv(rng, B, Sq, Sk, H, Dh)
    scale = 1.0 / math.sqrt(Dh)
    (qj, qt), (k0j, k0t), (v0j, v0t) = (_pair(a, dt) for a in (q, k0, v0))
    (kj, kt), (vj, vt) = _pair(k, dt), _pair(v, dt)
    o = np.zeros((B, Sq, H, Dh), np.float32)
    m = np.full((B, H, Sq), K.NEG_INF, np.float32)
    l = np.zeros((B, H, Sq), np.float32)
    # the first block: keys before every query, so every row sees them
    state = JR._block_update(qj, k0j, v0j, jnp.asarray(o), jnp.asarray(m), jnp.asarray(l),
                             q_off, q_off - Sk0 - 1000, causal, scale)
    state = [np.array(x) for x in state]
    want = JR._block_update(qj, kj, vj, *map(jnp.asarray, state), q_off, k_off, causal, scale)
    got = K.block_update(qt, kt, vt, *map(torch.from_numpy, state), q_off, k_off, causal, scale)
    for name, w, g in zip("oml", want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL_F32)
    if case == "causal_fully_masked":
        # the reference's pmask: the state passes through unchanged
        for name, s, w, g in zip("oml", state, want, got):
            np.testing.assert_array_equal(np.asarray(w), s, err_msg=name)
            np.testing.assert_array_equal(g.numpy(), s, err_msg=name)


def test_block_update_from_empty_state_fully_masked_keeps_m_at_neg_inf():
    """exp(-1e30 - (-1e30)) = 1 must not leak weight into a state that has
    seen nothing yet."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 8, 8, 2, 16)
    o = np.zeros((1, 8, 2, 16), np.float32)
    m = np.full((1, 2, 8), K.NEG_INF, np.float32)
    l = np.zeros((1, 2, 8), np.float32)
    got = K.block_update(*(torch.from_numpy(a) for a in (q, k, v, o, m, l)), 0, 8, True, 0.25)
    want = JR._block_update(*(jnp.asarray(a) for a in (q, k, v, o, m, l)), 0, 8, True, 0.25)
    for g, w, s in zip(got, want, (o, m, l)):
        np.testing.assert_array_equal(g.numpy(), s)
        np.testing.assert_array_equal(np.asarray(w), s)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 31])
def test_attention_matches_reference_attention(S, causal, dt):
    rng = np.random.default_rng(5 + S)
    q, k, v = _qkv(rng, 2, S, S, 3, 32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dt) for a in (q, k, v))
    want = JR.reference_attention(qj, kj, vj, causal=causal)
    got = K.attention(qt, kt, vt, causal)
    assert got.dtype == qt.dtype and tuple(got.shape) == want.shape
    tol = TOL_F32 if dt == "f32" else TOL_BF16_OUT
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the port's own plain reference agrees as well
    np.testing.assert_allclose(_np(PR.reference_attention(qt, kt, vt, causal=causal)),
                               _np(want), **tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ring_schedule_on_one_device_matches_ring_attention_on_a_mesh(dt):
    """The ring's schedule (n_shards**2 block_update calls, the blocks
    above the diagonal fully masked) against ray_tpu's ring_attention over 4
    virtual CPU devices."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 64, 64, 2, 16)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dt) for a in (q, k, v))
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    want = JR.ring_attention(qj, kj, vj, mesh, axis_name="sp", causal=True)
    got = _ring_schedule(qt, kt, vt, n_shards=4, causal=True)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(TOL_F32 if dt == "f32" else TOL_BF16_OUT))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rmsnorm_matches_reference(dt):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 17, 64)) * 3).astype(np.float32)
    scale = (1.0 + 0.5 * rng.standard_normal(64)).astype(np.float32)
    xj, xt = _pair(x, dt)
    want = JT._rmsnorm(xj, jnp.asarray(scale))
    got = K.rmsnorm(xt, torch.from_numpy(scale))
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(TOL_F32 if dt == "f32" else TOL_BF16_OUT))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [300, 31])
def test_rope_split_matches_reference(S, dt):
    """Positions up to S - 1, so angles reach ~300 rad in the fastest pair."""
    rng = np.random.default_rng(10 + S)
    B, H, Dh = 2, 4, 16
    qkv = rng.standard_normal((B, S, 3 * H * Dh)).astype(np.float32)
    qkvj, qkvt = _pair(qkv, dt)
    qj, kj, vj = jnp.split(qkvj, 3, axis=-1)
    want = (JT._rope(qj.reshape(B, S, H, Dh), 10000.0),
            JT._rope(kj.reshape(B, S, H, Dh), 10000.0), vj.reshape(B, S, H, Dh))
    got = K.rope_split(qkvt, H, 10000.0)
    tol = TOL_F32 if dt == "f32" else dict(rtol=2**-7, atol=2e-2)
    for name, w, g in zip("qkv", want, got):
        assert tuple(g.shape) == w.shape and g.dtype == qkvt.dtype, name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)


ROPE_HEAD_WIDTHS = [16, 20, 32, 64, 128]  # 20: a half-head of 10, no 16-byte vector


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("Dh", ROPE_HEAD_WIDTHS)
def test_rope_split_head_widths_match_reference(Dh, dt):
    """The plain K10b at every head width the card's test runs, against the
    split and _rope, S = 65."""
    rng = np.random.default_rng(40 + Dh)
    B, S, H = 2, 65, 2
    qkv = rng.standard_normal((B, S, 3 * H * Dh)).astype(np.float32)
    qkvj, qkvt = _pair(qkv, dt)
    qj, kj, vj = jnp.split(qkvj, 3, axis=-1)
    want = (JT._rope(qj.reshape(B, S, H, Dh), 10000.0),
            JT._rope(kj.reshape(B, S, H, Dh), 10000.0), vj.reshape(B, S, H, Dh))
    tol = TOL_F32 if dt == "f32" else dict(rtol=2**-7, atol=2e-2)
    for name, w, g in zip("qkv", want, K.rope_split(qkvt, H, 10000.0)):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)


def test_rope_split_of_an_offset_view_equals_the_contiguous_copy():
    """A qkv that starts one element into its storage (on the card: not
    16-byte aligned, the scalar form) gives what its contiguous copy gives."""
    rng = np.random.default_rng(44)
    buf = torch.from_numpy(rng.standard_normal(1 + 2 * 9 * 3 * 64).astype(np.float32))
    qkv = buf[1:].view(2, 9, 3 * 64)
    assert qkv.storage_offset() == 1
    for a, b in zip(K.rope_split(qkv, 2, 10000.0), K.rope_split(qkv.clone(), 2, 10000.0)):
        assert torch.equal(a, b)


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    x = torch.ones((2, 8))
    K.rmsnorm(x, torch.ones(8))
    K.rope_split(torch.ones((1, 4, 3 * 16)), 1, 10000.0)
    q = torch.ones((1, 4, 1, 16))
    K.attention(q, q, q)
    K.attention(q, q, q, round_probs=True)
    K.attention_bwd(q, q, q, q, torch.zeros((1, 1, 4)), torch.ones((1, 1, 4)))
    K.rmsnorm_bwd(x, torch.ones(8), x)
    K.rope_split_bwd(q, q, q, 10000.0)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert set(K.KERNELS) == {"block_update", "attention", "rmsnorm", "rope_split",
                              "attention_bwd", "rmsnorm_bwd", "rope_split_bwd"}


def test_wrappers_raise_on_mixed_devices_and_bad_shapes():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        K.attention(q, q, q.to("meta"))
    with pytest.raises(ValueError):
        K.rmsnorm(torch.zeros((2, 8)), torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="head width"):
        K._check_attention_shapes("attention", *(torch.zeros((1, 8, 2, 24)),) * 3)
    with pytest.raises(ValueError, match="head width"):
        K._check_attention_shapes("attention", *(torch.zeros((1, 8, 2, 144)),) * 3)
    with pytest.raises(ValueError, match="dtype"):
        K._dtype_code(torch.zeros(4, dtype=torch.float16), "rmsnorm")


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_cuda_model_kernels_equal_plain_on_card(Dh):
    """On the card: each kernel against its plain version at small shapes
    and the head widths K8 takes (16 to 128), with the tolerances above
    (the ragged S = 100 included). block_update's float32 state is an
    unnormalised sum, so its atol scales with the state's largest entry.
    The unrounded K8 stays on the CUDA cores in both dtypes: it counts no
    tensor-core launch (the rounded form is test_torch_model_grads.py's and
    test_torch_attention_sm90.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    for td in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dev, td) for a in _qkv(rng, 2, 100, 100, 3, Dh))
        tol = TOL_F32 if td == torch.float32 else TOL_BF16_OUT
        for causal in (True, False):
            before = K.tc_launch_counts()["attention"]
            torch.testing.assert_close(K.attention(q, k, v, causal).float(),
                                       K._attention_plain(q, k, v, causal).float(), **tol)
            assert K.tc_launch_counts()["attention"] == before
        o = torch.zeros((2, 100, 3, Dh), device=dev)
        m = torch.full((2, 3, 100), K.NEG_INF, device=dev)
        l = torch.zeros((2, 3, 100), device=dev)
        for q_off, k_off in ((100, 0), (100, 100), (0, 100)):
            got = K.block_update(q, k, v, o, m, l, q_off, k_off, True, Dh ** -0.5)
            want = K._block_update_plain(q, k, v, o, m, l, q_off, k_off, True, Dh ** -0.5)
            for g, w in zip(got, want):
                torch.testing.assert_close(
                    g, w, rtol=TOL_F32["rtol"],
                    atol=max(TOL_F32["atol"], TOL_F32["rtol"] * float(w.abs().max())))
            o, m, l = want
        if Dh != 64:
            continue
        x = torch.from_numpy(rng.standard_normal((50, 512)).astype(np.float32)).to(dev, td)
        s = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).to(dev)
        torch.testing.assert_close(K.rmsnorm(x, s).float(), K._rmsnorm_plain(x, s).float(), **tol)
        qkv = torch.from_numpy(rng.standard_normal((2, 100, 3 * 512)).astype(np.float32)).to(dev, td)
        for g, w in zip(K.rope_split(qkv, 8, 10000.0), K._rope_split_plain(qkv, 8, 10000.0)):
            torch.testing.assert_close(g.float(), w.float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", ROPE_HEAD_WIDTHS)
def test_cuda_rope_split_forms_equal_plain_and_each_other(Dh):
    """On the card: K10b at S = 2047 in bf16 and f32 against its plain
    version. The rows form (16-byte vectors) where a half-head is whole
    vectors and qkv is aligned; the scalar form at Dh = 20 and for a view
    one element into its storage, which gives the rows form's bits; two
    launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(50 + Dh)
    B, S, H = 2, 2047, 4
    n = B * S * 3 * H * Dh
    for td in (torch.bfloat16, torch.float32):
        buf = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(dev, td)
        qkv = buf[:n].view(B, S, 3 * H * Dh)
        shifted = buf[1:].view(B, S, 3 * H * Dh)
        shifted.copy_(qkv.clone())  # the same values, one element further on
        whole = (Dh // 2) * qkv.element_size() % 16 == 0
        assert K.rope_split_form(qkv, H) == ("rows" if whole else "scalar")
        assert K.rope_split_form(shifted, H) == "scalar"
        qkv = shifted.clone()  # aligned again
        tol = TOL_F32 if td == torch.float32 else TOL_BF16_OUT
        got = K.rope_split(qkv, H, 10000.0)
        for g, w in zip(got, K._rope_split_plain(qkv, H, 10000.0)):
            torch.testing.assert_close(g.float(), w.float(), **tol)
        again = K.rope_split(qkv, H, 10000.0)
        other = K.rope_split(shifted, H, 10000.0)
        for g, a, o in zip(got, again, other):
            assert torch.equal(g, a) and torch.equal(g, o)
    torch.cuda.synchronize()
