"""The tensor-core K8 (both forms) and K8'
(ray_tpu_torch/models/csrc/attention_sm90.cu): the plain version of the
split of a float32 operand into two bf16 parts (K8''s dS, the block form's
P), the block form's split P·V against the JAX package's _block_update,
the route between the tensor-core and the CUDA-core kernels, and the C
signatures of the port's libraries against their sources (no nvcc here:
the sources are parsed). The `cuda` tests hold the tensor-core K8 against
its plain version, on the card, at the head widths that only K8's wrapper
takes (48, 80, 96, 112), and the block form at every head width."""

import ctypes
import importlib
import math
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import kernels as K
from ray_tpu_torch.models import moe_kernels as EK
from ray_tpu_torch.sched import _build as SB

HEAD_WIDTHS = list(range(16, 129, 16))  # what K8's wrapper takes
BWD_HEAD_WIDTHS = [16, 32, 64, 128]     # what K8''s wrapper takes


# ------------------------------------------------------------------ the split


@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 3e4])
def test_split_bf16_parts_sum_to_the_float32_value(scale):
    """hi = bf16(x), lo = bf16(x - hi): hi + lo is x within 2**-16 of |x|
    (each of the two roundings keeps 8 significant bits)."""
    rng = np.random.default_rng(81)
    x = torch.from_numpy((rng.standard_normal(20_000) * scale).astype(np.float32))
    hi, lo = K._split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all()), float((err / x.double().abs()).max())


def test_split_bf16_keeps_zeros_and_bf16_values_exact():
    x = torch.tensor([0.0, -0.0, 1.0, -2.5, 0.15625, 2.0 ** 127], dtype=torch.float32)
    hi, lo = K._split_bf16(x)
    assert torch.equal(hi.float(), x) and torch.equal(lo.float(), torch.zeros_like(x))


@pytest.mark.parametrize("Dh", BWD_HEAD_WIDTHS)
def test_split_products_match_the_float32_product(Dh):
    """dQ's product as the kernel forms it, hi·K + lo·K with bf16 operands
    summed in float32, is dS·K within float32 rounding (a sum of 64 terms:
    64 units of 2**-24 of sum |dS| |K|); one bf16 rounding of dS, as
    FlashAttention takes it, is off by orders of magnitude more."""
    rng = np.random.default_rng(Dh)
    ds = torch.from_numpy((rng.standard_normal((64, 64)) * 1e-3).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((64, Dh)).astype(np.float32)).to(torch.bfloat16)
    ref = ds.double() @ k.double()
    hi, lo = K._split_bf16(ds)
    split = hi.float() @ k.float() + lo.float() @ k.float()
    single = hi.float() @ k.float()
    bound = 64 * 2.0 ** -24 * (ds.double().abs() @ k.double().abs())
    assert bool(((split.double() - ref).abs() <= bound).all())
    err_split = float((split.double() - ref).abs().max())
    err_single = float((single.double() - ref).abs().max())
    assert err_single > 100 * err_split, (err_single, err_split)


# (q_off, k_off, causal, Sq, Sk) of the block under test, after a first,
# fully visible block has set the state: a visible block (every key before
# every query, as the ring's steps below the diagonal), the causal block on
# the diagonal, ragged blocks on and off it, and one not causal
SPLIT_BLOCK_CASES = {
    "visible": (128, 0, True, 128, 128),
    "diagonal": (128, 128, True, 128, 128),
    "ragged_diagonal": (130, 128, True, 63, 65),
    "ragged_below": (200, 7, True, 65, 63),
    "not_causal": (0, 900, False, 65, 63),
}
#: KERNEL_TOL's float32 pair (chip_smoke.py): rtol, and atol as a share of
#: the state's largest entry (an unnormalised sum over the block's keys)
BLOCK_TOL = 1e-5


def _state_close(got, want, rtol=BLOCK_TOL):
    """Whether got is within rtol of want and rtol of want's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = max(BLOCK_TOL, rtol * float(np.abs(want).max()))
    return bool((np.abs(got - want) <= atol + rtol * np.abs(want)).all())


def _block_update_split(q, k, v, o, m, l, q_off, k_off, causal, scale, parts):
    """K8's block form as the tensor-core kernel takes it: the plain
    version's steps, with P·V the sum of part·V over parts(p), each part a
    bf16 tensor multiplied by the bf16 V and summed in float32 (exact
    products), added to o·corr at the end."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pmask = 1.0
    if causal:
        mask = ((q_off + torch.arange(q.shape[1]))[:, None]
                >= (k_off + torch.arange(k.shape[1]))[None, :])
        logits = torch.where(mask, logits, K.NEG_INF)
        pmask = mask.float()
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None]) * pmask
    corr = torch.exp(m - m_new)
    pv = sum(torch.einsum("bhqk,bkhd->bqhd", part.float(), v.float()) for part in parts(p))
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l * corr + p.sum(dim=-1)


@pytest.mark.parametrize("case", list(SPLIT_BLOCK_CASES))
def test_block_update_split_pv_matches_the_reference(case):
    """The tensor-core block form's arithmetic, emulated in plain PyTorch
    (p split into hi = bf16(p) and lo = bf16(p - hi) by _split_bf16, each
    multiplied by the bf16 V, summed in float32), against ray_tpu's
    _block_update, whose P·V is one float32 product: o, m and l within
    KERNEL_TOL's float32 pair (1e-5, atol 1e-5 of the state's largest
    entry). Two parts hold it; P rounded once to bf16 does not."""
    JR = importlib.import_module("ray_tpu.parallel.ring_attention")
    import jax.numpy as jnp

    q_off, k_off, causal, Sq, Sk = SPLIT_BLOCK_CASES[case]
    rng = np.random.default_rng(Sq + Sk)
    B, H, Dh, Sk0 = 2, 2, 64, 96
    q, k0, v0 = (rng.standard_normal((B, s, H, Dh)).astype(np.float32) for s in (Sq, Sk0, Sk0))
    k, v = (rng.standard_normal((B, Sk, H, Dh)).astype(np.float32) for _ in range(2))
    # the inputs in bf16, as the tensor-core kernel takes them
    qt, k0t, v0t, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k0, v0, k, v))
    qj, k0j, v0j, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (qt, k0t, v0t, kt, vt))
    scale = 1.0 / math.sqrt(Dh)
    state = (np.zeros((B, Sq, H, Dh), np.float32), np.full((B, H, Sq), K.NEG_INF, np.float32),
             np.zeros((B, H, Sq), np.float32))
    state = [np.array(x) for x in JR._block_update(
        qj, k0j, v0j, *map(jnp.asarray, state), q_off, q_off - Sk0 - 500, causal, scale)]
    want = [np.asarray(x) for x in JR._block_update(qj, kj, vj, *map(jnp.asarray, state),
                                                     q_off, k_off, causal, scale)]
    args = (qt, kt, vt, *map(torch.from_numpy, state), q_off, k_off, causal, scale)
    got = _block_update_split(*args, K._split_bf16)
    for name, g, w in zip("oml", got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _state_close(g.numpy(), w), (name, float(np.abs(g.numpy() - w).max()))
    # P·V with P rounded once to bf16: o is off by far more than the tolerance
    once = _block_update_split(*args, lambda p: (p.to(torch.bfloat16),))[0].numpy()
    assert not _state_close(once, want[0])
    assert float(np.abs(once - want[0]).max()) > 20 * float(np.abs(got[0].numpy() - want[0]).max())
    # and with the parts summed whole, the emulation is the plain version's
    plain = K._block_update_plain(*args)
    whole = _block_update_split(*args, lambda p: (p,))
    assert all(torch.equal(a, b) for a, b in zip(plain, whole))


# ------------------------------------------------------------------ the division


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32, ties to even (normal and subnormal)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(x / ulp, 1)
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return sign * n * ulp


def _f32(rng, lo_exp, hi_exp, n):
    bits = ((rng.integers(lo_exp, hi_exp + 1, n) + 127) << 23) | rng.integers(0, 2 ** 23, n)
    return bits.astype(np.uint32).view(np.float32)


def _near_midpoint_pairs(rng, n):
    """(a, b) with a, b in [1, 2) whose quotient lies within 3 * 2**-48 of
    its value of a float32 midpoint in [0.5, 1), the hardest quotients to
    round: with a = A 2**-23, b = B 2**-23 and the midpoint M 2**-25, A
    2**25 - B M = d for a small odd d fixes M modulo 2**25."""
    out = []
    for B in (2 * rng.integers(2 ** 22, 2 ** 23, n) + 1).tolist():
        inv = pow(B, -1, 2 ** 25)
        for d in (1, -1, 3, -3):
            M = (-d * inv) % 2 ** 25
            A, rem = divmod(B * M + d, 2 ** 25)
            if M >= 2 ** 24 and not rem and 2 ** 23 <= A < 2 ** 24:
                out.append((A / 2 ** 23, B / 2 ** 23))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_markstein_division_gives_the_ieee_quotient(seed):
    """The kernels' div_rn, in exact arithmetic: rb = RN(1/b), q0 = RN(a rb),
    then twice q = RN(q + rb RN(a - q b)) (four FMAs). The first step leaves
    q within one ulp of a / b (q0 alone may be more), which with rb
    correctly rounded is Markstein's condition for the second to give
    RN(a / b). Held for the quotients the kernels form: e / l with e in
    [2**-60, 1] and l in [1, 8192), and dP / l with |dP| in [2**-20, 256);
    for b with an all-ones or a power-of-two significand; and for quotients
    nearest a midpoint."""
    rng = np.random.default_rng(seed)
    n = 1500
    a = np.concatenate([_f32(rng, -60, 0, n), _f32(rng, -20, 7, n) * rng.choice([-1, 1], n)])
    b = np.concatenate([_f32(rng, 0, 12, n), _f32(rng, 0, 12, n)])
    special = (((rng.integers(0, 13, 200) + 127) << 23)
               | rng.choice([0x7FFFFF, 0x7FFFFE, 0, 1], 200)).astype(np.uint32).view(np.float32)
    a = np.concatenate([a, _f32(rng, -30, 0, 200)])
    b = np.concatenate([b, special])
    pairs = list(zip(a.tolist(), b.tolist())) + _near_midpoint_pairs(rng, 400)
    for x, y in pairs:
        A, B = Fraction(x), Fraction(y)
        rb = _rn32(1 / B)
        q = _rn32(A * rb)
        q = _rn32(q + rb * _rn32(A - q * B))
        ieee = _rn32(A / B)
        other = np.nextafter(np.float32(ieee), np.float32(np.inf if ieee < A / B else -np.inf))
        assert q in (ieee, Fraction(float(other))), (x, y)  # a float32 next to a / b
        assert _rn32(q + rb * _rn32(A - q * B)) == ieee, (x, y)


# ------------------------------------------------------------------ the route


@pytest.mark.parametrize("Dh", HEAD_WIDTHS)
def test_attention_route_sends_rounded_bf16_to_the_tensor_cores(Dh):
    """K8's whole form: bf16 with rounded probabilities to wgmma; its block
    form: every bf16 block to wgmma (P·V as two bf16 parts), float32 to
    the CUDA cores."""
    for dt in (torch.bfloat16, torch.float32):
        q = torch.empty((1, 4, 2, Dh), dtype=dt)
        K._check_attention_shapes("attention", q, q, q)
        for round_probs in (True, False):
            want = "wgmma" if dt == torch.bfloat16 and round_probs else "cuda_core"
            assert K._attention_route(q, round_probs) == want, (dt, round_probs)
        want = "wgmma" if dt == torch.bfloat16 else "cuda_core"
        assert K._block_update_route(q) == want, dt


def test_tensor_core_counters_reset_and_stay_zero_on_the_cpu():
    zero = {"block_update": 0, "attention": 0, "attention_bwd": 0}
    K.attention.launches_tc = K.attention_bwd.launches_tc = K.block_update.launches_tc = 5
    K.reset_launch_counts()
    assert K.tc_launch_counts() == zero
    q = torch.ones((1, 8, 1, 16), dtype=torch.bfloat16)
    out, m, l = K._attention_rounded_plain(q, q, q, True)
    K.attention(q, q, q, round_probs=True)
    K.attention_bwd(q, q, q, q, m, l)
    K.block_update(q, q, q, out.float(), m, l, 8, 0, True, 0.25)
    assert K.tc_launch_counts() == zero
    assert K.launch_counts()["attention"] == K.launch_counts()["block_update"] == 0


# ------------------------------------------------------------------ C signatures

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
            "unsigned long long": ctypes.c_ulonglong}


def _ctype(decl: str):
    """The ctypes type a wrapper declares for one C parameter or result."""
    decl = re.sub(r"\b(const|__restrict__)\b", " ", decl)
    if "*" in decl:
        return ctypes.c_char_p if re.fullmatch(r"\s*char\s*\*\s*\w*\s*", decl) else ctypes.c_void_p
    words = decl.split()
    return _C_TYPES[" ".join(words[:-1]) if len(words) > 1 else words[0]]


def _extern_c_signatures(src: str) -> dict:
    """name -> (argument types, result type) of every function defined in
    the source's extern "C" block, leaving out what a build flag adds
    (#ifdef ... #endif: the profile builds' entry points)."""
    block = src[src.index('extern "C" {'):src.rindex('}  // extern "C"')]
    block = re.sub(r"^#ifdef.*?^#endif", "", block, flags=re.M | re.S)
    sigs = {}
    for m in re.finditer(r"^([A-Za-z_][\w ]*?\**)\s*(\w+)\(([^)]*)\)\s*\{", block, re.M):
        ret, name, params = m.groups()
        args = [_ctype(p) for p in params.split(",") if p.strip()]
        sigs[name] = (args, _ctype(ret + " r"))
    return sigs


@pytest.mark.parametrize("lib", [K.LIBRARY_SM90, K.LIBRARY, EK.LIBRARY, SB.LIBRARY],
                         ids=lambda lib: lib.name)
def test_library_signatures_match_the_sources_entry_points(lib):
    """Each library's ctypes table names every extern "C" function of its
    source with the same arguments and result (a mismatch would cut a
    pointer or shift every argument after it)."""
    parsed = _extern_c_signatures(lib.src.read_text())
    assert set(parsed) == set(lib.signatures)
    for name, (argtypes, restype) in lib.signatures.items():
        assert parsed[name] == (list(argtypes), restype), name


def test_sm90_library_is_built_apart_with_the_base_flags():
    assert K.LIBRARY_SM90.src.name == "attention_sm90.cu"
    assert K.LIBRARY_SM90.flags == K.LIBRARY.flags
    assert "--use_fast_math" not in K.LIBRARY_SM90.flags
    assert K.LIBRARY_SM90.library_path() != K.LIBRARY.library_path()
    assert "#include \"" not in K.LIBRARY_SM90.src.read_text()  # the hash covers one file


# ------------------------------------------------------------------ on the card

# (rtol, atol as a share of the largest entry), as the backward tests' for
# K8's output: one rounding of the output, and the probabilities' own
# rounding, which a last-bit difference in a logit or in l can flip
CUDA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2e-3)}


def _assert_close(got, want, what):
    rtol, share = CUDA_TOL[want.dtype]
    got, want = got.double(), want.double()
    bad = (got - want).abs() > share * float(want.abs().max()) + rtol * want.abs()
    assert not bool(bad.any()), f"{what}: max abs {float((got - want).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", sorted(set(HEAD_WIDTHS) - set(BWD_HEAD_WIDTHS)))
def test_cuda_tensor_core_attention_forward_only_head_widths(Dh):
    """On the card, at the head widths K8 takes and K8' does not (the others
    are test_torch_model_grads.py's, with the backward): the tensor-core K8
    (bf16, rounded probabilities) against its plain version with its m and
    l, at the ragged S = 100 and 2047, causal and not; every launch counted
    as a tensor-core one, and a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(100 + Dh)
    for B, S, H in ((2, 100, 3), (1, 2047, 2)):
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, Dh)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        for causal in (True, False):
            before = dict(K.tc_launch_counts())
            got = K._attention_launch(q, k, v, causal, True, stats=True)
            again = K._attention_launch(q, k, v, causal, True, stats=True)
            assert K.tc_launch_counts()["attention"] == before["attention"] + 2
            want = K._attention_rounded_plain(q, k, v, causal)
            for name, g, w, a in zip(("out", "m", "l"), got, want, again):
                _assert_close(g, w, f"Dh={Dh} S={S} causal={causal} {name}")
                assert torch.equal(g, a), name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", HEAD_WIDTHS)
def test_cuda_tensor_core_block_update_equals_plain(Dh):
    """On the card: K8's block form in bf16 (the tensor-core kernel; every
    launch counted in launches_tc) against its plain version at Sq and Sk
    of 511, 512 and 513: a visible block on the empty state, then the
    causal block on the diagonal, then a fully masked one (the state comes
    back bit for bit), then one not causal; o, m, l within KERNEL_TOL's
    float32 pair (1e-5, atol 1e-5 of the state's largest entry), and a
    second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(200 + Dh)
    B, H = 2, 2
    scale = Dh ** -0.5
    for Sq, Sk in ((512, 512), (511, 513), (513, 511)):
        q = torch.from_numpy(rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)) \
            .to(dev, torch.bfloat16)
        k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, Dh)).astype(np.float32))
                .to(dev, torch.bfloat16) for _ in range(2))
        state = (torch.zeros((B, Sq, H, Dh), device=dev),
                 torch.full((B, H, Sq), K.NEG_INF, device=dev), torch.zeros((B, H, Sq), device=dev))
        for q_off, k_off, causal, what in ((Sk, 0, True, "visible"), (0, 0, True, "diagonal"),
                                           (5, 5 + Sq, True, "fully masked"),
                                           (0, 3 * Sq, False, "not causal")):
            before = K.tc_launch_counts()["block_update"]
            got = K.block_update(q, k, v, *state, q_off, k_off, causal, scale)
            again = K.block_update(q, k, v, *state, q_off, k_off, causal, scale)
            assert K.tc_launch_counts()["block_update"] == before + 2
            want = K._block_update_plain(q, k, v, *state, q_off, k_off, causal, scale)
            for name, g, w, a in zip("oml", got, want, again):
                label = f"Dh={Dh} Sq={Sq} Sk={Sk} {what} {name}"
                assert _state_close(g.cpu().numpy(), w.cpu().numpy()), \
                    (label, float((g - w).abs().max()))
                assert torch.equal(g, a), label
            if what == "fully masked":
                assert all(torch.equal(g, s) for g, s in zip(got, state))
            state = want
    torch.cuda.synchronize()
