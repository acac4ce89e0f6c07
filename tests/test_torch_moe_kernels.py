"""ray_tpu_torch's expert-layer kernels (plain PyTorch versions, on the CPU)
held against the lines of ray_tpu.models.moe.moe_ffn that they replace, on
the same numpy-seeded float32 logits and tokens.

K9a moe_route against moe.py :70-82 (and the aux loss's sums, :112-113),
K9b moe_dispatch against :83-89 and :99, K9c moe_combine against :86 and
:110, each evaluated with jax.numpy by jax_route below. Small config: G 4,
S 64 and the ragged S 61, D 32, E 4; capacity factors 1.25 with a skewed
router (drops), 4.0 (no drops), 0.25 and 0.0625 (C = 1); a tie of two
equal logits (the first index wins); E = 1; S = 1.

Tolerances. The routing's integers (expert, slot, token_of_slot, token
counts) are equal exactly; gate and the summed probabilities within 1e-6
(the reference's exp and its order of summation against PyTorch's).
Dispatch and combine only copy and do one product, so they are equal bit
for bit. The CUDA kernels are held against these plain versions on the
card by the `cuda`-marked test here and by chip_smoke.py.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import moe as PM
from ray_tpu_torch.models import moe_kernels as K

G, D = 4, 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
GATE_TOL = dict(rtol=1e-6, atol=1e-6)


def jax_route(logits, C):
    """The routing of moe.py :70-89 and the sums of :112-113, with
    jax.numpy on float32 logits [G, S, E], as the reference writes them:

        probs = jax.nn.softmax(logits, axis=-1)  # [G,S,E]
        expert = jnp.argmax(probs, axis=-1)  # [G,S]
        gate = jnp.max(probs, axis=-1)  # [G,S]
        onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)  # [G,S,E]
        pos = (
            jax.lax.associative_scan(jnp.add, onehot, axis=1) * onehot - 1.0
        )  # [G,S,E], -1 if not routed
        keep = (pos >= 0) & (pos < C)
        dispatch = keep[..., None] * jax.nn.one_hot(
            jnp.clip(pos, 0, C - 1).astype(jnp.int32), C, dtype=jnp.float32
        )  # [G,S,E,C]
        combine = dispatch * gate[..., None, None]

    Returns numpy arrays: expert, gate, slot (e * C + c where dispatch[g, s,
    e, c] is 1, else -1), token_of_slot (s there, else -1), stats [G, 2, E]
    (onehot and probs summed over S), dispatch and combine."""
    logits = jnp.asarray(logits, jnp.float32)
    Gn, S, E = logits.shape
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    gate = jnp.max(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    pos = jax.lax.associative_scan(jnp.add, onehot, axis=1) * onehot - 1.0
    keep = (pos >= 0) & (pos < C)
    dispatch = keep[..., None] * jax.nn.one_hot(
        jnp.clip(pos, 0, C - 1).astype(jnp.int32), C, dtype=jnp.float32)
    combine = dispatch * gate[..., None, None]
    dispatch_np = np.asarray(dispatch)
    slot = np.full((Gn, S), -1, np.int32)
    token_of_slot = np.full((E, Gn, C), -1, np.int32)
    for g, s, e, c in np.argwhere(dispatch_np == 1.0):
        slot[g, s] = e * C + c
        token_of_slot[e, g, c] = s
    stats = np.stack([np.asarray(onehot.sum(axis=1)), np.asarray(probs.sum(axis=1))], axis=1)
    return {"expert": np.asarray(expert, np.int32), "gate": np.array(gate),
            "slot": slot, "token_of_slot": token_of_slot, "stats": stats,
            "dispatch": dispatch, "combine": combine}


def _logits_and_x(S, E=4, skew=1.0, seed=0, n_groups=G):
    """Skewed tokens through a router from numpy_moe_params: x [G, S, D]
    and its float32 logits x @ router."""
    cfg = PM.MoEConfig(d_model=D, d_ff=64, n_experts=E)
    tree = PM.numpy_moe_params(cfg, seed)
    x = PM.numpy_moe_inputs(tree, (n_groups, S, D), seed + 1, skew)
    return (x @ tree["router"]).astype(np.float32), x


def _assert_route_equal(got, want):
    names = ("expert", "gate", "slot", "token_of_slot", "stats")
    got = dict(zip(names, (t.numpy() for t in got)))
    for name in ("expert", "slot", "token_of_slot"):
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["stats"][:, 0], want["stats"][:, 0])
    np.testing.assert_allclose(got["gate"], want["gate"], **GATE_TOL)
    np.testing.assert_allclose(got["stats"][:, 1], want["stats"][:, 1], rtol=1e-6, atol=0)


# capacity factor -> C at E = 4: 1.25 -> 20 (S 64) / 19 (S 61); 4.0 -> S;
# 0.25 -> 4 / 3; 0.0625 -> 1 (S 61 through the max(1, ...) floor)
CAPACITY_FACTORS = [1.25, 4.0, 0.25, 0.0625]


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("S", [64, 61, 257, 600])  # 257, 600: 2 and 3 of K9a's chunks
def test_route_matches_reference(S, cf):
    logits, _ = _logits_and_x(S)
    C = PM._capacity(PM.MoEConfig(d_model=D, n_experts=4, capacity_factor=cf), S)
    want = jax_route(logits, C)
    _assert_route_equal(K.moe_route(torch.from_numpy(logits), C), want)
    kept = int((want["slot"] >= 0).sum())
    if cf == 4.0:
        assert kept == G * S  # no drops
    else:
        assert kept < G * S  # the skewed router overflows expert 0
    if cf == 0.0625 and S <= 64:
        assert C == 1


def test_route_tie_takes_the_first_index():
    logits, _ = _logits_and_x(64)
    logits[:, ::3, 1] = 5.0  # experts 1 and 3 tie at the top for every third token
    logits[:, ::3, 3] = 5.0
    want = jax_route(logits, 20)
    got = K.moe_route(torch.from_numpy(logits), 20)
    _assert_route_equal(got, want)
    assert (got[0][:, ::3] == 1).all()


@pytest.mark.parametrize("E,S", [(1, 64), (4, 1), (1, 1), (9, 257), (9, 600), (9, 2049),
                                 (4, 2049)])
def test_route_edge_shapes(E, S):
    logits, _ = _logits_and_x(S, E=E)
    for C in (1, 3):
        want = jax_route(logits, C)
        _assert_route_equal(K.moe_route(torch.from_numpy(logits), C), want)
    if E == 1:
        assert (K.moe_route(torch.from_numpy(logits), 1)[1] == 1.0).all()


def _mid_chunk_capacity(expert, S):
    """A capacity that expert 0 of group 0 overflows at a token inside one
    of K9a's chunks of 256 (neither its first nor its last token), the one
    nearest the middle of the group, past the first chunk where one such
    token is: (C, the first dropped token)."""
    T = K.ROUTE_TOKENS_A_BLOCK
    routed = np.flatnonzero(expert[0] == 0)
    inside = [s for s in routed[1:] if s % T not in (0, T - 1)]
    if not inside:
        raise AssertionError("no mid-chunk token of expert 0")
    later = [s for s in inside if s >= T]
    s = min(later or inside, key=lambda s: abs(s - S // 2))
    return int((routed < s).sum()), int(s)


def test_route_overflows_mid_chunk():
    """E = 9 over 3 of K9a's chunks, with a capacity that expert 0 overflows
    in the middle of a chunk: positions, drops and the empty slots as the
    reference's scan gives them."""
    logits, _ = _logits_and_x(600, E=9, skew=2.0)
    C, first_dropped = _mid_chunk_capacity(jax_route(logits, 600)["expert"], 600)
    want = jax_route(logits, C)
    got = K.moe_route(torch.from_numpy(logits), C)
    _assert_route_equal(got, want)
    assert want["slot"][0, first_dropped] == -1
    assert want["token_of_slot"][0, 0, C - 1] == max(
        s for s in range(first_dropped) if want["expert"][0, s] == 0)


@pytest.mark.parametrize("G,S,E", [(8, 2048, 8), (1, 1, 1), (3, 255, 9), (3, 256, 9),
                                   (3, 257, 9), (64, 16384, 64), (65535, 1, 64)])
def test_route_plan_mirrors_the_source(G, S, E):
    """K9a's launch: a block a chunk of 256 tokens, G * ceil(S / 256) blocks
    in one launch, and the scratch's int32 words (the ticket and a pad, a
    finished-block count a group, E counts and E float64 sums a chunk, each
    section 8-byte aligned), as the source's route_layout computes them (the
    `cuda` test asks the built source). 64 blocks at the main path's
    [8, 2048, 8]."""
    plan = K.route_plan(G, S, E)
    chunks = -(-S // 256)
    assert plan.chunks == chunks and plan.blocks == G * chunks
    n = G * chunks * E
    agg = 2 + G + G % 2
    assert plan.scratch_words == agg + n + n % 2 + 2 * n
    assert (agg + n + n % 2) % 2 == 0  # the float64 sums 8-byte aligned
    if (G, S, E) == (8, 2048, 8):
        assert plan == K.RoutePlan(8, 64, 1546)


@pytest.mark.parametrize("out_dt", list(DTYPES))
@pytest.mark.parametrize("x_dt", list(DTYPES))
@pytest.mark.parametrize("cf", [4.0, 1.25, 0.0625])
def test_dispatch_matches_reference(cf, x_dt, out_dt):
    logits, x = _logits_and_x(61)
    C = PM._capacity(PM.MoEConfig(d_model=D, n_experts=4, capacity_factor=cf), 61)
    ref = jax_route(logits, C)
    xj = jnp.asarray(x, DTYPES[x_dt][0])
    # moe.py :89 and :99
    want = jnp.einsum("gsec,gsd->egcd", ref["dispatch"], xj.astype(jnp.float32)) \
        .astype(DTYPES[out_dt][0])
    xt = torch.from_numpy(x).to(DTYPES[x_dt][1])
    got = K.moe_dispatch(xt, torch.from_numpy(ref["token_of_slot"]), DTYPES[out_dt][1])
    assert got.dtype == DTYPES[out_dt][1] and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    empty = ref["token_of_slot"] < 0
    assert (got.float().numpy()[empty] == 0).all()
    assert empty.any() == (C > 1)  # at C = 1 every expert fills its one slot


@pytest.mark.parametrize("y_dt", list(DTYPES))
@pytest.mark.parametrize("cf", [1.25, 0.0625])
def test_combine_matches_reference(cf, y_dt):
    logits, _ = _logits_and_x(61)
    C = PM._capacity(PM.MoEConfig(d_model=D, n_experts=4, capacity_factor=cf), 61)
    ref = jax_route(logits, C)
    out = np.random.default_rng(5).standard_normal((4, G, C, D)).astype(np.float32)
    # moe.py :110
    want = jnp.einsum("gsec,egcd->gsd", ref["combine"], jnp.asarray(out)) \
        .astype(DTYPES[y_dt][0])
    got = K.moe_combine(torch.from_numpy(out), torch.from_numpy(ref["slot"]),
                        torch.from_numpy(ref["gate"]), DTYPES[y_dt][1])
    assert got.dtype == DTYPES[y_dt][1]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    dropped = ref["slot"] < 0
    assert dropped.any() and (got.float().numpy()[dropped] == 0).all()


def test_softmax_plain_divides_as_the_reference():
    logits, _ = _logits_and_x(64)
    got = K.softmax_plain(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)),
                               rtol=1e-6, atol=1e-7)


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    logits, x = _logits_and_x(16)
    lt = torch.from_numpy(logits)
    _, gate, slot, tos, stats = K.moe_route(lt, 4)
    out = K.moe_dispatch(torch.from_numpy(x), tos, torch.float32)
    y = K.moe_combine(out, slot, gate, torch.float32)
    d_out, d_gate = K.moe_combine_bwd(y, out, slot, gate, tos)
    K.moe_dispatch_bwd(d_out, slot, torch.float32)
    K.moe_route_bwd(lt, d_gate, K.aux_loss(stats, lt.shape[0] * lt.shape[1])[0],
                    torch.tensor(1.0))
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert set(K.KERNELS) == {"moe_route", "moe_dispatch", "moe_combine", "moe_route_bwd",
                              "moe_dispatch_bwd", "moe_combine_bwd"}


def test_wrappers_raise_on_bad_inputs():
    logits = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="experts"):
        K.moe_route(torch.zeros((2, 8, 65)), 4)
    with pytest.raises(ValueError, match="groups"):
        K.moe_route(torch.zeros((65536, 1, 2)), 4)
    with pytest.raises(ValueError, match="capacity"):
        K.moe_route(logits, 0)
    with pytest.raises(ValueError, match="float32"):
        K.moe_route(logits.double(), 4)
    with pytest.raises(ValueError, match="float32"):
        K.moe_route(torch.zeros((8, 4)), 4)
    tos = torch.full((4, 2, 3), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        K.moe_dispatch(torch.zeros((2, 8, 16), dtype=torch.float16), tos, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        K.moe_dispatch(torch.zeros((2, 8, 16)), tos, torch.float64)
    with pytest.raises(ValueError, match="token_of_slot"):
        K.moe_dispatch(torch.zeros((3, 8, 16)), tos, torch.bfloat16)
    with pytest.raises(ValueError):
        K.moe_dispatch(torch.zeros((2, 8, 16)), tos.to("meta"), torch.bfloat16)
    slot, gate = torch.zeros((2, 8), dtype=torch.int32), torch.zeros((2, 8))
    out = torch.zeros((4, 2, 3, 16))
    with pytest.raises(ValueError, match="moe_combine"):
        K.moe_combine(out.bfloat16(), slot, gate, torch.float32)
    with pytest.raises(ValueError, match="moe_combine"):
        K.moe_combine(out, slot.long(), gate, torch.float32)
    with pytest.raises(ValueError, match="moe_combine"):
        K.moe_combine(out, slot, gate[:, :4], torch.float32)


def test_out_of_range_slots_read_nothing():
    """An entry of token_of_slot outside [0, S), or a slot outside [0, E * C),
    is empty: the kernels never read outside x or out, and the plain
    versions agree (the card's half is in the `cuda`-marked test)."""
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8) + 1
    tos = torch.tensor([[[0, 3, -2]], [[2, 1, 7]]], dtype=torch.int32).reshape(2, 1, 3)
    tos = tos.expand(2, 2, 3).contiguous()
    got = K.moe_dispatch(x, tos, torch.float32)
    assert (got[0, :, 1:] == 0).all() and (got[1, :, 2] == 0).all()
    assert torch.equal(got[1, 1, 0], x[1, 2]) and torch.equal(got[0, 0, 0], x[0, 0])
    out = torch.ones((2, 2, 3, 8))
    slot = torch.tensor([[0, 6, -3], [5, 100, 1]], dtype=torch.int32)
    y = K.moe_combine(out, slot, torch.full((2, 3), 0.5), torch.float32)
    assert (y[0, 1:] == 0).all() and (y[1, 1] == 0).all()
    assert (y[0, 0] == 0.5).all() and (y[1, 0] == 0.5).all() and (y[1, 2] == 0.5).all()


@pytest.mark.cuda
def test_cuda_moe_kernels_equal_plain_on_card():
    """On the card: each kernel against its plain version, over expert
    counts 1 to 64 (every template of K9a), S from 1 to 2 048 (ragged
    chunks of 256), a D that is not a multiple of 8 (K9b/K9c's one-element
    path) and every dtype pair. Routing integers and token counts, dispatch
    and combine bit-equal; gate and probability sums within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    for E, S, Dw in ((1, 300, 32), (4, 61, 36), (8, 2048, 256), (13, 1, 8), (33, 700, 40),
                     (64, 513, 64)):
        Gn = 3
        logits = (rng.standard_normal((Gn, S, E)) * 2).astype(np.float32)
        logits[:, :, 0] += 1.0  # skew: drops at the smaller capacities
        for C in (1, max(1, int(S * 1.25 / E)), S):
            lt = torch.from_numpy(logits)
            got = K.moe_route(lt.to(dev), C)
            want = K.moe_route(lt, C)  # the plain version on the CPU
            want_dev = K._route_plain(lt.to(dev), C)  # and on the card
            for g, w, wd, name in zip(got, want, want_dev, ("expert", "gate", "slot", "tos",
                                                           "stats")):
                g = g.cpu()
                if name == "gate":
                    torch.testing.assert_close(g, wd.cpu(), **GATE_TOL)
                    torch.testing.assert_close(g, w, **GATE_TOL)
                elif name == "stats":
                    assert torch.equal(g[:, 0], wd.cpu()[:, 0]), name
                    torch.testing.assert_close(g[:, 1], wd.cpu()[:, 1], rtol=1e-6, atol=0)
                else:
                    assert torch.equal(g, wd.cpu()), (E, S, C, name)
                    assert torch.equal(g, w), (E, S, C, name)
            _, gate, slot, tos, _ = got
            for x_td in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(rng.standard_normal((Gn, S, Dw)).astype(np.float32)) \
                    .to(dev, x_td)
                for out_td in (torch.float32, torch.bfloat16):
                    assert torch.equal(K.moe_dispatch(x, tos, out_td),
                                       K._dispatch_plain(x, tos, out_td)), (E, S, Dw)
                    out = torch.from_numpy(
                        rng.standard_normal((E, Gn, C, Dw)).astype(np.float32)).to(dev)
                    assert torch.equal(K.moe_combine(out, slot, gate, out_td),
                                       K._combine_plain(out, slot, gate, out_td)), (E, S, Dw)
                # entries out of range are empty slots and dropped tokens
                bad_tos = torch.where(tos >= 0, tos + S // 2, -5)
                bad_slot = torch.where(slot >= 0, slot + E * C // 2, -5)
                for out_td in (torch.float32, torch.bfloat16):
                    assert torch.equal(K.moe_dispatch(x, bad_tos, out_td),
                                       K._dispatch_plain(x, bad_tos, out_td)), (E, S, Dw)
                    assert torch.equal(K.moe_combine(out, bad_slot, gate, out_td),
                                       K._combine_plain(out, bad_slot, gate, out_td))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_route_chunk_edges_equal_plain_and_are_deterministic():
    """On the card: K9a (a block a chunk of 256 tokens, the chunks' counts
    by a look-back) against its plain version where the chunks meet: S = 1,
    255, 256, 257, 2 049 and 8 192 at E = 1, 8, 9 and 64, at C = 1, a
    capacity that expert 0 overflows in the middle of a chunk, and S; ties
    at the top; and a grid larger than the card's resident blocks (G 64,
    S 16 384: 4 096 blocks). Routing integers and token counts bit-equal,
    gate and sums within 1e-6; a second launch gives the same bits; the
    plan is the source's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    names = ("expert", "gate", "slot", "token_of_slot", "stats")

    def check(lt, C, what):
        got = K.moe_route(lt, C)
        again = K.moe_route(lt, C)
        want = K._route_plain(lt, C)
        for name, g, a, w in zip(names, got, again, want):
            assert torch.equal(g, a), f"{what} C={C}: {name} differs between two launches"
            if name == "gate":
                torch.testing.assert_close(g, w, **GATE_TOL)
            elif name == "stats":
                assert torch.equal(g[:, 0], w[:, 0]), f"{what} C={C}: token counts"
                torch.testing.assert_close(g[:, 1], w[:, 1], rtol=1e-6, atol=0)
            else:
                assert torch.equal(g, w), f"{what} C={C}: {name}"
        return want

    for E in (1, 8, 9, 64):
        for S in (1, 255, 256, 257, 2049, 8192):
            plan = (ctypes.c_longlong * 4)()
            assert K.LIBRARY.load().moe_route_plan(3, S, E, plan) == 0
            assert tuple(plan) == (K.ROUTE_TOKENS_A_BLOCK, *K.route_plan(3, S, E))
            logits = (rng.standard_normal((3, S, E)) * 2).astype(np.float32)
            logits[:, :, 0] += 1.0  # skew: expert 0 overflows
            if E > 1:
                logits[:, ::3, 1] = logits[:, ::3, E - 1] = 30.0  # a tie at the top
            lt = torch.from_numpy(logits).to(dev)
            want = check(lt, S, f"E={E} S={S}")
            if E > 1:
                assert (want[0][:, ::3] == 1).all()
            check(lt, 1, f"E={E} S={S}")
            if S > 2:
                C, _ = _mid_chunk_capacity(want[0].cpu().numpy(), S)
                check(lt, C, f"E={E} S={S} mid-chunk overflow")
    G, S, E = 64, 16384, 8
    plan = K.route_plan(G, S, E)
    props = torch.cuda.get_device_properties(dev)
    assert plan.blocks > props.multi_processor_count * 8  # beyond the resident blocks
    logits = torch.from_numpy((rng.standard_normal((G, S, E)) * 2).astype(np.float32)).to(dev)
    check(logits, int(S * 1.25 / E), f"G={G} S={S} E={E}, {plan.blocks} blocks")
    torch.cuda.synchronize()
