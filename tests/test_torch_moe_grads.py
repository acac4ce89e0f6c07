"""ray_tpu_torch's expert layer under autograd (the plain backwards K9a',
K9b', K9c' and the layer's gradient, on the CPU) held against jax.vjp and
jax.grad of ray_tpu.models.moe.moe_ffn on the same numpy-seeded weights,
tokens and cotangents.

Small config: d_model 32, d_ff 64, 4 experts, G 4, at S = 64 and the
ragged S = 61, tokens skewed toward expert 0 (numpy_moe_inputs) so that
the capacity drops some; capacity factors 1.25, 4.0 (no drops), 0.25 and
0.0625 (C = 1); E = 1; S = 1.

Tolerances, as measured here:
- The gathers (d_out, the dispatch's dx) equal the reference's bit for bit.
- d_gate and d_logits within 1e-6 of their largest entry (measured 2.4e-7
  and 1.2e-7: the reference's dot and reduce orders against the plain
  versions').
- The layer's gradient (router, w1, w2, x) against jax.vjp, relative to
  each leaf's largest entry: float32 within 2e-6 (measured 4.7e-7);
  bf16 experts within 2**-8 (the products' cotangents round once to bf16,
  and a sum taken in another order can land on the other side of a
  rounding, which moves an entry by one bf16 ulp, 2**-8 to 2**-7 of it:
  measured 7.2e-4 for w1) with 99.9 % of entries bit-equal (measured >=
  99.97 %); the router's gradient, a float32 sum, within 1e-5 (measured
  2.7e-6), as x's in float32 with bf16 experts (measured 7.1e-6); x in
  bf16 within 2**-8 (measured 1.8e-3 of the largest entry, 99.98 %
  bit-equal).
- Two AdamW steps of the layer against optax.adamw: float32 params within
  1e-6 and 99.9 % within 1e-7; bf16 experts within 2 lr + 1e-6 (an entry
  whose gradient's sign differs moves by 2 lr), 99 % within 1e-6.

write_moe_grad_golden() writes tests/data/moe_grad_golden.npz from the
JAX package (called by hand from a script, as write_moe_golden is); a test
recomputes it from ray_tpu and holds the port's plain step to it within
models.moe.MOE_GRAD_GOLDEN_TOL, which chip_smoke.py applies to the card's
step. The `cuda`-marked test holds the three kernels to their plain
versions on the card.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import moe as JM
from ray_tpu_torch.models import moe as PM
from ray_tpu_torch.models import moe_kernels as K
from ray_tpu_torch.models.moe import MOE_GRAD_GOLDEN_TOL, MOE_GRAD_LEAVES, MOE_TIE_GAP
from ray_tpu_torch.parallel import make_optimizer
from test_torch_moe import golden_inputs, top2_gap  # tests/ is on sys.path
from test_torch_moe_kernels import jax_route

SMALL = dict(d_model=32, d_ff=64, n_experts=4)
G, D = 4, SMALL["d_model"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CAPACITY_FACTORS = [1.25, 4.0, 0.25, 0.0625]
LR, WD = 3e-4, 0.01

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "moe_grad_golden.npz")
GOLDEN_SAMPLES = 4096  # entries a leaf
GOLDEN_POSITION_SEED = 11


def _leaf_err(got, want):
    """Largest absolute difference over the leaf's largest entry, and the
    share of entries equal bit for bit."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / scale, float((got == want).mean())


def _logits(S, E=4, seed=0, skew=1.0):
    cfg = PM.MoEConfig(d_model=D, d_ff=64, n_experts=E)
    tree = PM.numpy_moe_params(cfg, seed)
    x = PM.numpy_moe_inputs(tree, (G, S, D), seed + 1, skew)
    return (x @ tree["router"]).astype(np.float32)


def _capacity(S, cf, E=4):
    return PM._capacity(PM.MoEConfig(n_experts=E, capacity_factor=cf), S)


# ------------------------------------------------------------ the pieces


def jax_route_vjp(logits, d_gate, d_aux):
    """jax.vjp of moe.py :70-72 and :112-114 (softmax, argmax, max, the aux
    loss) from logits to (gate, aux), pulled back from (d_gate, d_aux)."""
    E = logits.shape[-1]

    def f(lg):
        probs = jax.nn.softmax(lg, axis=-1)
        expert = jnp.argmax(probs, axis=-1)
        gate = jnp.max(probs, axis=-1)
        onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
        aux = E * jnp.sum(onehot.mean(axis=(0, 1)) * probs.mean(axis=(0, 1)))
        return gate, aux

    _, vjp = jax.vjp(f, jnp.asarray(logits))
    return np.asarray(vjp((jnp.asarray(d_gate), jnp.float32(d_aux)))[0])


def _route_bwd_case(logits, seed=3, d_aux=0.37):
    C = _capacity(logits.shape[1], 1.25, logits.shape[2])
    rng = np.random.default_rng(seed)
    d_gate = rng.standard_normal(logits.shape[:2]).astype(np.float32)
    d_aux = np.float32(d_aux)
    _, _, _, _, stats = K.moe_route(torch.from_numpy(logits), C)
    frac, _ = K.aux_loss(stats, logits.shape[0] * logits.shape[1])
    got = K.moe_route_bwd(torch.from_numpy(logits), torch.from_numpy(d_gate), frac,
                          torch.tensor(d_aux)).numpy()
    return got, jax_route_vjp(logits, d_gate, d_aux)


@pytest.mark.parametrize("E,S", [(4, 64), (4, 61), (1, 64), (4, 1), (8, 61)])
def test_route_bwd_matches_jax_vjp(E, S):
    got, want = _route_bwd_case(_logits(S, E))
    assert got.dtype == np.float32 and got.shape == want.shape
    err, _ = _leaf_err(got, want)
    assert err <= 1e-6, err
    if E == 1:  # softmax of one logit: no gradient reaches it
        assert (got == 0).all()


@pytest.mark.parametrize("E", [1, 3, 8, 9, 32, 33, 64])
def test_route_bwd_layout_in_the_source(E):
    """K9a''s layout, one lane a (token, expert), as the source builds it: a
    group of the next power of two >= E lanes a token (lanes past E idle),
    32 / lanes tokens a warp; past 32 experts one warp a token, two experts
    a lane; 8 warps a block. moe_route_bwd's switch instantiates the kernel
    for every E this test takes, every expert has a lane and fewer than
    half the lanes idle. 512 blocks of 256 at the main path's [8, 2048, 8]."""
    src = K.LIBRARY.src.read_text()
    assert int(re.search(r"constexpr int kRouteBwdThreads = (\d+);", src).group(1)) == 256
    assert re.search(r"while \(lanes < E && lanes < 32\) lanes <<= 1;", src)
    assert re.search(r"route_bwd_per_lane\(int E\) \{ return E > 32 \? 2 : 1; \}", src)
    body = src[src.index("int moe_route_bwd(const float* logits"):]
    layouts = {int(c): (int(a), int(b)) for c, a, b in re.findall(
        r"case (\d+): return launch_route_bwd<(\d+), (\d+)>", body)}
    default = tuple(map(int, re.search(r"default: return launch_route_bwd<(\d+), (\d+)>",
                                       body).groups()))
    lanes = 1 << max(0, min(E, 32) - 1).bit_length()
    per = 2 if E > 32 else 1
    assert layouts.get(lanes * per, default) == (lanes, per)
    assert lanes * per >= E > lanes * per // 2
    if E == 8:
        assert -(-8 * 2048 // (256 // 32 * (32 // lanes))) == 512


def test_route_bwd_splits_the_gate_over_exact_ties():
    """jnp.max's gradient goes to every expert tied at the max, divided by
    their count, not to the argmax (the first index) alone: without the aux
    term, two tied experts get the same d_logits; all four tie where the
    logits are 0 (x = 0)."""
    logits = _logits(64)
    logits[:, ::3, 1] = 5.0  # experts 1 and 3 tie at the top for every third token
    logits[:, ::3, 3] = 5.0
    logits[:, 1, :] = 0.0
    for d_aux in (0.37, 0.0):
        got, want = _route_bwd_case(logits, d_aux=d_aux)
        assert _leaf_err(got, want)[0] <= 1e-6
    np.testing.assert_array_equal(got[:, ::3, 1], got[:, ::3, 3])
    assert (got[:, ::3, 1] != 0).all()
    np.testing.assert_array_equal(got[:, 1], np.broadcast_to(got[:, 1, :1], (G, 4)))


@pytest.mark.parametrize("x_dt", list(DTYPES))
@pytest.mark.parametrize("cfg_dt", list(DTYPES))
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_dispatch_bwd_matches_jax_vjp(cf, cfg_dt, x_dt):
    """moe.py :89 and :99 pulled back: a gather by slot, in x's dtype, bit
    for bit; zeros for the dropped tokens."""
    logits = _logits(61)
    C = _capacity(61, cf)
    ref = jax_route(logits, C)
    x = jnp.zeros((G, 61, D), DTYPES[x_dt][0])
    _, vjp = jax.vjp(lambda xx: jnp.einsum("gsec,gsd->egcd", ref["dispatch"],
                                           xx.astype(jnp.float32)).astype(DTYPES[cfg_dt][0]), x)
    d_in = np.random.default_rng(4).standard_normal((4, G, C, D)).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(d_in, DTYPES[cfg_dt][0]))[0].astype(jnp.float32))
    got = K.moe_dispatch_bwd(torch.from_numpy(d_in).to(DTYPES[cfg_dt][1]),
                             torch.from_numpy(ref["slot"]), DTYPES[x_dt][1])
    assert got.dtype == DTYPES[x_dt][1] and tuple(got.shape) == (G, 61, D)
    np.testing.assert_array_equal(got.float().numpy(), want)
    dropped = ref["slot"] < 0
    assert dropped.any() == (cf != 4.0)
    assert (got.float().numpy()[dropped] == 0).all()


@pytest.mark.parametrize("y_dt", list(DTYPES))
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_combine_bwd_matches_jax_vjp(cf, y_dt):
    """moe.py :86 and :110 pulled back to the gate and the experts' rows:
    d_out bit for bit, d_gate within 1e-6 of its largest entry, zeros for
    the dropped tokens and the empty slots."""
    logits = _logits(61)
    C = _capacity(61, cf)
    ref = jax_route(logits, C)
    rng = np.random.default_rng(5)
    out = rng.standard_normal((4, G, C, D)).astype(np.float32)
    dy = rng.standard_normal((G, 61, D)).astype(np.float32)
    jd = DTYPES[y_dt][0]
    _, vjp = jax.vjp(lambda gate, o: jnp.einsum(
        "gsec,egcd->gsd", ref["dispatch"] * gate[..., None, None], o).astype(jd),
        jnp.asarray(ref["gate"]), jnp.asarray(out))
    want_gate, want_out = (np.asarray(a) for a in vjp(jnp.asarray(dy, jd)))
    td = DTYPES[y_dt][1]
    d_out, d_gate = K.moe_combine_bwd(
        torch.from_numpy(dy).to(td), torch.from_numpy(out), torch.from_numpy(ref["slot"]),
        torch.from_numpy(ref["gate"]), torch.from_numpy(ref["token_of_slot"]))
    assert d_out.dtype == d_gate.dtype == torch.float32
    np.testing.assert_array_equal(d_out.numpy(), want_out)
    assert _leaf_err(d_gate.numpy(), want_gate)[0] <= 1e-6
    dropped = ref["slot"] < 0
    assert (d_gate.numpy()[dropped] == 0).all()
    assert (d_out.numpy()[ref["token_of_slot"] < 0] == 0).all()


def test_backward_wrappers_raise_on_bad_inputs():
    logits, d_gate = torch.zeros((2, 8, 4)), torch.zeros((2, 8))
    frac, d_aux = torch.zeros(4), torch.zeros(())
    with pytest.raises(ValueError, match="moe_route_bwd"):
        K.moe_route_bwd(logits, d_gate[:, :4], frac, d_aux)
    with pytest.raises(ValueError, match="moe_route_bwd"):
        K.moe_route_bwd(logits, d_gate, frac.double(), d_aux)
    with pytest.raises(ValueError, match="float32"):
        K.moe_route_bwd(logits.double(), d_gate, frac, d_aux)
    slot = torch.zeros((2, 8), dtype=torch.int32)
    d_in = torch.zeros((4, 2, 3, 16))
    with pytest.raises(ValueError, match="dtype"):
        K.moe_dispatch_bwd(d_in.half(), slot, torch.float32)
    with pytest.raises(ValueError, match="moe_dispatch_bwd"):
        K.moe_dispatch_bwd(d_in, slot.long(), torch.float32)
    with pytest.raises(ValueError, match="moe_dispatch_bwd"):
        K.moe_dispatch_bwd(d_in, slot[:1], torch.float32)
    tos = torch.zeros((4, 2, 3), dtype=torch.int32)
    dy = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="moe_combine_bwd"):
        K.moe_combine_bwd(dy, d_in.bfloat16(), slot, d_gate, tos)
    with pytest.raises(ValueError, match="moe_combine_bwd"):
        K.moe_combine_bwd(dy[..., :8], d_in, slot, d_gate, tos)
    with pytest.raises(ValueError, match="moe_combine_bwd"):
        K.moe_combine_bwd(dy, d_in, slot, d_gate, tos[:, :1])


# -------------------------------------------------------- the whole layer


def _cfgs(dt, **kw):
    jd, td = DTYPES[dt]
    return JM.MoEConfig(dtype=jd, **kw), PM.MoEConfig(dtype=td, **kw)


def _jparams(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _layer_grads(tree, x, cfg_dt, x_dt, seed=2, **kw):
    """The layer's gradient by jax.vjp and by the port's backward, pulled
    back from the same seeded dy and d_aux, at SMALL updated by `kw`: two
    dicts of router, w1, w2 and x as float32 numpy arrays."""
    cfg_j, cfg_t = _cfgs(cfg_dt, **dict(SMALL, **kw))
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    d_aux = np.float32(0.37)
    jd, td = DTYPES[x_dt]
    _, vjp = jax.vjp(lambda p, xx: JM.moe_ffn(p, xx, cfg_j), _jparams(tree), jnp.asarray(x, jd))
    gj, dxj = vjp((jnp.asarray(dy, jd), jnp.float32(d_aux)))
    want = {k: np.asarray(v, np.float32) for k, v in gj.items()}
    want["x"] = np.asarray(dxj.astype(jnp.float32))
    model = PM.moe_params_from_numpy(tree, cfg_t, device="cpu").requires_grad_(True)
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    y, aux = PM.moe_ffn(model, xt)
    torch.autograd.backward([y, aux], [torch.from_numpy(dy).to(td), torch.tensor(d_aux)])
    assert xt.grad.dtype == td
    return dict(PM.moe_grads_to_numpy(model), x=xt.grad.float().numpy()), want


def _assert_layer_grads(got, want, cfg_dt, x_dt, what):
    for name in MOE_GRAD_LEAVES:
        err, same = _leaf_err(got[name], want[name])
        if name == "router":
            tol, share = (2e-6, 0.0) if cfg_dt == "f32" else (1e-5, 0.0)
        elif name == "x" and x_dt == "bf16":
            tol, share = 2.0 ** -8, 0.999
        elif name == "x":  # the router's part carries the bf16 experts' h
            tol, share = (2e-6, 0.0) if cfg_dt == "f32" else (1e-5, 0.0)
        else:
            tol, share = (2e-6, 0.0) if cfg_dt == "f32" else (2.0 ** -8, 0.999)
        assert err <= tol and same >= share, f"{what} {name}: err {err}, bit-equal {same}"


@pytest.mark.parametrize("x_dt", list(DTYPES))
@pytest.mark.parametrize("cfg_dt", list(DTYPES))
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("S", [64, 61])
def test_layer_grads_match_jax_vjp(S, cf, cfg_dt, x_dt):
    _, cfg_t, = _cfgs(cfg_dt, **SMALL)
    tree = PM.numpy_moe_params(cfg_t, 0)
    x = PM.numpy_moe_inputs(tree, (G, S, D), 1)
    got, want = _layer_grads(tree, x, cfg_dt, x_dt, capacity_factor=cf)
    _assert_layer_grads(got, want, cfg_dt, x_dt, f"S={S} cf={cf} {cfg_dt} x {x_dt}")


@pytest.mark.parametrize("case", ["tied_columns", "zero_tokens", "one_expert", "one_token"])
def test_layer_grads_at_ties_and_edges(case):
    """Exact ties through the whole layer, equal to JAX's, which splits the
    gate's gradient over the tied experts: two equal router columns tie
    their experts exactly for every token; x = 0 ties all experts (1/E
    each). And the edges E = 1 and S = 1."""
    kw = dict(SMALL)
    S = 64
    if case == "one_expert":
        kw["n_experts"] = 1
    if case == "one_token":
        S = 1
    cfg_j, cfg_t = _cfgs("f32", **kw)
    tree = PM.numpy_moe_params(cfg_t, 0)
    if case == "tied_columns":
        tree["router"][:, 3] = tree["router"][:, 1]
    x = PM.numpy_moe_inputs(tree, (G, S, D), 1, skew=0.0)
    if case == "zero_tokens":
        x[:] = 0.0
    if case == "tied_columns":
        logits = x @ tree["router"]
        assert (logits[..., 1] == logits[..., 3]).all()
        route = jax_route(logits, _capacity(S, 1.25))
        assert ((route["expert"] == 1) & (route["slot"] >= 0)).sum() > 0
    got, want = _layer_grads(tree, x, "f32", "f32", **kw)
    _assert_layer_grads(got, want, "f32", "f32", case)
    if case == "zero_tokens":
        assert (got["router"] == 0).all() and (got["w1"] == 0).all()


def test_dropped_tokens_get_no_gate_or_dispatch_gradient(monkeypatch):
    """A dropped token's d_gate is 0 and its dispatch part of dx is 0; only
    the router reaches it (through the aux loss)."""
    seen = {}
    for name in ("moe_combine_bwd", "moe_dispatch_bwd", "moe_route"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name: seen.setdefault(_n, _fn(*a)))
    _, cfg_t = _cfgs("f32", capacity_factor=0.25, **SMALL)
    tree = PM.numpy_moe_params(cfg_t, 0)
    x = torch.from_numpy(PM.numpy_moe_inputs(tree, (G, 64, D), 1)).requires_grad_(True)
    model = PM.moe_params_from_numpy(tree, cfg_t, device="cpu").requires_grad_(True)
    y, aux = PM.moe_ffn(model, x)
    (y.sum() + aux).backward()
    dropped = seen["moe_route"][2] < 0
    assert dropped.sum() > G * 64 // 2
    assert (seen["moe_combine_bwd"][1][dropped] == 0).all()
    assert (seen["moe_dispatch_bwd"][dropped] == 0).all()
    assert (x.grad[dropped] != 0).any(dim=-1).all()  # the router's part


def test_dx_adds_its_two_parts_in_bf16(monkeypatch):
    """With bf16 tokens dx is round(round(dispatch part) + round(router
    part)), as the reference's jaxpr adds them (add_any of two bf16), not
    one rounding of the float32 sum."""
    seen = {}
    for name in ("moe_dispatch_bwd", "moe_route_bwd"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name: seen.setdefault(_n, _fn(*a)))
    _, cfg_t = _cfgs("bf16", **SMALL)
    tree = PM.numpy_moe_params(cfg_t, 0)
    x = torch.from_numpy(PM.numpy_moe_inputs(tree, (G, 64, D), 1)).bfloat16()
    x.requires_grad_(True)
    model = PM.moe_params_from_numpy(tree, cfg_t, device="cpu").requires_grad_(True)
    y, aux = PM.moe_ffn(model, x)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    torch.autograd.backward([y, aux], [dy.bfloat16(), torch.tensor(0.37)])
    dispatch_part = seen["moe_dispatch_bwd"]
    router_part = torch.matmul(seen["moe_route_bwd"], model.router.detach().t())
    assert dispatch_part.dtype == torch.bfloat16
    twice = (dispatch_part.float() + router_part.bfloat16().float()).bfloat16()
    once = (dispatch_part.float() + router_part).bfloat16()
    assert torch.equal(x.grad, twice)
    assert not torch.equal(x.grad, once)


def test_port_of_test_moe_grads_flow():
    """tests/test_parallel.py::test_moe_grads_flow on the port: the same
    config, weights (carried from init_moe_params(PRNGKey(7))) and tokens;
    the loss (y ** 2).mean() + 0.01 * aux; every gradient finite, not all
    zero, and equal to jax.grad's within 2e-6 of each leaf's largest entry."""
    cfg_j = JM.MoEConfig(d_model=8, d_ff=16, n_experts=4, dtype=jnp.float32)
    cfg_t = PM.MoEConfig(d_model=8, d_ff=16, n_experts=4, dtype=torch.float32)
    params = JM.init_moe_params(jax.random.PRNGKey(7), cfg_j)
    x = jax.random.normal(jax.random.PRNGKey(8), (2, 8, cfg_j.d_model))

    def loss(p):
        y, aux = JM.moe_ffn(p, x, cfg_j)
        return (y ** 2).mean() + 0.01 * aux

    loss_j, g = jax.value_and_grad(loss)(params)
    model = PM.moe_params_from_numpy({k: np.array(v) for k, v in params.items()}, cfg_t,
                                     device="cpu").requires_grad_(True)
    y, aux = PM.moe_ffn(model, torch.from_numpy(np.array(x)))
    loss_t = (y ** 2).mean() + 0.01 * aux
    loss_t.backward()
    got = PM.moe_grads_to_numpy(model)
    norms = [float(np.abs(leaf).sum()) for leaf in got.values()]
    assert all(np.isfinite(norms)) and sum(norms) > 0
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    for name in ("router", "w1", "w2"):
        assert _leaf_err(got[name], g[name])[0] <= 2e-6, name


@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_adamw_steps_match_optax(dt):
    """The layer's train step, written out: the reference test's loss,
    backward, make_optimizer()'s AdamW; twice, against jax.grad and
    optax.adamw(3e-4, weight_decay=0.01)."""
    cfg_j, cfg_t = _cfgs(dt, **SMALL)
    tree = PM.numpy_moe_params(cfg_t, 0)
    x = PM.numpy_moe_inputs(tree, (G, 64, D), 1)

    def loss(p):
        y, aux = JM.moe_ffn(p, jnp.asarray(x), cfg_j)
        return (y ** 2).mean() + 0.01 * aux

    tx_j = optax.adamw(LR, weight_decay=WD)
    params_j = _jparams(tree)
    state_j = tx_j.init(params_j)
    model = PM.moe_params_from_numpy(tree, cfg_t, device="cpu").requires_grad_(True)
    tx = make_optimizer(LR, WD)
    state = tx.init(model)
    xt = torch.from_numpy(x)
    for i in range(2):
        updates, state_j = tx_j.update(jax.grad(loss)(params_j), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        model.zero_grad(set_to_none=True)
        y, aux = PM.moe_ffn(model, xt)
        ((y.float() ** 2).mean() + 0.01 * aux).backward()
        tx.update(model, state)
        got = PM.moe_to_numpy(model)
        for name in ("router", "w1", "w2"):
            d = np.abs(got[name] - np.asarray(params_j[name]))
            if dt == "f32":
                assert d.max() <= 1e-6 and (d <= 1e-7).mean() >= 0.999, (i, name, d.max())
            else:
                assert d.max() <= 2 * LR + 1e-6 and (d <= 1e-6).mean() >= 0.99, \
                    (i, name, d.max(), (d <= 1e-6).mean())
    assert state.count == 2


def test_no_graph_and_no_backward_kernels_when_gradients_are_off(monkeypatch):
    """Gradients off (or nothing requiring one): moe_ffn builds no graph and
    calls K9a, K9b and K9c once each, as before; with gradients on, the
    same three forwards, then each backward once."""
    calls = []
    for name, fn in K.KERNELS.items():
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    _, cfg_t = _cfgs("bf16", **SMALL)
    tree = PM.numpy_moe_params(cfg_t, 0)
    x = torch.from_numpy(PM.numpy_moe_inputs(tree, (G, 16, D), 1)).bfloat16()
    frozen = PM.moe_params_from_numpy(tree, cfg_t, device="cpu")
    trained = PM.moe_params_from_numpy(tree, cfg_t, device="cpu").requires_grad_(True)
    forward = ["moe_route", "moe_dispatch", "moe_combine"]
    for model, grad_on in ((frozen, True), (trained, False)):
        calls.clear()
        with torch.set_grad_enabled(grad_on):
            y, aux = PM.moe_ffn(model, x)
        assert y.grad_fn is None and aux.grad_fn is None and not y.requires_grad
        assert calls == forward
    calls.clear()
    y, aux = PM.moe_ffn(trained, x.clone().requires_grad_(True))
    assert y.grad_fn is not None and aux.grad_fn is not None
    y2, aux2 = PM.moe_ffn(frozen, x)
    assert torch.equal(y.detach(), y2) and torch.equal(aux.detach(), aux2)
    (y.float().square().mean() + aux).backward()
    assert calls[:3] == forward and calls[3:6] == forward
    assert sorted(calls[6:]) == ["moe_combine_bwd", "moe_dispatch_bwd", "moe_route_bwd"]


def test_grads_to_numpy_needs_a_backward():
    _, cfg_t = _cfgs("f32", **SMALL)
    model = PM.moe_params_from_numpy(PM.numpy_moe_params(cfg_t, 0), cfg_t, device="cpu")
    with pytest.raises(ValueError, match="backward"):
        PM.moe_grads_to_numpy(model.requires_grad_(True))


# ------------------------------------------------------------------ golden


def _golden_positions(sizes):
    rng = np.random.default_rng(GOLDEN_POSITION_SEED)
    return {name: np.sort(rng.choice(sizes[name], min(GOLDEN_SAMPLES, sizes[name]),
                                     replace=False)).astype(np.int64)
            for name in MOE_GRAD_LEAVES}


def _jax_golden_step(tree, x, dt):
    """ray_tpu's layer, one training step: the loss of
    tests/test_parallel.py::test_moe_grads_flow, its aux, the gradient of
    the loss in the parameters and in x, and the parameters after one
    optax.adamw(3e-4, weight_decay=0.01) step."""
    cfg_j, _ = _cfgs(dt)
    params = _jparams(tree)

    def loss(p, xx):
        y, aux = JM.moe_ffn(p, xx, cfg_j)
        return (y ** 2).mean() + 0.01 * aux, aux

    (loss_v, aux), (grads, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = optax.adamw(LR, weight_decay=WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    params1 = optax.apply_updates(params, updates)
    grads = {k: np.asarray(v) for k, v in grads.items()}
    grads["x"] = np.asarray(dx)
    return float(loss_v), float(aux), grads, {k: np.asarray(v) for k, v in params1.items()}


def write_moe_grad_golden(path=GOLDEN_PATH):
    """Write the one-step golden from the JAX package: MoEConfig() in
    float32 and bfloat16 on golden_inputs() (the MoE golden's weights, seed
    0, and x [2, 2048, 256] float32, seed 1, skew 1.0). Per dtype: the
    loss, aux, each leaf's gradient L2 norm (router, w1, w2, x), 4 096
    gradient entries a leaf at seeded positions, and the same entries of
    the parameters after one AdamW step; and each group's smallest top-2
    gap. Called by hand from a script; no test writes it."""
    tree, x = golden_inputs()
    sizes = dict({k: v.size for k, v in tree.items()}, x=x.size)
    pos = _golden_positions(sizes)
    logits = x @ tree["router"]
    out = {"weight_seed": np.int64(0), "x_seed": np.int64(1), "skew": np.float32(1.0),
           "shape": np.asarray(x.shape, np.int64), "lr": np.float32(LR),
           "weight_decay": np.float32(WD), "leaves": np.asarray(MOE_GRAD_LEAVES),
           "checksum": np.asarray(PM.moe_weights_checksum(tree)),
           "group_gap": top2_gap(logits).min(axis=1).astype(np.float32)}
    for name in MOE_GRAD_LEAVES:
        out[f"pos_{name}"] = pos[name]
    for dt in DTYPES:
        loss, aux, grads, params1 = _jax_golden_step(tree, x, dt)
        out[f"loss_{dt}"] = np.float32(loss)
        out[f"aux_{dt}"] = np.float32(aux)
        out[f"grad_norm_{dt}"] = np.asarray(
            [np.linalg.norm(grads[n].astype(np.float64)) for n in MOE_GRAD_LEAVES], np.float64)
        for name in MOE_GRAD_LEAVES:
            out[f"grad_{dt}_{name}"] = grads[name].reshape(-1)[pos[name]]
            if name in params1:
                out[f"param1_{dt}_{name}"] = params1[name].reshape(-1)[pos[name]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


def test_moe_grad_golden_is_the_reference_and_the_port_meets_it():
    """The committed golden equals a fresh run of the JAX package, its
    groups are free of near-ties (a weight's gradient sums over every
    group, so none can be left out), and the port's plain step meets it
    within MOE_GRAD_GOLDEN_TOL (its comment has the values measured here)."""
    g = np.load(GOLDEN_PATH)
    tree, x = golden_inputs()
    assert str(g["checksum"]) == PM.moe_weights_checksum(tree)
    assert tuple(g["shape"]) == x.shape and tuple(str(n) for n in g["leaves"]) == MOE_GRAD_LEAVES
    assert (g["group_gap"] >= MOE_TIE_GAP).all()
    np.testing.assert_allclose(g["group_gap"], top2_gap(x @ tree["router"]).min(axis=1),
                               rtol=0, atol=1e-6)
    pos = _golden_positions(dict({k: v.size for k, v in tree.items()}, x=x.size))
    for dt in DTYPES:
        loss, aux, grads, params1 = _jax_golden_step(tree, x, dt)
        np.testing.assert_allclose([loss, aux], [g[f"loss_{dt}"], g[f"aux_{dt}"]], rtol=1e-6)
        for i, name in enumerate(MOE_GRAD_LEAVES):
            np.testing.assert_array_equal(g[f"pos_{name}"], pos[name])
            np.testing.assert_allclose(np.linalg.norm(grads[name].astype(np.float64)),
                                       g[f"grad_norm_{dt}"][i], rtol=1e-5)
            np.testing.assert_allclose(grads[name].reshape(-1)[pos[name]],
                                       g[f"grad_{dt}_{name}"], rtol=1e-5, atol=1e-9)
            if name in params1:
                np.testing.assert_allclose(params1[name].reshape(-1)[pos[name]],
                                           g[f"param1_{dt}_{name}"], rtol=0, atol=1e-7)
        err = PM.moe_grad_golden_errors(g, dt, device="cpu")
        assert set(err) == set(MOE_GRAD_GOLDEN_TOL[dt])
        assert not PM.moe_grad_golden_violations(err, dt), (dt, err, MOE_GRAD_GOLDEN_TOL[dt])
        assert set(PM.moe_grad_golden_violations({**err, "loss": 1.0, "param_share": 0.0},
                                                  dt)) == {"loss", "param_share"}


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_cuda_moe_backward_kernels_equal_plain_on_card():
    """On the card: K9a', K9b' and K9c' against their plain versions over
    expert counts 1 to 64 (every template of K9a'), S from 1 to 2 048, a D
    that is not a multiple of 8 (the one-element path), every dtype pair
    and exact ties; the gathers bit-equal, d_gate and d_logits within
    BWD_TOL of their largest entry; a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)

    def close(a, b, what):
        a, b = a.double().cpu(), b.double().cpu()
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= K.BWD_TOL * scale, what

    for E, S, Dw in ((1, 300, 32), (4, 61, 36), (8, 2048, 256), (13, 1, 8), (33, 700, 40),
                     (64, 513, 64)):
        Gn = 3
        logits = (rng.standard_normal((Gn, S, E)) * 2).astype(np.float32)
        logits[:, :, 0] += 1.0
        if E > 2:
            logits[:, ::5, 2] = logits[:, ::5, 1] = 9.0  # exact ties
        lt = torch.from_numpy(logits).to(dev)
        for C in (1, max(1, int(S * 1.25 / E)), S):
            _, gate, slot, tos, stats = K.moe_route(lt, C)
            frac, _ = K.aux_loss(stats, Gn * S)
            d_gate = torch.from_numpy(rng.standard_normal((Gn, S)).astype(np.float32)).to(dev)
            d_aux = torch.tensor(0.37, device=dev)
            got = K.moe_route_bwd(lt, d_gate, frac, d_aux)
            close(got, K._route_bwd_plain(lt, d_gate, frac, d_aux), (E, S, C, "d_logits"))
            assert torch.equal(got, K.moe_route_bwd(lt, d_gate, frac, d_aux))
            for in_td in (torch.float32, torch.bfloat16):
                d_in = torch.from_numpy(rng.standard_normal((E, Gn, C, Dw)).astype(np.float32)) \
                    .to(dev, in_td)
                dy = torch.from_numpy(rng.standard_normal((Gn, S, Dw)).astype(np.float32)) \
                    .to(dev, in_td)
                out = torch.from_numpy(rng.standard_normal((E, Gn, C, Dw)).astype(np.float32)) \
                    .to(dev)
                for dx_td in (torch.float32, torch.bfloat16):
                    dx = K.moe_dispatch_bwd(d_in, slot, dx_td)
                    assert torch.equal(dx, K._dispatch_bwd_plain(d_in, slot, dx_td)), (E, S, Dw)
                    assert torch.equal(dx, K.moe_dispatch_bwd(d_in, slot, dx_td))
                d_out, dg = K.moe_combine_bwd(dy, out, slot, gate, tos)
                want_out, want_gate = K._combine_bwd_plain(dy, out, slot, gate, tos)
                assert torch.equal(d_out, want_out), (E, S, Dw)
                close(dg, want_gate, (E, S, Dw, "d_gate"))
                assert bool((dg[slot < 0] == 0).all())
                again = K.moe_combine_bwd(dy, out, slot, gate, tos)
                assert torch.equal(d_out, again[0]) and torch.equal(dg, again[1])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_route_bwd_lanes_equal_plain_and_are_deterministic():
    """On the card: K9a' (one lane a (token, expert)) against its plain
    version within BWD_TOL of the largest entry at E = 3, 8, 9, 33 and 64,
    over G * S not a multiple of the tokens a block, with exact ties (two
    experts, and every expert, equal on some tokens), a second launch the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    for E in (3, 8, 9, 33, 64):
        # G·S of 3003 and 7 are a multiple of no layout's tokens a block
        for Gn, S in ((3, 1001), (8, 2048), (1, 7)):
            logits = (rng.standard_normal((Gn, S, E)) * 2).astype(np.float32)
            logits[:, ::7, 0] = logits[:, ::7, E - 1] = 6.0  # two experts tied at the max
            logits[:, 3::11] = 0.5                           # every expert tied
            lt = torch.from_numpy(logits).to(dev)
            frac = torch.from_numpy(rng.random(E).astype(np.float32)).to(dev)
            d_gate = torch.from_numpy(rng.standard_normal((Gn, S)).astype(np.float32)).to(dev)
            d_aux = torch.tensor(0.37, device=dev)
            got = K.moe_route_bwd(lt, d_gate, frac, d_aux)
            want = K._route_bwd_plain(lt, d_gate, frac, d_aux)
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= K.BWD_TOL * scale, (E, Gn, S)
            assert torch.equal(got, K.moe_route_bwd(lt, d_gate, frac, d_aux)), (E, Gn, S)
    torch.cuda.synchronize()


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (not 16-byte aligned)."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    start = next(i for i in range(1, 16) if (flat.data_ptr() + i * t.element_size()) % 16)
    view = flat[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def test_combine_bwd_one_launch_form_by_width_and_alignment():
    """K9c' takes its one-launch form for D a multiple of 8 with dy and out
    16-byte aligned (as the source decides), else its two-launch form; an
    offset view is not aligned and holds the same values."""
    for D, want in ((256, True), (8, True), (20, False), (36, False)):
        dy, out = torch.zeros((2, 4, D)), torch.zeros((3, 2, 2, D))
        assert K.combine_bwd_one_launch(dy, out) is want
    dy = torch.arange(2 * 4 * 256, dtype=torch.float32).reshape(2, 4, 256)
    out = torch.zeros((3, 2, 2, 256))
    moved = _offset_view(dy)
    assert moved.is_contiguous() and torch.equal(moved, dy)
    assert not K.combine_bwd_one_launch(moved, out)
    assert not K.combine_bwd_one_launch(dy, _offset_view(out))


@pytest.mark.cuda
def test_cuda_combine_bwd_one_launch_and_fallback_equal_plain():
    """On the card: K9c' in one launch (D = 256) and in its two-launch form
    (D = 20, and D = 256 with dy or out offset from a 16-byte boundary), in
    f32 and bf16 dy: d_out bit-equal to the plain version, d_gate within
    BWD_TOL of its largest entry and 0 for a dropped token, two launches the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    Gn, S, E = 4, 512, 8
    logits = torch.from_numpy((rng.standard_normal((Gn, S, E)) * 2).astype(np.float32)).to(dev)
    logits[:, :, 0] += 1.5  # skewed: the capacity drops some
    C = int(S * 1.25 / E)
    _, gate, slot, tos, _ = K.moe_route(logits, C)
    assert bool((slot < 0).any())
    forms = set()
    for Dw, offset in ((256, None), (20, None), (256, "dy"), (256, "out")):
        out = torch.from_numpy(rng.standard_normal((E, Gn, C, Dw)).astype(np.float32)).to(dev)
        for td in (torch.float32, torch.bfloat16):
            dy = torch.from_numpy(rng.standard_normal((Gn, S, Dw)).astype(np.float32)).to(dev, td)
            o = _offset_view(out) if offset == "out" else out
            y = _offset_view(dy) if offset == "dy" else dy
            forms.add(K.combine_bwd_one_launch(y, o))
            d_out, dg = K.moe_combine_bwd(y, o, slot, gate, tos)
            want_out, want_gate = K._combine_bwd_plain(y, o, slot, gate, tos)
            assert torch.equal(d_out, want_out), (Dw, offset, td)
            scale = float(want_gate.abs().max())
            assert float((dg - want_gate).abs().max()) <= K.BWD_TOL * scale, (Dw, offset, td)
            assert bool((dg[slot < 0] == 0).all())
            again = K.moe_combine_bwd(y, o, slot, gate, tos)
            assert torch.equal(d_out, again[0]) and torch.equal(dg, again[1])
    assert forms == {True, False}
    torch.cuda.synchronize()
