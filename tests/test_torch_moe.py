"""ray_tpu_torch's expert layer (plain kernels, on the CPU) held against
ray_tpu.models.moe on the same numpy-seeded weights and tokens.

Small config: d_model 32, d_ff 64, 4 experts, G 4, at S = 64 and the
ragged S = 61, with a skewed router (numpy_moe_inputs) so that the
capacity drops tokens; capacity factors 1.25, 4.0 (no drops), 0.25 and
0.0625 (C = 1). Tolerances are models.moe.MOE_GOLDEN_TOL: y within 2e-5 in
float32 (the same products summed in another order) and 5e-3 in bfloat16
(h is rounded to bf16 after a float32 sum in another order, so one
rounding can differ by 2**-8 relative); aux within 1e-6. The rows that are
exactly zero (dropped tokens) must be the same rows.

The full-width golden (tests/data/moe_golden.npz, written once by
write_moe_golden below from the JAX package) is recomputed here from
ray_tpu, so it cannot drift from the reference, and chip_smoke.py holds the
card's moe_ffn and its routing kernel against it with the same tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as JM
from ray_tpu_torch.models import moe as PM
from ray_tpu_torch.models import moe_kernels as K
from ray_tpu_torch.models.moe import MOE_GOLDEN_TOL, MOE_TIE_GAP
from test_torch_moe_kernels import jax_route  # tests/ is on sys.path (pytest's prepend mode)

SMALL = dict(d_model=32, d_ff=64, n_experts=4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "moe_golden.npz")
GOLDEN_WEIGHT_SEED = 0
GOLDEN_X_SEED = 1
GOLDEN_SKEW = 1.0
GOLDEN_SHAPE = (2, 2048, 256)
GOLDEN_POSITION_SEED = 3
GOLDEN_KEPT, GOLDEN_DROPPED = 48, 16  # positions stored a group


def _cfgs(dt, **kw):
    jd, td = DTYPES[dt]
    return JM.MoEConfig(dtype=jd, **kw), PM.MoEConfig(dtype=td, **kw)


def _jparams(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def top2_gap(logits):
    """Each token's largest router probability minus its second largest,
    from the reference's softmax."""
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)), axis=-1)
    return p[..., -1] - p[..., -2]


def golden_inputs():
    cfg = PM.MoEConfig()
    tree = PM.numpy_moe_params(cfg, GOLDEN_WEIGHT_SEED)
    return tree, PM.numpy_moe_inputs(tree, GOLDEN_SHAPE, GOLDEN_X_SEED, GOLDEN_SKEW)


def write_moe_golden(path=GOLDEN_PATH):
    """Write the full-width golden from the JAX package: MoEConfig() in
    float32 and bfloat16, weights from numpy_moe_params (seed 0), x [2,
    2048, 256] float32 from numpy_moe_inputs (seed 1, skew 1.0). Stores the
    router logits, the routing (expert, slot, gate), the top-2 gaps, aux,
    and y at 64 seeded positions a group (16 of them dropped tokens).
    Called by hand from a script; no test writes it."""
    tree, x = golden_inputs()
    params = _jparams(tree)
    S = GOLDEN_SHAPE[1]
    C = PM._capacity(PM.MoEConfig(), S)
    # moe.py :67-69
    logits = np.asarray(jnp.einsum("gsd,de->gse", jnp.asarray(x).astype(jnp.float32),
                                   params["router"]))
    route = jax_route(logits, C)
    rng = np.random.default_rng(GOLDEN_POSITION_SEED)
    positions = np.stack([np.sort(np.concatenate([
        rng.choice(np.flatnonzero(route["slot"][g] >= 0), GOLDEN_KEPT, replace=False),
        rng.choice(np.flatnonzero(route["slot"][g] < 0), GOLDEN_DROPPED, replace=False)]))
        for g in range(GOLDEN_SHAPE[0])]).astype(np.int32)
    out = {"weight_seed": np.int64(GOLDEN_WEIGHT_SEED), "x_seed": np.int64(GOLDEN_X_SEED),
           "skew": np.float32(GOLDEN_SKEW), "checksum": np.asarray(PM.moe_weights_checksum(tree)),
           "logits": logits, "expert": route["expert"], "slot": route["slot"],
           "gate": route["gate"], "gap": top2_gap(logits).astype(np.float32),
           "positions": positions}
    for dt in DTYPES:
        cfg_j, _ = _cfgs(dt)
        y, aux = JM.moe_ffn(params, jnp.asarray(x), cfg_j)
        y = np.asarray(y)
        out[f"y_{dt}"] = np.stack([y[g, positions[g]] for g in range(len(positions))])
        out[f"aux_{dt}"] = np.float32(aux)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


def _small(dt, cf=1.25, seed=0):
    cfg_j, cfg_t = _cfgs(dt, capacity_factor=cf, **SMALL)
    tree = PM.numpy_moe_params(cfg_t, seed)
    return cfg_j, cfg_t, tree, PM.moe_params_from_numpy(tree, cfg_t, device="cpu")


def _x(tree, S, seed=1):
    return PM.numpy_moe_inputs(tree, (4, S, SMALL["d_model"]), seed)


def _assert_y_close(got, want, dt, what=""):
    atol = MOE_GOLDEN_TOL[dt][0]
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1), err_msg=what)


@pytest.mark.parametrize("cf", [1.25, 4.0, 0.25, 0.0625])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [64, 61])
def test_moe_ffn_matches_reference(S, dt, cf):
    cfg_j, cfg_t, tree, model = _small(dt, cf)
    x = _x(tree, S)
    yj, auxj = JM.moe_ffn(_jparams(tree), jnp.asarray(x), cfg_j)
    yt, auxt = PM.moe_ffn(model, torch.from_numpy(x))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape  # x's dtype, not cfg's
    assert auxt.dtype == torch.float32 and auxt.dim() == 0
    _assert_y_close(yt.numpy(), np.asarray(yj), dt, f"S={S} {dt} cf={cf}")
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0, atol=MOE_GOLDEN_TOL[dt][1])
    dropped = (yt.numpy() == 0).all(-1)
    assert dropped.any() == (cf != 4.0)  # the skewed router overflows expert 0


def test_moe_ffn_on_bf16_tokens_keeps_their_dtype():
    """The served case: x in bf16 and experts in bf16; y comes back in bf16,
    within one bf16 rounding of the reference's."""
    cfg_j, cfg_t, tree, model = _small("bf16")
    x = _x(tree, 64)
    xb = torch.from_numpy(x).bfloat16()
    yj, auxj = JM.moe_ffn(_jparams(tree), jnp.asarray(x, jnp.bfloat16), cfg_j)
    yt, auxt = model(xb)
    assert yt.dtype == torch.bfloat16
    yj = np.asarray(yj.astype(jnp.float32))
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=2**-7, atol=MOE_GOLDEN_TOL["bf16"][0])
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_no_drops_matches_the_dense_references(dt):
    """With the capacity at S nothing is dropped, so moe_ffn equals the
    dense reference_moe_ffn, the port's and (in float32) the JAX
    package's. The JAX package's reference_moe_ffn does not run in bf16 on
    the CPU (XLA's CPU dot takes no bf16 x bf16 = f32 product of that
    einsum), so in bf16 the port's reference stands for it; its float32 path
    is the same code with the casts."""
    cfg_j, cfg_t, tree, model = _small(dt, cf=4.0)
    x = _x(tree, 61)
    assert PM._capacity(cfg_t, 61) == 61
    y, _ = PM.moe_ffn(model, torch.from_numpy(x))
    ref_t = PM.reference_moe_ffn(model, torch.from_numpy(x))
    _assert_y_close(y.numpy(), ref_t.numpy(), dt, "moe_ffn vs the port's reference")
    if dt == "f32":
        ref_j = np.asarray(JM.reference_moe_ffn(_jparams(tree), jnp.asarray(x), cfg_j))
        _assert_y_close(ref_t.numpy(), ref_j, dt, "reference_moe_ffn")
        _assert_y_close(y.numpy(), ref_j, dt, "moe_ffn vs the JAX reference")


def test_capacity_is_the_reference_formula():
    for S in (1, 7, 61, 64, 2048, 4097):
        for cf in (0.0625, 0.25, 1.0, 1.25, 2.0):
            for E in (1, 3, 8, 64):
                cfg_j = JM.MoEConfig(n_experts=E, capacity_factor=cf)
                cfg_t = PM.MoEConfig(n_experts=E, capacity_factor=cf)
                assert PM._capacity(cfg_t, S) == JM._capacity(cfg_j, S)


def test_params_round_trip_bit_for_bit():
    _, cfg_t, tree, model = _small("bf16")
    back = PM.moe_to_numpy(model)
    for key in ("router", "w1", "w2"):
        assert back[key].dtype == np.float32 and back[key].shape == tree[key].shape, key
        np.testing.assert_array_equal(back[key].view(np.uint32), tree[key].view(np.uint32))
    assert PM.moe_weights_checksum(back) == PM.moe_weights_checksum(tree)
    assert all(not p.requires_grad for p in model.parameters())


def test_params_from_numpy_rejects_wrong_shapes():
    _, cfg_t, tree, _ = _small("f32")
    for key, bad in (("router", tree["router"][:, :2]), ("w1", tree["w1"][:3]),
                     ("w2", tree["w2"].transpose(0, 2, 1))):
        with pytest.raises(ValueError, match=key):
            PM.moe_params_from_numpy(dict(tree, **{key: bad}), cfg_t, device="cpu")
    with pytest.raises(ValueError, match="experts"):
        PM.MoE(PM.MoEConfig(n_experts=65), device="cpu")
    with pytest.raises(ValueError, match="moe_ffn"):
        PM.moe_ffn(PM.moe_params_from_numpy(tree, cfg_t, device="cpu"), torch.zeros((2, 8, 16)))


def test_init_moe_params_draws_the_reference_distribution():
    cfg = PM.MoEConfig()
    model = PM.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = PM.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(model.w1, again.w1)
    ref = JM.init_moe_params(jax.random.PRNGKey(0), JM.MoEConfig())
    for key, fan in (("router", cfg.d_model), ("w1", cfg.d_model), ("w2", cfg.d_ff)):
        got = getattr(model, key)
        assert tuple(got.shape) == ref[key].shape, key
        assert abs(float(got.std()) * fan ** 0.5 - 1.0) < 0.05, key
        assert abs(float(np.asarray(ref[key]).std()) * fan ** 0.5 - 1.0) < 0.05, key
        assert abs(float(got.mean())) * fan ** 0.5 < 0.05, key


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PM.MoEConfig(**SMALL)
    tree = PM.numpy_moe_params(cfg, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        PM.MoE(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        PM.moe_params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        PM.init_moe_params(cfg, torch.Generator().manual_seed(0))


def test_a_mesh_is_the_multi_card_work():
    """The mesh form is forward only: under autograd it raises, naming the
    next slice (its forward across ranks: tests/test_torch_parallel.py)."""
    _, cfg_t, tree, model = _small("f32")
    x = torch.from_numpy(_x(tree, 8)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.moe_ffn(model, x, cfg_t, mesh=object())


def test_moe_ffn_goes_through_the_kernels_wrappers(monkeypatch):
    """moe_ffn reaches K9a, K9b and K9c through their wrappers (the plain
    versions on the CPU), once each."""
    calls = []
    for name, fn in K.KERNELS.items():
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    _, _, tree, model = _small("f32")
    model(torch.from_numpy(_x(tree, 16)))
    assert calls == ["moe_route", "moe_dispatch", "moe_combine"]


def test_golden_file_is_the_reference_and_the_port_meets_it():
    """The committed golden equals a fresh run of the JAX package (weights
    by checksum; logits, routing, aux, y at the stored positions), its
    routing is K9a's (plain) on its logits, and the port's plain moe_ffn on
    the CPU meets it within MOE_GOLDEN_TOL in the groups free of near-ties."""
    g = np.load(GOLDEN_PATH)
    tree, x = golden_inputs()
    assert str(g["checksum"]) == PM.moe_weights_checksum(tree)
    assert (int(g["weight_seed"]), int(g["x_seed"]), float(g["skew"])) == \
        (GOLDEN_WEIGHT_SEED, GOLDEN_X_SEED, GOLDEN_SKEW)
    params = _jparams(tree)
    C = PM._capacity(PM.MoEConfig(), GOLDEN_SHAPE[1])
    logits = np.asarray(jnp.einsum("gsd,de->gse", jnp.asarray(x), params["router"]))
    np.testing.assert_allclose(logits, g["logits"], rtol=0, atol=1e-5)
    route = jax_route(g["logits"], C)
    for key in ("expert", "slot"):
        np.testing.assert_array_equal(route[key], g[key], err_msg=key)
    np.testing.assert_allclose(route["gate"], g["gate"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(top2_gap(g["logits"]), g["gap"], rtol=0, atol=1e-6)
    dropped = (g["slot"] < 0).mean()
    assert 0.2 < dropped < 0.35, dropped
    pos = g["positions"]
    assert (np.take_along_axis(g["slot"], pos, 1) < 0).sum() == GOLDEN_DROPPED * len(pos)

    expert, gate, slot, _, _ = K.moe_route(torch.from_numpy(g["logits"]), C)
    np.testing.assert_array_equal(expert.numpy(), g["expert"])
    np.testing.assert_array_equal(slot.numpy(), g["slot"])
    np.testing.assert_allclose(gate.numpy(), g["gate"], rtol=0, atol=1e-6)

    clean = g["gap"].min(axis=1) >= MOE_TIE_GAP
    assert clean.all()  # both groups of this golden are free of near-ties
    for dt, (jd, td) in DTYPES.items():
        y, aux = JM.moe_ffn(params, jnp.asarray(x), JM.MoEConfig(dtype=jd))
        y = np.asarray(y)
        want = np.stack([y[i, pos[i]] for i in range(len(pos))])
        np.testing.assert_allclose(want, g[f"y_{dt}"], rtol=0, atol=MOE_GOLDEN_TOL[dt][0])
        np.testing.assert_allclose(float(aux), float(g[f"aux_{dt}"]), rtol=0, atol=1e-6)
        model = PM.moe_params_from_numpy(tree, PM.MoEConfig(dtype=td), device="cpu")
        yt, auxt = PM.moe_ffn(model, torch.from_numpy(x))
        got = np.stack([yt.numpy()[i, pos[i]] for i in range(len(pos))])
        _assert_y_close(got[clean], g[f"y_{dt}"][clean], dt, f"golden {dt}")
        np.testing.assert_allclose(float(auxt), float(g[f"aux_{dt}"]), rtol=0,
                                   atol=MOE_GOLDEN_TOL[dt][1])
