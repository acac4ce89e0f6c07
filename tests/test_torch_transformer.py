"""ray_tpu_torch's transformer (plain kernels, on the CPU) held against
ray_tpu.models.transformer on the same numpy-seeded weights and tokens.

Small config: vocab 256, d_model 64, 4 heads, 2 layers, d_ff 128, at
S = 32 and the ragged S = 31. Tolerances:
- float32: logits within 1e-4, loss within 1e-5 relative (the same
  arithmetic in another summation order).
- bfloat16: logits within 0.08 and loss within 1e-2. The port rounds the
  attention probabilities to bf16 before P·V as the reference's _attention
  does; the bf16 products, GELU and residual adds still round at other
  places in XLA and in PyTorch, which moves the small config's logits by
  ~0.034 (max |logit| ~4.5) and the loss by ~1.8e-3.

The full-width golden (tests/data/transformer_golden.npz, written once by
write_golden below from the JAX package) is recomputed here from ray_tpu,
so it cannot drift from the reference, and chip_smoke.py holds the card's
forward against it with the tolerances of models.transformer.GOLDEN_TOL,
which hold for the port's plain forward on the CPU too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import transformer as JT
from ray_tpu_torch.models import transformer as PT
from ray_tpu_torch.models.transformer import GOLDEN_TOL
from ray_tpu_torch.parallel import make_forward_step

SMALL = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGITS_TOL = {"f32": dict(rtol=0, atol=1e-4), "bf16": dict(rtol=0, atol=0.08)}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=0), "bf16": dict(rtol=0, atol=1e-2)}

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "transformer_golden.npz")
GOLDEN_WEIGHT_SEED = 0
GOLDEN_TOKEN_SEED = 1
GOLDEN_TOKENS_SHAPE = (2, 513)
GOLDEN_POSITIONS = (0, 1, 63, 64, 255, 256, 510, 511)


def _cfgs(dt, **kw):
    jd, td = DTYPES[dt]
    return JT.TransformerConfig(dtype=jd, **kw), PT.TransformerConfig(dtype=td, **kw)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def golden_tokens(cfg):
    return _tokens(GOLDEN_TOKEN_SEED, GOLDEN_TOKENS_SHAPE, cfg.vocab_size)


def write_golden(path=GOLDEN_PATH):
    """Write the full-width golden from the JAX package: the default
    TransformerConfig in float32 and bfloat16, weights from numpy_params
    (seed 0), tokens [2, 513] (seed 1). Called by hand from a script; no
    test writes it."""
    cfg_t = PT.TransformerConfig()
    tree = PT.numpy_params(cfg_t, GOLDEN_WEIGHT_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = golden_tokens(cfg_t)
    out = {"tokens": tokens, "positions": np.asarray(GOLDEN_POSITIONS, np.int32),
           "weight_seed": np.int64(GOLDEN_WEIGHT_SEED),
           "checksum": np.asarray(PT.weights_checksum(tree))}
    for dt in DTYPES:
        cfg_j, _ = _cfgs(dt)
        logits = np.asarray(JT.forward(params, jnp.asarray(tokens[:, :-1]), cfg_j))
        out[f"loss_{dt}"] = np.float32(JT.loss_fn(params, {"tokens": jnp.asarray(tokens)}, cfg_j))
        out[f"logits_{dt}"] = logits[:, list(GOLDEN_POSITIONS)].astype(np.float32)
        out[f"argmax_{dt}"] = logits.argmax(-1).astype(np.int32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


def _small_model(dt, seed=0):
    cfg_j, cfg_t = _cfgs(dt, **SMALL)
    tree = PT.numpy_params(cfg_t, seed)
    return cfg_j, cfg_t, tree, jax.tree.map(jnp.asarray, tree), \
        PT.params_from_numpy(tree, cfg_t, device="cpu")


def test_params_round_trip_bit_for_bit():
    _, cfg_t, tree, _, model = _small_model("bf16")
    back = PT.to_numpy(model)
    leaves = [("embed",), ("unembed",), ("ln_f",)] + [("layers", k) for k in PT._LAYER_KEYS]
    for path in leaves:
        a, b = tree, back
        for key in path:
            a, b = a[key], b[key]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=str(path))
    assert PT.weights_checksum(back) == PT.weights_checksum(tree)
    assert len(model.blocks) == cfg_t.n_layers
    assert isinstance(model.blocks, torch.nn.ModuleList)


def test_params_from_numpy_rejects_wrong_shapes():
    _, cfg_t, tree, _, _ = _small_model("f32")
    bad = dict(tree, embed=tree["embed"][:, :32])
    with pytest.raises(ValueError, match="embed"):
        PT.params_from_numpy(bad, cfg_t, device="cpu")
    bad = dict(tree, layers=dict(tree["layers"], w1=tree["layers"]["w1"][:1]))
    with pytest.raises(ValueError, match="layers.w1"):
        PT.params_from_numpy(bad, cfg_t, device="cpu")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [32, 31])
def test_forward_and_loss_match_reference(S, dt):
    cfg_j, cfg_t, _, params, model = _small_model(dt)
    tokens = _tokens(100 + S, (2, S + 1), cfg_t.vocab_size)
    want = np.asarray(JT.forward(params, jnp.asarray(tokens[:, :-1]), cfg_j))
    got = PT.forward(model, torch.from_numpy(tokens[:, :-1]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL[dt])
    np.testing.assert_array_equal(model(torch.from_numpy(tokens[:, :-1])).numpy(), got.numpy())
    loss_j = float(JT.loss_fn(params, {"tokens": jnp.asarray(tokens)}, cfg_j))
    loss_t = PT.loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    assert loss_t.dtype == torch.float32 and loss_t.shape == ()
    np.testing.assert_allclose(float(loss_t), loss_j, **LOSS_TOL[dt])


def test_layer_matches_reference_and_gelu_is_tanh_form():
    """One block in float32 against the reference's _layer (1e-5), and the
    tanh GELU it needs: jax.nn.gelu's default, not PyTorch's erf default,
    which differs by more than the layer's tolerance."""
    cfg_j, cfg_t, tree, params, model = _small_model("f32")
    x = np.random.default_rng(4).standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: a[0], params["layers"])
    want = np.asarray(JT._layer(jnp.asarray(x), layer0, cfg_j))
    got = PT._layer(torch.from_numpy(x), model.blocks[0], cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    z = np.linspace(-4, 4, 101).astype(np.float32)
    jg = np.asarray(jax.nn.gelu(jnp.asarray(z)))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(z), approximate="tanh").numpy(), jg,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(z)).numpy() - jg).max() > 1e-4


def test_make_forward_step_on_the_cpu():
    _, cfg_t, _, _, model = _small_model("bf16")
    fwd = make_forward_step(cfg_t, device="cpu")
    tokens = _tokens(7, (3, 20), cfg_t.vocab_size)
    out = fwd(model, tokens)  # numpy tokens are taken as they are
    np.testing.assert_array_equal(out.numpy(), PT.forward(model, torch.from_numpy(tokens)).numpy())
    assert tuple(out.shape) == (3, 20, cfg_t.vocab_size)


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PT.TransformerConfig(**SMALL)
    tree = PT.numpy_params(cfg, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        PT.Transformer(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        PT.params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        PT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        make_forward_step(cfg)


def test_init_params_draws_the_reference_distribution():
    cfg = PT.TransformerConfig(**SMALL)
    model = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(model.embed, again.embed)
    assert torch.equal(model.ln_f, torch.ones(cfg.d_model))
    assert abs(float(model.blocks[1].w2.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert abs(float(model.embed.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert all(not p.requires_grad for p in model.parameters())


def test_golden_file_is_the_reference_and_the_port_meets_it():
    """The committed golden equals a fresh run of the JAX package (weights
    by checksum; loss, logits at 8 positions a sequence, argmax), and the
    port's plain forward on the CPU meets it within GOLDEN_TOL."""
    g = np.load(GOLDEN_PATH)
    cfg_t = PT.TransformerConfig()
    tree = PT.numpy_params(cfg_t, GOLDEN_WEIGHT_SEED)
    assert int(g["weight_seed"]) == GOLDEN_WEIGHT_SEED
    assert str(g["checksum"]) == PT.weights_checksum(tree)
    tokens = golden_tokens(cfg_t)
    np.testing.assert_array_equal(g["tokens"], tokens)
    pos = list(g["positions"])
    params = jax.tree.map(jnp.asarray, tree)
    for dt, (jd, td) in DTYPES.items():
        cfg_j = JT.TransformerConfig(dtype=jd)
        logits = np.asarray(JT.forward(params, jnp.asarray(tokens[:, :-1]), cfg_j))
        np.testing.assert_allclose(logits[:, pos], g[f"logits_{dt}"], rtol=0, atol=1e-4)
        assert (logits.argmax(-1) == g[f"argmax_{dt}"]).mean() >= 0.999
        loss = float(JT.loss_fn(params, {"tokens": jnp.asarray(tokens)}, cfg_j))
        np.testing.assert_allclose(loss, float(g[f"loss_{dt}"]), rtol=0, atol=1e-5)
        model = PT.params_from_numpy(tree, PT.TransformerConfig(dtype=td), device="cpu")
        atol_logits, atol_loss, agree = GOLDEN_TOL[dt]
        got = PT.forward(model, torch.from_numpy(tokens[:, :-1]))
        np.testing.assert_allclose(got[:, pos].numpy(), g[f"logits_{dt}"], rtol=0,
                                   atol=atol_logits)
        assert (got.argmax(-1).numpy() == g[f"argmax_{dt}"]).mean() >= agree
        loss_t = float(PT.loss_fn(model, {"tokens": torch.from_numpy(tokens)}))
        np.testing.assert_allclose(loss_t, float(g[f"loss_{dt}"]), rtol=0, atol=atol_loss)
