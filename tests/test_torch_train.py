"""ray_tpu_torch's training (the plain kernels and their plain backwards, on
the CPU) held against ray_tpu's: loss_fn's value and gradient against
jax.value_and_grad(loss_fn), the train step against ray_tpu's
make_train_step on a one-device CPU mesh, AdamW against optax.adamw, and
the full-width one-step golden (tests/data/train_golden.npz).

Small config: vocab 128, d_model 64, 2 heads, 2 layers, d_ff 128; tokens
[4, 33] from a numpy seed; weights from numpy_params. Tolerances, as
measured here:
- float32: loss within 1e-5 relative; every gradient leaf within 1e-5 of
  its largest entry (measured 9e-7); parameters after one and two steps
  within 1e-5 absolute, and 99.99 % of them within 1e-6 (measured: max
  3.1e-6, 99.9993 %; an entry whose gradient is ~1e-6 sits where AdamW's
  m / (sqrt(v) + eps) turns, so a last-bit difference in g moves it most);
  the moments within 1e-5 of their leaf's largest entry.
- bfloat16: loss within 1e-3 (measured 3.3e-4); every gradient leaf
  within 5 % of its largest entry (measured 2.2 %: the bf16 products and
  GELU round at other places in XLA and in PyTorch, and the norm scales'
  gradient is a bf16 sum in XLA's own order) and its L2 norm within 1 %
  (measured 0.26 %); parameters after one step: 99 % within 1e-6 (measured
  99.80 % over all leaves) and all within 2 lr + 1e-4 (an entry whose gradient's sign
  differs moves by 2 lr); after two steps 60 % of each leaf within 1e-6
  (measured 73.4 % for the least, the norm scales, whose bf16-summed
  gradient enters the moments; 83.6 % over all), all within 4 lr + 1e-4
  (measured 1.16e-3); the moments within 5 % of their leaf's
  largest entry (measured 3.3 %).
AdamW alone against optax.adamw on random trees: 1e-6 absolute after
three steps (the same order of operations in float32).

write_train_golden() writes the golden from the JAX package (called by
hand, as write_golden is); a test recomputes it from ray_tpu and holds the
port's plain step to it within tpu_train.TRAIN_GOLDEN_TOL, which
chip_smoke.py applies to the card's step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.models import transformer as JT
from ray_tpu.parallel import tpu_train as JTT
from ray_tpu_torch.models import transformer as PT
from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
from ray_tpu_torch.parallel import mesh as PMESH
from ray_tpu_torch.parallel import tpu_train as PTT
from ray_tpu_torch.parallel.tpu_train import TRAIN_GOLDEN_TOL

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other's (one plain K1 call on config_5's round took
    ~200 s with six processes at once, ~1 s at one thread each). One
    thread for this module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LR = 3e-4

TRAIN_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "train_golden.npz")
GOLDEN_WEIGHT_SEED = 0  # the forward golden's seeds and token shape
GOLDEN_TOKEN_SEED = 1
GOLDEN_TOKENS_SHAPE = (2, 513)
GOLDEN_SAMPLES = 4096  # entries a leaf
GOLDEN_POSITION_SEED = 7
LEAVES = ("embed", "unembed", "ln_f", "layers.wqkv", "layers.wo", "layers.w1", "layers.w2",
          "layers.ln1", "layers.ln2")


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _cfgs(dt, **kw):
    jd, td = DTYPES[dt]
    return JT.TransformerConfig(dtype=jd, **kw), PT.TransformerConfig(dtype=td, **kw)


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


def _port_model(tree, cfg_t):
    model = PT.params_from_numpy(tree, cfg_t, device="cpu")
    return model.requires_grad_(True)


def _small(dt, seed=0):
    cfg_j, cfg_t = _cfgs(dt, **SMALL)
    tree = PT.numpy_params(cfg_t, seed)
    tokens = np.random.default_rng(5).integers(0, SMALL["vocab_size"], (4, 33)).astype(np.int32)
    return cfg_j, cfg_t, tree, tokens


def _assert_leaf_close(got, want, rel, what):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs {err} > {rel} x {scale}"


@pytest.mark.parametrize("dt", list(DTYPES))
def test_loss_and_grads_match_jax(dt):
    cfg_j, cfg_t, tree, tokens = _small(dt)
    loss_j, grads_j = jax.value_and_grad(JT.loss_fn)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)}, cfg_j)
    model = _port_model(tree, cfg_t)
    loss_t = PT.loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    assert loss_t.requires_grad and loss_t.dtype == torch.float32 and loss_t.shape == ()
    loss_t.backward()
    got = PT.grads_to_numpy(model)
    if dt == "f32":
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    else:
        assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-3
    for name in LEAVES:
        g, w = _leaf(got, name), _leaf(grads_j, name)
        assert g.shape == w.shape and g.dtype == np.float32, name
        _assert_leaf_close(g, w, 1e-5 if dt == "f32" else 0.05, name)
        if dt == "bf16":
            assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) <= 0.01, name


def test_grads_to_numpy_needs_a_backward():
    _, cfg_t, tree, _ = _small("f32")
    with pytest.raises(ValueError, match="backward"):
        PT.grads_to_numpy(_port_model(tree, cfg_t))


# params after step i: (max abs, share within 1e-6); moments: share of
# their leaf's largest entry
STEP_TOL = {"f32": [(1e-5, 0.9999), (1e-5, 0.9999)],
            "bf16": [(2 * LR + 1e-4, 0.99), (4 * LR + 1e-4, 0.6)]}
MOMENT_TOL = {"f32": 1e-5, "bf16": 0.05}


@pytest.mark.parametrize("dt", list(DTYPES))
def test_train_steps_match_jax_make_train_step(dt):
    """One and two steps (loss, params, AdamW's moments and count) against
    ray_tpu's make_train_step on a one-device CPU mesh."""
    cfg_j, cfg_t, tree, tokens = _small(dt)
    tx_j = JTT.make_optimizer()
    params_j = jax.tree.map(jnp.asarray, tree)
    state_j = tx_j.init(params_j)
    step_j, _ = JTT.make_train_step(cfg_j, _one_device_mesh(), tx_j, None)
    model = _port_model(tree, cfg_t)
    tx = make_optimizer()
    state = tx.init(model)
    step, batch_sharding = make_train_step(cfg_t, None, tx, None)
    assert batch_sharding is None
    for i in range(2):
        params_j, state_j, loss_j = step_j(params_j, state_j, {"tokens": jnp.asarray(tokens)})
        model_out, state_out, loss = step(model, state, {"tokens": tokens})
        assert model_out is model and state_out is state
        assert abs(float(loss) - float(loss_j)) <= (1e-5 * float(loss_j) if dt == "f32" else 1e-3)
        got = PT.to_numpy(model)
        max_abs, share = STEP_TOL[dt][i]
        for name in LEAVES:
            d = np.abs(_leaf(got, name) - _leaf(params_j, name))
            assert d.max() <= max_abs, (i, name, d.max())
            assert (d <= 1e-6).mean() >= share, (i, name, (d <= 1e-6).mean())
        moments = PTT.opt_state_to_numpy(state)
        adam_j = state_j[0]
        assert moments["count"] == int(adam_j.count) == i + 1
        for part, want_tree in (("mu", adam_j.mu), ("nu", adam_j.nu)):
            for name in LEAVES:
                _assert_leaf_close(_leaf(moments[part], name), _leaf(want_tree, name),
                                   MOMENT_TOL[dt], f"step {i} {part} {name}")


def test_adamw_matches_optax_on_random_trees():
    rng = np.random.default_rng(9)
    cfg = PT.TransformerConfig(**SMALL, dtype=torch.float32)
    tree = PT.numpy_params(cfg, 3)
    model = _port_model(tree, cfg)
    tx_j = optax.adamw(2e-2, weight_decay=0.1)
    tx = PTT.AdamW(2e-2, weight_decay=0.1)
    params_j = jax.tree.map(jnp.asarray, tree)
    state_j, state = tx_j.init(params_j), tx.init(model)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * rng.choice([1e-9, 1e-3, 1.0])).astype(
                np.float32), tree)
        updates, state_j = tx_j.update(jax.tree.map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        grad_model = PT.params_from_numpy(grads, cfg, device="cpu")
        for p, g in zip(model.parameters(), grad_model.parameters()):
            p.grad = g.detach().clone()
        tx.update(model, state)
    got = PT.to_numpy(model)
    for name in LEAVES:
        np.testing.assert_allclose(_leaf(got, name), _leaf(params_j, name), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_make_train_state_one_device_and_rejects_larger_meshes():
    cfg = PT.TransformerConfig(**SMALL)
    params, opt_state, tx, shardings = make_train_state(cfg, seed=4, device="cpu")
    assert shardings is None and isinstance(tx, PTT.AdamW) and opt_state.count == 0
    assert all(p.requires_grad and p.device.type == "cpu" for p in params.parameters())
    again = make_train_state(cfg, _one_device_mesh(), seed=4, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    other = make_train_state(cfg, seed=5, device="cpu")[0]
    assert not torch.equal(params.embed, other.embed)
    # a larger mesh must be a port Mesh ("dp", "tp"), whose tp divides the
    # heads (tests/test_torch_train_mesh.py runs the sharded step)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("dp", "tp"))
    with pytest.raises(ValueError, match="ray_tpu_torch.parallel.mesh.Mesh"):
        make_train_state(cfg, mesh, device="cpu")
    with pytest.raises(ValueError, match="ray_tpu_torch.parallel.mesh.Mesh"):
        make_train_step(cfg, mesh, tx)
    port_mesh = PMESH.Mesh(("dp", "tp"), (1, 4), np.arange(4).reshape(1, 4), 0,
                           {"dp": None, "tp": None}, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide the 2 heads"):
        make_train_state(cfg, port_mesh, device="cpu")
    with pytest.raises(ValueError, match="does not divide the 2 heads"):
        make_train_step(cfg, port_mesh, tx)
    step, _ = make_train_step(cfg, _one_device_mesh(), tx)
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab_size"], (2, 17)).astype(np.int32)
    losses = [float(step(params, opt_state, {"tokens": tokens})[2]) for _ in range(3)]
    assert losses[2] < losses[0] and opt_state.count == 3


def test_train_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PT.TransformerConfig(**SMALL)
    with pytest.raises(RuntimeError, match="is_available"):
        make_train_state(cfg)
    make_train_state(cfg, device="cpu")


# ------------------------------------------------------------------ golden


def _golden_positions(tree):
    rng = np.random.default_rng(GOLDEN_POSITION_SEED)
    out = {}
    for name in LEAVES:
        size = _leaf(tree, name).size
        out[name] = np.sort(rng.choice(size, min(GOLDEN_SAMPLES, size), replace=False)) \
            .astype(np.int64)
    return out


def _jax_golden_step(tree, tokens, dt):
    """ray_tpu's one train step on a one-device CPU mesh: the loss, the
    gradient, the params after the step, and the second step's loss."""
    cfg_j, _ = _cfgs(dt)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(JT.loss_fn)(params, batch, cfg_j)
    tx = JTT.make_optimizer()
    step, _ = JTT.make_train_step(cfg_j, _one_device_mesh(), tx, None)
    params, state, loss1 = step(jax.tree.map(jnp.array, params), tx.init(params), batch)
    params_np = jax.tree.map(np.asarray, params)
    _, _, loss2 = step(params, state, batch)
    return float(loss), jax.tree.map(np.asarray, grads), params_np, float(loss2)


def write_train_golden(path=TRAIN_GOLDEN_PATH):
    """Write the full-width one-step golden from the JAX package: the
    default TransformerConfig in float32 and bfloat16, weights from
    numpy_params (seed 0), tokens [2, 513] (seed 1), as the forward
    golden. Per dtype: the loss, each leaf's gradient L2 norm, 4 096
    gradient entries a leaf at seeded positions, the same entries of the
    params after one AdamW step, and the second step's loss. Called by
    hand from a script; no test writes it."""
    cfg_t = PT.TransformerConfig()
    tree = PT.numpy_params(cfg_t, GOLDEN_WEIGHT_SEED)
    tokens = np.random.default_rng(GOLDEN_TOKEN_SEED).integers(
        0, cfg_t.vocab_size, GOLDEN_TOKENS_SHAPE).astype(np.int32)
    pos = _golden_positions(tree)
    out = {"tokens": tokens, "leaves": np.asarray(LEAVES),
           "weight_seed": np.int64(GOLDEN_WEIGHT_SEED), "lr": np.float32(LR),
           "checksum": np.asarray(PT.weights_checksum(tree))}
    for name in LEAVES:
        out[f"pos_{name}"] = pos[name]
    for dt in DTYPES:
        loss, grads, params1, loss2 = _jax_golden_step(tree, tokens, dt)
        out[f"loss_{dt}"] = np.float32(loss)
        out[f"loss2_{dt}"] = np.float32(loss2)
        out[f"grad_norm_{dt}"] = np.asarray(
            [np.linalg.norm(_leaf(grads, n).astype(np.float64)) for n in LEAVES], np.float64)
        for name in LEAVES:
            out[f"grad_{dt}_{name}"] = _leaf(grads, name).reshape(-1)[pos[name]]
            out[f"param1_{dt}_{name}"] = _leaf(params1, name).reshape(-1)[pos[name]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


def test_train_golden_file_is_the_reference_and_the_port_meets_it():
    g = np.load(TRAIN_GOLDEN_PATH)
    cfg_t = PT.TransformerConfig()
    tree = PT.numpy_params(cfg_t, GOLDEN_WEIGHT_SEED)
    assert str(g["checksum"]) == PT.weights_checksum(tree)
    tokens = np.random.default_rng(GOLDEN_TOKEN_SEED).integers(
        0, cfg_t.vocab_size, GOLDEN_TOKENS_SHAPE).astype(np.int32)
    np.testing.assert_array_equal(g["tokens"], tokens)
    assert tuple(str(n) for n in g["leaves"]) == LEAVES
    pos = _golden_positions(tree)
    for dt in DTYPES:
        loss, grads, params1, loss2 = _jax_golden_step(tree, tokens, dt)
        np.testing.assert_allclose([loss, loss2], [g[f"loss_{dt}"], g[f"loss2_{dt}"]],
                                   rtol=1e-6)
        for i, name in enumerate(LEAVES):
            np.testing.assert_array_equal(g[f"pos_{name}"], pos[name])
            np.testing.assert_allclose(np.linalg.norm(_leaf(grads, name).astype(np.float64)),
                                       g[f"grad_norm_{dt}"][i], rtol=1e-5)
            np.testing.assert_allclose(_leaf(grads, name).reshape(-1)[pos[name]],
                                       g[f"grad_{dt}_{name}"], rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(_leaf(params1, name).reshape(-1)[pos[name]],
                                       g[f"param1_{dt}_{name}"], rtol=0, atol=1e-7)
        err = PTT.train_golden_errors(g, dt, device="cpu")
        assert set(err) == set(TRAIN_GOLDEN_TOL[dt])
        assert not PTT.train_golden_violations(err, dt), (dt, err, TRAIN_GOLDEN_TOL[dt])
        assert set(PTT.train_golden_violations({**err, "loss": 1.0, "param_share": 0.0}, dt)) \
            == {"loss", "param_share"}
