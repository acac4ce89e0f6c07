"""ray_tpu_torch's training across ranks held against ray_tpu's on the same
numpy-seeded inputs: the dp x tp train step (parallel/tpu_train.py over a
port mesh, the Megatron layout of models/transformer.py) against
ray_tpu's make_train_step on a mesh of the same shape, and the expert
layer's gradients through moe_ffn(mesh=...) against jax.grad of the
reference's loss (tests/test_parallel.py's test_moe_grads_flow).

The JAX side runs on 4 devices of the 8-device virtual CPU mesh that
tests/conftest.py sets up. The port's side runs once for every case, in 4
gloo CPU ranks spawned by a module-scoped fixture (``start_method="spawn"``,
rendezvous in a file under tmp_path, so xdist workers cannot collide; a
deadline, after which every rank still running is killed): each rank writes
what every case gave it to one file, which the tests read.

Small config: vocab 512, d_model 128, 8 heads, 2 layers, d_ff 256 (the
reference dryrun's sizes with 8 heads, so that tp 1, 2 and 4 divide them);
tokens [8, 33] from a numpy seed; weights from numpy_params. Tolerances:
- float32 against the reference: the loss within 1e-5 each step; the
  gathered parameters after each of two steps within TRAIN_GOLDEN_TOL
  ["f32"]'s param (1e-5) and param_share (0.998 of each leaf within 1e-6),
  over every entry.
- bfloat16 at dp x tp = 2 x 2 against the port's own one-process step
  (JAX's bf16 dot does not run on the CPU, ROADMAP queue 3): the two
  losses within TRAIN_GOLDEN_TOL["bf16"]'s loss and loss2, the parameters
  after one step within its param and param_share.
- the leaves replicated over an axis bit-equal on every rank that holds
  them, after every step.
- the expert layer (float32, dp x ep 2 x 2 and 1 x 4): each rank's router,
  experts' w1 and w2 and its block's dx within MOE_GRAD_GOLDEN_TOL["f32"]
  ["grad"] (1e-4) of the leaf's rms, the routing exactly JAX's.
"""

import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import moe as JM
from ray_tpu.models import transformer as JT
from ray_tpu.parallel import mesh as JMESH
from ray_tpu.parallel import tpu_train as JTT
from ray_tpu_torch.models import moe as PM
from ray_tpu_torch.models import moe_kernels as EK
from ray_tpu_torch.models import transformer as PT
from ray_tpu_torch.models.moe import MOE_GRAD_GOLDEN_TOL
from ray_tpu_torch.parallel import mesh as PMESH
from ray_tpu_torch.parallel import tpu_train as PTT
from ray_tpu_torch.parallel.tpu_train import TRAIN_GOLDEN_TOL
from test_torch_moe_kernels import jax_route  # tests/ is on sys.path (pytest's prepend mode)

WORLD = 4
DEADLINE_S = 240
SMALL = dict(vocab_size=512, d_model=128, n_heads=8, n_layers=2, d_ff=256, max_seq_len=64)
TOKENS_SHAPE = (8, 33)
WEIGHT_SEED, TOKEN_SEED = 0, 5
STEPS = 2
MESHES = ((2, 2), (1, 4), (4, 1))
BF16_MESH = (2, 2)
MOE_MESHES = ((2, 2), (1, 4))
MOE_KW = dict(d_model=16, d_ff=32, n_experts=8, capacity_factor=1.25)
MOE_X_SHAPE = (4, 32, 16)
LEAVES = ("embed", "unembed", "ln_f", "layers.wqkv", "layers.wo", "layers.w1", "layers.w2",
          "layers.ln1", "layers.ln2")
COLLECTIVES = ("copy_to", "reduce_from", "gather_from", "scatter_to", "all_to_all_with_grad")


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _spec(name):
    return _leaf(PT.param_partition_specs(PT.TransformerConfig(**SMALL)), name).tolist()


def _inputs(dt=torch.float32):
    cfg = PT.TransformerConfig(**SMALL, dtype=dt)
    tokens = np.random.default_rng(TOKEN_SEED).integers(
        0, SMALL["vocab_size"], TOKENS_SHAPE).astype(np.int32)
    return cfg, PT.numpy_params(cfg, WEIGHT_SEED), tokens


def _moe_inputs():
    cfg = PM.MoEConfig(dtype=torch.float32, **MOE_KW)
    tree = PM.numpy_moe_params(cfg, 30)
    return cfg, tree, PM.numpy_moe_inputs(tree, MOE_X_SHAPE, 31)


def _fake_mesh(shape, coords):
    """A one-process port Mesh of axes ("dp", "tp") that claims `shape` and
    sits at `coords`, for what needs no collective."""
    layout = np.arange(int(np.prod(shape))).reshape(shape)
    return PMESH.Mesh(("dp", "tp"), shape, layout, int(layout[coords]),
                      {"dp": None, "tp": None}, torch.device("cpu"))


def _flat(tree, prefix):
    out = {}
    for name in LEAVES:
        out[f"{prefix}{name}"] = _leaf(tree, name)
    return out


# ------------------------------------------------------ the ranks (spawned)


def _collective_cases(mesh, rank):
    """Each differentiable collective over "tp" on a rank-dependent input,
    its output and its input's gradient for a rank-dependent cotangent."""
    out = {}
    x0 = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * rank
    for name in COLLECTIVES:
        x = x0.clone().requires_grad_(True)
        if name in ("gather_from", "scatter_to"):
            y = getattr(PMESH, name)(x, mesh, "tp", 0)
        elif name == "all_to_all_with_grad":
            y = PMESH.all_to_all_with_grad(x, mesh, "tp", 0, 1)
        else:
            y = getattr(PMESH, name)(x, mesh, "tp")
        g = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * 100 + rank
        y.backward(g)
        out[f"coll_{name}_y"], out[f"coll_{name}_dx"] = y.detach().numpy(), x.grad.numpy()
    return out


def _train_case(tag, dt, dp, tp, out):
    cfg, tree, tokens = _inputs(dt)
    mesh = PMESH.make_mesh(("dp", "tp"), shape=(dp, tp), device="cpu")
    model = PT.shard_params(tree, cfg, mesh).requires_grad_(True)
    back = PT.gather_params(model, mesh)
    out[f"{tag}_roundtrip"] = np.array(all(np.array_equal(_leaf(back, n), _leaf(tree, n))
                                           for n in LEAVES))
    tx = PTT.make_optimizer()
    state = tx.init(model)
    step, batch_sharding = PTT.make_train_step(cfg, mesh, tx, PT.param_partition_specs(cfg))
    assert batch_sharding == ("dp", None)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(model, state, {"tokens": tokens})[2]))
        out.update(_flat(PT.to_numpy(model), f"{tag}_local{i}_"))
        out.update(_flat(PT.gather_params(model, mesh), f"{tag}_gathered{i}_"))
    out[f"{tag}_losses"] = np.array(losses)


def _moe_case(dp, ep, out):
    cfg, tree, x = _moe_inputs()
    mesh = PMESH.make_mesh(("dp", "ep"), shape=(dp, ep), device="cpu")
    Gl = MOE_X_SHAPE[0] // dp
    d = mesh.axis_index("dp")
    xb = torch.from_numpy(x[d * Gl:(d + 1) * Gl].copy()).requires_grad_(True)
    local = PM.shard_moe_params(tree, cfg, mesh).requires_grad_(True)
    y, aux = PM.moe_ffn(local, xb, cfg, mesh=mesh)
    loss = ((y.float() ** 2).mean() + 0.01 * aux) * PM.mesh_loss_scale(mesh)
    loss.backward()
    PM.reduce_moe_grads(local, mesh, xb)
    tag = f"moe_{dp}x{ep}"
    for key, g in PM.moe_grads_to_numpy(local).items():
        out[f"{tag}_{key}"] = g
    out[f"{tag}_dx"] = xb.grad.numpy()
    route = EK.moe_route(torch.matmul(xb.detach(), local.router.detach()),
                         PM._capacity(cfg, MOE_X_SHAPE[1]))
    out[f"{tag}_expert"], out[f"{tag}_slot"] = route[0].numpy(), route[2].numpy()


def _rank(rank, world, tmp):
    """Every case on this rank, into rank<r>.npz."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=DEADLINE_S))
    try:
        out = _collective_cases(PMESH.make_mesh(("dp", "tp"), shape=(2, 2), device="cpu"), rank)
        for dp, tp in MESHES:
            _train_case(f"f32_{dp}x{tp}", torch.float32, dp, tp, out)
        _train_case("bf16_{}x{}".format(*BF16_MESH), torch.bfloat16, *BF16_MESH, out)
        for dp, ep in MOE_MESHES:
            _moe_case(dp, ep, out)
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 gloo CPU ranks once; every rank's results by rank."""
    tmp = tmp_path_factory.mktemp("train_mesh_ranks")
    ctx = mp.start_processes(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=0.1):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


# ------------------------------------------------------------- collectives


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_and_their_backwards_equal_their_definitions(ranks, name):
    """Over "tp" of the row-major 2 x 2 layout (lines {0, 1} and {2, 3}):
    each collective's output and, for the cotangent g_r, its backward."""
    x = lambda r: np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * r  # noqa: E731
    for r in range(WORLD):
        line = [r - r % 2, r - r % 2 + 1]
        i = line.index(r)
        y, dx = ranks[r][f"coll_{name}_y"], ranks[r][f"coll_{name}_dx"]
        g = lambda q: np.arange(y.size, dtype=np.float32).reshape(y.shape) * 100 + q  # noqa
        if name == "copy_to":
            want_y, want_dx = x(r), sum(g(q) for q in line)
        elif name == "reduce_from":
            want_y, want_dx = sum(x(q) for q in line), g(r)
        elif name == "gather_from":
            want_y, want_dx = np.concatenate([x(q) for q in line]), g(r)[4 * i:4 * i + 4]
        elif name == "scatter_to":
            want_y = x(r)[2 * i:2 * i + 2]
            want_dx = np.concatenate([g(q) for q in line])
        else:  # split 0, concat 1; the backward is the inverse exchange
            want_y = np.concatenate([x(q)[2 * i:2 * i + 2] for q in line], axis=1)
            want_dx = np.concatenate([g(q)[:, 2 * i:2 * i + 2] for q in line], axis=0)
        np.testing.assert_array_equal(y, want_y, err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(dx, want_dx, err_msg=f"{name} rank {r} backward")


# ------------------------------------------------------------------ layout


def test_param_partition_specs_equal_reference():
    cfg_j = JT.TransformerConfig(**SMALL, dtype=jnp.float32)
    ref = jax.tree.map(tuple, JT.param_partition_specs(cfg_j),
                       is_leaf=lambda s: isinstance(s, P))
    assert PT.param_partition_specs(PT.TransformerConfig(**SMALL)) == ref


@pytest.mark.parametrize("dp,tp", MESHES)
def test_shard_then_gather_is_the_identity(ranks, dp, tp):
    for r in range(WORLD):
        assert bool(ranks[r][f"f32_{dp}x{tp}_roundtrip"]), r


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_make_train_state_shards_equal_one_device_state(tp):
    """Every rank's shards from make_train_state(cfg, mesh) are the
    one-device state's slices: wqkv its heads' q, k, v columns, the other
    leaves the reference's NamedSharding blocks."""
    cfg = PT.TransformerConfig(**SMALL, dtype=torch.float32)
    whole = PT.to_numpy(PTT.make_train_state(cfg, seed=4, device="cpu")[0])
    D, Dl = cfg.d_model, cfg.d_model // tp
    for t in range(tp):
        params, state, tx, shardings = PTT.make_train_state(
            cfg, _fake_mesh((4 // tp, tp), (0, t)), seed=4)
        assert shardings == PT.param_partition_specs(cfg) and state.count == 0
        assert params.tp == tp and all(p.requires_grad for p in params.parameters())
        got = PT.to_numpy(params)
        cols = np.r_[t * Dl:(t + 1) * Dl, D + t * Dl:D + (t + 1) * Dl,
                     2 * D + t * Dl:2 * D + (t + 1) * Dl]
        F = cfg.d_ff // tp
        want = {"embed": whole["embed"][:, t * Dl:(t + 1) * Dl],
                "unembed": whole["unembed"][t * Dl:(t + 1) * Dl], "ln_f": whole["ln_f"],
                "layers": {"wqkv": whole["layers"]["wqkv"][..., cols],
                           "wo": whole["layers"]["wo"][:, t * Dl:(t + 1) * Dl],
                           "w1": whole["layers"]["w1"][..., t * F:(t + 1) * F],
                           "w2": whole["layers"]["w2"][:, t * F:(t + 1) * F],
                           "ln1": whole["layers"]["ln1"], "ln2": whole["layers"]["ln2"]}}
        for name in LEAVES:
            np.testing.assert_array_equal(_leaf(got, name), _leaf(want, name), err_msg=name)


# ------------------------------------------------------------- the step


def _jax_steps(dp, tp):
    """ray_tpu's make_train_step on a dp x tp mesh of 4 CPU devices from
    numpy_params placed by param_shardings: the losses and the params
    after each step."""
    cfg_t, tree, tokens = _inputs()
    cfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32)
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]).reshape(dp, tp), ("dp", "tp"))
    shardings = JTT._sharding_tree(mesh, JT.param_partition_specs(cfg))
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), tree, shardings)
    tx = JTT.make_optimizer()
    state = tx.init(params)
    step, batch_sharding = JTT.make_train_step(cfg, mesh, tx, shardings)
    batch = {"tokens": jax.device_put(jnp.asarray(tokens), batch_sharding)}
    losses, trees = [], []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        trees.append(jax.tree.map(np.asarray, params))
    return losses, trees


def _param_errors(got_flat, prefix, want_tree):
    """max abs error over every entry, and the least share of a leaf's
    entries within 1e-6."""
    err, share = 0.0, 1.0
    for name in LEAVES:
        d = np.abs(got_flat[f"{prefix}{name}"] - _leaf(want_tree, name))
        err, share = max(err, float(d.max())), min(share, float((d <= 1e-6).mean()))
    return err, share


@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_step_equals_jax_make_train_step(ranks, dp, tp):
    losses, trees = _jax_steps(dp, tp)
    tol = TRAIN_GOLDEN_TOL["f32"]
    tag = f"f32_{dp}x{tp}"
    for r in range(WORLD):
        got = ranks[r][f"{tag}_losses"]
        for i in range(STEPS):
            assert abs(float(got[i]) - losses[i]) <= 1e-5, (r, i, float(got[i]), losses[i])
            err, share = _param_errors(ranks[r], f"{tag}_gathered{i}_", trees[i])
            assert err <= tol["param"] and share >= tol["param_share"], (r, i, err, share)


def _one_process_steps(dt):
    cfg, tree, tokens = _inputs(dt)
    model = PT.params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
    tx = PTT.make_optimizer()
    state = tx.init(model)
    step, _ = PTT.make_train_step(cfg, None, tx)
    losses, trees = [], []
    for _ in range(STEPS):
        losses.append(float(step(model, state, {"tokens": tokens})[2]))
        trees.append(PT.to_numpy(model))
    return losses, trees


def test_bf16_step_equals_one_process_step(ranks):
    losses, trees = _one_process_steps(torch.bfloat16)
    tol = TRAIN_GOLDEN_TOL["bf16"]
    tag = "bf16_{}x{}".format(*BF16_MESH)
    for r in range(WORLD):
        got = ranks[r][f"{tag}_losses"]
        assert abs(float(got[0]) - losses[0]) <= tol["loss"], (r, float(got[0]), losses[0])
        assert abs(float(got[1]) - losses[1]) <= tol["loss2"], (r, float(got[1]), losses[1])
        err, share = _param_errors(ranks[r], f"{tag}_gathered0_", trees[0])
        assert err <= tol["param"] and share >= tol["param_share"], (r, err, share)


@pytest.mark.parametrize("tag", [f"f32_{dp}x{tp}" for dp, tp in MESHES]
                         + ["bf16_{}x{}".format(*BF16_MESH)])
def test_replicated_leaves_bit_equal_across_ranks(ranks, tag):
    """After every step, each leaf's block is the same bits on every rank
    that holds it: a leaf split over "tp" on the ranks of one tp
    coordinate (every dp), a whole one on every rank."""
    dp, tp = (int(n) for n in tag.split("_")[1].split("x"))
    layout = np.arange(WORLD).reshape(dp, tp)
    for i in range(STEPS):
        for name in LEAVES:
            key = f"{tag}_local{i}_{name}"
            groups = ([list(layout[:, t]) for t in range(tp)] if "tp" in _spec(name)
                      else [list(range(WORLD))])
            for holders in groups:
                for r in holders[1:]:
                    np.testing.assert_array_equal(ranks[r][key], ranks[holders[0]][key],
                                                  err_msg=f"{key} rank {r}")


def test_mesh_none_calls_no_collective(monkeypatch):
    """The one-device step (mesh None, or a one-device mesh) never reaches
    torch.distributed."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective on the one-device path")

    for name in ("all_reduce", "all_gather", "all_to_all_single", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    cfg, tree, tokens = _inputs()
    for mesh in (None, JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))):
        model = PT.params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
        tx = PTT.make_optimizer()
        step, batch_sharding = PTT.make_train_step(cfg, mesh, tx)
        assert batch_sharding is None
        assert np.isfinite(float(step(model, tx.init(model), {"tokens": tokens})[2]))


@pytest.mark.parametrize("case", ["jax_mesh", "axes", "heads", "d_ff"])
def test_train_entry_points_reject_bad_meshes(case):
    cfg = PT.TransformerConfig(**SMALL, dtype=torch.float32)
    if case == "jax_mesh":
        mesh, match = JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1), ("dp", "tp")), "Mesh"
    elif case == "axes":
        mesh = PMESH.Mesh(("dp", "ep"), (2, 2), np.arange(4).reshape(2, 2), 0,
                          {"dp": None, "ep": None}, torch.device("cpu"))
        match = "axes"
    elif case == "heads":
        mesh, match = _fake_mesh((1, 3), (0, 0)), "heads"
    else:
        cfg = PT.TransformerConfig(**dict(SMALL, d_ff=250), dtype=torch.float32)
        mesh, match = _fake_mesh((2, 4), (0, 0)), "d_ff"
    with pytest.raises(ValueError, match=match):
        PTT.make_train_state(cfg, mesh, device="cpu")
    with pytest.raises(ValueError, match=match):
        PTT.make_train_step(cfg, mesh, PTT.make_optimizer())


# ----------------------------------------------------------- expert layer


@pytest.mark.parametrize("dp,ep", MOE_MESHES)
def test_moe_mesh_grads_equal_jax_grad(ranks, dp, ep):
    cfg, tree, x = _moe_inputs()
    cfg_j = JM.MoEConfig(dtype=jnp.float32, **MOE_KW)
    mesh = JMESH.make_mesh(("dp", "ep"), shape=(dp, ep), devices=jax.devices()[:WORLD])
    p_shd = jax.tree.map(lambda s: NamedSharding(mesh, s), JM.moe_partition_specs(),
                         is_leaf=lambda s: isinstance(s, P))
    params = jax.tree.map(jax.device_put, {k: jnp.asarray(v) for k, v in tree.items()}, p_shd)
    x_s = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", None, None)))

    def loss(p, xs):
        y, aux = JM.moe_ffn(p, xs, cfg_j, mesh=mesh)
        return (y ** 2).mean() + 0.01 * aux

    grads, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x_s)
    want = {k: np.asarray(v) for k, v in grads.items()}
    want["dx"] = np.asarray(dx)
    logits = np.asarray(jnp.einsum("gsd,de->gse", jnp.asarray(x), jnp.asarray(tree["router"])))
    route = jax_route(logits, PM._capacity(cfg, MOE_X_SHAPE[1]))
    tol = MOE_GRAD_GOLDEN_TOL["f32"]["grad"]
    tag, n, Gl = f"moe_{dp}x{ep}", cfg.n_experts // ep, MOE_X_SHAPE[0] // dp
    for r in range(WORLD):
        d, e = divmod(r, ep)  # the rank's coordinates (row-major layout)
        blocks = {"router": slice(None), "w1": slice(e * n, (e + 1) * n),
                  "w2": slice(e * n, (e + 1) * n), "dx": slice(d * Gl, (d + 1) * Gl)}
        for key, blk in blocks.items():
            w = want[key][blk]
            rms = float(np.sqrt(np.mean(want[key].astype(np.float64) ** 2)))
            err = float(np.abs(ranks[r][f"{tag}_{key}"] - w).max())
            assert err <= tol * rms, (r, key, err, rms)
        np.testing.assert_array_equal(ranks[r][f"{tag}_expert"], route["expert"][d * Gl:(d + 1) * Gl])
        np.testing.assert_array_equal(ranks[r][f"{tag}_slot"], route["slot"][d * Gl:(d + 1) * Gl])
    assert (route["slot"] < 0).any()  # the capacity drops some tokens
