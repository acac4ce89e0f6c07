"""ray_tpu_torch's paths across ranks (parallel/mesh, ring_attention,
ulysses, pipeline, the expert layer's mesh form, the dryrun) held against
ray_tpu's on the same numpy-seeded inputs.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
sets up. The port's side runs once for every case, in 4 gloo CPU ranks
spawned by a module-scoped fixture (``start_method="spawn"``, rendezvous in
a file under tmp_path, so xdist workers cannot collide; a deadline, after
which every rank still running is killed): each rank writes its blocks of
every case to one file, which the tests read. Cases over 2 ranks use the
subgroup of ranks 0 and 1.

Tolerances: float32 attention within 1e-5 (rtol and atol, as
tests/test_parallel.py holds the reference to its dense attention); the
ring bit-equal to a one-process schedule of the plain _block_update, which
makes the same calls in the same order; the pipeline within 1e-5; the
expert layer within models.moe.MOE_GOLDEN_TOL's float32 bound (y 2e-5, aux
1e-6) with its routing exactly JAX's (float32 only: JAX's bf16 dot does
not run on the CPU, ROADMAP queue 3).
"""

import importlib
import math
import os
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import moe as JM
from ray_tpu.parallel import mesh as JMESH
from ray_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from ray_tpu.parallel.ulysses import ulysses_attention as jax_ulysses_attention
from ray_tpu_torch.models import moe as PM
from ray_tpu_torch.models import moe_kernels as EK
from ray_tpu_torch.models.moe import MOE_GOLDEN_TOL
from ray_tpu_torch.parallel import mesh as PMESH
from ray_tpu_torch.parallel import pipeline as PP
from ray_tpu_torch.parallel import ring_attention as PR
from ray_tpu_torch.parallel import ulysses as PU
from ray_tpu_torch.scripts import dryrun_multichip as DRY
from test_torch_moe_kernels import jax_route  # tests/ is on sys.path (pytest's prepend mode)

# the reference's function shadows its module on import (ROADMAP queue 3)
JR = importlib.import_module("ray_tpu.parallel.ring_attention")

WORLD = 4
DEADLINE_S = 240
QKV_SHAPE = (2, 32, 4, 16)  # [B, S, H, Dh], tests/test_parallel.py's _qkv
SPS = (2, 4)
CAUSALS = (True, False)
STAGES = (2, 4)
MICRO, MB, D_PIPE = 6, 3, 8
MOE_MESHES = ((2, 2), (1, 4))
MOE_KW = dict(d_model=16, d_ff=32, n_experts=8, capacity_factor=1.25)
MOE_X_SHAPE = (4, 32, 16)
ATT_TOL = 1e-5


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(QKV_SHAPE, dtype=np.float32) for _ in range(3))


def _qkv_seed(sp, causal):
    return 10 * sp + int(causal)


def _pipe_inputs(n_stages):
    rng = np.random.default_rng(20 + n_stages)
    params = {"w": rng.standard_normal((n_stages, D_PIPE, D_PIPE), dtype=np.float32)
              * np.float32(0.3),
              "b": rng.standard_normal((n_stages, D_PIPE), dtype=np.float32) * np.float32(0.1)}
    return params, rng.standard_normal((MICRO, MB, D_PIPE), dtype=np.float32)


def _stage_torch(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_jax(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _moe_inputs():
    cfg = PM.MoEConfig(dtype=torch.float32, **MOE_KW)
    tree = PM.numpy_moe_params(cfg, 30)
    return cfg, tree, PM.numpy_moe_inputs(tree, MOE_X_SHAPE, 31)


def _fake_mesh(axis, size):
    """A one-process Mesh whose axis claims `size` ranks, for the checks a
    call makes before any collective."""
    return PMESH.Mesh((axis,), (size,), np.arange(size), 0, {axis: None},
                      torch.device("cpu"))


# ------------------------------------------------------ the ranks (spawned)


def _rank(rank, world, tmp):
    """Every case's blocks on this rank, into rank<r>.npz."""
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=DEADLINE_S))
    try:
        groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
        out = {}
        T = torch.from_numpy
        for sp in SPS:
            if rank >= sp:
                continue
            mesh = PMESH.make_mesh(("sp",), group=groups[sp], device="cpu")
            Sb = QKV_SHAPE[1] // sp
            blk = slice(rank * Sb, (rank + 1) * Sb)
            for causal in CAUSALS:
                q, k, v = (T(x[:, blk].copy()) for x in _qkv(_qkv_seed(sp, causal)))
                out[f"ring_{sp}_{causal}"] = PR.ring_attention(q, k, v, mesh,
                                                               causal=causal).numpy()
                out[f"ulysses_{sp}_{causal}"] = PU.ulysses_attention(q, k, v, mesh,
                                                                     causal=causal).numpy()
        for n_stages in STAGES:
            if rank >= n_stages:
                continue
            mesh = PMESH.make_mesh(("pp",), group=groups[n_stages], device="cpu")
            params, x = _pipe_inputs(n_stages)
            out[f"pipe_{n_stages}"] = PP.pipeline_apply(
                _stage_torch, {k: T(v) for k, v in params.items()}, T(x), mesh).numpy()
        cfg, tree, x = _moe_inputs()
        for dp, ep in MOE_MESHES:
            mesh = PMESH.make_mesh(("dp", "ep"), shape=(dp, ep), device="cpu")
            mine = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
            for axis in ("dp", "ep"):  # every collective over every axis
                tag = f"{dp}x{ep}_{axis}"
                out[f"coll_psum_{tag}"] = mesh.psum(mine, axis).numpy()
                out[f"coll_all_gather_{tag}"] = mesh.all_gather(mine, axis, dim=1).numpy()
                out[f"coll_all_to_all_{tag}"] = mesh.all_to_all(
                    torch.arange(4 * 2, dtype=torch.float32).reshape(4, 2) + 10 * rank, axis,
                    split_axis=0, concat_axis=1).numpy()
                n = mesh.shape[axis]
                out[f"coll_ppermute_{tag}"] = mesh.ppermute(
                    mine, axis, [(i, i + 1) for i in range(n - 1)]).numpy()
            Gl = MOE_X_SHAPE[0] // dp
            xb = T(x[mesh.axis_index("dp") * Gl:(mesh.axis_index("dp") + 1) * Gl].copy())
            y, aux = PM.moe_ffn(PM.shard_moe_params(tree, cfg, mesh), xb, cfg, mesh=mesh)
            route = EK.moe_route(torch.matmul(xb.float(), T(tree["router"])),
                                 PM._capacity(cfg, MOE_X_SHAPE[1]))
            tag = f"{dp}x{ep}"
            out[f"moe_y_{tag}"] = y.numpy()
            out[f"moe_aux_{tag}"] = np.float32(aux)
            out[f"moe_expert_{tag}"] = route[0].numpy()
            out[f"moe_slot_{tag}"] = route[2].numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 gloo CPU ranks once; every rank's results by rank."""
    tmp = tmp_path_factory.mktemp("parallel_ranks")
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


def _blocks(ranks, key, n, axis=1):
    return np.concatenate([ranks[r][key] for r in range(n)], axis=axis)


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("n_axes", [1, 2, 3, 4])
def test_mesh_shape_for_equals_reference(n_axes):
    axes = ("dp", "tp", "sp", "ep")[:n_axes]
    for n in range(1, 65):
        assert PMESH.mesh_shape_for(n, axes) == JMESH.mesh_shape_for(n, axes), n


def test_make_mesh_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PMESH.make_mesh(("sp",))
    with pytest.raises(RuntimeError, match="is_available"):
        DRY.dryrun_multichip(2)


def test_parallel_exports_shadow_no_submodule():
    import ray_tpu_torch.parallel as par

    for name in par.__all__:
        assert not os.path.exists(os.path.join(os.path.dirname(par.__file__), f"{name}.py"))
    assert par.ring_attention is PR  # the module, not the function


@pytest.mark.parametrize("dp,ep", MOE_MESHES)
@pytest.mark.parametrize("axis", ["dp", "ep"])
def test_mesh_collectives_equal_their_definitions(ranks, dp, ep, axis):
    """psum, all_gather (tiled, along dim 1), all_to_all (split 0, concat
    1) and ppermute (i -> i + 1, coordinate 0 gets zeros) over each axis of
    the row-major dp x ep layout, against the same computed from every
    rank's input."""
    layout = np.arange(WORLD).reshape(dp, ep)
    tag = f"{dp}x{ep}_{axis}"
    mine = lambda r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r  # noqa: E731
    a2a_in = lambda r: np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * r  # noqa: E731
    for r in range(WORLD):
        d, e = np.argwhere(layout == r)[0]
        line = list(layout[:, e] if axis == "dp" else layout[d, :])
        i, n = line.index(r), len(line)
        np.testing.assert_array_equal(ranks[r][f"coll_psum_{tag}"], sum(mine(q) for q in line))
        np.testing.assert_array_equal(ranks[r][f"coll_all_gather_{tag}"],
                                      np.concatenate([mine(q) for q in line], axis=1))
        chunk = 4 // n
        np.testing.assert_array_equal(ranks[r][f"coll_all_to_all_{tag}"], np.concatenate(
            [a2a_in(q)[i * chunk:(i + 1) * chunk] for q in line], axis=1))
        want = mine(line[i - 1]) if i > 0 else np.zeros((2, 3), np.float32)
        np.testing.assert_array_equal(ranks[r][f"coll_ppermute_{tag}"], want)


# ------------------------------------------------------------------ rings


@pytest.mark.parametrize("causal", CAUSALS)
@pytest.mark.parametrize("sp", SPS)
def test_ring_attention_equals_jax(ranks, sp, causal):
    q, k, v = _qkv(_qkv_seed(sp, causal))
    mesh = JMESH.make_mesh(("sp",), shape=(sp,), devices=jax.devices()[:sp])
    want = jax.jit(lambda q, k, v: JR.ring_attention(q, k, v, mesh, causal=causal))(q, k, v)
    got = _blocks(ranks, f"ring_{sp}_{causal}", sp)
    np.testing.assert_allclose(got, np.asarray(want), rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("causal", CAUSALS)
@pytest.mark.parametrize("sp", SPS)
def test_ring_attention_bit_equal_to_one_process_schedule(ranks, sp, causal):
    """The same _block_update calls in the same order in one process: block
    idx meets at step t the K/V block of (idx - t) mod sp."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(_qkv_seed(sp, causal)))
    B, S, H, Dh = q.shape
    Sb = S // sp
    outs = []
    for idx in range(sp):
        o = torch.zeros((B, Sb, H, Dh))
        m = torch.full((B, H, Sb), PR._NEG_INF)
        l = torch.zeros((B, H, Sb))
        for t in range(sp):
            src = (idx - t) % sp
            o, m, l = PR._block_update(q[:, idx * Sb:(idx + 1) * Sb], k[:, src * Sb:(src + 1) * Sb],
                                       v[:, src * Sb:(src + 1) * Sb], o, m, l, idx * Sb,
                                       src * Sb, causal, 1.0 / math.sqrt(Dh))
        outs.append((o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    np.testing.assert_array_equal(_blocks(ranks, f"ring_{sp}_{causal}", sp),
                                  torch.cat(outs, dim=1).numpy())


@pytest.mark.parametrize("causal", CAUSALS)
@pytest.mark.parametrize("sp", SPS)
def test_ulysses_attention_equals_jax(ranks, sp, causal):
    q, k, v = _qkv(_qkv_seed(sp, causal))
    mesh = JMESH.make_mesh(("sp",), shape=(sp,), devices=jax.devices()[:sp])
    want = jax.jit(lambda q, k, v: jax_ulysses_attention(q, k, v, mesh, causal=causal))(q, k, v)
    got = _blocks(ranks, f"ulysses_{sp}_{causal}", sp)
    np.testing.assert_allclose(got, np.asarray(want), rtol=ATT_TOL, atol=ATT_TOL)
    # and the two strategies agree, as the reference's test_ulysses_matches_ring
    np.testing.assert_allclose(got, _blocks(ranks, f"ring_{sp}_{causal}", sp),
                               rtol=ATT_TOL, atol=ATT_TOL)


def test_ulysses_rejects_indivisible_heads():
    q = torch.zeros((2, 4, 4, 16))
    with pytest.raises(ValueError, match="divisible"):
        PU.ulysses_attention(q, q, q, _fake_mesh("sp", 8))


# --------------------------------------------------------------- pipeline


@pytest.mark.parametrize("n_stages", STAGES)
def test_pipeline_equals_jax(ranks, n_stages):
    params, x = _pipe_inputs(n_stages)
    mesh = JMESH.make_mesh(("pp",), shape=(n_stages,), devices=jax.devices()[:n_stages])
    want = np.asarray(jax.jit(lambda p, x: jax_pipeline_apply(_stage_jax, p, x, mesh))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    for r in range(n_stages):  # replicated on every stage
        np.testing.assert_allclose(ranks[r][f"pipe_{n_stages}"], want, rtol=ATT_TOL,
                                   atol=ATT_TOL)
    seq = PP.reference_pipeline(_stage_torch, {k: torch.from_numpy(v) for k, v in params.items()},
                                torch.from_numpy(x))
    np.testing.assert_allclose(ranks[0][f"pipe_{n_stages}"], seq.numpy(), rtol=ATT_TOL,
                               atol=ATT_TOL)


def test_pipeline_rejects_wrong_stage_count():
    with pytest.raises(ValueError, match="leading dim"):
        PP.pipeline_apply(lambda p, x: x, {"w": torch.zeros((3, 8, 8))},
                          torch.zeros((2, 2, 8)), _fake_mesh("pp", 4))


# ----------------------------------------------------------- expert layer


def test_moe_partition_specs_equal_reference():
    ref = JM.moe_partition_specs()
    assert PM.moe_partition_specs() == {k: tuple(v) for k, v in ref.items()}


def test_shard_moe_params_takes_the_ranks_experts():
    cfg, tree, _ = _moe_inputs()
    mesh = PMESH.Mesh(("dp", "ep"), (1, 4), np.arange(4).reshape(1, 4), 2,
                      {"dp": None, "ep": None}, torch.device("cpu"))
    for local in (PM.shard_moe_params(tree, cfg, mesh),
                  PM.shard_moe_params(PM.moe_params_from_numpy(tree, cfg, device="cpu"),
                                      cfg, mesh)):
        got = PM.moe_to_numpy(local)
        np.testing.assert_array_equal(got["router"], tree["router"])
        np.testing.assert_array_equal(got["w1"], tree["w1"][4:6])
        np.testing.assert_array_equal(got["w2"], tree["w2"][4:6])


@pytest.mark.parametrize("dp,ep", MOE_MESHES)
def test_moe_mesh_equals_jax(ranks, dp, ep):
    cfg, tree, x = _moe_inputs()
    cfg_j = JM.MoEConfig(dtype=jnp.float32, **MOE_KW)
    mesh = JMESH.make_mesh(("dp", "ep"), shape=(dp, ep), devices=jax.devices()[:dp * ep])
    p_shd = jax.tree.map(lambda s: NamedSharding(mesh, s), JM.moe_partition_specs(),
                         is_leaf=lambda s: isinstance(s, P))
    params = jax.tree.map(jax.device_put, {k: jnp.asarray(v) for k, v in tree.items()}, p_shd)
    x_s = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", None, None)))
    y, aux = jax.jit(lambda p, x: JM.moe_ffn(p, x, cfg_j, mesh=mesh))(params, x_s)
    logits = np.asarray(jnp.einsum("gsd,de->gse", jnp.asarray(x), jnp.asarray(tree["router"])))
    route = jax_route(logits, PM._capacity(cfg, MOE_X_SHAPE[1]))
    tag = f"{dp}x{ep}"
    atol_y, atol_aux = MOE_GOLDEN_TOL["f32"]
    Gl = MOE_X_SHAPE[0] // dp
    for r in range(WORLD):
        d = r // ep  # the rank's coordinate on dp (row-major layout)
        blk = slice(d * Gl, (d + 1) * Gl)
        np.testing.assert_array_equal(ranks[r][f"moe_expert_{tag}"], route["expert"][blk])
        np.testing.assert_array_equal(ranks[r][f"moe_slot_{tag}"], route["slot"][blk])
        np.testing.assert_allclose(ranks[r][f"moe_y_{tag}"], np.asarray(y)[blk], rtol=0,
                                   atol=atol_y)
        assert abs(float(ranks[r][f"moe_aux_{tag}"]) - float(aux)) <= atol_aux
    assert (route["slot"] < 0).any()  # the capacity drops some tokens


# ---------------------------------------------------------------- dryrun


def test_dryrun_multichip_on_four_cpu_ranks():
    res = DRY.dryrun_multichip(WORLD, device="cpu", timeout_s=DEADLINE_S)
    assert res["meshes"] == {"sp": 4, "pp": 4, "dp x ep": [2, 2], "experts": 4}
    assert res["sched_placed"] > 0
    for key in ("ring", "ulysses", "pipeline", "moe", "moe_aux"):
        assert res[key] <= DRY.TOL, key
