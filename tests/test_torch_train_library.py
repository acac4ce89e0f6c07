"""ray_tpu_torch's Train library (air/, train/) held against ray_tpu's on the
same inputs, on the CPU.

- The nine cases of tests/test_train.py, each loop run by both packages:
  the results' metrics and histories equal (local mode, 8 CPUs; the
  cluster-mode cases on a one-node cluster of each package).
- The configs' fields and defaults, the workers' resources and
  placement-group bundles over a grid, and CheckpointManager's kept and
  best directories for one sequence of scores, equal.
- Checkpoint.from_dict written by one package and read by the other;
  save_pytree's pytree_leaves.npz leaf for leaf equal; the port's
  load_pytree of the reference's checkpoint raises, naming its file.
- JaxTrainer: one worker at a small TransformerConfig against the
  reference's JaxTrainer on a one-device mesh (two losses and the
  checkpointed parameters within TRAIN_GOLDEN_TOL["f32"]); two workers in
  cluster mode (gloo, dp 2 x tp 1) against the reference's one worker on a
  2-device mesh (loss 1e-5, rank 0's gathered parameters within
  TRAIN_GOLDEN_TOL["f32"], every leaf bit-equal across the two ranks).
- TorchTrainer's DDP over gloo: the weights bit-equal to the reference's.

Every function a worker runs is nested in a module-level factory, so it
is pickled by value and a worker process never imports this module (nor
jax). Every cluster-mode case runs its fit() under a deadline and reaps
the worker processes it started.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.air as ref_air
import ray_tpu.train as ref_train
from ray_tpu.cluster import Cluster as RefCluster
from ray_tpu.core.config import Config as RefConfig
from ray_tpu.train.checkpoint_manager import CheckpointManager as RefCheckpointManager
import ray_tpu_torch
import ray_tpu_torch.air as port_air
import ray_tpu_torch.train as port_train
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.parallel.tpu_train import TRAIN_GOLDEN_TOL
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from test_torch_runtime import TORCH_CPU

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)
DEADLINE_S = 240.0
LEAVES = ("embed", "unembed", "ln_f", "layers.wqkv", "layers.wo", "layers.w1", "layers.w2",
          "layers.ln1", "layers.ln2")
PACKAGES = {"ref": (ray_tpu, ref_train, ref_air), "port": (ray_tpu_torch, port_train, port_air)}


def _init_local(which):
    if which == "ref":
        ray_tpu.init(num_cpus=8)
    else:
        ray_tpu_torch.init(num_cpus=8, _system_config=TORCH_CPU)


def _fit_both(tmp_path, make_trainer):
    """fit() of make_trainer(rt, train, air, storage) in local mode, first
    by the reference, then by the port."""
    out = {}
    for which, (rt, train, air) in PACKAGES.items():
        _init_local(which)
        try:
            out[which] = make_trainer(rt, train, air, str(tmp_path / which)).fit()
        finally:
            rt.shutdown()
    return out["ref"], out["port"]


def _same_results(ref, port):
    assert port.metrics == ref.metrics
    assert port.metrics_history == ref.metrics_history
    assert (port.error is None) == (ref.error is None)


# ------------------------------------------------------------------ loops


def _basic_loop(train):
    def loop(config):
        ctx = train.get_context()
        for i in range(3):
            train.report({"loss": 1.0 / (i + 1), "rank": ctx.get_world_rank()})
    return loop


def _ranks_loop(train):
    def loop(config):
        ctx = train.get_context()
        train.report({"world_size": ctx.get_world_size(), "rank": ctx.get_world_rank(),
                      "local_rank": ctx.get_local_rank(), "node_rank": ctx.get_node_rank()})
    return loop


def _ckpt_loop(train, Checkpoint):
    def loop(config):
        ctx = train.get_context()
        for i in range(4):
            ckpt = None
            if ctx.get_world_rank() == 0:
                d = os.path.join(ctx.get_trial_dir(), f"wip_{i}")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "state.txt"), "w") as f:
                    f.write(str(i))
                ckpt = Checkpoint.from_directory(d)
            train.report({"score": float(i)}, checkpoint=ckpt)
    return loop


def _fail_once_loop(train, Checkpoint, marker):
    def loop(config):
        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for i in range(start, 4):
            if i == 2 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("injected failure at step 2")
            c = Checkpoint.from_dict({"step": i}) if ctx.get_world_rank() == 0 else None
            train.report({"step": float(i)}, checkpoint=c)
    return loop


def _always_fails_loop():
    def loop(config):
        raise ValueError("always fails")
    return loop


def _ddp_loop(train, prepare_data_loader, prepare_model):
    """tests/test_train.py's DDP loop; rank 0 reports its final weights."""
    def loop(config):
        import torch
        import torch.distributed as dist
        from torch.utils.data import DataLoader, TensorDataset

        assert dist.is_initialized() and dist.get_world_size() == 2
        assert os.environ["WORLD_SIZE"] == "2"
        assert int(os.environ["RANK"]) == dist.get_rank()
        assert os.environ["MASTER_PORT"] not in ("", "0")
        rank = dist.get_rank()
        torch.manual_seed(0)
        model = prepare_model(torch.nn.Linear(4, 1))
        xs = torch.randn(32, 4)
        ys = xs.sum(dim=1, keepdim=True)
        loader = prepare_data_loader(DataLoader(TensorDataset(xs, ys), batch_size=8))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        n_batches = 0
        for _ in range(3):
            for xb, yb in loader:
                opt.zero_grad()
                loss = ((model(xb) - yb) ** 2).mean()
                loss.backward()
                opt.step()
                n_batches += 1
        assert n_batches == 3 * 2, n_batches
        w = model.module.weight.detach().clone()
        gathered = [torch.zeros_like(w) for _ in range(2)]
        dist.all_gather(gathered, w)
        assert torch.equal(gathered[0], gathered[1]), "replicas diverged"
        train.report({"loss": float(loss), "rank": rank,
                      "weight": w.reshape(-1).tolist(),
                      "bias": model.module.bias.detach().reshape(-1).tolist()})
    return loop


# ------------------------------------------- the cases of tests/test_train.py


def test_basic_report_equals_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.DataParallelTrainer(
        _basic_loop(train), scaling_config=air.ScalingConfig(num_workers=2),
        run_config=air.RunConfig(name="basic", storage_path=d)))
    _same_results(ref, port)
    assert port.error is None and port.metrics["training_iteration"] == 3
    assert port.metrics["rank"] == 0 and len(port.metrics_history) == 3


def test_context_ranks_equal_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.DataParallelTrainer(
        _ranks_loop(train), scaling_config=air.ScalingConfig(num_workers=4),
        run_config=air.RunConfig(name="ranks", storage_path=d)))
    _same_results(ref, port)
    assert port.metrics["world_size"] == 4 and port.metrics["local_rank"] == 0


def test_checkpoint_persist_and_keep_equal_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.DataParallelTrainer(
        _ckpt_loop(train, air.Checkpoint), scaling_config=air.ScalingConfig(num_workers=2),
        run_config=air.RunConfig(name="ckpt", storage_path=d,
                                 checkpoint_config=air.CheckpointConfig(
                                     num_to_keep=2, checkpoint_score_attribute="score"))))
    _same_results(ref, port)
    for r in (ref, port):
        with r.checkpoint.as_directory() as d:
            assert open(os.path.join(d, "state.txt")).read() == "3"
    kept = [sorted(p for p in os.listdir(r.path) if p.startswith("checkpoint_"))
            for r in (ref, port)]
    assert kept[0] == kept[1] and len(kept[1]) <= 2
    assert os.path.basename(port.checkpoint.path) == os.path.basename(ref.checkpoint.path)


def test_failure_restart_from_checkpoint_equals_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.DataParallelTrainer(
        _fail_once_loop(train, air.Checkpoint, os.path.join(d + "_marker")),
        scaling_config=air.ScalingConfig(num_workers=2),
        run_config=air.RunConfig(name="ft", storage_path=d,
                                 failure_config=air.FailureConfig(max_failures=2))))
    _same_results(ref, port)
    assert port.error is None and port.metrics["step"] == 3.0
    assert port.checkpoint.to_dict()["step"] == 3 == ref.checkpoint.to_dict()["step"]
    assert [m["step"] for m in port.metrics_history] == [0.0, 1.0, 2.0, 3.0]


def test_failure_exhausted_surfaces_error_as_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.DataParallelTrainer(
        _always_fails_loop(), scaling_config=air.ScalingConfig(num_workers=1),
        run_config=air.RunConfig(name="err", storage_path=d)))
    _same_results(ref, port)
    assert port.error is not None and "always fails" in str(port.error)
    assert "always fails" in str(ref.error)


def test_torch_trainer_local_mode_raises_as_reference(tmp_path):
    ref, port = _fit_both(tmp_path, lambda rt, train, air, d: train.TorchTrainer(
        lambda config: None, scaling_config=air.ScalingConfig(num_workers=2),
        run_config=air.RunConfig(name="torch-local", storage_path=d)))
    assert str(port.error) == str(ref.error).replace("ray_tpu.", "ray_tpu_torch.")
    assert "cluster mode" in str(port.error)


def test_jax_trainer_local_mode_with_two_workers_raises(tmp_path):
    """The port's JaxTrainer forms a process group for two workers, which
    local mode's threads cannot (the reference forms none on one node)."""
    ray_tpu_torch.init(num_cpus=8, _system_config=TORCH_CPU)
    try:
        result = port_train.JaxTrainer(
            lambda config: None, scaling_config=port_air.ScalingConfig(num_workers=2),
            jax_backend=port_train.JaxBackend(coordinator_port=0),
            run_config=port_air.RunConfig(name="jax-local", storage_path=str(tmp_path))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is not None and "cluster mode" in str(result.error)


def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(6).reshape(2, 3), "b": [np.ones(4), np.float32(2.5)],
            "c": (None, torch.arange(3, dtype=torch.float32)), "d": {}}
    back = port_train.load_pytree(port_train.save_pytree(tree, str(tmp_path / "ck")))
    np.testing.assert_array_equal(back["a"], np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(back["b"][0], np.ones(4))
    assert back["b"][1] == np.float32(2.5) and back["b"][1].dtype == np.float32
    assert back["c"][0] is None and isinstance(back["c"], tuple)
    np.testing.assert_array_equal(back["c"][1], np.arange(3, dtype=np.float32))
    assert back["d"] == {}


# ----------------------------------------------------------- checkpoints


def _numpy_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": {"b": rng.integers(0, 9, (5,)).astype(np.int64),
                       "a": [rng.standard_normal(2), np.float32(1.5), None,
                             (np.uint8(7), np.bool_(True))]},
            "count": 4, "half": np.ones(3, np.float16)}


def test_save_pytree_leaves_equal_reference_and_reference_checkpoint_raises(tmp_path):
    tree = _numpy_tree()
    ref_train.save_pytree(tree, str(tmp_path / "ref"))
    port_train.save_pytree(tree, str(tmp_path / "port"))
    want = np.load(tmp_path / "ref" / "pytree_leaves.npz")
    got = np.load(tmp_path / "port" / "pytree_leaves.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    back = port_train.load_pytree(port_air.Checkpoint(str(tmp_path / "port")))
    ref_back = ref_train.load_pytree(ref_air.Checkpoint(str(tmp_path / "ref")))
    import jax

    assert jax.tree.structure(back) == jax.tree.structure(ref_back)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pytree_structure.pkl"):
        port_train.load_pytree(port_air.Checkpoint(str(tmp_path / "ref")))
    with pytest.raises(TypeError, match="bfloat16"):
        port_train.save_pytree({"x": torch.ones(2, dtype=torch.bfloat16)}, str(tmp_path / "bf"))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_from_dict_read_by_the_other_package(writer, tmp_path):
    data = {"step": 3, "arr": np.arange(4.0), "nested": {"k": [1, "two"]}}
    write, read = (ref_air, port_air) if writer == "ref" else (port_air, ref_air)
    ckpt = write.Checkpoint.from_dict(data)
    ckpt.set_metadata({"by": writer})
    other = read.Checkpoint.from_directory(ckpt.path)
    back = other.to_dict()
    assert back["step"] == 3 and back["nested"] == data["nested"]
    np.testing.assert_array_equal(back["arr"], data["arr"])
    assert other.get_metadata() == {"by": writer}
    copied = read.Checkpoint(other.to_directory(str(tmp_path / "copy")))
    assert copied.to_dict()["step"] == 3


# -------------------------------------------------------------- configs


def _fields(cls):
    import dataclasses

    out = {}
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out[f.name] = repr(default)
    return out


@pytest.mark.parametrize("name", ["ScalingConfig", "RunConfig", "CheckpointConfig",
                                  "FailureConfig"])
def test_config_fields_and_defaults_equal_reference(name):
    assert _fields(getattr(port_air, name)) == _fields(getattr(ref_air, name))


def test_worker_resources_and_bundles_equal_reference():
    grid = [dict(num_workers=n, use_tpu=t, use_gpu=g, resources_per_worker=r,
                 trainer_resources=tr)
            for n in (0, 1, 3) for t in (False, True) for g in (False, True)
            for r in (None, {"GPU": 0.5}, {"CPU": 2, "H100": 1}, {"TPU": 4, "GPU": 1})
            for tr in (None, {"CPU": 1})]
    for kw in grid:
        port, ref = port_air.ScalingConfig(**kw), ref_air.ScalingConfig(**kw)
        assert port._worker_resources() == ref._worker_resources(), kw
        assert port.as_placement_group_bundles() == ref.as_placement_group_bundles(), kw
    assert port_air.ScalingConfig(use_gpu=True)._worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    with pytest.raises(ValueError):
        port_air.CheckpointConfig(checkpoint_score_order="up")


@pytest.mark.parametrize("cfg", [dict(), dict(num_to_keep=2),
                                 dict(num_to_keep=2, checkpoint_score_attribute="score"),
                                 dict(num_to_keep=3, checkpoint_score_attribute="score",
                                      checkpoint_score_order="min")])
def test_checkpoint_manager_kept_and_best_equal_reference(cfg, tmp_path):
    scores = [0.5, 2.0, 1.0, 3.0, 0.25, 2.5]
    out = {}
    for which, mgr_cls, air in (("ref", RefCheckpointManager, ref_air),
                                ("port", CheckpointManager, port_air)):
        run_dir = tmp_path / which / "run"
        mgr = mgr_cls(str(run_dir), air.CheckpointConfig(**cfg))
        for i, s in enumerate(scores):
            src = tmp_path / which / f"src_{i}"
            src.mkdir(parents=True)
            (src / "i.txt").write_text(str(i))
            mgr.register(str(src), {"score": s})
        out[which] = (sorted(os.listdir(run_dir)), os.path.basename(mgr.best().path),
                      os.path.basename(mgr.latest.path))
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ accelerators


def test_accelerator_constants_and_helpers_equal_reference(monkeypatch):
    import ray_tpu.util.accelerators as RA
    import ray_tpu_torch.util.accelerators as PA

    for name in dir(RA):
        if name.startswith("TPU_"):
            assert getattr(PA, name) == getattr(RA, name), name
    assert PA.NVIDIA_H100 == "H100"
    for t in (PA.TPU_V5E, PA.NVIDIA_H100):
        for n in (1, 0.5, 4):
            assert PA.accelerator_resource(t, n) == RA.accelerator_resource(t, n)
    envs = [{}, {"TPU_NAME": "pod-a"}, {"TPU_WORKER_HOSTNAMES": "h0,h1,,h2"},
            {"TPU_NUM_WORKERS": "4", "TPU_WORKER_ID": "2"}, {"TPU_WORKER_ID": ""},
            {"TPU_NAME": "pod-b", "TPU_WORKER_HOSTNAMES": "x,y", "TPU_WORKER_ID": "0"}]
    keys = ("TPU_NAME", "TPU_WORKER_HOSTNAMES", "TPU_NUM_WORKERS", "TPU_WORKER_ID")
    for env in envs:
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("get_current_pod_name", "get_current_pod_worker_count",
                   "get_current_pod_worker_id"):
            assert getattr(PA, fn)() == getattr(RA, fn)(), (env, fn)


def test_current_accelerator_type(monkeypatch):
    import ray_tpu_torch.util.accelerators as PA

    if not torch.cuda.is_available():
        assert PA.current_accelerator_type() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", PA.NVIDIA_H100),
                       ("NVIDIA A100-SXM4-80GB", PA.NVIDIA_A100),
                       ("Tesla V100-SXM2-16GB", PA.NVIDIA_TESLA_V100),
                       ("NVIDIA L4", PA.NVIDIA_L4)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0, n=name: n)
        assert PA.current_accelerator_type() == want, name


def test_accelerators_import_does_not_start_cuda():
    import subprocess
    import sys

    code = ("import torch, ray_tpu_torch.util.accelerators, ray_tpu_torch.train;"
            "print(torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


# --------------------------------------------------------- profile_device


def test_profile_device_writes_a_trace(tmp_path):
    from ray_tpu_torch.util.tracing import profile_device

    with profile_device(str(tmp_path / "prof")) as d:
        assert d == str(tmp_path / "prof")
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith(f"trace_{os.getpid()}_")
    import json

    with open(tmp_path / "prof" / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_profile_device_guard_raises_on_lost_device_records(tmp_path):
    """A window in which a kernel wrapper counted launches and the trace
    holds no record of its kernel raises, after writing the trace."""
    from ray_tpu_torch.models import kernels as MK
    from ray_tpu_torch.util import tracing

    before = MK.attention_bwd.launches
    with pytest.raises(tracing.LostDeviceRecordsError, match="attention_bwd"):
        with tracing.profile_device(str(tmp_path / "prof")):
            MK.attention_bwd.launches += 2  # as a launch on the card counts
    MK.attention_bwd.launches = before
    assert len(os.listdir(tmp_path / "prof")) == 1
    # the matching is by CUDA symbol, whole words
    assert tracing.device_records_missing(
        {"attention_bwd": 1, "rmsnorm_bwd": 1, "rope_split_bwd": 1},
        ["void attention_sm90_bwd_dq_kernel<64>(Params)", "rmsnorm_bwd_kernel",
         "rope_split_bwd_rows_kernel<true>"]) == {}
    assert tracing.device_records_missing(
        {"rmsnorm": 3}, ["rmsnorm_bwd_kernel"]) == {"rmsnorm": 3}


# ------------------------------------------------------------- JaxTrainer


def _train_inputs():
    from ray_tpu_torch.models import transformer as PT

    cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
    tree = PT.numpy_params(cfg, 0)
    tokens = np.random.default_rng(5).integers(0, SMALL["vocab_size"], (4, 33)).astype(np.int32)
    return {"cfg": dict(SMALL), "tree": tree, "tokens": tokens, "steps": 2}


def _ref_jax_loop(train, n_devices):
    """The reference's JaxTrainer loop: make_train_step on a dp x 1 mesh of
    n_devices CPU devices from the numpy weights; a report a step, the
    last with save_pytree of the parameters."""
    def loop(config):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from ray_tpu.models import transformer as JT
        from ray_tpu.parallel import tpu_train as JTT

        cfg = JT.TransformerConfig(dtype=jnp.float32, **config["cfg"])
        mesh = Mesh(np.array(jax.devices()[:n_devices]).reshape(n_devices, 1), ("dp", "tp"))
        if n_devices == 1:
            shardings = None
            params = jax.tree.map(jnp.asarray, config["tree"])
        else:
            shardings = JTT._sharding_tree(mesh, JT.param_partition_specs(cfg))
            params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                                  config["tree"], shardings)
        tx = JTT.make_optimizer()
        state = tx.init(params)
        step, batch_sharding = JTT.make_train_step(cfg, mesh, tx, shardings)
        tokens = jnp.asarray(config["tokens"])
        batch = {"tokens": tokens if batch_sharding is None
                 else jax.device_put(tokens, batch_sharding)}
        ctx = train.get_context()
        for i in range(config["steps"]):
            params, state, loss = step(params, state, batch)
            ckpt = None
            if i + 1 == config["steps"]:
                ckpt = train.save_pytree(jax.tree.map(np.asarray, params),
                                         os.path.join(ctx.get_trial_dir(), "wip"))
            train.report({"loss": float(loss), "step": i}, checkpoint=ckpt)
    return loop


def _port_jax_loop(train, PT, TT):
    """The port's JaxTrainer loop: prepare_mesh (one rank, or dp x 1 over
    the group), make_train_state on it with the numpy weights put in, the
    global batch by prepare_data_shard; a report a step, the last with
    rank 0's gathered parameters by save_pytree; every rank writes its
    parameters to rank<r>.npz beside it."""
    def loop(config):
        cfg = PT.TransformerConfig(dtype=torch.float32, **config["cfg"])
        ctx = train.get_context()
        n = ctx.get_world_size()
        mesh = train.prepare_mesh(("dp", "tp"), (n, 1), device="cpu")
        params, state, tx, shardings = TT.make_train_state(cfg, mesh, seed=0)
        if shardings is None:
            params = PT.params_from_numpy(config["tree"], cfg, device=mesh.device)
        else:
            params = PT.shard_params(config["tree"], cfg, mesh)
        params.requires_grad_(True)
        state = tx.init(params)
        step, _ = TT.make_train_step(cfg, mesh, tx, shardings)
        batch = {"tokens": train.prepare_data_shard(config["tokens"], mesh)}
        for i in range(config["steps"]):
            _, _, loss = step(params, state, batch)
            ckpt = None
            if i + 1 == config["steps"]:
                tree = PT.to_numpy(params) if shardings is None \
                    else PT.gather_params(params, mesh)
                rank = ctx.get_world_rank()
                mine = PT.to_numpy(params)
                np.savez(os.path.join(ctx.get_trial_dir(), f"rank{rank}.npz"),
                         **{name: mine[name] if "." not in name else mine["layers"][name[7:]]
                            for name in LEAVES})
                if rank == 0:
                    ckpt = train.save_pytree(tree, os.path.join(ctx.get_trial_dir(), "wip"))
            train.report({"loss": float(loss), "step": i}, checkpoint=ckpt)
    return loop


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _assert_params_close(got, want):
    tol = TRAIN_GOLDEN_TOL["f32"]
    for name in LEAVES:
        d = np.abs(_leaf(got, name) - _leaf(want, name))
        assert d.max() <= tol["param"], (name, float(d.max()))
        assert (d <= 1e-6).mean() >= tol["param_share"], (name, float((d <= 1e-6).mean()))


def _assert_losses_close(port, ref):
    assert [m["step"] for m in port.metrics_history] == [m["step"] for m in ref.metrics_history]
    assert [m["training_iteration"] for m in port.metrics_history] == \
        [m["training_iteration"] for m in ref.metrics_history]
    for a, b in zip(port.metrics_history, ref.metrics_history):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_GOLDEN_TOL["f32"]["loss"], (a, b)


def test_jax_trainer_one_worker_equals_reference(tmp_path):
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    config = _train_inputs()
    out = {}
    for which, (rt, train, air) in PACKAGES.items():
        loop = _ref_jax_loop(train, 1) if which == "ref" else _port_jax_loop(train, PT, TT)
        _init_local(which)
        try:
            out[which] = train.JaxTrainer(
                loop, train_loop_config=config,
                scaling_config=air.ScalingConfig(num_workers=1),
                run_config=air.RunConfig(name="jax", storage_path=str(tmp_path / which))).fit()
        finally:
            rt.shutdown()
    ref, port = out["ref"], out["port"]
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert len(port.metrics_history) == 2
    _assert_losses_close(port, ref)
    _assert_params_close(port_train.load_pytree(port.checkpoint),
                         ref_train.load_pytree(ref.checkpoint))


def _worker_procs(c):
    return [w.proc for d in c.daemons for w in list(d.workers.values())
            if w.proc is not None]


def _reap(rt, c, seen):
    """Driver first, then the cluster; every worker process seen is waited
    for, and killed if it outlives its daemon's SIGTERM."""
    procs = set(seen) | set(_worker_procs(c))
    try:
        rt.shutdown()
    finally:
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)


def _fit_in_cluster(which, make_trainer, node_cpus=4):
    """fit() on a one-node cluster of the package, under DEADLINE_S; the
    cluster and its worker processes are torn down whatever happens."""
    if which == "ref":
        rt, c = ray_tpu, RefCluster(config=RefConfig({"gray_defense_enabled": False}))
    else:
        rt, c = ray_tpu_torch, Cluster(config=Config({**TORCH_CPU,
                                                      "gray_defense_enabled": False}))
    seen = []
    try:
        c.add_node(num_cpus=node_cpus)
        c.wait_for_nodes(1)
        rt.init(address=c.address)
        trainer = make_trainer()
        box = {}

        def run():
            try:
                box["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + DEADLINE_S
        while t.is_alive():
            seen.extend(p for p in _worker_procs(c) if p not in seen)
            if time.monotonic() > deadline:
                raise AssertionError(f"{which}: fit() still running after {DEADLINE_S} s")
            t.join(0.5)
        if "error" in box:
            raise box["error"]
        return box["result"]
    finally:
        _reap(rt, c, seen)


def test_jax_trainer_two_workers_in_cluster_mode_equals_reference_on_two_devices(tmp_path):
    """Two port workers, one gloo group, dp 2 x tp 1, against the
    reference's one worker on a 2-device mesh."""
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    config = _train_inputs()
    ray_tpu.init(num_cpus=8)
    try:
        ref = ref_train.JaxTrainer(
            _ref_jax_loop(ref_train, 2), train_loop_config=config,
            scaling_config=ref_air.ScalingConfig(num_workers=1),
            run_config=ref_air.RunConfig(name="jax2", storage_path=str(tmp_path / "ref"))).fit()
    finally:
        ray_tpu.shutdown()
    port = _fit_in_cluster("port", lambda: port_train.JaxTrainer(
        _port_jax_loop(port_train, PT, TT), train_loop_config=config,
        jax_backend=port_train.JaxBackend(coordinator_port=0),
        scaling_config=port_air.ScalingConfig(num_workers=2),
        run_config=port_air.RunConfig(name="jax2", storage_path=str(tmp_path / "port"))))
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert len(port.metrics_history) == 2
    _assert_losses_close(port, ref)
    _assert_params_close(port_train.load_pytree(port.checkpoint),
                         ref_train.load_pytree(ref.checkpoint))
    ranks = [np.load(os.path.join(port.path, f"rank{r}.npz")) for r in range(2)]
    assert sorted(ranks[0].files) == sorted(LEAVES)
    for name in LEAVES:
        assert np.array_equal(ranks[0][name], ranks[1][name]), name


def test_torch_trainer_ddp_gloo_weights_equal_reference(tmp_path):
    from ray_tpu.train.torch_trainer import prepare_data_loader as ref_pdl
    from ray_tpu.train.torch_trainer import prepare_model as ref_pm

    out = {}
    for which, (rt, train, air) in PACKAGES.items():
        pdl, pm = (ref_pdl, ref_pm) if which == "ref" else \
            (port_train.prepare_data_loader, port_train.prepare_model)
        out[which] = _fit_in_cluster(which, lambda: train.TorchTrainer(
            _ddp_loop(train, pdl, pm), scaling_config=air.ScalingConfig(num_workers=2),
            run_config=air.RunConfig(name="torch", storage_path=str(tmp_path / which))))
    ref, port = out["ref"], out["port"]
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert np.isfinite(port.metrics["loss"])
    assert port.metrics == ref.metrics  # the weights and the loss, bit for bit
    assert port.metrics_history == ref.metrics_history


def test_prepare_mesh_runs_on_the_card_unless_cpu():
    """Without a process group, prepare_mesh is one rank on the card, and
    raises without one; device="cpu" asks for the CPU. make_train_state
    takes the one-rank mesh as one device, on the mesh's device."""
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            port_train.prepare_mesh(("dp", "tp"))
    mesh = port_train.prepare_mesh(("dp", "tp"), device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.size == 1 and mesh.device.type == "cpu"
    assert port_train.prepare_mesh(device="cpu").axis_names == ("dp",)
    with pytest.raises(ValueError, match="one rank"):
        port_train.prepare_mesh(("dp", "tp"), (2, 1), device="cpu")
    cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
    params, state, tx, shardings = TT.make_train_state(cfg, mesh, seed=4)
    assert shardings is None and params.device.type == "cpu"
    want = TT.make_train_state(cfg, seed=4, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), want.parameters()))
    tokens = np.arange(8 * 5, dtype=np.int32).reshape(8, 5)
    shard = port_train.prepare_data_shard(tokens, mesh)
    assert shard.device.type == "cpu" and torch.equal(shard, torch.as_tensor(tokens))
    with pytest.raises(ValueError, match="no axis"):
        port_train.prepare_data_shard(tokens, mesh, axis="sp")


def test_opt_state_round_trips_through_numpy():
    """AdamW's state through opt_state_to_numpy and back, bit for bit: the
    checkpoint a Train loop resumes from."""
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
    params, state, tx, _ = TT.make_train_state(cfg, seed=1, device="cpu")
    step, _ = TT.make_train_step(cfg, None, tx)
    tokens = np.random.default_rng(2).integers(0, SMALL["vocab_size"], (2, 17)).astype(np.int32)
    step(params, state, {"tokens": tokens})
    back = TT.opt_state_from_numpy(TT.opt_state_to_numpy(state), params)
    assert back.count == state.count == 1
    for part in ("mu", "nu"):
        got, want = getattr(back, part), getattr(state, part)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
