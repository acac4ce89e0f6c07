"""The slice as a whole on the CPU, at a small config (2 layers, width 64,
float32): Data feeding the models.

- A Dataset shuffled with one seed feeds the port's JaxTrainer (its
  worker draws iter_torch_batches(device="cpu")) and the reference's
  JaxTrainer (iter_batches), the Dataset passed through
  train_loop_config; 3 steps each from the same numpy weights. The
  batches are equal and the losses agree within TRAIN_GOLDEN_TOL["f32"].
- map_batches with a class on an actor pool runs the port's small forward
  over a Dataset of tokens: each row's last-position logits against the
  JAX forward on the same rows within the forward's float32 tolerance
  (test_torch_transformer.py: 1e-4).

Torch runs with one intra-op thread here, the count restored after: the
ops are small, and under the suite's xdist run torch's threads otherwise
spin against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.air as ref_air
import ray_tpu.data as ref_data
import ray_tpu.train as ref_train
from ray_tpu.models import transformer as JT
import ray_tpu_torch
import ray_tpu_torch.air as port_air
import ray_tpu_torch.data as port_data
import ray_tpu_torch.train as port_train
from ray_tpu_torch.models import transformer as PT
from ray_tpu_torch.parallel.tpu_train import TRAIN_GOLDEN_TOL
from test_torch_runtime import TORCH_CPU

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)
ROWS, SEQ, BATCH, STEPS = 12, 33, 4, 3
SHUFFLE_SEED = 24
FORWARD_TOL = 1e-4  # float32 logits, test_torch_transformer.py's LOGITS_TOL


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def _ref_loop(train):
    def loop(config):
        from jax.sharding import Mesh

        from ray_tpu.parallel import tpu_train as JTT

        cfg = JT.TransformerConfig(dtype=jnp.float32, **config["cfg"])
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
        params = jax.tree.map(jnp.asarray, config["tree"])
        tx = JTT.make_optimizer()
        state = tx.init(params)
        step, _ = JTT.make_train_step(cfg, mesh, tx, None)
        for i, batch in enumerate(config["dataset"].iter_batches(batch_size=config["batch"])):
            params, state, loss = step(params, state, {"tokens": jnp.asarray(batch["tokens"])})
            train.report({"loss": float(loss), "step": i,
                          "first_row": batch["tokens"][:, 0].tolist()})
    return loop


def _port_loop(train):
    def loop(config):
        from ray_tpu_torch.parallel import tpu_train as TT

        cfg = PT.TransformerConfig(dtype=torch.float32, **config["cfg"])
        mesh = train.prepare_mesh(("dp", "tp"), (1, 1), device="cpu")
        _, _, tx, shardings = TT.make_train_state(cfg, mesh, seed=0)
        params = PT.params_from_numpy(config["tree"], cfg, device=mesh.device)
        params.requires_grad_(True)
        state = tx.init(params)
        step, _ = TT.make_train_step(cfg, mesh, tx, shardings)
        for i, batch in enumerate(config["dataset"].iter_torch_batches(
                batch_size=config["batch"], device="cpu")):
            assert batch["tokens"].device.type == "cpu"
            _, _, loss = step(params, state, {"tokens": batch["tokens"]})
            train.report({"loss": float(loss), "step": i,
                          "first_row": batch["tokens"][:, 0].tolist()})
    return loop


def test_shuffled_dataset_feeds_both_trainers_equal_losses(tmp_path):
    cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
    tree = PT.numpy_params(cfg, 0)
    tokens = _tokens(5, (ROWS, SEQ))
    out = {}
    for which, rt, data, train, air, loop in (
            ("ref", ray_tpu, ref_data, ref_train, ref_air, _ref_loop(ref_train)),
            ("port", ray_tpu_torch, port_data, port_train, port_air, _port_loop(port_train))):
        if which == "ref":
            rt.init(num_cpus=8)
        else:
            rt.init(num_cpus=8, _system_config=TORCH_CPU)
        try:
            # one block: the shuffle's partitions hold random row counts, and
            # a batch never spans two blocks
            ds = data.from_numpy(tokens, column="tokens").random_shuffle(
                seed=SHUFFLE_SEED).repartition(1)
            out[which] = train.JaxTrainer(
                loop, train_loop_config={"cfg": dict(SMALL), "tree": tree, "dataset": ds,
                                         "batch": BATCH},
                scaling_config=air.ScalingConfig(num_workers=1),
                run_config=air.RunConfig(name="data", storage_path=str(tmp_path / which))).fit()
        finally:
            rt.shutdown()
    ref, port = out["ref"], out["port"]
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert len(port.metrics_history) == STEPS == ROWS // BATCH
    rows = [m["first_row"] for m in port.metrics_history]
    assert rows == [m["first_row"] for m in ref.metrics_history]
    assert sorted(r for b in rows for r in b) == sorted(tokens[:, 0].tolist())
    assert [r for b in rows for r in b] != tokens[:, 0].tolist()  # shuffled
    for a, b in zip(port.metrics_history, ref.metrics_history):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_GOLDEN_TOL["f32"]["loss"], (a, b)


class _PortForward:
    """map_batches' class: the port's small forward on the CPU, built once
    an actor; returns each row's last-position logits."""

    def __init__(self, tree):
        from ray_tpu_torch.parallel import make_forward_step

        cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
        self.model = PT.params_from_numpy(tree, cfg, device="cpu")
        self.fwd = make_forward_step(cfg, "cpu")

    def __call__(self, batch):
        return {"last": self.fwd(self.model, batch["tokens"])[:, -1].numpy()}


def test_map_batches_actor_pool_forward_equals_jax_forward():
    cfg = PT.TransformerConfig(dtype=torch.float32, **SMALL)
    tree = PT.numpy_params(cfg, 0)
    tokens = _tokens(6, (ROWS, SEQ - 1))
    ray_tpu_torch.init(num_cpus=8, _system_config=TORCH_CPU)
    try:
        ds = port_data.from_numpy(tokens, column="tokens").map_batches(
            _PortForward, compute=port_data.ActorPoolStrategy(size=2), batch_size=BATCH,
            fn_constructor_args=(tree,))
        got = np.concatenate([b["last"] for b in ds.iter_batches(batch_size=BATCH)])
    finally:
        ray_tpu_torch.shutdown()
    cfg_j = JT.TransformerConfig(dtype=jnp.float32, **SMALL)
    want = np.asarray(JT.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens),
                                 cfg_j))[:, -1]
    assert got.shape == want.shape == (ROWS, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)
