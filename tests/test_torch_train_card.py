"""ray_tpu_torch's Train library on the card: a JaxTrainer worker asking for
the GPU trains a small transformer there and checkpoints it
(chip_smoke.py phase 15 runs the full width). Marked `cuda`: it skips
without a card. It imports no JAX, as tests for the card do not; the CPU
pairing with the JAX package is tests/test_torch_train_library.py."""

import os
import subprocess

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.air as port_air
import ray_tpu_torch.train as port_train
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)


def _reap(c):
    procs = [w.proc for d in c.daemons for w in list(d.workers.values())
             if w.proc is not None]
    try:
        ray_tpu_torch.shutdown()
    finally:
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)


@pytest.mark.cuda
def test_cuda_jax_trainer_one_worker_on_the_card(tmp_path):
    """On the card: a JaxTrainer worker asking for the GPU trains on it
    (the model kernels launched in the worker) and checkpoints the
    parameters; chip_smoke.py phase 15 runs the full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    from ray_tpu_torch.models import kernels as MK
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    def loop(config):
        cfg = PT.TransformerConfig(**config["cfg"])
        mesh = port_train.prepare_mesh(("dp", "tp"))
        params, state, tx, shardings = TT.make_train_state(cfg, mesh, seed=0)
        assert params.device.type == "cuda"
        step, _ = TT.make_train_step(cfg, mesh, tx, shardings)
        batch = {"tokens": port_train.prepare_data_shard(config["tokens"], mesh)}
        ctx = port_train.get_context()
        for i in range(2):
            _, _, loss = step(params, state, batch)
        ckpt = port_train.save_pytree(PT.to_numpy(params),
                                      os.path.join(ctx.get_trial_dir(), "wip"))
        port_train.report({"loss": float(loss), "launches": MK.launch_counts()},
                          checkpoint=ckpt)

    tokens = np.random.default_rng(5).integers(0, SMALL["vocab_size"], (4, 33)).astype(np.int32)
    config = {"cfg": SMALL, "tokens": tokens}
    c = Cluster(config=Config({"jax_policy_min_cells": 0}))
    try:
        c.add_node(num_cpus=4, resources={"GPU": 1})
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
        result = port_train.JaxTrainer(
            loop, train_loop_config=config,
            scaling_config=port_air.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=port_air.RunConfig(name="cuda", storage_path=str(tmp_path))).fit()
    finally:
        _reap(c)
    assert result.error is None, result.error
    assert np.isfinite(result.metrics["loss"])
    assert all(result.metrics["launches"][k] > 0 for k in ("attention", "attention_bwd",
                                                          "rmsnorm_bwd", "rope_split_bwd"))
    assert port_train.load_pytree(result.checkpoint)["embed"].shape == (128, 64)
