"""ray_tpu_torch.data on the card: iter_torch_batches() with no device lands
on the card, and an actor pool's forward through map_batches equals the
direct forward bit for bit at a small config (chip_smoke.py phase 17 runs
the full width). Marked `cuda`: each skips without a card, and on the CPU
iter_torch_batches() with no device raises instead of handing back CPU
tensors. It imports no JAX, as tests for the card do not; the CPU pairing
with the JAX package is tests/test_torch_data*.py."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")


def test_iter_torch_batches_without_a_card_raises():
    """No quiet fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("runs where there is no card")
    ray_tpu_torch.init(num_cpus=2, _system_config={"scheduler_device": "cpu"})
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            next(iter(data.range(4).iter_torch_batches(batch_size=2)))
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_cuda_iter_torch_batches_lands_on_the_card():
    _needs_card()
    ray_tpu_torch.init(num_cpus=4)
    try:
        ds = data.from_items([{"x": float(i), "y": i} for i in range(20)], parallelism=2)
        batches = list(ds.iter_torch_batches(batch_size=8, dtypes={"x": torch.float32}))
    finally:
        ray_tpu_torch.shutdown()
    assert all(t.device.type == "cuda" for b in batches for t in b.values())
    assert torch.cat([b["y"] for b in batches]).cpu().tolist() == list(range(20))
    assert batches[0]["x"].dtype == torch.float32


class _Forward:
    def __init__(self, tree, cfg):
        from ray_tpu_torch.models import transformer as PT
        from ray_tpu_torch.parallel import make_forward_step

        self.model = PT.params_from_numpy(tree, cfg, device="cuda")
        self.fwd = make_forward_step(cfg)

    def __call__(self, batch):
        last = self.fwd(self.model, batch["tokens"])[:, -1].float().cpu().numpy()
        return {"last": last}


@pytest.mark.cuda
def test_cuda_actor_pool_forward_bit_equal_direct():
    """map_batches with a class on a pool of 2 actors, each holding the
    small bf16 model on the card: every row's last logits bit-equal to the
    direct forward on the same 4-row batches, and the forward's kernels
    launched by the actors."""
    _needs_card()
    from ray_tpu_torch.models import kernels as MK
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_forward_step

    cfg = PT.TransformerConfig(**SMALL)
    tree = PT.numpy_params(cfg, 0)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (16, 48)).astype(np.int32)
    ray_tpu_torch.init(num_cpus=4)
    try:
        base = data.from_numpy(tokens, column="tokens").repartition(4)
        batches = [b["tokens"] for b in base.iter_batches(batch_size=4)]
        MK.reset_launch_counts()
        ds = base.map_batches(_Forward, compute=data.ActorPoolStrategy(size=2), batch_size=4,
                              fn_constructor_args=(tree, cfg))
        got = np.concatenate([b["last"] for b in ds.iter_batches(batch_size=4)])
        launches = MK.launch_counts()
    finally:
        ray_tpu_torch.shutdown()
    model = PT.params_from_numpy(tree, cfg, device="cuda")
    fwd = make_forward_step(cfg)
    want = np.concatenate([fwd(model, b)[:, -1].float().cpu().numpy() for b in batches])
    assert got.shape == want.shape and np.array_equal(got, want)
    assert all(launches[k] > 0 for k in ("attention", "rmsnorm", "rope_split")), launches
