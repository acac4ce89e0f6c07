"""ray_tpu_torch's RLlib kernels and Algorithm on the card. Marked `cuda`:
each test skips without a card. No JAX here, as tests for the card import
none; the CPU pairing with the JAX package is
tests/test_torch_rllib_kernels.py and tests/test_torch_rllib.py.

- K11 against its plain version on the same card: actions, logp's bits and
  the next key equal, at B 1 and 2048, A 2 and 7, and over a 512-step key
  chain.
- K12 (PG, PPO) and K13 against their plain versions within
  CARD_TOL (the batch summed in another order than torch.sum), and two
  launches bit-equal.
- One PG, one PPO and one DQN iteration of Algorithm with the learner and
  the runners on the card, each of K11-K13 launched (chip_smoke.py phase 16
  runs the full width).
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import AlgorithmConfig, prng
from ray_tpu_torch.rllib import rllib_kernels as RK

#: K12/K13 against their plain versions on the card: losses relative,
#: gradients in units of their rms (float32 sums in another order)
CARD_TOL = {"loss_rel": 1e-5, "grad_rms": 1e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    return torch.device("cuda", 0)


def _pg_inputs(dev, B, A, seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, A, generator=g)
    v = torch.randn(B, generator=g)
    actions = torch.randint(0, A, (B,), generator=g, dtype=torch.int32)
    returns = torch.randn(B, generator=g) * 2 + 3
    mask = (torch.arange(B) < B - B // 5).float()
    lp = torch.log_softmax(logits, -1).gather(1, actions.long()[:, None])[:, 0]
    logp_old = lp + torch.randn(B, generator=g) * 0.2 * (torch.rand(B, generator=g) < 0.5)
    return [t.to(dev) for t in (logits, v, actions, returns, mask, logp_old)]


def _close(got, want, what):
    for g, w, kind in zip(got, want, ("loss", "grad", "grad")):
        if kind == "loss":
            err = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item()
            assert err <= CARD_TOL["loss_rel"], (what, err)
        else:
            rms = w.double().pow(2).mean().sqrt().item()
            err = (g - w).abs().max().item() / max(rms, 1e-30)
            assert err <= CARD_TOL["grad_rms"], (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("B", [1, 2048])
def test_cuda_sample_actions_equals_plain(B, A):
    dev = _card()
    g = torch.Generator().manual_seed(B * A)
    for seed in range(8):
        logits = torch.randn(B, A, generator=g).to(dev)
        key = prng.PRNGKey(seed * 7919, device=dev)
        got = RK.sample_actions(logits, key)
        want = RK.sample_actions_plain(logits, key)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_cuda_sample_actions_key_chain_of_512_steps():
    dev = _card()
    logits = torch.randn(1, 2, generator=torch.Generator().manual_seed(1)).to(dev)
    k_card = k_plain = prng.PRNGKey(3_000_010, device=dev)
    for i in range(512):
        a, lp, k_card = RK.sample_actions(logits, k_card)
        b, lq, k_plain = RK.sample_actions_plain(logits, k_plain)
        assert torch.equal(k_card, k_plain) and torch.equal(a, b), i
        assert torch.equal(lp.view(torch.int32), lq.view(torch.int32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("ppo", [False, True], ids=["pg", "ppo"])
@pytest.mark.parametrize("B,A", [(2048, 2), (1024, 2), (2048, 7), (5, 3)])
def test_cuda_pg_loss_equals_plain_and_is_deterministic(ppo, B, A):
    dev = _card()
    logits, v, actions, returns, mask, logp_old = _pg_inputs(dev, B, A, B + A)
    clip = RK.PPO_CLIP if ppo else None
    old = logp_old if ppo else None
    got = RK.pg_loss(logits, v, actions, returns, mask, old, clip)
    again = RK.pg_loss(logits, v, actions, returns, mask, old, clip)
    want = RK.pg_loss_plain(logits, v, actions, returns, mask, old, clip)
    _close(got, want, "pg_loss")
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("B,A", [(128, 2), (128, 7), (3000, 2)])
def test_cuda_dqn_loss_equals_plain_and_is_deterministic(B, A):
    dev = _card()
    g = torch.Generator().manual_seed(B + A)
    q, qo, qt = (torch.randn(B, A, generator=g).to(dev) * 3 for _ in range(3))
    actions = torch.randint(0, A, (B,), generator=g, dtype=torch.int32).to(dev)
    rewards = torch.ones(B, device=dev)
    dones = (torch.rand(B, generator=g) < 0.1).float().to(dev)
    args = (q, qo, qt, actions, rewards, dones, 0.99)
    got, again, want = RK.dqn_loss(*args), RK.dqn_loss(*args), RK.dqn_loss_plain(*args)
    _close((got[0], got[1]), (want[0], want[1]), "dqn_loss")
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["pg", "ppo", "dqn"])
def test_cuda_algorithm_iterates_on_the_card(algo):
    _card()
    ray_tpu_torch.init(num_cpus=4, _system_config={"scheduler_device": "cpu"})
    try:
        cfg = AlgorithmConfig(algo=algo).environment("CartPole-v1")
        if algo == "dqn":
            cfg = AlgorithmConfig(algo="dqn", train_batch_size=128, num_updates_per_iter=8,
                                  learning_starts=256).env_runners(2, 128)
        else:
            cfg = cfg.env_runners(2, 128).training(train_batch_size=256)
        algo_ = cfg.resources(learner_device="cuda", env_runner_device="cuda").build()
        RK.reset_launch_counts()
        try:
            for _ in range(2):
                r = algo_.train()
        finally:
            algo_.stop()
        assert np.isfinite(r["total_loss"])
        n = RK.launch_counts()
        if algo == "dqn":
            assert n["dqn_loss"] == 16 and n["sample_actions"] == 0
        else:
            assert n["sample_actions"] == 2 * 2 * 128 and n["pg_loss"] == 2
    finally:
        ray_tpu_torch.shutdown()
