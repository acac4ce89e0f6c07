"""ray_tpu_torch's RLlib kernels and Algorithm on the card. Marked `cuda`:
each test skips without a card. No JAX here, as tests for the card import
none; the CPU pairing with the JAX package is
tests/test_torch_rllib_kernels.py and tests/test_torch_rllib.py.

- K11, the runner's whole step, against its plain version (the trunk as
  torch ops and draw_plain) on the same card at B 1, 3 and 64, hidden 32,
  64 and 128, A 2 and 7, and over a 512-step key chain: the next key bit
  for bit, the draws equal outside RL_TIE_GAP (the plain version's top-2
  gap of logits + noise), logp within RL_LOGP_TOL; two launches bit-equal;
  observations from the kernel's arguments and from pinned staging.
- K12 (PG, PPO) against its plain version within CARD_TOL (the batch
  summed in another order than torch.sum), and two launches bit-equal.
- K13, the whole DQN update, against its plain version (torch ops, AdamW)
  at B 32 and 128 (hidden 64, A 2), B 32 at A 7, and in tiles: B 2 048
  (the default train_batch_size, 7 tiles) and hidden 128 at B 128 (8
  tiles); over 1 and 5 updates with a target sync after the third: the
  stats within CARD_TOL (mean q against mean |q|: its terms have both
  signs), params and moments within DQN_UPDATE_TOL tensor by tensor, the
  value head bit-equal; two launches bit-equal.
- The card's limits raise.
- One PG, one PPO and one DQN iteration of Algorithm with the learner and
  the runners on the card, each of K11-K13 launched (chip_smoke.py phase 16
  runs the full width).
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import AlgorithmConfig, prng
from ray_tpu_torch.rllib import policy as pol
from ray_tpu_torch.rllib import rllib_kernels as RK
from ray_tpu_torch.rllib.learner import DQNLearner

#: K12 and K13 against their plain versions on the card: losses relative,
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


def _policy(dev, A, hidden, seed):
    return pol.init_params(np.random.default_rng(seed), 4, A, hidden, device=dev)


def _k11_against_plain(net, obs, key, buffers=None):
    """K11 and its plain version on one step; returns K11's next key."""
    got = RK.sample_actions(net, obs, key, buffers)
    want = RK.sample_actions_plain(net, obs, key)
    assert torch.equal(got[2], want[2])
    noise = prng.gumbel_of_bits(prng.split_and_bits(key.cpu(), want[0].shape + (net.wp.shape[1],))[1])
    with torch.no_grad():
        logits = (net.trunk(torch.as_tensor(obs).to(net.w1.device)) @ net.wp + net.bp).cpu()
    s = torch.sort(noise + logits, dim=-1).values
    clean = (s[:, -1] - s[:, -2]) >= RK.RL_TIE_GAP
    assert torch.equal(got[0][clean], want[0].cpu()[clean])
    err = (got[1] - want[1].cpu()).abs()[clean].max().item() if clean.any() else 0.0
    assert err <= RK.RL_LOGP_TOL, err
    return got[2]


@pytest.mark.cuda
@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("hidden", [32, 64, 128])
@pytest.mark.parametrize("B", [1, 3, 64])
def test_cuda_sample_actions_equals_plain(B, hidden, A):
    dev = _card()
    net = _policy(dev, A, hidden, B * A + hidden)
    rng = np.random.default_rng(B * A)
    for seed in range(8):
        obs = rng.normal(0, 1.0, (B, 4)).astype(np.float32)
        key = prng.PRNGKey(seed * 7919, device=dev)
        _k11_against_plain(net, obs, key)
        a = RK.sample_actions(net, obs, key)
        b = RK.sample_actions(net, obs, key)
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
        assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.cuda
def test_cuda_sample_actions_key_chain_of_512_steps():
    dev = _card()
    net = _policy(dev, 2, 64, 1)
    buffers = RK.SampleBuffers(dev, 1)
    rng = np.random.default_rng(1)
    k_card = k_plain = prng.PRNGKey(3_000_010, device=dev)
    for i in range(512):
        obs = rng.normal(0, 0.5, (1, 4)).astype(np.float32)
        k_card = _k11_against_plain(net, obs, k_card, buffers)
        k_plain = RK.sample_actions_plain(net, obs, k_plain)[2]
        assert torch.equal(k_card, k_plain), i


@pytest.mark.cuda
def test_cuda_sample_actions_observations_from_pinned_staging():
    """B * O above ARG_OBS: the observations staged in pinned memory, each
    row drawn as the arguments' path draws it."""
    dev = _card()
    net = _policy(dev, 7, 64, 5)
    obs = np.random.default_rng(5).normal(0, 1.0, (96, 4)).astype(np.float32)
    assert obs.size > RK.ARG_OBS and obs[:60].size <= RK.ARG_OBS
    key = prng.PRNGKey(17, device=dev)
    _k11_against_plain(net, obs, key)
    staged = [t.clone() for t in RK.sample_actions(net, obs, key)]
    in_args = RK.sample_actions(net, obs[:60], key)
    assert torch.equal(in_args[0], staged[0][:60]) and torch.equal(in_args[1], staged[1][:60])
    assert torch.equal(in_args[2], staged[2])


@pytest.mark.cuda
def test_cuda_limits_raise():
    dev = _card()
    with pytest.raises(ValueError):
        RK.sample_actions(_policy(dev, 2, 512, 0), np.zeros((1, 4), np.float32),
                          prng.PRNGKey(0, device=dev))
    net = _policy(dev, 2, 256, 0)
    batch = _dqn_batch(np.random.default_rng(0), 8, 2)
    with pytest.raises(ValueError):
        RK.dqn_update(net, _policy(dev, 2, 256, 1), pol.make_optimizer(1e-3).init(net),
                      pol.make_optimizer(1e-3), batch)
    with pytest.raises(ValueError):  # at build time, before the first update
        DQNLearner(4, 2, hidden=256, device="cuda")


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


def _dqn_batch(rng, B, A):
    return {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
            "actions": rng.integers(0, A, B).astype(np.int32),
            "rewards": np.ones(B, np.float32),
            "next_obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
            "dones": (rng.random(B) < 0.1).astype(np.float32)}


def _clone(net, state):
    copy = pol.params_from_numpy(pol.params_to_numpy(net), net.device)
    return copy, type(state)(state.count, {n: t.clone() for n, t in state.mu.items()},
                             {n: t.clone() for n, t in state.nu.items()})


def _stats_close(got, want, q_abs_mean):
    rel = ((got - want.cpu()).abs() / want.cpu().abs()).tolist()
    assert max(rel[:2]) <= CARD_TOL["loss_rel"], rel
    assert abs(got[2] - want[2].cpu()).item() <= CARD_TOL["loss_rel"] * q_abs_mean, rel


@pytest.mark.cuda
@pytest.mark.parametrize("updates", [1, 5])
@pytest.mark.parametrize("B,H,A", [(32, 64, 2), (128, 64, 2), (32, 64, 7), (2048, 64, 2),
                                   (128, 128, 2)])
def test_cuda_dqn_update_equals_plain_and_is_deterministic(B, H, A, updates):
    dev = _card()
    lr = 1e-3
    net, opt = _policy(dev, A, H, B), pol.make_optimizer(lr)
    tnet = _policy(dev, A, H, B + 1)
    state = opt.init(net)
    ref, ref_state = _clone(net, state)
    ref_t = pol.params_from_numpy(pol.params_to_numpy(tnet), dev)
    rng = np.random.default_rng(B)
    for u in range(updates):
        batch = _dqn_batch(rng, B, A)
        with torch.no_grad():
            q = ref.trunk(torch.from_numpy(batch["obs"]).to(dev)) @ ref.wp + ref.bp
        twin, twin_state = _clone(net, state)
        got = RK.dqn_update(net, tnet, state, opt, batch)
        again = RK.dqn_update(twin, tnet, twin_state, opt, batch)
        want = RK.dqn_update_plain(ref, ref_t, ref_state, opt, batch, 0.99)
        _stats_close(got, want, q.abs().mean().item())
        assert torch.equal(got, again)
        for n in RK.PARAM_NAMES:
            assert torch.equal(getattr(net, n), getattr(twin, n)), n
            assert torch.equal(state.mu[n], twin_state.mu[n])
            assert torch.equal(state.nu[n], twin_state.nu[n])
        if u == 2:  # DQNLearner.sync_target
            with torch.no_grad():
                for t, p in zip(tnet.parameters(), net.parameters()):
                    t.copy_(p)
                for t, p in zip(ref_t.parameters(), ref.parameters()):
                    t.copy_(p)
    bad, got = RK.dqn_update_mismatch(net, state, ref, ref_state, updates, lr)
    assert bad is None, (bad, got)


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
            assert n["dqn_update"] == 16 and n["sample_actions"] == 0
        else:
            assert n["sample_actions"] == 2 * 2 * 128 and n["pg_loss"] == 2
    finally:
        ray_tpu_torch.shutdown()
