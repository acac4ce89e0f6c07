"""ray_tpu_torch.rllib held against ray_tpu.rllib on the CPU.

- The eight cases of tests/test_rllib.py on the port, with the same
  thresholds and iteration counts; the learner and the runners asked for
  the CPU (their default is the card).
- CartPole's transitions and the replay buffer's samples equal the
  reference's for the same seeds and actions.
- pg_update, ppo_update and dqn_update against the JAX package's on the
  same params, optax state (one reference step in, so the moments are not
  zero) and padded batch: total and value losses and DQN's aux within 1e-6
  relative, the policy loss within 2e-6 of its mean |term| (as
  tests/test_torch_rllib_kernels.py), and the params after the step within
  UPDATE_PARAM_TOL.
- One PG iteration (1 runner x 128 steps) in both packages from one seed:
  the runner's fragment equal up to the first step where the reference's
  top-2 gap of logits + Gumbel noise is under RL_TIE_GAP (logged), and the
  iteration's total_loss within 1e-5 relative.
- The weights and optax's state across packages; the port's checkpoint
  round trip (npz + json); a directory with only the reference's
  algorithm_state.pkl raises, naming it.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.rllib as ref_rllib
from ray_tpu.rllib import policy as ref_pol
from ray_tpu.rllib.env_runner import EnvRunner as RefEnvRunner
from ray_tpu.rllib.learner import Learner as RefLearner
from ray_tpu.rllib.replay_buffer import ReplayBuffer as RefReplayBuffer
import ray_tpu_torch
from ray_tpu_torch.rllib import AlgorithmConfig, CartPole, register_env
from ray_tpu_torch.rllib import policy as pol
from ray_tpu_torch.rllib import rllib_kernels as RK
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from test_torch_runtime import TORCH_CPU

CPU = dict(learner_device="cpu", env_runner_device="cpu")
#: params after one update against the reference's (abs): Adam's first
#: steps move each entry by about lr, so a gradient entry near zero, where
#: float32 sums in two orders differ most in relative terms, moves most
UPDATE_PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The learner's ops are small: with torch's default intra-op threads
    on a loaded machine (the suite under xdist) their OpenMP threads spin
    against each other, and test_dqn_learns_cartpole took 326 s instead of
    5. One thread for this module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def local_rt():
    ray_tpu_torch.init(num_cpus=4, _system_config=TORCH_CPU)
    yield
    ray_tpu_torch.shutdown()


# ------------------------------------------- tests/test_rllib.py's 8 cases


def test_cartpole_physics():
    env = CartPole(seed=0)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (4,)
    total = 0.0
    for _ in range(10):
        obs, r, term, trunc, _ = env.step(1)
        total += r
        if term or trunc:
            break
    assert total >= 1.0
    # constant force topples the pole eventually
    env.reset(seed=0)
    done = False
    for _ in range(500):
        _, _, term, trunc, _ = env.step(1)
        if term:
            done = True
            break
    assert done


def test_register_custom_env():
    class Trivial:
        observation_size = 2
        num_actions = 2

        def __init__(self):
            self.t = 0

        def reset(self, seed=None):
            self.t = 0
            return np.zeros(2, np.float32), {}

        def step(self, a):
            self.t += 1
            return np.zeros(2, np.float32), 1.0, False, self.t >= 5, {}

    register_env("Trivial-v0", Trivial)
    env = make_env("Trivial-v0")
    env.reset()
    steps = 0
    while True:
        _, _, term, trunc, _ = env.step(0)
        steps += 1
        if term or trunc:
            break
    assert steps == 5


def test_algorithm_iterates_and_reports(local_rt):
    algo = (
        AlgorithmConfig()
        .environment("CartPole-v1")
        .env_runners(2, rollout_fragment_length=128)
        .training(train_batch_size=256)
        .resources(**CPU)
        .build()
    )
    try:
        r = algo.train()
        assert r["training_iteration"] == 1
        assert r["num_env_steps_sampled"] == 256  # 2 runners x 128
        assert "total_loss" in r
        r2 = algo.train()
        assert r2["training_iteration"] == 2
    finally:
        algo.stop()


def test_pg_learns_cartpole(local_rt):
    """Learning smoke: mean episode reward must clearly improve over
    training (reference: tuned_examples CartPole runs)."""
    algo = (
        AlgorithmConfig()
        .environment("CartPole-v1")
        .env_runners(2, rollout_fragment_length=512)
        .training(lr=5e-3, train_batch_size=1024)
        .resources(**CPU)
        .build()
    )
    try:
        first = None
        best = -np.inf
        for i in range(25):
            r = algo.train()
            m = r["episode_reward_mean"]
            if first is None and not np.isnan(m):
                first = m
            if not np.isnan(m):
                best = max(best, m)
            if best > 120:
                break
        assert first is not None
        assert best > max(60.0, first * 1.5), (first, best)
    finally:
        algo.stop()


def test_ppo_update_runs(local_rt):
    algo = (
        AlgorithmConfig(algo="ppo")
        .environment("CartPole-v1")
        .env_runners(1, rollout_fragment_length=128)
        .training(train_batch_size=128)
        .resources(**CPU)
        .build()
    )
    try:
        r = algo.train()
        assert np.isfinite(r["total_loss"])
    finally:
        algo.stop()


def test_checkpoint_roundtrip(local_rt, tmp_path):
    cfg = (
        AlgorithmConfig()
        .environment("CartPole-v1")
        .env_runners(1, rollout_fragment_length=64)
        .training(train_batch_size=64)
        .resources(**CPU)
    )
    algo = cfg.build()
    try:
        algo.train()
        algo.save(str(tmp_path))
        w1 = algo.get_weights()
        it = algo.iteration
    finally:
        algo.stop()

    algo2 = cfg.build()
    try:
        algo2.restore(str(tmp_path))
        assert algo2.iteration == it
        w2 = algo2.get_weights()
        for k in w1:
            np.testing.assert_array_equal(
                np.asarray(w1[k]), np.asarray(w2[k])
            )
    finally:
        algo2.stop()


def test_dqn_learns_cartpole(local_rt):
    """Off-policy training curve (reference: rllib/algorithms/dqn/ tuned
    CartPole): epsilon-greedy collection into a replay-buffer ACTOR,
    uniform replay sampling, target-network Q-learning. Mean episode
    reward must clearly improve, and the replay actor must have seen
    sustained add/sample traffic through the object store."""
    algo = (
        AlgorithmConfig(
            algo="dqn",
            rollout_fragment_length=256,
            train_batch_size=128,
            num_updates_per_iter=64,
            lr=1e-3,
            learning_starts=1_000,
            target_sync_every=100,
            epsilon_decay_steps=4_000,
            **CPU,
        )
        .environment("CartPole-v1")
        .env_runners(2, rollout_fragment_length=256)
        .build()
    )
    try:
        first = None
        best = -np.inf
        for i in range(60):
            r = algo.train()
            m = r["episode_reward_mean"]
            if first is None and not np.isnan(m):
                first = m
            if not np.isnan(m):
                best = max(best, m)
            if best > 130:
                break
        assert first is not None
        assert best > max(100.0, first * 1.5), (first, best)
        stats = ray_tpu_torch.get(algo.replay.stats.remote())
        assert stats["added"] >= algo.config.learning_starts
        assert stats["size"] > 0
        assert r["num_updates"] >= 32  # learner actually trained
    finally:
        algo.stop()


def test_replay_buffer_ring_and_sampling(local_rt):
    """Unit: ring wrap-around keeps the newest `capacity` transitions;
    samples draw only from real data."""
    rb = ReplayBuffer(capacity=10, seed=0)
    mk = lambda lo, n: {
        "obs": np.arange(lo, lo + n, dtype=np.float32)[:, None],
        "actions": np.zeros(n, np.int32),
    }
    rb.add_batch(mk(0, 8))
    assert rb.size() == 8
    rb.add_batch(mk(8, 6))  # wraps: ring now holds 4..13
    assert rb.size() == 10
    vals = set()
    for _ in range(50):
        s = rb.sample(10)
        vals.update(int(v) for v in s["obs"].ravel())
    assert vals <= set(range(4, 14))
    assert max(vals) == 13


# ---------------------------------------------- against the JAX package


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_cartpole_transitions_equal_reference(seed):
    ref, port = ref_rllib.CartPole(seed=seed), CartPole(seed=seed)
    o1, _ = ref.reset(seed=seed)
    o2, _ = port.reset(seed=seed)
    actions = np.random.default_rng(seed).integers(0, 2, 600)
    for a in actions:
        np.testing.assert_array_equal(o1, o2)
        s1, s2 = ref.step(int(a)), port.step(int(a))
        o1, o2 = s1[0], s2[0]
        assert s1[1:4] == s2[1:4]
        if s1[2] or s1[3]:
            o1, _ = ref.reset()
            o2, _ = port.reset()


def test_replay_buffer_samples_equal_reference():
    ref, port = RefReplayBuffer(capacity=100, seed=3), ReplayBuffer(capacity=100, seed=3)
    rng = np.random.default_rng(0)
    for n in (40, 50, 30):
        b = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32)}
        assert ref.add_batch(b) == port.add_batch(b)
        s1, s2 = ref.sample(32), port.sample(32)
        for k in s1:
            np.testing.assert_array_equal(s1[k], s2[k])
    assert ref.stats() == port.stats()


def test_init_params_and_optax_state_cross_packages():
    ref = ref_pol.init_params(np.random.default_rng(4), 4, 2, 64)
    net = pol.init_params(np.random.default_rng(4), 4, 2, 64, device="cpu")
    got = pol.params_to_numpy(net)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    back = pol.params_to_numpy(pol.params_from_numpy(got, "cpu"))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])
    tx = ref_pol.make_optimizer(3e-3)
    state = tx.init(ref)
    batch = _padded(_fragment_batch(5, 2, 256), 256)
    _, state, _ = ref_pol.pg_update(ref, state, _jax_batch(batch), tx)
    port_state = pol.opt_state_from_optax(jax.tree.map(np.asarray, state), "cpu")
    out = pol.opt_state_to_numpy(port_state)
    adam = state[0]
    assert out["count"] == int(adam.count) == 1
    for k in ref:
        np.testing.assert_array_equal(out["mu"][k], np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(out["nu"][k], np.asarray(adam.nu[k]))


def _fragment_batch(seed, A, n):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(0, 0.5, (n, 4)).astype(np.float32),
            "actions": rng.integers(0, A, n).astype(np.int32),
            "returns": rng.uniform(0, 40, n).astype(np.float32),
            "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32)}


def _padded(batch, size):
    n = len(batch["obs"])
    out = {k: np.concatenate([v, np.zeros((size - n,) + v.shape[1:], v.dtype)])
           for k, v in batch.items()}
    out["mask"] = (np.arange(size) < n).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


def _start_both(seed, A, lr, batch, update):
    """The reference's params and optax state after one reference step on
    `batch`, and the port's copies of them."""
    params = ref_pol.init_params(np.random.default_rng(seed), 4, A, 64)
    tx = ref_pol.make_optimizer(lr)
    state = tx.init(params)
    params, state, _ = update(params, state, _jax_batch(batch), tx)
    net = pol.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    port_state = pol.opt_state_from_optax(jax.tree.map(np.asarray, state), "cpu")
    return params, state, tx, net, port_state, pol.make_optimizer(lr)


def _params_close(net, params):
    got = pol.params_to_numpy(net)
    worst = max(float(np.abs(got[k] - np.asarray(params[k])).max()) for k in got)
    assert worst <= UPDATE_PARAM_TOL, worst
    return worst


@pytest.mark.parametrize("algo", ["pg", "ppo"])
@pytest.mark.parametrize("A,n,size", [(2, 2048, 2048), (2, 1000, 1024), (7, 300, 512)])
def test_pg_and_ppo_update_equal_reference(algo, A, n, size):
    ref_fn = ref_pol.ppo_update if algo == "ppo" else ref_pol.pg_update
    port_fn = pol.ppo_update if algo == "ppo" else pol.pg_update
    batch = _padded(_fragment_batch(n + A, A, n), size)
    params, state, tx, net, port_state, opt = _start_both(A, A, 3e-3, batch, ref_fn)
    batch2 = _padded(_fragment_batch(n + A + 1, A, n), size)
    params, state, want = ref_fn(params, state, _jax_batch(batch2), tx)
    net, port_state, got = port_fn(net, port_state, {k: torch.from_numpy(v)
                                                     for k, v in batch2.items()}, opt)
    for k in ("total_loss", "vf_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    # the policy loss is a mean of terms of both signs (see the kernels' test)
    scale = abs(float(want["total_loss"])) + abs(float(want["pg_loss"]))
    assert abs(float(got["pg_loss"]) - float(want["pg_loss"])) <= 2e-6 * scale
    print(f"{algo} A={A} n={n}: worst param error {_params_close(net, params):.3e}")


@pytest.mark.parametrize("A", [2, 7])
def test_dqn_update_equal_reference(A):
    rng = np.random.default_rng(A)
    B = 128

    def batch_of(r):
        return {"obs": r.normal(0, 0.5, (B, 4)).astype(np.float32),
                "actions": r.integers(0, A, B).astype(np.int32),
                "rewards": np.ones(B, np.float32),
                "next_obs": r.normal(0, 0.5, (B, 4)).astype(np.float32),
                "dones": (r.random(B) < 0.1).astype(np.float32)}

    params = ref_pol.init_params(np.random.default_rng(A), 4, A, 64)
    target = ref_pol.init_params(np.random.default_rng(A + 1), 4, A, 64)
    tx = ref_pol.make_optimizer(1e-3)
    state = tx.init(params)
    params, state, _ = ref_pol.dqn_update(params, target, state, _jax_batch(batch_of(rng)), tx)
    net = pol.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tnet = pol.params_from_numpy(jax.tree.map(np.asarray, target), "cpu")
    port_state = pol.opt_state_from_optax(jax.tree.map(np.asarray, state), "cpu")
    b = batch_of(rng)
    params, state, want = ref_pol.dqn_update(params, target, state, _jax_batch(b), tx)
    net, port_state, got = pol.dqn_update(net, tnet, port_state, b, pol.make_optimizer(1e-3))
    for k in ("total_loss", "td_error_abs", "q_mean"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    print(f"dqn A={A}: worst param error {_params_close(net, params):.3e}")


def _reference_gaps(params, obs, seed, steps):
    """The reference runner's top-2 gap of logits + Gumbel noise at each
    step of a fragment (env_runner.py :45-54), on its own observations."""
    key = jax.random.PRNGKey(seed)
    gaps = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        logits = np.asarray(ref_pol.action_logits(params, obs[i:i + 1]))
        s = np.sort(np.asarray(jax.random.gumbel(sub, logits.shape)) + logits, axis=-1)
        gaps.append(float(s[0, -1] - s[0, -2]))
    return np.array(gaps)


def test_one_pg_iteration_equals_reference():
    """1 runner x 128 steps from seed 0: the fragment equal to the
    reference's up to the first near-tie, then one update; its total_loss
    within 1e-5 relative. Also through Algorithm.train() in each package's
    local runtime."""
    params = ref_pol.init_params(np.random.default_rng(0), 4, 2, 64)
    weights = jax.tree.map(np.asarray, params)
    ref_frag = RefEnvRunner("CartPole-v1", seed=0, rollout_fragment_length=128).sample(params)
    frag = EnvRunner("CartPole-v1", seed=0, rollout_fragment_length=128,
                     device="cpu").sample(weights)
    gaps = _reference_gaps(params, ref_frag["obs"], (0 * 1_000_003 + 1) % 2**31, 128)
    near = np.flatnonzero(gaps < RK.RL_TIE_GAP)
    upto = int(near[0]) if len(near) else 128
    print(f"fragment compared over {upto} of 128 steps (first near-tie: "
          f"{'none' if upto == 128 else upto})")
    assert upto >= 64
    for k in ("obs", "actions", "rewards"):
        np.testing.assert_array_equal(frag[k][:upto], ref_frag[k][:upto])
    np.testing.assert_allclose(frag["logp_old"][:upto], ref_frag["logp_old"][:upto],
                               rtol=0, atol=1e-6)
    if upto == 128:
        np.testing.assert_array_equal(frag["returns"], ref_frag["returns"])
        ref_stats = RefLearner(4, 2, train_batch_size=128).update(ref_frag)
        stats = Learner(4, 2, train_batch_size=128, device="cpu").update(frag)
        np.testing.assert_allclose(stats["total_loss"], ref_stats["total_loss"], rtol=1e-5)

    results = {}
    for which, rt, cfg_cls in (("ref", ray_tpu, ref_rllib.AlgorithmConfig),
                               ("port", ray_tpu_torch, AlgorithmConfig)):
        if which == "ref":
            rt.init(num_cpus=4)
            cfg = cfg_cls()
        else:
            rt.init(num_cpus=4, _system_config=TORCH_CPU)
            cfg = cfg_cls(**CPU)
        try:
            algo = cfg.environment("CartPole-v1").env_runners(1, 128).training(
                train_batch_size=128).build()
            try:
                results[which] = algo.train()
            finally:
                algo.stop()
        finally:
            rt.shutdown()
    ref_r, r = results["ref"], results["port"]
    if upto == 128:
        np.testing.assert_allclose(r["total_loss"], ref_r["total_loss"], rtol=1e-5)
        for k in ("episodes_this_iter", "num_env_steps_sampled"):
            assert r[k] == ref_r[k]


def test_port_checkpoint_roundtrip_keeps_adam_and_dqn_state(local_rt, tmp_path):
    cfg = AlgorithmConfig(algo="dqn", train_batch_size=32, num_updates_per_iter=4,
                          learning_starts=64, target_sync_every=3,
                          **CPU).env_runners(1, 64)
    algo = cfg.build()
    try:
        for _ in range(2):
            algo.train()
        algo.save(str(tmp_path))
        learner = algo.learner_group.learner
        want_opt = pol.opt_state_to_numpy(learner.opt_state)
        want_target = pol.params_to_numpy(learner.target_params)
        want = (algo.iteration, algo._env_steps, learner._updates)
    finally:
        algo.stop()
    assert sorted(os.listdir(tmp_path)) == ["algorithm_state.json", "algorithm_state.npz"]
    algo2 = cfg.build()
    try:
        algo2.restore(str(tmp_path))
        learner = algo2.learner_group.learner
        assert (algo2.iteration, algo2._env_steps, learner._updates) == want
        got_opt = pol.opt_state_to_numpy(learner.opt_state)
        assert got_opt["count"] == want_opt["count"] == 8
        for part in ("mu", "nu"):
            for k, v in want_opt[part].items():
                np.testing.assert_array_equal(got_opt[part][k], v)
        for k, v in pol.params_to_numpy(learner.target_params).items():
            np.testing.assert_array_equal(v, want_target[k])
    finally:
        algo2.stop()


def test_restore_of_a_reference_checkpoint_raises_naming_it(local_rt, tmp_path):
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=2)
    try:
        ref = ref_rllib.AlgorithmConfig().env_runners(1, 32).training(
            train_batch_size=32).build()
        try:
            ref.save(str(tmp_path))
        finally:
            ref.stop()
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, _system_config=TORCH_CPU)
    algo = AlgorithmConfig(**CPU).env_runners(1, 32).training(train_batch_size=32).build()
    try:
        with pytest.raises(ValueError, match="algorithm_state.pkl"):
            algo.restore(str(tmp_path))
    finally:
        algo.stop()


def test_devices_default_to_the_card():
    """Nothing carries on on the CPU when no card is there: the learner's and
    the runner's default device is CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Learner(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        EnvRunner("CartPole-v1")
