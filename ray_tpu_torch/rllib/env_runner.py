"""EnvRunner: an actor that owns env instances and samples with the
current policy.

Reference: rllib/env/single_agent_env_runner.py + env_runner_group.py (the
old WorkerSet) — sampling runs on remote actors; the algorithm broadcasts
weights and gathers batches.

The runner infers on its own device (the card unless the caller asks for
the CPU): each environment step is one launch of K11 (the trunk, the
logits, the split of the runner's key and the draw), so the key chain
stays on the device, and one synchronisation, after which the action and
its log-probability lie in the runner's own pinned buffers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class EnvRunner:
    """Plain class; the Algorithm wraps it with @remote so instances become
    actors (sampling then overlaps across runners)."""

    def __init__(self, env_spec: Any, seed: int = 0,
                 rollout_fragment_length: int = 512, gamma: float = 0.99,
                 device: Optional[str] = None):
        from ray_tpu_torch.rllib.env import make_env
        from ray_tpu_torch.util.device import resolve_device

        self.env = make_env(env_spec, seed=seed)
        self.rollout_fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.device = resolve_device(device, what="the env runner")
        self._net = None
        self._buffers = None  # K11's pinned outputs and keys, on the card
        self._seed = seed
        self._episodes = 0
        self._samples = 0  # per-call counter feeding key derivation
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_reward = 0.0
        self._ep_rewards_window: List[float] = []

    def _policy(self, params):
        """The runner's copy of the policy, on its device, set to `params`
        (a dict of numpy arrays)."""
        from ray_tpu_torch.rllib import policy as pol

        if self._net is None:
            self._net = pol.params_from_numpy(params, self.device)
        else:
            pol.load_params(self._net, params)
        return self._net

    def sample(self, params) -> Dict[str, np.ndarray]:
        """Collect one fragment with the given policy weights. Returns flat
        arrays plus reward-to-go returns computed per episode segment."""
        from ray_tpu_torch.rllib import policy as pol, prng

        net = self._policy(params)
        if self.device.type == "cuda" and self._buffers is None:
            from ray_tpu_torch.rllib.rllib_kernels import SampleBuffers

            self._buffers = SampleBuffers(self.device, 1)
        # keyed by a per-call counter: episode count alone stalls once
        # fragments stop containing episode ends (long trained episodes),
        # which would replay an identical action-noise stream every call
        self._samples += 1
        key = prng.PRNGKey(
            (self._seed * 1_000_003 + self._samples) % (2**31), device=self.device
        )
        obs_buf, act_buf, rew_buf, logp_buf = [], [], [], []
        done_idx = []  # fragment indices where an episode ended
        for i in range(self.rollout_fragment_length):
            # K11: the trunk, the reference's split of the key and its
            # draw, one launch and one synchronisation
            a, logp, key = pol.sample_actions(net, self._obs[None, :], key, self._buffers)
            a = int(a[0])
            obs_buf.append(self._obs)
            next_obs, r, term, trunc, _ = self.env.step(a)
            act_buf.append(a)
            rew_buf.append(r)
            logp_buf.append(float(logp[0]))
            self._ep_reward += r
            self._obs = next_obs
            if term or trunc:
                done_idx.append(i)
                self._ep_rewards_window.append(self._ep_reward)
                self._ep_rewards_window = self._ep_rewards_window[-20:]
                self._ep_reward = 0.0
                self._episodes += 1
                self._obs, _ = self.env.reset()

        rewards = np.asarray(rew_buf, np.float32)
        returns = np.zeros_like(rewards)
        running = 0.0
        ends = set(done_idx)
        for i in range(len(rewards) - 1, -1, -1):
            if i in ends:
                running = 0.0
            running = rewards[i] + self.gamma * running
            returns[i] = running
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": rewards,
            "returns": returns,
            "logp_old": np.asarray(logp_buf, np.float32),
            "episodes_done": np.int64(len(done_idx)),
            "episode_reward_mean": np.float32(
                np.mean(self._ep_rewards_window)
                if self._ep_rewards_window else np.nan
            ),
        }

    def sample_transitions(self, params, epsilon: float) -> Dict[str, np.ndarray]:
        """Off-policy collection: epsilon-greedy over Q-values, returning
        raw (s, a, r, s', done) transitions for a replay buffer
        (reference: the DQN family's EnvRunner sampling path)."""
        from ray_tpu_torch.rllib import policy as pol

        net = self._policy(params)
        self._samples += 1
        rng = np.random.default_rng(
            (self._seed * 1_000_003 + self._samples) % (2**31)
        )
        n_act = self.env.num_actions
        obs_buf, act_buf, rew_buf, next_buf, done_buf = [], [], [], [], []
        for _ in range(self.rollout_fragment_length):
            if rng.random() < epsilon:
                a = int(rng.integers(n_act))
            else:
                a = int(pol.q_values(net, self._obs[None, :]).argmax())
            next_obs, r, term, trunc, _ = self.env.step(a)
            obs_buf.append(self._obs)
            act_buf.append(a)
            rew_buf.append(r)
            next_buf.append(next_obs)
            # bootstrap through time-limit truncation: only TERMINAL
            # transitions cut the TD target (reference: dqn handles
            # truncated episodes by bootstrapping)
            done_buf.append(1.0 if term else 0.0)
            self._ep_reward += r
            self._obs = next_obs
            if term or trunc:
                self._ep_rewards_window.append(self._ep_reward)
                self._ep_rewards_window = self._ep_rewards_window[-20:]
                self._ep_reward = 0.0
                self._episodes += 1
                self._obs, _ = self.env.reset()
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "next_obs": np.asarray(next_buf, np.float32),
            "dones": np.asarray(done_buf, np.float32),
            "episode_reward_mean": np.float32(
                np.mean(self._ep_rewards_window)
                if self._ep_rewards_window else np.nan
            ),
            "episodes_done": np.int64(self._episodes),
        }
