"""Algorithm: the RLlib-style outer loop over EnvRunner actors + a
LearnerGroup.

Reference: rllib/algorithms/algorithm.py (Algorithm.train iterating
sample -> learn), algorithm_config.py (builder-style config), and
env_runner_group.py (the remote sampling fleet). Orchestration rides this
framework's own actor layer; the learning math is torch ops and the RL
kernels (learner.py, policy.py).

Devices: the learner and the runners each run on the card unless the
config asks for another device (``learner_device``, ``env_runner_device``;
``AlgorithmConfig.resources``). Checkpoints are the port's own format:
``algorithm_state.npz`` (the weights, Adam's moments, DQN's target
weights) and ``algorithm_state.json`` (the iteration, Adam's count, the
DQN counters, the config's fields); the reference's pickled
``algorithm_state.pkl`` holds optax objects and is not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

STATE_NPZ = "algorithm_state.npz"
STATE_JSON = "algorithm_state.json"
#: the reference's pickle, which holds optax state the port cannot read
REFERENCE_STATE = "algorithm_state.pkl"


@dataclass
class AlgorithmConfig:
    env: Any = "CartPole-v1"
    algo: str = "pg"  # "pg" (REINFORCE+baseline) | "ppo" (clip) | "dqn"
    num_env_runners: int = 2
    rollout_fragment_length: int = 512
    train_batch_size: int = 2048
    lr: float = 3e-3
    gamma: float = 0.99
    hidden: int = 64
    seed: int = 0
    num_updates_per_iter: int = 1
    # dqn only (reference: rllib/algorithms/dqn/dqn.py config surface)
    replay_capacity: int = 50_000
    learning_starts: int = 1_000  # env steps before the first update
    target_sync_every: int = 250  # updates between target-network syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 7_000
    # where the learner and the runners compute; None is the card
    learner_device: Optional[str] = None
    env_runner_device: Optional[str] = None

    # builder-style helpers (reference: AlgorithmConfig chaining)
    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, lr: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 gamma: Optional[float] = None) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if gamma is not None:
            self.gamma = gamma
        return self

    def resources(self, learner_device: Optional[str] = None,
                  env_runner_device: Optional[str] = None) -> "AlgorithmConfig":
        """The learner's and the runners' devices ("cuda", "cpu", ...)."""
        if learner_device is not None:
            self.learner_device = learner_device
        if env_runner_device is not None:
            self.env_runner_device = env_runner_device
        return self

    def build(self) -> "Algorithm":
        return Algorithm(self)


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        import ray_tpu_torch
        from ray_tpu_torch.rllib.env import make_env
        from ray_tpu_torch.rllib.env_runner import EnvRunner
        from ray_tpu_torch.rllib.learner import LearnerGroup

        self.config = config
        probe = make_env(config.env, seed=config.seed)
        self.replay = None
        if config.algo == "dqn":
            from ray_tpu_torch.rllib.learner import DQNLearner
            from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer

            self.learner_group = LearnerGroup(learner=DQNLearner(
                obs_size=probe.observation_size,
                num_actions=probe.num_actions,
                lr=config.lr,
                hidden=config.hidden,
                gamma=config.gamma,
                target_sync_every=config.target_sync_every,
                seed=config.seed,
                device=config.learner_device,
            ))
            self.replay = ray_tpu_torch.remote(ReplayBuffer).remote(
                config.replay_capacity, config.seed
            )
            self._env_steps = 0
        else:
            self.learner_group = LearnerGroup(
                obs_size=probe.observation_size,
                num_actions=probe.num_actions,
                lr=config.lr,
                algo=config.algo,
                hidden=config.hidden,
                train_batch_size=config.train_batch_size,
                seed=config.seed,
                device=config.learner_device,
            )
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self.env_runners = [
            runner_cls.remote(
                config.env,
                seed=config.seed * 10_000 + i,
                rollout_fragment_length=config.rollout_fragment_length,
                gamma=config.gamma,
                device=config.env_runner_device,
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        """One iteration: broadcast weights -> parallel sample -> learn."""
        import ray_tpu_torch

        if self.config.algo == "dqn":
            return self._train_dqn()
        t0 = time.time()
        weights = self.learner_group.get_weights()
        batches = ray_tpu_torch.get(
            [r.sample.remote(weights) for r in self.env_runners],
            timeout=600,
        )
        t_sampled = time.time()
        batch = {
            k: np.concatenate([b[k] for b in batches])
            for k in ("obs", "actions", "returns", "logp_old")
        }
        stats: Dict[str, float] = {}
        for _ in range(self.config.num_updates_per_iter):
            stats = self.learner_group.update(batch)
        self.iteration += 1
        ep_means = [
            float(b["episode_reward_mean"]) for b in batches
            if not np.isnan(b["episode_reward_mean"])
        ]
        t1 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (
                float(np.mean(ep_means)) if ep_means else float("nan")
            ),
            "episodes_this_iter": int(
                sum(int(b["episodes_done"]) for b in batches)
            ),
            "num_env_steps_sampled": len(batch["obs"]),
            "time_this_iter_s": round(t1 - t0, 3),
            "sample_time_s": t_sampled - t0,
            "update_time_s": t1 - t_sampled,
            **stats,
        }

    def _train_dqn(self) -> Dict[str, Any]:
        """One off-policy iteration (reference: dqn.py training_step):
        epsilon-greedy sample -> push transitions to the replay actor ->
        gradient updates on uniform replay samples -> periodic target
        sync (inside the learner)."""
        import ray_tpu_torch

        cfg = self.config
        t0 = time.time()
        frac = min(1.0, self._env_steps / max(cfg.epsilon_decay_steps, 1))
        eps = cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)
        weights = self.learner_group.get_weights()
        batches = ray_tpu_torch.get(
            [r.sample_transitions.remote(weights, eps)
             for r in self.env_runners],
            timeout=600,
        )
        t_sampled = time.time()
        sampled = sum(len(b["obs"]) for b in batches)
        self._env_steps += sampled
        size = 0
        for b in batches:
            size = ray_tpu_torch.get(self.replay.add_batch.remote({
                k: b[k]
                for k in ("obs", "actions", "rewards", "next_obs", "dones")
            }))
        stats: Dict[str, float] = {}
        if size >= cfg.learning_starts:
            # pipeline: request the next replay sample while the learner
            # chews on the current one (no trailing prefetch — the last
            # update consumes the last request)
            nxt = self.replay.sample.remote(cfg.train_batch_size)
            for u in range(cfg.num_updates_per_iter):
                batch = ray_tpu_torch.get(nxt)
                if u + 1 < cfg.num_updates_per_iter:
                    nxt = self.replay.sample.remote(cfg.train_batch_size)
                stats = self.learner_group.update(batch)
        self.iteration += 1
        ep_means = [
            float(b["episode_reward_mean"]) for b in batches
            if not np.isnan(b["episode_reward_mean"])
        ]
        t1 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (
                float(np.mean(ep_means)) if ep_means else float("nan")
            ),
            "num_env_steps_sampled": self._env_steps,
            "replay_buffer_size": int(size),
            "epsilon": round(eps, 4),
            "time_this_iter_s": round(t1 - t0, 3),
            "sample_time_s": t_sampled - t0,
            "update_time_s": t1 - t_sampled,
            **stats,
        }

    # ----------------------------------------------------- checkpointing

    def save(self, checkpoint_dir: str) -> str:
        from ray_tpu_torch.rllib import policy as pol

        os.makedirs(checkpoint_dir, exist_ok=True)
        learner = self.learner_group.learner
        opt = pol.opt_state_to_numpy(learner.opt_state)
        arrays = {f"weights/{k}": v for k, v in self.learner_group.get_weights().items()}
        arrays.update({f"mu/{k}": v for k, v in opt["mu"].items()})
        arrays.update({f"nu/{k}": v for k, v in opt["nu"].items()})
        meta = {
            "iteration": self.iteration,
            "opt_count": opt["count"],
            "config": {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                           else repr(v))
                       for k, v in dataclasses.asdict(self.config).items()},
        }
        if self.config.algo == "dqn":
            # off-policy extras: without these a restore resets epsilon to
            # its start value and loses the target-sync phase
            meta["env_steps"] = self._env_steps
            meta["updates"] = learner._updates
            arrays.update({f"target/{k}": v
                           for k, v in pol.params_to_numpy(learner.target_params).items()})
        np.savez(os.path.join(checkpoint_dir, STATE_NPZ), **arrays)
        with open(os.path.join(checkpoint_dir, STATE_JSON), "w") as f:
            json.dump(meta, f, indent=1)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        from ray_tpu_torch.parallel.tpu_train import AdamWState
        from ray_tpu_torch.rllib import policy as pol

        npz = os.path.join(checkpoint_dir, STATE_NPZ)
        if not os.path.exists(npz):
            ref = os.path.join(checkpoint_dir, REFERENCE_STATE)
            if os.path.exists(ref):
                raise ValueError(
                    f"{ref} is the JAX package's checkpoint (pickled optax "
                    f"state), which this package cannot read; it reads {STATE_NPZ} "
                    f"and {STATE_JSON}")
            raise FileNotFoundError(f"no {STATE_NPZ} in {checkpoint_dir}")
        with open(os.path.join(checkpoint_dir, STATE_JSON)) as f:
            meta = json.load(f)
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        learner = self.learner_group.learner

        def group(prefix):
            return {k.split("/", 1)[1]: v for k, v in arrays.items()
                    if k.startswith(prefix + "/")}

        learner.set_weights(group("weights"))
        dev = learner.device

        def tensors(tree):
            import torch

            return {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}

        learner.opt_state = AdamWState(int(meta["opt_count"]), tensors(group("mu")),
                                       tensors(group("nu")))
        self.iteration = meta["iteration"]
        if self.config.algo == "dqn" and "env_steps" in meta:
            self._env_steps = meta["env_steps"]
            learner._updates = meta["updates"]
            pol.load_params(learner.target_params, group("target"))

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
        if self.replay is not None:
            try:
                ray_tpu_torch.kill(self.replay)
            except Exception:  # noqa: BLE001
                pass
