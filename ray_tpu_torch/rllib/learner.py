"""Learner + LearnerGroup: the train-math side of the RL stack.

Reference: rllib/core/learner/learner.py (per-learner update step) and
learner_group.py (the coordination wrapper Train/RLlib share). One Learner
holds the policy on its device (the card unless the caller asks for the
CPU) and runs one update a batch over static padded batch shapes: on the
card each update is one kernel launch, K12 for PG/PPO (the sampled batch
written into pinned memory with its padding and mask, one copy across) and
K13 for DQN; on the CPU their plain versions.
Weights leave the learner as dicts of numpy arrays, so runners on any
device load them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class Learner:
    def __init__(self, obs_size: int, num_actions: int, lr: float = 3e-3,
                 algo: str = "pg", hidden: int = 64,
                 train_batch_size: int = 2048, seed: int = 0,
                 device: Optional[str] = None):
        from ray_tpu_torch.rllib import policy as pol

        self.algo = algo
        self.train_batch_size = train_batch_size
        self.params = pol.init_params(
            np.random.default_rng(seed), obs_size, num_actions, hidden, device=device
        )
        self.device = self.params.device
        if self.device.type == "cuda":  # K12's widths, checked before the first update
            from ray_tpu_torch.rllib.rllib_kernels import pg_plan

            pg_plan(train_batch_size, obs_size, hidden, num_actions)
        self.optimizer = pol.make_optimizer(lr)
        self.opt_state = self.optimizer.init(self.params)
        self._updates = 0
        self._truncation_warned = False

    def get_weights(self) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.rllib import policy as pol

        return pol.params_to_numpy(self.params)

    def set_weights(self, params) -> None:
        from ray_tpu_torch.rllib import policy as pol

        pol.load_params(self.params, params)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        from ray_tpu_torch.rllib import policy as pol

        n_in = len(batch["obs"])
        trained = min(n_in, self.train_batch_size)
        if n_in > self.train_batch_size and not self._truncation_warned:
            self._truncation_warned = True
            print(
                f"[ray_tpu_torch.rllib] sampled batch ({n_in}) exceeds "
                f"train_batch_size ({self.train_batch_size}); the excess is "
                "dropped every iteration — lower runner count/fragment "
                "length or raise train_batch_size",
                flush=True,
            )
        # padded to the static train_batch_size so every update has one
        # shape (masked math ignores the padding); the excess is cut
        fn = pol.ppo_update if self.algo == "ppo" else pol.pg_update
        self.params, self.opt_state, stats = fn(
            self.params, self.opt_state, batch, self.optimizer,
            rows=self.train_batch_size,
        )
        self._updates += 1
        return {k: float(v) for k, v in stats.items()} | {
            "num_updates": self._updates,
            "num_env_steps_trained": trained,
        }


class LearnerGroup:
    """Owns the learner(s). v1 runs ONE learner in-process, as the
    reference does (its data-parallel scaling lives inside the jitted
    update); the group API matches the reference so that seam is ready."""

    def __init__(self, learner: Optional[Any] = None, **learner_kwargs):
        # a prebuilt learner (e.g. DQNLearner) keeps the group the single
        # construction seam for every algorithm family
        self.learner = learner if learner is not None else Learner(
            **learner_kwargs
        )

    def update(self, batch) -> Dict[str, float]:
        return self.learner.update(batch)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)


class DQNLearner:
    """Off-policy Q-learning with a frozen target network (reference:
    rllib/algorithms/dqn/ — the learner half; replay lives in its own
    actor, replay_buffer.py). Replay batches are a fixed size."""

    def __init__(self, obs_size: int, num_actions: int, lr: float = 1e-3,
                 hidden: int = 64, gamma: float = 0.99,
                 target_sync_every: int = 250, seed: int = 0,
                 device: Optional[str] = None):
        from ray_tpu_torch.rllib import policy as pol

        self.gamma = gamma
        self.target_sync_every = target_sync_every
        self.params = pol.init_params(
            np.random.default_rng(seed), obs_size, num_actions, hidden, device=device
        )
        self.device = self.params.device
        if self.device.type == "cuda":  # K13's widths, checked before the first update
            from ray_tpu_torch.rllib.rllib_kernels import dqn_tile_rows

            dqn_tile_rows(1, obs_size, hidden, num_actions)
        self.target_params = pol.params_from_numpy(pol.params_to_numpy(self.params),
                                                   self.device)
        self.optimizer = pol.make_optimizer(lr)
        self.opt_state = self.optimizer.init(self.params)
        self._updates = 0

    def get_weights(self) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.rllib import policy as pol

        return pol.params_to_numpy(self.params)

    def set_weights(self, params) -> None:
        from ray_tpu_torch.rllib import policy as pol

        pol.load_params(self.params, params)
        pol.load_params(self.target_params, params)

    def sync_target(self) -> None:
        with torch.no_grad():
            for t, p in zip(self.target_params.parameters(), self.params.parameters()):
                t.copy_(p)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        from ray_tpu_torch.rllib import policy as pol

        self.params, self.opt_state, stats = pol.dqn_update(
            self.params, self.target_params, self.opt_state, batch,
            self.optimizer, self.gamma,
        )
        self._updates += 1
        if self._updates % self.target_sync_every == 0:
            self.sync_target()
        return {k: float(v) for k, v in stats.items()} | {
            "num_updates": self._updates,
        }
