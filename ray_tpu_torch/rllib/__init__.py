"""RL stack: EnvRunner actors sample, a torch learner trains, the Algorithm
loop coordinates — the capability-level equivalent of the reference's
RLlib (rllib/algorithms/algorithm.py, env/env_runner_group.py,
core/learner/). The algorithm zoo is deliberately thin (PG, PPO-clip and
DQN on built-in envs); the ORCHESTRATION — remote sampling fleet, weight
broadcast, learner group, checkpoints — is the component the survey
inventories. RLlib's own device programs (the runner's whole step, the whole
PG/PPO update, the whole DQN update) are the CUDA kernels K11-K13, one launch
each (rllib_kernels.py).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import CartPole, make_env, register_env
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "CartPole",
    "EnvRunner",
    "Learner",
    "LearnerGroup",
    "make_env",
    "register_env",
]
