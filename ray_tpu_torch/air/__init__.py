"""ray_tpu_torch.air — shared config/result/checkpoint types for Train and Tune:
the port of ray_tpu/air/, host code copied with its imports rewritten.

Reference: python/ray/air/ (config.py, result.py) and
python/ray/train/_checkpoint.py.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "Result",
]
