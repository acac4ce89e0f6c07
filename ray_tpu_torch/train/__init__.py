"""ray_tpu_torch.train — distributed training orchestration.

Reference: python/ray/train/ (TorchTrainer, DataParallelTrainer,
train.report/get_context/get_checkpoint, Checkpoint, ScalingConfig/RunConfig).
The port of ray_tpu/train/, with its names. The flagship is JaxTrainer:
worker-group actors, one a rank with one device, each running the port's
train step over a mesh of ranks (the framework orchestrates, the step
function owns the device).
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend_executor import Backend, BackendExecutor
from ray_tpu_torch.train.jax_trainer import JaxBackend, JaxTrainer
from ray_tpu_torch.train.torch_trainer import (
    TorchBackend,
    TorchTrainer,
    prepare_data_loader,
    prepare_model,
)
from ray_tpu_torch.train.jax_utils import (
    load_pytree,
    prepare_data_shard,
    prepare_mesh,
    save_pytree,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    report,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer, TrainingFailedError
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "Backend",
    "BackendExecutor",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "JaxBackend",
    "JaxTrainer",
    "TorchBackend",
    "TorchTrainer",
    "prepare_data_loader",
    "prepare_model",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "TrainingFailedError",
    "WorkerGroup",
    "get_checkpoint",
    "get_context",
    "load_pytree",
    "prepare_data_shard",
    "prepare_mesh",
    "report",
    "save_pytree",
]
