"""DataParallelTrainer: the Train entry point.

Reference: python/ray/train/data_parallel_trainer.py (DataParallelTrainer)
+ python/ray/train/base_trainer.py (BaseTrainer.fit). The reference routes
fit() through a 1-trial Tune run; here fit() drives the BackendExecutor
directly and a tuner reuses this trainer as a trainable — same layering,
inverted dependency (Tune on Train instead of Train on Tune), which is the
cleaner factoring for a fresh build.

Failure handling (reference: FailureConfig.max_failures + Tune trial
restore): on worker-group failure the group is torn down and restarted from
the latest persisted checkpoint, surfaced to workers via
train.get_checkpoint().
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend_executor import Backend, BackendExecutor
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager


class TrainingFailedError(RuntimeError):
    pass


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend: Optional[Backend] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend = backend
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    # ------------------------------------------------------------------- fit
    def fit(self) -> Result:
        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        run_dir = os.path.join(self.run_config.resolved_storage_path(), name)
        os.makedirs(run_dir, exist_ok=True)
        ckpt_mgr = CheckpointManager(run_dir, self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures
        attempts_left = float("inf") if max_failures < 0 else max_failures + 1

        metrics_history: list = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[Exception] = None
        start_ckpt = self.resume_from_checkpoint

        while attempts_left > 0:
            attempts_left -= 1
            executor = BackendExecutor(
                self.scaling_config,
                backend=self.backend,
                experiment_name=name,
                trial_name=name,
                trial_dir=run_dir,
            )
            try:
                executor.start(
                    start_checkpoint=ckpt_mgr.latest or start_ckpt,
                    trial_config=self.train_loop_config,
                )
                futures = executor.run_training(
                    self.train_loop, self.train_loop_config
                )
                pending = list(futures)
                while pending:
                    done, pending = ray_tpu_torch.wait(
                        pending, num_returns=len(pending), timeout=0.25
                    )
                    for round_ in executor.drain_reports():
                        last_metrics = self._process_round(
                            round_, ckpt_mgr, metrics_history
                        )
                    if done:
                        # surface worker exceptions immediately
                        ray_tpu_torch.get(done)
                for round_ in executor.drain_reports():
                    last_metrics = self._process_round(
                        round_, ckpt_mgr, metrics_history
                    )
                error = None
                break
            except Exception as e:  # worker/actor failure
                error = e
                if attempts_left > 0:
                    time.sleep(0.2)  # backoff before group restart
                    continue
            finally:
                executor.shutdown()

        if error is not None and self.run_config.failure_config.fail_fast:
            raise TrainingFailedError(str(error)) from error
        return Result(
            metrics=last_metrics,
            checkpoint=ckpt_mgr.latest,
            path=run_dir,
            error=error,
            metrics_history=metrics_history,
        )

    def _process_round(self, round_, ckpt_mgr: CheckpointManager, history: list):
        rank0 = round_[0]
        metrics = dict(rank0["metrics"])
        metrics["training_iteration"] = rank0["iteration"] + 1
        path = rank0.get("checkpoint_path")
        if path:
            if os.path.isdir(path):  # shared-fs fast path
                ckpt_mgr.register(path, metrics)
            elif rank0.get("checkpoint_ref") is not None:
                import io
                import shutil
                import tarfile
                import tempfile

                data = ray_tpu_torch.get(rank0["checkpoint_ref"])
                tmp = tempfile.mkdtemp(prefix="ray_tpu_ckpt_rx_")
                try:
                    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
                        tar.extractall(tmp, filter="data")
                    ckpt_mgr.register(tmp, metrics)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        history.append(metrics)
        return metrics

    # Tune integration: run as a trainable with per-trial config override.
    def as_trainable(self) -> Callable:
        base = self

        def trainable(config: Dict[str, Any]):
            import copy

            trainer = copy.copy(base)
            merged = dict(base.train_loop_config)
            merged.update(config)
            trainer.train_loop_config = merged
            return trainer

        return trainable
