"""Tuner: the Tune entry point.

Reference: python/ray/tune/tuner.py (Tuner, Tuner.restore) +
tune/tune_config.py (TuneConfig) + tune/result_grid.py (ResultGrid).
"""

from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.controller import TuneController
from ray_tpu_torch.tune.search_space import resolve_variants
from ray_tpu_torch.tune.trial import ERROR, PENDING, RUNNING, TERMINATED, Trial


@dataclass
class TuneConfig:
    """Reference: python/ray/tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    scheduler: Any = None
    search_seed: Optional[int] = None
    time_budget_s: Optional[float] = None
    resources_per_trial: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


class ResultGrid:
    """Reference: python/ray/tune/result_grid.py."""

    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        return iter(self._results())

    def __getitem__(self, i):
        return self._results()[i]

    def _results(self) -> List[Result]:
        out = []
        for t in self._trials:
            ckpt = (
                Checkpoint.from_directory(t.checkpoint_path)
                if t.checkpoint_path and os.path.isdir(t.checkpoint_path)
                else None
            )
            err = RuntimeError(t.error) if t.error else None
            out.append(Result(
                metrics=dict(t.last_result, config=t.config),
                checkpoint=ckpt, path=t.dir, error=err,
                metrics_history=list(t.results),
            ))
        return out

    @property
    def errors(self):
        return [r.error for r in self._results() if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (not set in TuneConfig)")
        scored = [
            r for r in self._results()
            if r.error is None and metric in r.metrics
        ]
        if not scored:
            raise RuntimeError("no successful trial reported the metric")
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self._results()])


class Tuner:
    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restored_trials: Optional[List[Trial]] = None,
        _experiment_dir: Optional[str] = None,
    ):
        # trainer objects (DataParallelTrainer) expose as_trainable()
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_trials = _restored_trials
        self._experiment_dir = _experiment_dir

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        if self._restored_trials is not None:
            exp_dir = self._experiment_dir
            trials = self._restored_trials
        else:
            name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
            exp_dir = os.path.join(self.run_config.resolved_storage_path(), name)
            os.makedirs(exp_dir, exist_ok=True)
            variants = resolve_variants(
                self.param_space, tc.num_samples, seed=tc.search_seed
            )
            trials = [
                Trial(f"{i:05d}", cfg, exp_dir) for i, cfg in enumerate(variants)
            ]
            with open(os.path.join(exp_dir, "experiment_state.json"), "w") as f:
                json.dump({
                    "num_trials": len(trials),
                    "metric": tc.metric,
                    "mode": tc.mode,
                    "stop": self.run_config.stop,
                }, f)
        trainable = self.trainable

        # Uniform wrapper: plain function trainables report through the
        # session themselves; trainer-factory trainables (Trainer.as_trainable)
        # run a nested trainer and forward its terminal metrics/checkpoint to
        # the trial session (reference: trainers run as Tune trainables).
        def run_trial(config, _t=trainable):
            out = _t(config)
            if hasattr(out, "fit"):
                res = out.fit()
                if res.error is not None:
                    raise res.error
                from ray_tpu_torch.train.session import report as _report

                _report(res.metrics, checkpoint=res.checkpoint)
                return res.metrics
            return out

        controller = TuneController(
            run_trial,
            trials,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=tc.max_concurrent_trials,
            resources_per_trial=tc.resources_per_trial,
            stop=getattr(self.run_config, "stop", None),
            time_budget_s=tc.time_budget_s,
        )
        controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results, unfinished ones restart from their latest checkpoints
        (reference: Tuner.restore). Stop criteria persist with the
        experiment; pass run_config to override."""
        path = os.path.abspath(os.path.expanduser(path))
        state_f = os.path.join(path, "experiment_state.json")
        meta = {}
        if os.path.exists(state_f):
            with open(state_f) as f:
                meta = json.load(f)
        trials = []
        for d in sorted(os.listdir(path)):
            tdir = os.path.join(path, d)
            if not os.path.isdir(tdir):
                continue
            t = Trial.load_state(tdir, path)
            if t is None:
                continue
            if t.status in (RUNNING, PENDING, ERROR):
                t.status = PENDING  # re-run from its checkpoint
                t.error = None
            trials.append(t)
        tc = tune_config or TuneConfig(
            metric=meta.get("metric"), mode=meta.get("mode", "max")
        )
        if run_config is None:
            run_config = RunConfig(stop=meta.get("stop"))
        return cls(
            trainable,
            tune_config=tc,
            run_config=run_config,
            _restored_trials=trials,
            _experiment_dir=path,
        )


def run(trainable, *, param_space=None, tune_config=None, run_config=None):
    """Convenience one-shot (reference: tune.run)."""
    return Tuner(
        trainable,
        param_space=param_space,
        tune_config=tune_config,
        run_config=run_config,
    ).fit()
