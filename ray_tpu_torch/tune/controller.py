"""TuneController: the experiment event loop.

Reference: python/ray/tune/execution/tune_controller.py — launches trials
onto actors as resources allow, consumes results, applies scheduler
decisions (early stop, PBT exploit), persists experiment state.

Each trial runs the function trainable on a ``_TrainWorker`` actor with a
1-worker report bus — ``tune.report`` IS ``train.report`` (same session
machinery, reference parity: ray.tune and ray.train share the session).
"""

from __future__ import annotations

import io
import os
import shutil
import tarfile
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import make_report_bus
from ray_tpu_torch.train.worker_group import _TrainWorker
from ray_tpu_torch.tune.schedulers import EXPLOIT, STOP, FIFOScheduler
from ray_tpu_torch.tune.trial import ERROR, PENDING, RUNNING, TERMINATED, Trial


class _RunningTrial:
    def __init__(self, trial: Trial, actor, bus, future):
        self.trial = trial
        self.actor = actor
        self.bus = bus
        self.future = future
        self.stopped_by_scheduler = False


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        trials: List[Trial],
        *,
        scheduler=None,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent: int = 0,
        resources_per_trial: Optional[Dict[str, float]] = None,
        stop: Optional[Dict[str, Any]] = None,
        time_budget_s: Optional[float] = None,
        on_result: Optional[Callable[[Trial, dict], None]] = None,
    ):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or FIFOScheduler()
        if getattr(self.scheduler, "metric", None) is None and metric:
            self.scheduler.metric = metric
            self.scheduler.mode = mode
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.stop_criteria = stop or {}
        self.time_budget_s = time_budget_s
        self.on_result = on_result
        self._running: Dict[str, _RunningTrial] = {}
        self._start = time.time()

    # ----------------------------------------------------------- main loop
    def run(self):
        pending = [t for t in self.trials if t.status == PENDING]
        while pending or self._running:
            budget_left = (
                self.time_budget_s is None
                or time.time() - self._start < self.time_budget_s
            )
            while (
                pending
                and budget_left
                and (self.max_concurrent <= 0
                     or len(self._running) < self.max_concurrent)
            ):
                self._launch(pending.pop(0))
            if not self._running:
                if not budget_left:
                    for t in pending:
                        t.status = TERMINATED
                        t.save_state()
                    return
                continue
            self._poll()
            time.sleep(0.02)

    # ------------------------------------------------------------- launch
    def _launch(self, trial: Trial, start_checkpoint: Optional[str] = None):
        opts: Dict[str, Any] = {"name": f"trial_{trial.trial_id}"}
        if "CPU" in self.resources:
            opts["num_cpus"] = self.resources["CPU"]
        if self.resources.get("TPU"):
            opts["num_tpus"] = self.resources["TPU"]
        if self.resources.get("GPU"):
            opts["num_gpus"] = self.resources["GPU"]
        extra = {k: v for k, v in self.resources.items() if k not in ("CPU", "GPU", "TPU")}
        if extra:
            opts["resources"] = extra
        actor = _TrainWorker.options(**opts).remote()
        bus = make_report_bus(1)
        ctx = dict(
            world_size=1, world_rank=0, local_rank=0, node_rank=0,
            experiment_name=os.path.basename(os.path.dirname(trial.dir)),
            trial_name=trial.trial_id, trial_dir=trial.dir,
            trial_config=dict(trial.config),
        )
        ckpt = start_checkpoint or trial.checkpoint_path
        ray_tpu_torch.get(actor.setup_session.remote(ctx, bus, ckpt))
        future = actor.run_train_loop.remote(self.trainable, trial.config)
        trial.status = RUNNING
        trial.save_state()
        self._running[trial.trial_id] = _RunningTrial(trial, actor, bus, future)

    def _teardown(self, rt: _RunningTrial):
        try:
            ray_tpu_torch.get(rt.bus.abort.remote(), timeout=2.0)
        except Exception:
            pass
        for h in (rt.bus, rt.actor):
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass
        if self._running.get(rt.trial.trial_id) is rt:
            self._running.pop(rt.trial.trial_id)

    # --------------------------------------------------------------- poll
    def _is_live(self, rt: _RunningTrial) -> bool:
        # identity check, not membership: an EXPLOIT relaunch re-registers the
        # same trial_id with a NEW _RunningTrial; the stale one must not touch it
        return self._running.get(rt.trial.trial_id) is rt

    def _poll(self):
        for rt in list(self._running.values()):
            # 1) consume reports
            try:
                rounds = ray_tpu_torch.get(rt.bus.drain.remote(), timeout=10.0)
            except Exception:
                rounds = []
            for round_ in rounds:
                self._handle_result(rt, round_[0])
                if not self._is_live(rt):
                    break
            if not self._is_live(rt):
                continue
            # 2) completion?
            done, _ = ray_tpu_torch.wait([rt.future], num_returns=1, timeout=0)
            if done:
                self._handle_completion(rt)

    def _handle_result(self, rt: _RunningTrial, payload: dict):
        trial = rt.trial
        trial.record(payload["metrics"])
        result = trial.last_result
        self._materialize_checkpoint(trial, payload)
        trial.save_state()
        if self.on_result:
            self.on_result(trial, result)
        if self._hit_stop_criteria(result):
            rt.stopped_by_scheduler = True
            trial.status = TERMINATED
            trial.save_state()
            self._teardown(rt)
            return
        decision = self.scheduler.on_trial_result(trial, result, self.trials)
        if decision == STOP:
            rt.stopped_by_scheduler = True
            trial.status = TERMINATED
            trial.save_state()
            self._teardown(rt)
        elif decision == EXPLOIT:
            source, new_config = self.scheduler.choose_exploit(trial, self.trials)
            if source is not None and source.checkpoint_path:
                # snapshot the source checkpoint into THIS trial's dir first:
                # the source keeps running and its keep-only-latest retention
                # may delete the original before the clone reads it
                snap = os.path.join(trial.dir, "exploit_src")
                shutil.rmtree(snap, ignore_errors=True)
                try:
                    shutil.copytree(source.checkpoint_path, snap)
                except (FileNotFoundError, shutil.Error, OSError):
                    # mid-copy deletion by the source's retention; try next round
                    shutil.rmtree(snap, ignore_errors=True)
                    return
                rt.stopped_by_scheduler = True
                self._teardown(rt)
                trial.config = new_config
                trial.sched_state["last_perturb"] = trial.iteration
                self._launch(trial, start_checkpoint=snap)

    def _handle_completion(self, rt: _RunningTrial):
        trial = rt.trial
        # final drain: reports pushed between the last poll and completion
        try:
            for round_ in ray_tpu_torch.get(rt.bus.drain.remote(), timeout=10.0):
                self._handle_result(rt, round_[0])
                if not self._is_live(rt):
                    return  # a late result triggered stop/exploit teardown
        except Exception:
            pass
        try:
            ray_tpu_torch.get(rt.future)
            trial.status = TERMINATED
        except Exception as e:
            if rt.stopped_by_scheduler:
                trial.status = TERMINATED
            else:
                trial.status = ERROR
                trial.error = f"{e!r}"
        trial.save_state()
        self._teardown(rt)

    def _hit_stop_criteria(self, result: Dict[str, Any]) -> bool:
        for k, v in self.stop_criteria.items():
            r = result.get(k)
            if r is not None and r >= v:
                return True
        return False

    def _materialize_checkpoint(self, trial: Trial, payload: dict):
        path = payload.get("checkpoint_path")
        if not path:
            return
        dest = os.path.join(trial.dir, f"checkpoint_{trial.iteration:06d}")
        if os.path.isdir(path):  # shared fs
            if os.path.abspath(path) != os.path.abspath(dest):
                shutil.copytree(path, dest, dirs_exist_ok=True)
        elif payload.get("checkpoint_ref") is not None:
            data = ray_tpu_torch.get(payload["checkpoint_ref"])
            os.makedirs(dest, exist_ok=True)
            with tarfile.open(fileobj=io.BytesIO(data)) as tar:
                tar.extractall(dest, filter="data")
        else:
            return
        old = trial.checkpoint_path
        trial.checkpoint_path = dest
        # keep only the latest per trial (experiment-level retention is the
        # CheckpointConfig of the embedded trainer when used via trainers)
        if old and os.path.isdir(old) and old != dest:
            shutil.rmtree(old, ignore_errors=True)
