"""Trial schedulers: FIFO, ASHA, PBT.

Reference: python/ray/tune/schedulers/ — trial_scheduler.py
(TrialScheduler.CONTINUE/STOP), async_hyperband.py (AsyncHyperBandScheduler
= ASHA brackets/rungs), pbt.py (PopulationBasedTraining exploit+explore).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.search_space import Domain
from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: restart this trial from another trial's checkpoint with a mutated
# config (controller performs the clone)
EXPLOIT = "EXPLOIT"


class TrialScheduler:
    def on_trial_result(self, trial: Trial, result: Dict[str, Any],
                        trials: List[Trial]) -> str:
        return CONTINUE

    def choose_exploit(self, trial: Trial, trials: List[Trial]):
        raise NotImplementedError


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: async_hyperband.py): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung stops unless
    its metric is in the top 1/reduction_factor of values recorded there."""

    def __init__(self, metric: str = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: Dict[int, List[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(int(t))
            t *= reduction_factor
        self.milestones = milestones

    def on_trial_result(self, trial, result, trials):
        it = result.get("training_iteration", trial.iteration)
        if it >= self.max_t:
            return STOP
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        v = float(metric) if self.mode == "max" else -float(metric)
        decision = CONTINUE
        # >= with per-trial rung memory (not ==): trials reporting coarser
        # iteration strides, or resumed past a milestone, still hit each rung
        # exactly once (reference: ASHA records the highest rung reached)
        done_rungs = trial.sched_state.setdefault("asha_rungs", [])
        for m in self.milestones:
            if it >= m and m not in done_rungs:
                done_rungs.append(m)
                recorded = self.rungs.setdefault(m, [])
                recorded.append(v)
                k = max(1, int(math.ceil(len(recorded) / self.rf)))
                cutoff = sorted(recorded, reverse=True)[k - 1]
                if v < cutoff:
                    decision = STOP
        return decision


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: pbt.py): every perturbation_interval iterations,
    bottom-quantile trials clone a top-quantile trial's checkpoint and
    perturb its hyperparameters."""

    def __init__(self, metric: str = None, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 perturbation_factors=(0.8, 1.2),
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.factors = perturbation_factors
        self.rng = random.Random(seed)

    def _score(self, r: Dict[str, Any]) -> Optional[float]:
        v = r.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, trial, result, trials):
        it = result.get("training_iteration", trial.iteration)
        last = trial.sched_state.get("last_perturb", 0)
        if it - last < self.interval:
            return CONTINUE
        trial.sched_state["last_perturb"] = it
        scored = [
            (self._score(t.last_result), t)
            for t in trials
            if t.last_result and self._score(t.last_result) is not None
        ]
        if len(scored) < 2:
            return CONTINUE
        scored.sort(key=lambda x: x[0])
        k = max(1, int(len(scored) * self.quantile))
        bottom = {t.trial_id for _, t in scored[:k]}
        if trial.trial_id in bottom:
            return EXPLOIT
        return CONTINUE

    def choose_exploit(self, trial, trials):
        """Pick a top-quantile source and a mutated config."""
        scored = [
            (self._score(t.last_result), t)
            for t in trials
            if t.trial_id != trial.trial_id and t.last_result
            and self._score(t.last_result) is not None
        ]
        if not scored:
            return None, trial.config
        scored.sort(key=lambda x: -x[0])
        k = max(1, int(len(scored) * self.quantile))
        source = self.rng.choice(scored[:k])[1]
        new_config = dict(source.config)
        for key, mut in self.mutations.items():
            if isinstance(mut, list):
                new_config[key] = self.rng.choice(mut)
            elif isinstance(mut, Domain):
                import numpy as np

                new_config[key] = mut.sample(np.random.default_rng(
                    self.rng.randrange(2**31)))
            elif callable(mut):
                new_config[key] = mut()
            elif isinstance(new_config.get(key), (int, float)):
                new_config[key] = new_config[key] * self.rng.choice(self.factors)
        return source, new_config
