"""ray_tpu_torch.tune — hyperparameter search over trial actors.

Reference: python/ray/tune/ (Tuner/TuneConfig/ResultGrid, search spaces in
search/sample.py, BasicVariantGenerator, schedulers: ASHA async_hyperband.py
and PBT pbt.py). ``tune.report`` is the shared train session (reference
parity: ray.train and ray.tune share one session).
"""

from ray_tpu_torch.train.session import get_checkpoint, get_context, report
from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search_space import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    resolve_variants,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

ASHAScheduler = AsyncHyperBandScheduler  # reference alias

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "FIFOScheduler",
    "PopulationBasedTraining",
    "ResultGrid",
    "Trial",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_context",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "resolve_variants",
    "run",
    "sample_from",
    "uniform",
]
