"""ray_tpu_torch.tune held against ray_tpu.tune on the CPU.

- The fourteen cases of tests/test_tune.py on the port (local mode, 8
  CPUs), with the same configurations and expectations.
- The search space's samples and resolve_variants' variants equal the
  reference's for one seed; ASHA's and PBT's decisions equal the
  reference's on the same reported metrics; the trial state a package
  writes is read by the other.
"""

import json
import os

import numpy as np
import pytest

import ray_tpu.tune as ref_tune
from ray_tpu.tune.trial import Trial as RefTrial
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import Checkpoint, RunConfig
from test_torch_runtime import TORCH_CPU


@pytest.fixture
def ray8(tmp_path):
    ray_tpu_torch.init(num_cpus=8, _system_config=TORCH_CPU)
    yield str(tmp_path)
    ray_tpu_torch.shutdown()


def test_search_space_sampling():
    rng = np.random.default_rng(0)
    assert 0.0 <= tune.uniform(0, 1).sample(rng) <= 1.0
    v = tune.loguniform(1e-4, 1e-1).sample(rng)
    assert 1e-4 <= v <= 1e-1
    assert tune.randint(3, 7).sample(rng) in (3, 4, 5, 6)
    assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")
    q = tune.quniform(0, 10, 0.5).sample(rng)
    assert abs(q / 0.5 - round(q / 0.5)) < 1e-9


def test_resolve_variants_grid_cross_product():
    variants = tune.resolve_variants(
        {"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search(["x", "y"]),
         "c": tune.uniform(0, 1), "d": "fixed"},
        num_samples=2, seed=0,
    )
    assert len(variants) == 12  # 3 * 2 grid × 2 samples
    assert {(v["a"], v["b"]) for v in variants} == {
        (a, b) for a in (1, 2, 3) for b in ("x", "y")
    }
    assert all(v["d"] == "fixed" for v in variants)


def test_tuner_basic_grid(ray8):
    def trainable(config):
        tune.report({"score": config["x"] * 2})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 5])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="grid", storage_path=ray8),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.metrics["score"] == 10
    assert best.metrics["config"]["x"] == 5


def test_tuner_min_mode_and_errors(ray8):
    def trainable(config):
        if config["x"] == 2:
            raise RuntimeError("bad trial")
        tune.report({"loss": float(config["x"])})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="minmode", storage_path=ray8),
    ).fit()
    assert len(grid.errors) == 1
    assert grid.get_best_result().metrics["loss"] == 1.0


def test_stop_criteria(ray8):
    def trainable(config):
        for i in range(100):
            tune.report({"it": i})

    grid = tune.Tuner(
        trainable,
        param_space={},
        tune_config=tune.TuneConfig(metric="it", mode="max"),
        run_config=RunConfig(name="stop", storage_path=ray8,
                             stop={"training_iteration": 5}),
    ).fit()
    assert grid[0].metrics["training_iteration"] == 5


def test_asha_early_stops_bad_trials(ray8):
    """Bad trials stop at rungs; good ones reach max_t (reference:
    async_hyperband tests)."""

    def trainable(config):
        for i in range(1, 17):
            tune.report({"score": config["quality"] * i})

    sched = tune.ASHAScheduler(max_t=16, grace_period=2, reduction_factor=2)
    grid = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([1.0, 0.9, 0.2, 0.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=sched,
            max_concurrent_trials=1,  # deterministic rung order
        ),
        run_config=RunConfig(name="asha", storage_path=ray8),
    ).fit()
    results = {r.metrics["config"]["quality"]: r.metrics["training_iteration"]
               for r in grid}
    assert results[1.0] == 16       # best survives to max_t
    assert results[0.1] < 16        # worst early-stopped
    assert not grid.errors


def test_pbt_exploits_checkpoint(ray8):
    """Bottom-quantile trial clones the top trial's checkpoint + mutated
    config (reference: pbt.py exploit/explore)."""

    def trainable(config):
        ck = tune.get_checkpoint()
        state = ck.to_dict() if ck else {"acc": 0.0}
        acc = state["acc"]
        for _ in range(12):
            acc += config["lr"]
            tune.report({"acc": acc, "lr": config["lr"]},
                        checkpoint=Checkpoint.from_dict({"acc": acc}))

    sched = tune.PopulationBasedTraining(
        perturbation_interval=3,
        hyperparam_mutations={"lr": [0.01, 0.1]},
        quantile_fraction=0.5,
        seed=0,
    )
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 0.1])},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=sched),
        run_config=RunConfig(name="pbt", storage_path=ray8),
    ).fit()
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["acc"] > 0.3  # exploitation pushed the slow trial up


def test_tuner_restore_resumes_unfinished(ray8):
    """Interrupt an experiment, restore it: finished trials keep results,
    unfinished re-run from checkpoints (reference: Tuner.restore)."""
    marker = os.path.join(ray8, "interrupted")

    def trainable(config):
        ck = tune.get_checkpoint()
        start = ck.to_dict()["i"] + 1 if ck else 0
        for i in range(start, 6):
            if config["x"] == 2 and i == 3 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("simulated interruption")
            tune.report({"i": i, "x": config["x"]},
                        checkpoint=Checkpoint.from_dict({"i": i}))

    g1 = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="i", mode="max"),
        run_config=RunConfig(name="resume", storage_path=ray8),
    ).fit()
    exp_dir = os.path.dirname(g1[0].path)
    assert len(g1.errors) == 1
    g2 = tune.Tuner.restore(exp_dir, trainable).fit()
    assert not g2.errors
    for r in g2:
        assert r.metrics["i"] == 5


def test_trainer_as_trainable(ray8):
    """A DataParallelTrainer runs under Tune with per-trial config
    (reference: trainers are Tune trainables)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    def loop(config):
        train.report({"value": config["scale"] * 10.0})

    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="inner", storage_path=ray8),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"scale": tune.grid_search([1.0, 3.0])},
        tune_config=tune.TuneConfig(metric="value", mode="max"),
        run_config=RunConfig(name="outer", storage_path=ray8),
    ).fit()
    assert not grid.errors
    assert grid.get_best_result().metrics["value"] == 30.0


def test_asha_coarse_iteration_stride(ray8):
    """Regression: ASHA rungs use >= with per-trial memory, so trainables
    whose iteration counts skip milestone values still get pruned."""
    sched = tune.ASHAScheduler(
        metric="s", mode="max", max_t=100, grace_period=2, reduction_factor=2
    )
    from ray_tpu_torch.tune.trial import Trial

    t1 = Trial("a", {}, ray8)
    t2 = Trial("b", {}, ray8)
    # t1 (good) reports at it=5: crosses rungs 2 and 4 at once
    assert sched.on_trial_result(t1, {"training_iteration": 5, "s": 10.0}, []) == "CONTINUE"
    # t2 (bad) at it=5 must be cut at those same rungs
    assert sched.on_trial_result(t2, {"training_iteration": 5, "s": 1.0}, []) == "STOP"
    # a rung is never double-counted for one trial
    assert sched.on_trial_result(t1, {"training_iteration": 6, "s": 10.0}, []) == "CONTINUE"
    assert len(sched.rungs[2]) == 2


def test_trial_state_roundtrip_preserves_history(ray8):
    from ray_tpu_torch.tune.trial import Trial

    t = Trial("x", {"lr": 0.1}, ray8)
    t.record({"m": 1.0})
    t.record({"m": 2.0})
    t.sched_state["last_perturb"] = 2
    t.save_state()
    back = Trial.load_state(t.dir, ray8)
    assert len(back.results) == 2
    assert back.sched_state["last_perturb"] == 2


def test_nested_grid_search_expands(ray8):
    """Regression: nested grid_search participates in the cross product."""
    variants = tune.resolve_variants(
        {"opt": {"lr": tune.grid_search([0.1, 0.01])},
         "b": tune.grid_search([1, 2])},
        num_samples=1,
    )
    assert len(variants) == 4
    assert {(v["opt"]["lr"], v["b"]) for v in variants} == {
        (lr, b) for lr in (0.1, 0.01) for b in (1, 2)
    }


def test_restore_preserves_stop_criteria(ray8, tmp_path):
    """Regression: Tuner.restore keeps the experiment's stop dict."""
    meta_dir = str(tmp_path / "exp")
    os.makedirs(meta_dir)
    import json

    with open(os.path.join(meta_dir, "experiment_state.json"), "w") as f:
        json.dump({"metric": "m", "mode": "max", "stop": {"training_iteration": 7}}, f)
    t = tune.Tuner.restore(meta_dir, lambda c: None)
    assert t.run_config.stop == {"training_iteration": 7}


def test_crashing_trials_dont_corrupt_experiment(ray8):
    """Flaky trainables: crashes surface as per-trial errors, surviving
    trials complete, and the best result is still the true optimum."""
    def trainable(config):
        if config["crash"] and config["q"] < 0.5:
            raise RuntimeError("boom")
        for i in range(1, 9):
            tune.report({"score": config["q"] * i})

    qs = [0.1, 0.3, 0.45, 0.6, 0.8, 0.95]
    res = tune.Tuner(
        trainable,
        param_space={
            "q": tune.grid_search(qs),
            "crash": tune.grid_search([False, True]),
        },
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.ASHAScheduler(max_t=8, grace_period=2),
            max_concurrent_trials=4,
        ),
        run_config=RunConfig(name="flaky", storage_path=ray8),
    ).fit()
    crashed = sum(1 for r in res if r.error is not None)
    assert crashed == 3  # q in {0.1, 0.3, 0.45} with crash=True
    assert res.get_best_result().metrics["config"]["q"] == 0.95


# ---------------------------------------------- against the JAX package


def _space(t):
    return {"lr": t.loguniform(1e-4, 1e-1), "u": t.uniform(-1, 2), "q": t.quniform(0, 10, 0.5),
            "n": t.randint(3, 9), "ln": t.lograndint(2, 100), "c": t.choice(["a", "b", "c"]),
            "g": t.grid_search([1, 2]), "nested": {"h": t.grid_search(["x", "y"]),
                                                    "w": t.uniform(0, 1)},
            "fixed": 5}


@pytest.mark.parametrize("seed", [0, 11])
def test_search_space_samples_and_variants_equal_reference(seed):
    ref_rng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for name in ("lr", "u", "q", "n", "ln", "c"):
        for _ in range(20):
            assert _space(tune)[name].sample(rng) == _space(ref_tune)[name].sample(ref_rng)
    got = tune.resolve_variants(_space(tune), num_samples=3, seed=seed)
    want = ref_tune.resolve_variants(_space(ref_tune), num_samples=3, seed=seed)
    assert len(got) == len(want) == 12
    assert got == want


def _asha_run(t, trial_cls, tmp, scores, **kw):
    """Feed each package's ASHA the same results in the same order; returns
    its decisions and rungs."""
    sched = t.ASHAScheduler(metric="s", mode=kw.pop("mode", "max"), **kw)
    trials = {name: trial_cls(name, {}, tmp) for name in scores}
    decisions = []
    for it in range(1, max(len(v) for v in scores.values()) + 1):
        for name, seq in scores.items():
            if it <= len(seq):
                decisions.append(sched.on_trial_result(
                    trials[name], {"training_iteration": it, "s": seq[it - 1]}, []))
    return decisions, sched.rungs, sched.milestones


@pytest.mark.parametrize("mode", ["max", "min"])
def test_asha_decisions_equal_reference(tmp_path, mode):
    from ray_tpu_torch.tune.trial import Trial

    rng = np.random.default_rng(5)
    scores = {f"t{i}": list(np.cumsum(rng.normal(q, 1.0, 20)))
              for i, q in enumerate([0.5, 1.0, -0.3, 2.0, 0.0, 1.5, 0.2, 0.9])}
    kw = dict(max_t=16, grace_period=1, reduction_factor=2, mode=mode)
    got = _asha_run(tune, Trial, str(tmp_path / "port"), scores, **dict(kw))
    want = _asha_run(ref_tune, RefTrial, str(tmp_path / "ref"), scores, **dict(kw))
    assert got == want
    assert "STOP" in got[0] and "CONTINUE" in got[0]


def test_pbt_decisions_equal_reference(tmp_path):
    from ray_tpu_torch.tune.trial import Trial

    def run(t, trial_cls, where):
        pbt = t.PopulationBasedTraining(metric="acc", perturbation_interval=2,
                                        hyperparam_mutations={"lr": [0.01, 0.1, 1.0]},
                                        quantile_fraction=0.5, seed=3)
        trials = [trial_cls(f"t{i}", {"lr": lr}, str(tmp_path / where))
                  for i, lr in enumerate([0.01, 0.1, 0.5, 1.0])]
        out = []
        for it in range(1, 7):
            for i, tr in enumerate(trials):
                tr.record({"training_iteration": it, "acc": it * tr.config["lr"] + i})
                d = pbt.on_trial_result(tr, tr.last_result, trials)
                if d == "EXPLOIT":
                    src, cfg = pbt.choose_exploit(tr, trials)
                    out.append((it, tr.trial_id, src.trial_id, cfg))
                out.append(d)
        return out

    assert run(tune, Trial, "port") == run(ref_tune, RefTrial, "ref")


def test_trial_state_files_cross_packages(tmp_path):
    from ray_tpu_torch.tune.trial import Trial

    t = RefTrial("x", {"lr": 0.1, "nested": {"a": 1}}, str(tmp_path))
    t.record({"m": 1.0})
    t.record({"m": 2.5})
    t.sched_state["asha_rungs"] = [1, 2]
    t.save_state()
    back = Trial.load_state(t.dir, str(tmp_path))
    assert (back.config, back.results, back.sched_state, back.iteration) == \
        (t.config, t.results, t.sched_state, t.iteration)
    back.record({"m": 3.0})
    back.save_state()
    with open(os.path.join(back.dir, "trial_state.json")) as f:
        assert json.load(f)["iteration"] == 3
    assert RefTrial.load_state(back.dir, str(tmp_path)).results == back.results
