"""The port's GCS model checker (ray_tpu_torch/analysis/explore.py) against
the JAX package's on the same scenarios, budgets and seeds.

The port's explored GCS runs every scheduler step as one synchronous K1
round; here K1's plain version on the CPU (``device="cpu"``), which equals
``kernel_np`` decision for decision. The reference's GCS runs its own
default policy (the NumPy kernel at these sizes). So the schedules, counts,
coverage and violations must be equal, and any difference is a fault.
"""

import json
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_explore as REF_TESTS
from ray_tpu.analysis import explore as ref_ex
from ray_tpu_torch.analysis import explore as ex
from ray_tpu_torch.analysis.core import analyze_paths
from ray_tpu_torch.sched import kernel_torch, policy as policy_mod
from test_torch_analysis import norm_analysis, parity_params, run_with_parity

SEEDED_BUG = ["register-node-double-book"]
SCENARIOS = sorted(ref_ex.SCENARIOS)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Every explored round runs K1's plain version in torch: with the
    suite's xdist workers, torch's intra-op threads spin against each
    other. One thread for this module, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(res):
    """An ExploreResult as comparable data."""
    return {
        "scenario": res.scenario,
        "schedules_run": res.schedules_run,
        "dfs_schedules": res.dfs_schedules,
        "sampled_schedules": res.sampled_schedules,
        "branches_pruned": res.branches_pruned,
        "branches_queued": res.branches_queued,
        "coverage": sorted(res.coverage),
        "found": res.found,
        "violation_kinds": sorted(res.violating.violation_kinds) if res.found else [],
        "violating_schedule": res.violating.schedule if res.found else None,
        "shrunk": res.shrunk,
        "shrunk_kinds": sorted({v.kind for v in res.shrunk_violations or []}),
    }


def test_scenario_library_equals_reference():
    assert sorted(ex.SCENARIOS) == SCENARIOS and len(SCENARIOS) == 7


@pytest.mark.parametrize("name", SCENARIOS)
def test_default_schedule_equals_reference(name):
    want = ref_ex.run_world(ref_ex.SCENARIOS[name], ref_ex.Chooser())
    got = ex.run_world(ex.SCENARIOS[name], ex.Chooser(), device=CPU)
    assert got.quiesced and want.quiesced
    assert got.violations == [] and want.violations == []
    assert got.schedule == want.schedule
    assert got.options_at == want.options_at
    assert got.keys_of == want.keys_of


@pytest.mark.parametrize("name", SCENARIOS)
def test_small_budget_sweep_equals_reference(name):
    """tests/test_explore.py's sweep: 60 DFS schedules, 30 samples, seed 11."""
    kw = dict(max_schedules=60, samples=30, seed=11)
    want = ref_ex.explore(ref_ex.SCENARIOS[name], **kw)
    got = ex.explore(ex.SCENARIOS[name], device=CPU, **kw)
    assert _summary(got) == _summary(want)
    assert not got.found and got.schedules_run > 0


def test_sampled_schedule_equals_reference():
    want = ref_ex.run_world(ref_ex.SCENARIOS["watchdog-resend"],
                            ref_ex.Chooser(rng=random.Random(42)))
    got = ex.run_world(ex.SCENARIOS["watchdog-resend"],
                       ex.Chooser(rng=random.Random(42)), device=CPU)
    assert got.schedule == want.schedule
    assert [v.format() for v in got.violations] == [v.format() for v in want.violations]


@pytest.fixture(scope="module")
def seeded_pair():
    kw = dict(max_schedules=300, samples=300, seed=5, seeded_bugs=SEEDED_BUG)
    want = ref_ex.explore(ref_ex.SCENARIOS["node-reconnect-instance"], **kw)
    got = ex.explore(ex.SCENARIOS["node-reconnect-instance"], device=CPU, **kw)
    return want, got


def test_seeded_bug_found_and_shrunk_as_the_reference(seeded_pair):
    want, got = seeded_pair
    assert got.found and want.found
    assert _summary(got) == _summary(want)
    assert got.violating.violation_kinds & {"capacity", "exactly-once"}
    assert got.shrunk is not None and len(got.shrunk) <= 10


def test_seeded_bug_replay_reproduces_exactly(seeded_pair, tmp_path):
    got = seeded_pair[1]
    p = tmp_path / "cex.json"
    ex.write_replay(str(p), got, seeded_bugs=SEEDED_BUG)
    rec = json.loads(p.read_text())
    assert rec["scenario"] == "node-reconnect-instance"
    r1 = ex.replay(str(p), device=CPU)
    r2 = ex.replay(str(p), device=CPU)
    assert r1.violations and [v.format() for v in r1.violations] == \
        [v.format() for v in r2.violations]
    assert r1.schedule == r2.schedule == rec["schedule"]
    # the fixed protocol runs the same schedule clean
    clean = ex.run_world(ex.SCENARIOS["node-reconnect-instance"],
                         ex.Chooser(got.shrunk, stop_after=True), device=CPU)
    assert clean.violations == []


# ------------------------------------------------- the rounds are K1 rounds


def test_sched_step_is_one_synchronous_plain_k1_round(monkeypatch):
    """Each `sched` step that has work is exactly one K1 call (its plain
    version here), on the calling thread: no NumPy twin, no pipeline
    window, no thread of the policy's own."""
    k1_calls, rounds = [], []
    real_k1 = kernel_torch.schedule_classes
    real_schedule = policy_mod.HybridPolicy.schedule

    def k1(*a, **kw):
        k1_calls.append(threading.current_thread())
        return real_k1(*a, **kw)

    def schedule(self, state, demands, counts):
        rounds.append(demands.shape[0])
        return real_schedule(self, state, demands, counts)

    def twin(*a, **kw):
        raise AssertionError("a round reached the NumPy twin")

    monkeypatch.setattr(kernel_torch, "schedule_classes", k1)
    monkeypatch.setattr(policy_mod.HybridPolicy, "schedule", schedule)
    monkeypatch.setattr(policy_mod.kernel_np, "schedule_classes", twin)
    before = set(threading.enumerate())
    world = ex.World(ex.Chooser(), ex.BufTracer())
    try:
        world.build_gcs(device=CPU)
        pol = world.gcs.policy
        assert pol.name == "torch_cuda" and pol.device == torch.device("cpu")
        assert pol.device_min_cells == 0 and not pol.pipelined
        ex.SCENARIOS["node-reconnect-instance"].build(world)
        world.run()
        assert set(threading.enumerate()) == before
    finally:
        world.close()
    assert rounds and all(c > 0 for c in rounds)
    assert len(k1_calls) == len(rounds)
    assert set(k1_calls) == {threading.current_thread()}


def test_world_close_frees_the_device_view():
    world = ex.World(ex.Chooser(), ex.BufTracer())
    world.build_gcs(device=CPU)
    ex.SCENARIOS["node-reconnect-instance"].build(world)
    world.run()
    pol = world.gcs.policy
    assert pol._torch is not None
    world.close()
    assert pol._torch is None and world.gcs is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_explorer_raises_without_a_card():
    """The default device is the card; without one the explorer raises,
    it never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.run_world(ex.SCENARIOS["watchdog-resend"], ex.Chooser())


def test_plain_k1_equals_kernel_np_on_explored_rounds(monkeypatch):
    """Every round the explorer hands K1 in one scenario's sweep, solved
    again by kernel_np: the assignments are equal."""
    from ray_tpu_torch.sched import kernel_np

    seen = []
    real = kernel_torch.schedule_classes

    def k1(avail, total, alive, demands, counts, spread_threshold, *a, **kw):
        args = [t.clone() for t in (avail, total, alive, demands, counts)]
        out = real(avail, total, alive, demands, counts, spread_threshold, *a, **kw)
        seen.append((args, float(spread_threshold), out[0].clone()))
        return out

    monkeypatch.setattr(kernel_torch, "schedule_classes", k1)
    ex.explore(ex.SCENARIOS["actor-kill-vs-release"], max_schedules=20,
               samples=5, seed=3, device=CPU)
    assert seen
    for (avail, total, alive, demands, counts), thr, assigned in seen:
        want, _ = kernel_np.schedule_classes(
            avail.numpy(), total.numpy(), alive.numpy().astype(bool),
            demands.numpy(), counts.numpy(), spread_threshold=thr)
        np.testing.assert_array_equal(assigned.numpy(), want)


# ------------------------------------------------------------------- CLI


def test_cli_explore_on_the_cpu_exit_zero():
    p = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "--explore",
         "watchdog-resend", "--budget", "30", "--samples", "10",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "no violations" in p.stdout


# -------------------------- the state-machine and cross-thread checkers

LINT_TESTS = parity_params(REF_TESTS, ("lint",))


@pytest.mark.parametrize("name", LINT_TESTS)
def test_lifecycle_findings_equal_reference(name, tmp_path, monkeypatch):
    n = run_with_parity(monkeypatch, tmp_path, REF_TESTS, name,
                        {"analyze_paths": (analyze_paths, norm_analysis)})
    assert n >= 1
