"""The port's channel memory-model checker (ray_tpu_torch/analysis/memmodel.py)
against the JAX package's on the same scenarios, budgets and seeded bugs,
and its round-trip gate against the port's own dag/channel.py."""

import pytest
import torch

import test_memmodel as REF_TESTS
from ray_tpu.analysis import memmodel as ref_mm
from ray_tpu_torch.analysis import memmodel as mm
from ray_tpu_torch.analysis.core import analyze_paths
from ray_tpu_torch.analysis.explore import Chooser
from ray_tpu_torch.dag import channel as chan_mod
from test_torch_analysis import norm_analysis, parity_params, run_with_parity

SCENARIOS = sorted(ref_mm.CHANNEL_SCENARIOS)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(res):
    return {
        "scenario": res.scenario,
        "schedules_run": res.schedules_run,
        "dfs_schedules": res.dfs_schedules,
        "sampled_schedules": res.sampled_schedules,
        "branches_pruned": res.branches_pruned,
        "branches_queued": res.branches_queued,
        "ops_covered": res.ops_covered,
        "crash_points": sorted(res.crash_points),
        "found": res.found,
        "violation_kinds": sorted({v.kind for v in res.violating.violations})
        if res.found else [],
        "shrunk": res.shrunk,
        "shrunk_kinds": sorted({v.kind for v in res.shrunk_violations or []}),
    }


def test_scenarios_and_seeded_bugs_equal_reference():
    assert sorted(mm.CHANNEL_SCENARIOS) == SCENARIOS
    assert mm.SEEDED_BUG_SCENARIOS == ref_mm.SEEDED_BUG_SCENARIOS
    assert mm.WORD_NAMES == ref_mm.WORD_NAMES
    assert mm.DECLARED_SEQUENCES == ref_mm.DECLARED_SEQUENCES


@pytest.mark.parametrize("name", SCENARIOS)
def test_default_schedule_equals_reference(name):
    want = ref_mm.run_channel_world(ref_mm.CHANNEL_SCENARIOS[name], Chooser())
    got = mm.run_channel_world(mm.CHANNEL_SCENARIOS[name], Chooser())
    assert got.schedule == want.schedule
    assert [v.format() for v in got.violations] == \
        [v.format() for v in want.violations] == []


@pytest.mark.parametrize("name", SCENARIOS)
def test_small_budget_sweep_equals_reference(name):
    """tests/test_memmodel.py's sweep: 80 DFS schedules, 40 samples, seed 7."""
    kw = dict(max_schedules=80, samples=40, seed=7)
    want = ref_mm.explore_channel(ref_mm.CHANNEL_SCENARIOS[name], **kw)
    got = mm.explore_channel(mm.CHANNEL_SCENARIOS[name], **kw)
    assert _summary(got) == _summary(want)
    assert not got.found and got.ops_covered > 0


@pytest.mark.parametrize("bug,scen", ref_mm.SEEDED_BUG_SCENARIOS,
                         ids=[b for b, _ in ref_mm.SEEDED_BUG_SCENARIOS])
def test_seeded_bug_found_and_shrunk_as_the_reference(bug, scen):
    kw = dict(max_schedules=2000, samples=0, seeded_bugs=[bug])
    want = ref_mm.explore_channel(ref_mm.CHANNEL_SCENARIOS[scen], **kw)
    got = mm.explore_channel(mm.CHANNEL_SCENARIOS[scen], **kw)
    assert got.found and want.found
    assert _summary(got) == _summary(want)


def test_round_trip_holds_on_the_ports_channel():
    """memmodel's AST round trip over the port's dag/channel.py."""
    assert mm.verify_op_sequences() == []
    assert mm.channel_op_sequences() == ref_mm.channel_op_sequences()


def test_layout_single_source_of_truth():
    assert tuple(n for n, _ in chan_mod.HEADER_LAYOUT) == mm.WORD_NAMES
    assert len(chan_mod.HEADER_LAYOUT) * 8 <= chan_mod.HDR
    for name in chan_mod.WORDS:
        assert name in chan_mod.__doc__, f"{name} missing from docstring"


LINT_TESTS = parity_params(REF_TESTS, ("lint",))


@pytest.mark.parametrize("name", LINT_TESTS)
def test_channel_checker_findings_equal_reference(name, tmp_path, monkeypatch):
    """The chan-raw-header-access and chan-publication-order checkers on
    the reference tests' snippets."""
    n = run_with_parity(monkeypatch, tmp_path, REF_TESTS, name,
                        {"analyze_paths": (analyze_paths, norm_analysis)})
    assert n >= 1
