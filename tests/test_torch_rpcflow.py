"""The port's RPC flow graph (ray_tpu_torch/analysis/rpcflow.py) against
the JAX package's: the graph of each tree (``--dump-rpcflow``), the static
model and its two checkers on the reference tests' snippets, and the
reference's own tests of the budget ratchet and the profiler run against
the port's."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import test_rpcflow as REF_TESTS
from ray_tpu.analysis import rpcflow as ref_rpcflow
from ray_tpu_torch.analysis import rpcflow
from ray_tpu_torch.analysis.core import analyze_paths
from test_torch_analysis import (norm_analysis, norm_report, parity_params, plain_tests,
                                 rebound, run_with_parity, to_ref)

REPO = rpcflow.repo_root()
PORT_NAMES = {name: getattr(rpcflow, name) for name in (
    "DEFAULT_BUDGET_FILE", "OpCost", "RpcFlowReport", "RpcProfiler", "SiteUse",
    "ZERO_STEADY_STATE_OPS", "build_rpcflow", "check_measured", "load_budget",
    "ratchet_check", "repo_root")}
PORT_NAMES.update(rpcflow=rpcflow, analyze_paths=analyze_paths, REPO=REPO)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real_report():
    return rpcflow.build_rpcflow([os.path.join(REPO, "ray_tpu_torch")], root=REPO)


def _no_lines(obj):
    if isinstance(obj, dict):
        return {k: _no_lines(v) for k, v in obj.items() if k != "line"}
    if isinstance(obj, list):
        return [_no_lines(x) for x in obj]
    if isinstance(obj, str):
        return re.sub(r":\d+\b", ":N", to_ref(obj))
    return obj


def test_flow_graph_equals_reference(real_report):
    """Every driver operation's RPC sites, depths and predicted class equal
    the reference's; only the count of indexed functions differs (the
    port's kernel wrappers and its own modules)."""
    want = ref_rpcflow.build_rpcflow([os.path.join(REPO, "ray_tpu")], root=REPO).to_dict()
    got = real_report.to_dict()
    assert got["unresolved_entries"] == want["unresolved_entries"] == []
    assert _no_lines(got["ops"]) == _no_lines(want["ops"])
    assert got["functions_indexed"] > want["functions_indexed"]


def test_live_tree_clean_for_both_checkers():
    res = analyze_paths([os.path.join(REPO, "ray_tpu_torch")], root=REPO,
                        select=["rpc-in-loop", "rpc-under-lock"])
    assert res.findings == [], [f.format() for f in res.findings]


def test_cli_dump_rpcflow_json_exit_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "--dump-rpcflow",
         "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    data = json.loads(proc.stdout)
    assert data["unresolved_entries"] == []
    assert data["ops"]["dag_execute"]["predicted_class"] == "zero"
    assert data["ops"]["serve_request"]["predicted_class"] == "zero"


LINT_TESTS = parity_params(REF_TESTS, ("flow", "lint", "analyze_paths", "build_rpcflow"))


@pytest.mark.parametrize("name", LINT_TESTS)
def test_static_model_equals_reference(name, tmp_path, monkeypatch):
    n = run_with_parity(monkeypatch, tmp_path, REF_TESTS, name, {
        "analyze_paths": (analyze_paths, norm_analysis),
        "build_rpcflow": (rpcflow.build_rpcflow, norm_report),
    })
    assert n >= 1


@pytest.fixture
def profiler():
    p = rpcflow.RpcProfiler().install()
    yield p
    p.uninstall()


REPORT_TESTS = plain_tests(REF_TESTS, ("real_report",))
PROFILER_TESTS = plain_tests(REF_TESTS, ("profiler",))
UNIT_TESTS = plain_tests(REF_TESTS, ())


def test_reference_cases_were_found():
    assert len(REPORT_TESTS) >= 3 and len(PROFILER_TESTS) >= 3 and len(UNIT_TESTS) >= 8


@pytest.mark.parametrize("name", REPORT_TESTS)
def test_real_tree_as_reference(name, real_report):
    rebound(getattr(REF_TESTS, name), **PORT_NAMES)(real_report)


@pytest.mark.parametrize("name", PROFILER_TESTS)
def test_profiler_as_reference(name, profiler):
    rebound(getattr(REF_TESTS, name), **PORT_NAMES)(profiler)


@pytest.mark.parametrize("name", UNIT_TESTS)
def test_budget_and_profiler_contract_as_reference(name):
    rebound(getattr(REF_TESTS, name), **PORT_NAMES)()
