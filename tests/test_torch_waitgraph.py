"""The port's wait-for deadlock sanitizer and blocking graph
(ray_tpu_torch/analysis/waitgraph.py) against the JAX package's: the static
graph of each tree, the two checkers on the reference tests' snippets, the
probes clean and seeded, and the reference's own tests of the dynamic core
run against the port's sanitizer. Every case that installs a sanitizer runs
in a fresh interpreter (`run_child`)."""

import os
import re

import pytest
import torch

import test_waitgraph as REF_TESTS
from ray_tpu.analysis import waitgraph as ref_wg
from ray_tpu_torch.analysis import waitgraph as wg
from ray_tpu_torch.analysis.core import analyze_paths
from test_torch_analysis import (norm_analysis, norm_report, parity_params, plain_tests,
                                 run_child, run_rebound, run_with_parity, to_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seeded_waits_name_the_ports_modules():
    assert [(b, p) for b, _m, p in wg.SEEDED_WAITS] == \
        [(b, p) for b, _m, p in ref_wg.SEEDED_WAITS]
    assert [m for _b, m, _p in wg.SEEDED_WAITS] == \
        ["ray_tpu_torch.cluster.gcs", "ray_tpu_torch.dag.compiled"]
    assert sorted(wg.WAIT_PROBES) == sorted(ref_wg.WAIT_PROBES)


def test_control_plane_graph_equals_reference():
    """The blocking graph of the port's cluster/, serve/ and dag/ equals
    the reference's, line numbers aside, and has no cycle."""
    def shape(obj):
        if isinstance(obj, dict):
            return {k: shape(v) for k, v in obj.items() if k != "line"}
        if isinstance(obj, list):
            return [shape(x) for x in obj]
        if isinstance(obj, str):
            return re.sub(r":\d+\b", ":N", to_ref(obj))
        return obj

    want, got = ref_wg.build_waitgraph(), wg.build_waitgraph()
    assert got.cycles == [] and got.contexts and got.edges
    got_d = shape(got.to_dict())
    # the one stated difference: the owner's republish puts through
    # ClusterClient._republish (ray_tpu_torch/cluster/client.py), which
    # tries the next live node where the reference's tried one
    sites = got_d["contexts"]["client.ClusterClient._repair_and_resubmit"]
    put = [s for s in sites if s["method"] == "put_object"]
    assert [s["via"] for s in put] == [["_republish"]]
    put[0]["via"] = []
    want_d = shape(want.to_dict())
    # the second: the fast path's reader fails its pair again on its way
    # out (ray_tpu_torch/serve/fastpath.py _read_loop), after reading what
    # a dead replica wrote: its context holds the reference's three sites in
    # the reverse order, the two through _fail_pair first, the read last
    key = "fastpath.FastPathRouter._read_loop"
    assert got_d["contexts"][key] == want_d["contexts"][key][::-1]
    got_d["contexts"][key] = want_d["contexts"][key]
    assert got_d == want_d


def test_repo_checkers_find_nothing():
    res = analyze_paths([os.path.join(wg._REPO, "ray_tpu_torch")], root=wg._REPO,
                        select=["blocking-wait-under-lock", "rpc-reentry-cycle"])
    assert not res.errors and res.findings == []


LINT_TESTS = parity_params(REF_TESTS, ("lint", "graph", "analyze_paths"))


@pytest.mark.parametrize("name", LINT_TESTS)
def test_static_half_equals_reference(name, tmp_path, monkeypatch):
    n = run_with_parity(monkeypatch, tmp_path, REF_TESTS, name, {
        "analyze_paths": (analyze_paths, norm_analysis),
        "build_waitgraph": (wg.build_waitgraph, norm_report),
    })
    assert n >= 1


def _deadlock_shape(rep):
    return {
        "cycle": sorted(to_ref(c.split(" ")[0]) for c in rep["cycle"]),
        "threads": sorted(t["thread"] for t in rep["threads"]),
        "rpc_chain": sorted(e["method"] for e in rep.get("rpc_chain", [])),
    }


def _probe(package, probe, bugs, rounds):
    """One probe's report, in a fresh interpreter, with the seeded bug sets
    of the probed modules read after it."""
    return run_child([
        "import importlib",
        f"from {package}.analysis import waitgraph as wg",
        f"r = wg.run_probe({probe!r}, seeded_bugs={tuple(bugs)!r}, rounds={rounds})",
        "bugs = {m: sorted(importlib.import_module(m).SEEDED_BUGS) for _b, m, _p in wg.SEEDED_WAITS}",
        "print(json.dumps({'detected': r.detected, 'rounds': r.rounds, 'stalls': r.stalls,"
        " 'deadlocks': r.deadlocks, 'bugs_after': bugs}, default=str))",
    ])


@pytest.mark.parametrize("probe", sorted(ref_wg.WAIT_PROBES))
def test_clean_probe_equals_reference(probe):
    want = _probe("ray_tpu", probe, (), 2)
    got = _probe("ray_tpu_torch", probe, (), 2)
    assert not got["detected"] and got["deadlocks"] == [] and got["stalls"] == []
    assert (got["rounds"], got["deadlocks"]) == (want["rounds"], want["deadlocks"])


@pytest.mark.parametrize("bug,probe", [(b, p) for b, _m, p in ref_wg.SEEDED_WAITS])
def test_seeded_wait_equals_reference(bug, probe):
    want = _probe("ray_tpu", probe, (bug,), 3)
    got = _probe("ray_tpu_torch", probe, (bug,), 3)
    assert got["detected"] and want["detected"] and got["rounds"] <= 2
    assert got["rounds"] == want["rounds"]
    assert [_deadlock_shape(r) for r in got["deadlocks"]] == \
        [_deadlock_shape(r) for r in want["deadlocks"]]
    assert all(t["stack"] for t in got["deadlocks"][0]["threads"])
    assert all(v == [] for v in got["bugs_after"].values())  # the probe restores them


# ------------------ the reference's own tests, against the port's sanitizer

NAMES = ("from ray_tpu_torch.analysis import sanitizer as san_mod, waitgraph as wg\n"
         "from ray_tpu_torch.analysis.core import analyze_paths\n"
         "NAMES.update(wg=wg, san_mod=san_mod, WaitSanitizer=wg.WaitSanitizer,"
         " blocking_wait_kind=wg.blocking_wait_kind, build_waitgraph=wg.build_waitgraph,"
         " reentry_chains=wg.reentry_chains, run_probe=wg.run_probe,"
         " analyze_paths=analyze_paths)")
CORE_TESTS = plain_tests(REF_TESTS, ("san",))
UNIT_TESTS = plain_tests(REF_TESTS, ())


def test_reference_cases_were_found():
    assert len(CORE_TESTS) >= 6 and len(UNIT_TESTS) >= 10


@pytest.mark.parametrize("name", CORE_TESTS)
def test_dynamic_core_as_reference(name):
    run_rebound("test_waitgraph", name, NAMES,
                "fx = wg.WaitSanitizer(stall_warn_s=60.0).install()")


@pytest.mark.parametrize("name", UNIT_TESTS)
def test_classifier_and_contract_as_reference(name):
    run_rebound("test_waitgraph", name, NAMES)
