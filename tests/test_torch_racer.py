"""The port's happens-before race sanitizer (ray_tpu_torch/analysis/racer.py)
against the JAX package's: the static watchlist extracted from each tree,
the probes' reports clean and seeded, and the reference's own tests of the
vector-clock core run against the port's sanitizer. Every case that
installs a sanitizer runs in a fresh interpreter (`run_child`)."""

import pytest
import torch

import test_racer as REF_TESTS
from ray_tpu.analysis import racer as ref_racer
from ray_tpu_torch.analysis import racer as racer_mod
from test_torch_analysis import plain_tests, run_child, run_rebound, to_ref

NAMES = ("from ray_tpu_torch.analysis import racer as racer_mod, sanitizer as san_mod\n"
         "NAMES.update(racer_mod=racer_mod, san_mod=san_mod,"
         " RaceSanitizer=racer_mod.RaceSanitizer,"
         " extract_watchlist=racer_mod.extract_watchlist, run_probe=racer_mod.run_probe)")
#: Watched fields only the port has: (module, class, field) and the cause.
PORT_ONLY_FIELDS = {
    # ClusterClient._foreign, the refs of other owners a task's pin held
    # (ray_tpu_torch/cluster/client.py:153), written by the submit path and
    # the background free loop under self._lock
    ("ray_tpu/cluster/client.py", "ClusterClient", "_foreign"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def watchlists():
    return ref_racer.extract_watchlist(), racer_mod.extract_watchlist()


def _key(e):
    return (to_ref(e["module"]), e["cls"], e["field"])


def test_seeded_races_name_the_ports_modules():
    assert [(b, p) for b, _m, p in racer_mod.SEEDED_RACES] == \
        [(b, p) for b, _m, p in ref_racer.SEEDED_RACES]
    assert [m for _b, m, _p in racer_mod.SEEDED_RACES] == \
        ["ray_tpu_torch.cluster.node_daemon", "ray_tpu_torch.serve.fastpath"]
    assert sorted(racer_mod.RACE_PROBES) == sorted(ref_racer.RACE_PROBES)


def test_watchlist_equals_reference_but_for_stated_fields(watchlists):
    ref, port = watchlists
    want = {_key(e): {**e, "module": to_ref(e["module"])} for e in ref}
    got = {_key(e): {**e, "module": to_ref(e["module"])} for e in port}
    assert set(got) - set(want) == PORT_ONLY_FIELDS
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == want[k], k
    assert all(e["module"].startswith("ray_tpu_torch/") for e in port)


def test_watchlist_covers_control_plane_fields(watchlists):
    idx = {(e["cls"], e["field"]): e for e in watchlists[1]}
    wm = idx[("NodeDaemon", "_worker_metrics")]
    assert wm["locked"] and wm["locks"] == ["self._lock"]
    st = idx[("FastPathRouter", "stats")]
    assert st["locked"] and st["locks"] == ["self._stats_lock"]
    assert idx[("NodeDaemon", "_metrics_seq")]["kind"] == "scalar"


def test_watchlist_resolves_dynamically():
    """Every static entry resolves to a live class of the port."""
    got = run_child([
        "from ray_tpu_torch.analysis import racer",
        "san = racer.RaceSanitizer().install()",
        "try:",
        "    out = [san.unresolved, bool(san._class_fields)]",
        "finally:",
        "    san.uninstall()",
        "print(json.dumps(out))",
    ])
    assert got == [[], True]


def _probe_lines(package, probe, bugs):
    return [
        f"from {package}.analysis import racer",
        f"r = racer.run_probe({probe!r}, seeded_bugs={bugs!r}, rounds=3)",
        "print(json.dumps({'detected': r.detected, 'rounds': r.rounds,"
        " 'races': r.races, 'unresolved': r.unresolved}, default=str))",
    ]


def _race_shape(r):
    """A race report without its thread ids, clocks and line numbers."""
    frames = [to_ref(s.rsplit(" ", 1)[-1]) for s in r["prior"]["stack"] + r["current"]["stack"]]
    return {
        "field": r["field"], "kind": r["kind"],
        "static_claim_violated": r.get("static_claim_violated"),
        "suggestion": to_ref(r.get("suggestion", "")),
        "threads": sorted([r["prior"]["thread"], r["current"]["thread"]]),
        "locks": sorted([len(r["prior"]["locks"]), len(r["current"]["locks"])]),
        "functions": sorted(set(frames)),
    }


@pytest.mark.parametrize("probe", sorted(ref_racer.RACE_PROBES))
def test_clean_probe_equals_reference(probe):
    want = run_child(_probe_lines("ray_tpu", probe, []))
    got = run_child(_probe_lines("ray_tpu_torch", probe, []))
    assert not got["detected"] and got["races"] == [] and got["unresolved"] == []
    assert got == want


@pytest.mark.parametrize("bug,probe", [(b, p) for b, _m, p in ref_racer.SEEDED_RACES])
def test_seeded_race_equals_reference(bug, probe):
    want = run_child(_probe_lines("ray_tpu", probe, [bug]))
    got = run_child(_probe_lines("ray_tpu_torch", probe, [bug]))
    assert got["detected"] and want["detected"]
    assert got["rounds"] == want["rounds"] == 1
    assert [_race_shape(r) for r in got["races"]] == [_race_shape(r) for r in want["races"]]


def test_seeded_bug_sets_restored_after_probe():
    got = run_child([
        "from ray_tpu_torch.analysis import racer",
        "from ray_tpu_torch.cluster import node_daemon",
        "from ray_tpu_torch.serve import fastpath",
        "for bug, _m, probe in racer.SEEDED_RACES:",
        "    racer.run_probe(probe, seeded_bugs=[bug])",
        "print(json.dumps([sorted(node_daemon.SEEDED_BUGS), sorted(fastpath.SEEDED_BUGS)]))",
    ])
    assert got == [[], []]


def test_dag_push_lookup_is_ordered_with_the_index_pop(tmp_path):
    """`rpc_dag_push`'s channel lookup (the daemon's event loop) against a
    pop of the channel index under the daemon's lock (a teardown on the
    GCS client's reader thread): the racer must see them ordered. The
    lookup was unlocked, a race the racer reported around a cluster whose
    GCS ran on the card (the reference's daemon reads it the same way)."""
    path = str(tmp_path / "k.chan")
    races = run_child([
        "import threading",
        "from ray_tpu_torch.analysis import racer",
        "from ray_tpu_torch.cluster.node_daemon import NodeDaemon",
        "wl = [e for e in racer.extract_watchlist() if e['cls'] == 'NodeDaemon']",
        "san = racer.RaceSanitizer(watchlist=wl).install()",
        "try:",
        "    d = object.__new__(NodeDaemon)",
        "    d._lock = threading.Lock()",
        "    d.node_id = 'node-x'",
        "    d._chan_index = {'k': None}",
        f"    d._chan_paths = {{'k': {path!r}}}",
        "    racer._barrier_pair(",
        "        lambda: NodeDaemon.rpc_dag_push(d, {'key': 'k', 'close': True}, None),",
        f"        lambda: NodeDaemon._close_serve_pair(d, {{'keys': ['k'], 'paths': [{path!r}]}}))",
        "finally:",
        "    san.uninstall()",
        "print(json.dumps(san.format_races() if san.races else ''))",
    ])
    assert races == ""


# --------------------- the reference's own tests, against the port's racer

CORE_TESTS = plain_tests(REF_TESTS, ("racer",))
# the watchlist and probe cases above compare the port with the reference
# on one extraction; these would extract it again per case
UNIT_TESTS = plain_tests(REF_TESTS, (), exclude={
    "test_watchlist_covers_control_plane_fields",
    "test_watchlist_pragma_keeps_static_claim",
    "test_watchlist_includes_scalar_fields",
    "test_watchlist_resolves_dynamically",
    "test_probes_clean_without_seeds",
})


def test_reference_cases_were_found():
    assert len(CORE_TESTS) >= 15 and len(UNIT_TESTS) >= 5


@pytest.mark.parametrize("name", CORE_TESTS)
def test_vector_clock_core_as_reference(name):
    """The port's racer scoped to the reference tests' synthetic class."""
    run_rebound("test_racer", name, NAMES,
                "fx = racer_mod.RaceSanitizer(watchlist=ref._wl())\nfx.install()")


@pytest.mark.parametrize("name", UNIT_TESTS)
def test_sanitizer_contract_as_reference(name):
    run_rebound("test_racer", name, NAMES)
