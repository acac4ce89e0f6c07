"""The port's scripts (ray_tpu_torch/scripts/: lint_gate and the three
storms) against the reference's (ray_tpu/scripts/): their option surfaces,
the storms' deterministic helpers equal to the reference's, and the
analysis gate on the port's tree (the storms themselves run in
test_torch_storms.py, the soaks in test_torch_soaks.py). Every process
runs with ``RAY_TPU_scheduler_device=cpu`` and a private ``TMPDIR``."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu.scripts import gray_storm as ref_gray
from ray_tpu.scripts import lint_gate as ref_lint_gate
from ray_tpu.scripts import overload_storm as ref_overload
from ray_tpu.scripts import serve_storm as ref_serve
from ray_tpu_torch.scripts import gray_storm as port_gray
from ray_tpu_torch.scripts import lint_gate as port_lint_gate
from ray_tpu_torch.scripts import overload_storm as port_overload
from ray_tpu_torch.scripts import serve_storm as port_serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other; one thread for this module, the count restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    env["RAY_TPU_scheduler_device"] = "cpu"
    env.pop("RAY_TPU_CHAOS_SPEC", None)
    return env


# ------------------------------------------------------- option surfaces


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(main, monkeypatch):
    """The ArgumentParser a script's main() builds, taken at parse_args."""
    def grab(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as exc:
            main([])
    return exc.value.parser


def _surface(parser):
    return [
        (tuple(a.option_strings), a.dest, type(a).__name__, a.default,
         getattr(a.type, "__name__", a.type), a.choices, a.nargs, a.required, a.help)
        for a in parser._actions if not isinstance(a, argparse._HelpAction)
    ]


@pytest.mark.parametrize("script", ["lint_gate", "serve_storm", "overload_storm",
                                    "gray_storm"])
def test_script_options_equal_reference(script, monkeypatch):
    ref = {"lint_gate": ref_lint_gate, "serve_storm": ref_serve,
           "overload_storm": ref_overload, "gray_storm": ref_gray}[script]
    port = {"lint_gate": port_lint_gate, "serve_storm": port_serve,
            "overload_storm": port_overload, "gray_storm": port_gray}[script]
    got = _surface(_parser_of(port.main, monkeypatch))
    want = _surface(_parser_of(ref.main, monkeypatch))
    if script == "lint_gate":  # the artifact directory's default is each package's REPO
        assert port.REPO == ref.REPO == REPO
    assert got == want


def test_lint_gate_files_are_the_ports():
    assert port_lint_gate.BASELINE == os.path.join(REPO, ".ray-lint-baseline-torch.json")
    with open(port_lint_gate.BASELINE) as f:
        assert json.load(f)["findings"] == {}
    # the tier-1 command in the reference's form, over the port's tests
    assert port_lint_gate.TIER1_CMD == ref_lint_gate.TIER1_CMD.replace(
        "pytest tests/ ", "pytest tests/test_torch_*.py ")


# ------------------------------------------- the storms' deterministic helpers


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_burst_schedule_equals_reference(seed):
    for duration, lo, hi in ((12.0, 2.0, 10.0), (6.0, 3.0, 6.0), (3.0, 0.9, 0.9),
                             (0.35, 1.0, 50.0)):
        assert port_overload.burst_schedule(seed, duration, lo, hi) == \
            ref_overload.burst_schedule(seed, duration, lo, hi)


def test_overload_constants_equal_reference():
    assert port_overload.nominal_capacity() == ref_overload.nominal_capacity() == 75.0
    for name in ("CONTROL_ON", "CONTROL_OFF", "N_NODES", "CPUS_PER_NODE", "WORK_S",
                 "TICK_S"):
        assert getattr(port_overload, name) == getattr(ref_overload, name), name


def test_gray_constants_and_node_ids_equal_reference():
    assert port_gray.node_ids() == ref_gray.node_ids() == [f"gray-{i}" for i in range(5)]
    for name in ("CONTROL_ON", "CONTROL_OFF", "N_NODES", "CPUS_PER_NODE", "N_SLOW",
                 "WORK_S"):
        assert getattr(port_gray, name) == getattr(ref_gray, name), name


@pytest.mark.parametrize("seed, factor", [(7, 25.0), (3, 12.0), (11, 2.5)])
def test_slow_spec_equals_reference(seed, factor):
    """The spec crosses process boundaries (RAY_TPU_CHAOS_SPEC): it names
    only the port's modules, and is otherwise the reference's."""
    got = json.dumps(port_gray.slow_spec(seed, factor), sort_keys=True)
    want = json.dumps(ref_gray.slow_spec(seed, factor), sort_keys=True)
    assert "ray_tpu" not in want.replace("ray_tpu_torch", "")
    assert "ray_tpu" not in got.replace("ray_tpu_torch", "")
    assert got == want.replace("ray_tpu.", "ray_tpu_torch.")
    from ray_tpu_torch.chaos.schedule import FaultSchedule

    assert FaultSchedule.from_spec(json.loads(got)).to_spec() == json.loads(got)


@pytest.mark.parametrize("n", [0, 1, 2, 999, 1000, 4097])
def test_percentile_equals_reference(n):
    vals = sorted(np.random.default_rng(n).exponential(0.01, size=n).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert port_serve._percentile(vals, q) == ref_serve._percentile(vals, q)


# --------------------------------------------------------- the analysis gate


def test_lint_gate_with_no_flags_passes_on_the_port(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.lint_gate",
         "--artifact-dir", str(tmp_path / "artifacts")],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: clean" in proc.stdout
    assert "baseline: empty (ratchet holds)" in proc.stdout
    assert "invariant method table round-trips" in proc.stdout
    lint = json.loads((tmp_path / "artifacts" / "lint.json").read_text())
    assert lint["new"] == [] and lint["files_scanned"] > 100
    protocol = json.loads((tmp_path / "artifacts" / "protocol.json").read_text())
    paths = {h["path"] for hs in protocol["handlers"].values() for h in hs}
    assert paths and all(p.startswith("ray_tpu_torch/") for p in paths), paths


def test_lint_gate_rpc_budget_measures_the_port(tmp_path):
    """``--rpc-budget`` drives rpcflow.measure_rpc_budget on an embedded
    port cluster (whose `import` of the package was broken: a NameError
    before the repair) and gates it on the committed budget."""
    with open(os.path.join(REPO, ".rpc-budget.json"), "rb") as f:
        budget = f.read()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.lint_gate", "--rpc-budget",
         "--rpc-budget-iters", "4", "--artifact-dir", str(tmp_path / "artifacts")],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "measured frames fit the committed budget" in proc.stdout
    art = json.loads((tmp_path / "artifacts" / "rpc_budget.json").read_text())
    assert set(art["measured"]) == set(json.loads(budget)["ops"])
    with open(os.path.join(REPO, ".rpc-budget.json"), "rb") as f:
        assert f.read() == budget  # read, never written
