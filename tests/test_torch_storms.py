"""The port's three storms (ray_tpu_torch/scripts/{serve,overload,gray}_storm.py),
each run by its ``main`` at its ``--smoke`` settings in a fresh process.

A storm's timing bars (goodput ratios, p99 bounds, the wedge's deadline)
depend on the machine's load and are checked on the card only
(chip_smoke.py phase 20b); here each storm is held to its exactness gates:
nothing lost, duplicated or wrong, nothing silently unresolved, and a clean
strict-terminal invariant check. Every process runs with
``RAY_TPU_scheduler_device=cpu`` and a private ``TMPDIR``."""

import json
import subprocess
import sys

from test_torch_scripts import _env


def _storm(tmp_path, script):
    art = tmp_path / f"{script}.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"ray_tpu_torch.scripts.{script}", "--smoke",
         "--json", str(art)],
        cwd=str(tmp_path), env=_env(tmp_path), capture_output=True, text=True,
        timeout=600)
    # 0 green, 1 a gate red (the timing bars are the card's to hold)
    assert proc.returncode in (0, 1), proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(art.read_text()), proc


def test_serve_storm_smoke_exact(tmp_path):
    rec, proc = _storm(tmp_path, "serve_storm")
    s = rec["storm"]
    assert s["chaos"] and s["fast_path"] and s["clients"] == 48 and s["replicas"] == 3
    assert s["ok"] > 0, s
    assert (s["lost"], s["duplicates"], s["value_errors"]) == (0, 0, 0), s
    assert s["replica_kills"] + s["node_kills"] > 0, s


def test_overload_storm_smoke_exact(tmp_path):
    rec, proc = _storm(tmp_path, "overload_storm")
    assert rec["mult_range"] == [3.0, 6.0]
    for arm in ("peak", "overload_on", "overload_off"):
        assert rec[arm]["submitted"] > 0
    assert rec["gates"]["zero_silent_drops"], rec
    assert rec["gates"]["invariants_clean"], rec["invariant_violations"]
    on = rec["overload_on"]
    for arm in ("peak", "overload_on"):  # every admitted ref ends terminally
        r = rec[arm]
        assert r["ok_slo"] + r["late"] + r["rejected"] + r["errors"] == r["submitted"], r
    assert rec["overload_off"]["offered_mult"] >= 2.0


def test_gray_storm_smoke_exact(tmp_path):
    rec, proc = _storm(tmp_path, "gray_storm")
    on, off = rec["defense_on"], rec["defense_off"]
    assert on["waves"] == off["waves"] == 14
    assert rec["gates"]["all_resolved"], (on, off)
    assert rec["gates"]["invariants_clean"], rec["invariant_violations"]
    assert rec["slow_nodes"] == ["gray-3", "gray-4"]
