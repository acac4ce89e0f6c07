"""Gray storm: seeded gray-failure A/B over the defense plane.

    python -m ray_tpu_torch.scripts.gray_storm [--seed N] [--waves N]
        [--slow-factor X] [--smoke] [--json FILE]

Topology: 5 nodes x 2 CPU with deterministic node ids; a seeded chaos
``slow`` rule stretches task execution 25x on 2 of the 5 nodes (the
nodes stay ALIVE on heartbeats — the canonical gray failure). The
workload is barrier waves of cluster-width gangs: submit one task per
CPU, wait for all, repeat — so, exactly as in the motivating failure
mode, each wave's latency collapses to its slowest replica.

Two arms on the SAME seeded slow-node trace:

1. **defense ON** — health scoring folds the slow nodes' duration EMAs
   into suspicion, quarantines them after the sustain window, probes
   keep them quarantined (the probe itself is slowed by the same rule),
   and straggler speculation re-runs wedged in-flight tasks on healthy
   nodes. The run is protocol-traced; the invariant checker replays it
   strict-terminal with the speculation invariants armed (exactly-one
   winning task_done apply, cancel-conservation on losers).
2. **defense OFF** — ``gray_defense_enabled: false``: same rules, same
   waves; every wave keeps paying the 25x replica.

Both arms exclude the same warmup-wave prefix from the latency stats:
the ON arm needs a few sweeps of completions before suspicion can see
the gray nodes (the defense *engaging* is what's under test; the bars
measure the recovered steady state).

Gates (``--smoke`` shrinks the run, same teeth): OFF p99 >= p99_bar x
ON p99 (3x), ON goodput >= goodput_bar x OFF (2x), every submission in
BOTH arms terminally resolved, 0 invariant violations (incl. duplicate
task_done applies), >= 1 node actually quarantined in the ON arm.
Exit code: 0 = green, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

N_NODES = 5
CPUS_PER_NODE = 2
N_SLOW = 2
WORK_S = 0.05

# defense ON: fast sweeps + short sustain so quarantine engages within
# the warmup prefix on a tiny cluster; speculation floor above WORK_S so
# healthy tasks are never eligible
CONTROL_ON = {
    "gray_defense_enabled": True,
    "health_check_period_ms": 250.0,
    "quarantine_sustain_sweeps": 2,
    "probe_interval_s": 0.5,
    "speculation_quantile_factor": 3.0,
    "speculation_min_elapsed_s": 0.3,
    "log_to_driver": False,
}
CONTROL_OFF = {
    "gray_defense_enabled": False,
    "health_check_period_ms": 250.0,
    "log_to_driver": False,
}


def node_ids() -> List[str]:
    return [f"gray-{i}" for i in range(N_NODES)]


def slow_spec(seed: int, factor: float) -> Dict:
    """Chaos spec slowing the LAST ``N_SLOW`` nodes by ``factor`` on
    every execution (p=1.0: gray, not flaky). Exported via the
    RAY_TPU_CHAOS_SPEC env payload so worker subprocesses join the same
    fault plane; byte-identical across both arms."""
    from ray_tpu_torch import chaos

    # first-match-wins: the method-scoped inf rule (wedge_task on the
    # last slow node wedges FOREVER — the speculation-rescue phase)
    # shadows the generic 25x rule for that one class only
    rules = [chaos.slow(node=node_ids()[-1], factor=float("inf"),
                        p=1.0, method="wedge_task")]
    rules += [chaos.slow(node=nid, factor=factor, p=1.0)
              for nid in node_ids()[-N_SLOW:]]
    from ray_tpu_torch.chaos.schedule import FaultSchedule

    return FaultSchedule(seed=seed, rules=rules).to_spec()


def build_cluster(overrides: Dict):
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.cluster.cluster_utils import Cluster

    cluster = Cluster(config=Config(dict(overrides)))
    for nid in node_ids():
        cluster.add_node(num_cpus=CPUS_PER_NODE, node_id=nid)
    cluster.wait_for_nodes(N_NODES)
    return cluster


def run_arm(n_waves: int, warmup_waves: int, slo_s: float) -> Dict:
    """Drive barrier waves; per-task end-to-end latencies from the
    task-stamped completion time (collector-lag independent)."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch.core.exceptions import GetTimeoutError

    @ray_tpu_torch.remote(num_cpus=1, max_retries=4)
    def gang_task(work_s):
        time.sleep(work_s)
        return True

    wave_width = N_NODES * CPUS_PER_NODE
    lat: List[float] = []          # measured waves only
    warm_lat: List[float] = []
    stats = {"submitted": 0, "resolved": 0, "errors": 0,
             "silently_unresolved": 0}
    lock = threading.Lock()

    def collect(ref, submit_ts: float, sink: List[float]) -> None:
        # latency is stamped DRIVER-side at resolution: a chaos-stalled
        # execution stalls after the fn body, so a task-side stamp would
        # hide exactly the gray slowness under test
        try:
            ray_tpu_torch.get(ref, timeout=120.0)
            dt = time.time() - submit_ts
            with lock:
                stats["resolved"] += 1
                sink.append(dt)
        except GetTimeoutError:
            with lock:
                stats["silently_unresolved"] += 1
        except Exception:  # noqa: BLE001 - typed task error, terminal
            with lock:
                stats["errors"] += 1
                stats["resolved"] += 1

    t_meas0 = None
    t0 = time.perf_counter()
    for w in range(n_waves):
        if w == warmup_waves:
            t_meas0 = time.perf_counter()
        submit_ts = time.time()
        refs = [gang_task.remote(WORK_S) for _ in range(wave_width)]
        stats["submitted"] += wave_width
        sink = lat if w >= warmup_waves else warm_lat
        threads = [threading.Thread(target=collect,
                                    args=(ref, submit_ts, sink),
                                    daemon=True)
                   for ref in refs]
        for t in threads:
            t.start()
        for t in threads:  # wave barrier
            t.join(timeout=150.0)
    wall = time.perf_counter() - t0
    meas_wall = time.perf_counter() - (t_meas0 or t0)

    lat.sort()

    def pct(q: float) -> float:
        if not lat:
            return float("nan")
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    ok_slo = sum(1 for x in lat if x <= slo_s)
    return {
        "waves": n_waves,
        "warmup_waves": warmup_waves,
        "submitted": stats["submitted"],
        "resolved": stats["resolved"],
        "errors": stats["errors"],
        "silently_unresolved": stats["silently_unresolved"],
        "wall_s": round(wall, 2),
        "p50_s": round(pct(0.50), 4),
        "p95_s": round(pct(0.95), 4),
        "p99_s": round(pct(0.99), 4),
        "max_s": round(max(lat), 4) if lat else float("nan"),
        "ok_slo": ok_slo,
        "goodput_rps": round(ok_slo / max(meas_wall, 1e-9), 1),
        "slo_s": slo_s,
    }


def run_wedge_phase(deadline_s: float) -> Dict:
    """Straggler-speculation rescue: one cluster-width gang of a class
    the chaos spec wedges FOREVER on the last slow node. Without
    speculation those refs never resolve (the node stays ALIVE on
    heartbeats — retries never trigger); the defense must re-run them on
    healthy nodes within the deadline."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=1, max_retries=2)
    def wedge_task(work_s):
        time.sleep(work_s)
        return True

    t0 = time.perf_counter()
    refs = [wedge_task.remote(0.02)
            for _ in range(N_NODES * CPUS_PER_NODE)]
    resolved = unresolved = 0
    for ref in refs:
        budget = max(0.1, deadline_s - (time.perf_counter() - t0))
        try:
            ray_tpu_torch.get(ref, timeout=budget)
            resolved += 1
        except Exception:  # noqa: BLE001 - timeout = not rescued
            unresolved += 1
    return {
        "submitted": len(refs),
        "resolved": resolved,
        "unresolved": unresolved,
        "deadline_s": deadline_s,
        "wall_s": round(time.perf_counter() - t0, 2),
    }


def _trace_spec_stats(trace_path: str) -> Dict:
    """Speculation activity observed in the protocol trace."""
    launched = cancels = promotes = quarantines = 0
    with open(trace_path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            k = ev.get("k")
            if k == "dispatch" and ev.get("speculative"):
                launched += 1
            elif k == "spec_cancel":
                cancels += 1
            elif k == "spec_promote":
                promotes += 1
            elif k == "node_quarantine" and ev.get("quarantined"):
                quarantines += 1
    return {"speculative_launches": launched, "spec_cancels": cancels,
            "spec_promotes": promotes, "quarantine_events": quarantines}


def run_storm(seed: int = 7, n_waves: int = 28, warmup_waves: int = 6,
              slow_factor: float = 25.0, slo_s: float = 0.5,
              p99_bar: float = 3.0, goodput_bar: float = 2.0) -> Dict:
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import chaos
    from ray_tpu_torch.analysis import invariants

    out: Dict = {
        "seed": seed,
        "topology": f"{N_NODES}x{CPUS_PER_NODE}cpu, "
                    f"{N_SLOW} slowed {slow_factor:g}x",
        "work_s": WORK_S,
        "slow_nodes": node_ids()[-N_SLOW:],
    }
    # same seeded slow-node trace for both arms; workers inherit the env
    os.environ["RAY_TPU_CHAOS_SPEC"] = json.dumps(
        slow_spec(seed, slow_factor))
    # the daemons (and their probe hook) run in THIS process: install here
    chaos.install_from_env()

    # ---- arm A: defense ON, protocol-traced, strict-terminal checked
    fd, trace_path = tempfile.mkstemp(
        prefix="gray_storm_trace_", suffix=".jsonl")
    os.close(fd)
    open(trace_path, "w").close()
    invariants.install(trace_path)
    cluster = build_cluster(CONTROL_ON)
    ray_tpu_torch.init(address=cluster.address, config=dict(CONTROL_ON))
    try:
        out["wedge"] = run_wedge_phase(deadline_s=20.0)
        print("wedge rescue:", json.dumps(out["wedge"]), flush=True)
        out["defense_on"] = run_arm(n_waves, warmup_waves, slo_s)
        print("defense ON:", json.dumps(out["defense_on"]), flush=True)
        nodes = ray_tpu_torch.nodes()
        out["on_quarantined"] = sorted(
            n["NodeID"] for n in nodes if n.get("Quarantined"))
        out["on_health"] = {n["NodeID"]: n.get("Health", "OK")
                            for n in nodes}
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        invariants.uninstall()
    violations = invariants.check_trace(trace_path, strict_terminal=True)
    out["invariant_violations"] = [v.format() for v in violations]
    out.update(_trace_spec_stats(trace_path))
    print(f"protocol trace: {trace_path} ({len(violations)} violations, "
          "strict-terminal incl. speculation conservation)", flush=True)
    for v in violations:
        print("  " + v.format(), flush=True)

    # ---- arm B: defense OFF, same chaos spec, same waves
    cluster = build_cluster(CONTROL_OFF)
    ray_tpu_torch.init(address=cluster.address, config=dict(CONTROL_OFF))
    try:
        out["defense_off"] = run_arm(n_waves, warmup_waves, slo_s)
        print("defense OFF:", json.dumps(out["defense_off"]), flush=True)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        chaos.uninstall()
        os.environ.pop("RAY_TPU_CHAOS_SPEC", None)

    on, off = out["defense_on"], out["defense_off"]
    out["p99_ratio_off_on"] = round(
        off["p99_s"] / max(on["p99_s"], 1e-9), 2)
    out["goodput_ratio_on_off"] = round(
        on["goodput_rps"] / max(off["goodput_rps"], 1e-9), 2)
    out["gates"] = {
        "p99_bar": p99_bar,
        "goodput_bar": goodput_bar,
        "p99_ok": out["p99_ratio_off_on"] >= p99_bar,
        "goodput_ok": out["goodput_ratio_on_off"] >= goodput_bar,
        "all_resolved":
            on["silently_unresolved"] == 0
            and off["silently_unresolved"] == 0
            and on["resolved"] == on["submitted"]
            and off["resolved"] == off["submitted"],
        "wedge_rescued":
            out["wedge"]["unresolved"] == 0
            and out["speculative_launches"] >= 1,
        "quarantine_engaged": bool(out["on_quarantined"]),
        "invariants_clean": not out["invariant_violations"],
    }
    out["storm_pass"] = all(out["gates"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--waves", type=int, default=28)
    ap.add_argument("--warmup-waves", type=int, default=6)
    ap.add_argument("--slow-factor", type=float, default=25.0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: fewer waves, same 25x slow rule and "
                         "the same zero-unresolved + invariant teeth")
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args(argv)

    if args.smoke:
        rec = run_storm(seed=args.seed, n_waves=14, warmup_waves=5,
                        slow_factor=args.slow_factor, p99_bar=3.0,
                        goodput_bar=2.0)
    else:
        rec = run_storm(seed=args.seed, n_waves=args.waves,
                        warmup_waves=args.warmup_waves,
                        slow_factor=args.slow_factor)
    print("gray storm:", json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=2)
        print("record ->", args.json, flush=True)
    print("GRAY STORM:", "GREEN" if rec["storm_pass"] else "RED",
          flush=True)
    return 0 if rec["storm_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
