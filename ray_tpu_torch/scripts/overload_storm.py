"""Overload storm: bursty open-loop traffic past cluster saturation, A/B
over the overload control plane.

    python -m ray_tpu_torch.scripts.overload_storm [--seed N] [--duration S]
        [--mult-lo X] [--mult-hi X] [--smoke] [--json FILE]

Three phases on identical topologies (3 churn nodes x 2 CPU):

1. **peak** — open-loop at ~0.9x nominal capacity, no chaos, overload
   control ON: the single-rate throughput ceiling everything else is
   measured against.
2. **overload ON** — seeded bursty open-loop traffic at ``mult-lo``..
   ``mult-hi`` x capacity (per-100ms-tick multipliers) under chaos node
   kills, with the full control plane armed: GCS admission bound per
   driver + typed retryable rejections, client pacing + paced retries,
   and the advisory overload throttle push. The run is protocol-traced;
   the invariant checker replays it with the admission-conservation
   check in strict-terminal mode — every admitted task must terminally
   resolve.
3. **overload OFF** — the SAME seeded traffic and chaos on a fresh
   cluster with the control plane disabled: excess work piles into the
   GCS queues without bound and completion latency blows through the
   SLO — the collapse arm.

Goodput = tasks whose end-to-end latency (task-stamped completion time
minus submit time, collector-lag independent) is within the SLO, per
second of the submission window. Every submitted task is driven to a
TERMINAL outcome in the ON arm (value, typed ClusterOverloadedError, or
task error); ``silently_unresolved`` must be 0.

Gates (``--smoke`` relaxes the bars, same zero-silent-drop teeth):
goodput_ON >= ratio_bar x goodput_OFF (3x full / 2x smoke),
goodput_ON >= frac_bar x peak (0.6 full / 0.5 smoke), 0 silent drops,
0 invariant violations. Exit code: 0 = green, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import queue
import random
import sys
import threading
import time
from typing import Dict, List

# control-plane knobs for the ON arm: a tight per-driver admission bound
# (the cluster is tiny), fast retries, and low overload thresholds so the
# advisory throttle actually exercises
CONTROL_ON = {
    "admission_max_pending_per_driver": 48,
    "admission_retry_after_s": 0.1,
    "admission_pacing_enabled": True,
    "admission_pacing_max_s": 45.0,
    "overload_pending_high_per_cpu": 4.0,
    "overload_pending_low_per_cpu": 1.0,
    "log_to_driver": False,
}
# the A/B arm: admission off, pacing off, throttle thresholds unreachable
CONTROL_OFF = {
    "admission_max_pending_per_driver": 0,
    "admission_pacing_enabled": False,
    "overload_pending_high_per_cpu": 1e12,
    "overload_pending_low_per_cpu": 1e12,
    "log_to_driver": False,
}

N_NODES = 3
CPUS_PER_NODE = 2
WORK_S = 0.08  # per-task sleep -> nominal capacity = 6 CPU / 0.08 = 75/s
TICK_S = 0.1


def nominal_capacity() -> float:
    return N_NODES * CPUS_PER_NODE / WORK_S


def build_cluster(overrides: Dict):
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.cluster.cluster_utils import Cluster

    cluster = Cluster(config=Config(dict(overrides)))
    for _ in range(N_NODES):
        cluster.add_node(num_cpus=CPUS_PER_NODE)
    cluster.wait_for_nodes(N_NODES)
    return cluster


def burst_schedule(seed: int, duration_s: float, mult_lo: float,
                   mult_hi: float) -> List[int]:
    """Seeded per-tick burst sizes (tasks per 100ms tick) — byte-identical
    across both arms so the A/B comparison sees the SAME offered trace."""
    rng = random.Random(seed * 7919 + 13)
    cap = nominal_capacity()
    out = []
    for _ in range(int(duration_s / TICK_S)):
        mult = mult_lo + (mult_hi - mult_lo) * rng.random()
        out.append(max(1, int(round(mult * cap * TICK_S))))
    return out


def _chaos_loop(cluster, stop: threading.Event, seed: int,
                kill_period_s: float, stats: Dict):
    """Seeded churn-node kills, each replaced after a beat (capacity
    recovers; in-flight tasks on the victim retry)."""
    rng = random.Random(seed)
    while not stop.wait(kill_period_s * (0.7 + 0.6 * rng.random())):
        try:
            if len(cluster.daemons) < 2:
                continue  # keep a survivor for failover
            cluster.kill_node(rng.choice(cluster.daemons))
            stats["node_kills"] += 1
            time.sleep(0.5)
            cluster.add_node(num_cpus=CPUS_PER_NODE)
        except Exception as e:  # noqa: BLE001 - chaos must not kill the run
            print("chaos error:", repr(e), file=sys.stderr)


def run_phase(bursts: List[int], slo_s: float, chaos: bool, seed: int,
              kill_period_s: float, resolve_full: bool,
              cluster) -> Dict:
    """Drive one open-loop phase against an already-init'd runtime.

    resolve_full: ON-arm semantics — wait for EVERY ref to terminally
    resolve (the zero-silent-drop gate). The OFF arm instead bounds each
    wait at the SLO (+grace): its backlog is unbounded by construction
    and waiting it out would only measure the collector.
    """
    import ray_tpu_torch
    from ray_tpu_torch.core.exceptions import (
        ClusterOverloadedError,
        GetTimeoutError,
    )

    @ray_tpu_torch.remote(num_cpus=1, max_retries=8)
    def storm_task(work_s):
        time.sleep(work_s)
        return time.time()

    # warm the worker pool so phase 1 tasks don't pay process spawns
    ray_tpu_torch.get([storm_task.remote(0.001)
                 for _ in range(N_NODES * CPUS_PER_NODE)], timeout=60)

    stats = {"submitted": 0, "ok_slo": 0, "late": 0, "rejected": 0,
             "errors": 0, "silently_unresolved": 0, "node_kills": 0}
    q: "queue.Queue" = queue.Queue()

    def collector():
        while True:
            item = q.get()
            if item is None:
                return
            ref, submit_ts = item
            timeout = 90.0 if resolve_full else \
                max(0.01, submit_ts + slo_s + 2.0 - time.time())
            try:
                end = ray_tpu_torch.get(ref, timeout=timeout)
            except GetTimeoutError:
                # OFF arm: late-or-never — counted against goodput; the
                # ON arm's 90s bound makes this a SILENT DROP (gated 0)
                stats["silently_unresolved" if resolve_full
                      else "late"] += 1
                continue
            except ClusterOverloadedError:
                stats["rejected"] += 1  # typed terminal outcome
                continue
            except Exception:  # noqa: BLE001 - typed task error
                stats["errors"] += 1
                continue
            # classification by the TASK-stamped completion time, so a
            # lagging collector cannot misclassify
            if end - submit_ts <= slo_s:
                stats["ok_slo"] += 1
            else:
                stats["late"] += 1

    col = threading.Thread(target=collector, daemon=True)
    col.start()
    stop = threading.Event()
    chaos_t = None
    if chaos:
        chaos_t = threading.Thread(
            target=_chaos_loop,
            args=(cluster, stop, seed, kill_period_s, stats), daemon=True,
        )
        chaos_t.start()

    t0 = time.perf_counter()
    next_tick = t0
    for burst in bursts:
        for _ in range(burst):
            ts = time.time()
            ref = storm_task.remote(WORK_S)
            stats["submitted"] += 1
            q.put((ref, ts))
        next_tick += TICK_S
        delay = next_tick - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
    gen_wall = time.perf_counter() - t0
    stop.set()
    if chaos_t is not None:
        chaos_t.join(timeout=kill_period_s * 2)
    q.put(None)
    col.join(timeout=300.0)

    cap = nominal_capacity()
    return {
        "submitted": stats["submitted"],
        "offered_rate": round(stats["submitted"] / max(gen_wall, 1e-9), 1),
        "offered_mult": round(
            stats["submitted"] / max(gen_wall, 1e-9) / cap, 2),
        "gen_wall_s": round(gen_wall, 2),
        "goodput_rps": round(stats["ok_slo"] / max(gen_wall, 1e-9), 1),
        "ok_slo": stats["ok_slo"],
        "late": stats["late"],
        "rejected": stats["rejected"],
        "errors": stats["errors"],
        "silently_unresolved": stats["silently_unresolved"],
        "node_kills": stats["node_kills"],
        "slo_s": slo_s,
    }


def run_storm(seed: int = 7, duration_s: float = 12.0,
              peak_duration_s: float = 6.0, mult_lo: float = 2.0,
              mult_hi: float = 10.0, slo_s: float = 1.5,
              kill_period_s: float = 3.0, ratio_bar: float = 3.0,
              frac_bar: float = 0.6) -> Dict:
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.analysis import invariants

    bursts = burst_schedule(seed, duration_s, mult_lo, mult_hi)
    peak_bursts = burst_schedule(seed + 1, peak_duration_s, 0.9, 0.9)
    out: Dict = {
        "seed": seed,
        "nominal_capacity_rps": nominal_capacity(),
        "mult_range": [mult_lo, mult_hi],
    }

    # ---- arm A: control ON (peak phase, then the overload phase),
    # protocol-traced and admission-conservation-checked strict-terminal
    fd, trace_path = tempfile.mkstemp(
        prefix="overload_storm_trace_", suffix=".jsonl")
    import os as _os

    _os.close(fd)
    open(trace_path, "w").close()
    invariants.install(trace_path)
    cluster = build_cluster(CONTROL_ON)
    ray_tpu_torch.init(address=cluster.address, config=dict(CONTROL_ON))
    try:
        out["peak"] = run_phase(peak_bursts, slo_s, chaos=False,
                                seed=seed, kill_period_s=kill_period_s,
                                resolve_full=True, cluster=cluster)
        print("peak:", json.dumps(out["peak"]), flush=True)
        out["overload_on"] = run_phase(
            bursts, slo_s, chaos=True, seed=seed,
            kill_period_s=kill_period_s, resolve_full=True,
            cluster=cluster)
        print("overload ON:", json.dumps(out["overload_on"]), flush=True)
        from ray_tpu_torch.core import api as _api

        # the advisory throttle should have CLEARED by the time the ON
        # arm fully resolved (drained queue -> unthrottle push)
        out["final_overload_state"] = _api._runtime.overload_state()
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        invariants.uninstall()
    violations = invariants.check_trace(trace_path, strict_terminal=True)
    out["invariant_violations"] = [v.format() for v in violations]
    print(f"protocol trace: {trace_path} "
          f"({len(violations)} violations, strict-terminal incl. "
          "admission conservation)", flush=True)
    for v in violations:
        print("  " + v.format(), flush=True)

    # ---- arm B: control OFF (same bursts + chaos), the collapse arm
    cluster = build_cluster(CONTROL_OFF)
    ray_tpu_torch.init(address=cluster.address, config=dict(CONTROL_OFF))
    try:
        out["overload_off"] = run_phase(
            bursts, slo_s, chaos=True, seed=seed,
            kill_period_s=kill_period_s, resolve_full=False,
            cluster=cluster)
        print("overload OFF:", json.dumps(out["overload_off"]),
              flush=True)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()

    on = out["overload_on"]["goodput_rps"]
    off = out["overload_off"]["goodput_rps"]
    peak = out["peak"]["goodput_rps"]
    out["goodput_ratio_on_off"] = round(on / max(off, 1e-9), 2)
    out["on_frac_of_peak"] = round(on / max(peak, 1e-9), 3)
    out["gates"] = {
        "ratio_bar": ratio_bar,
        "frac_bar": frac_bar,
        "offered_ge_2x": out["overload_off"]["offered_mult"] >= 2.0,
        "ratio_ok": out["goodput_ratio_on_off"] >= ratio_bar,
        "frac_ok": out["on_frac_of_peak"] >= frac_bar,
        "zero_silent_drops":
            out["overload_on"]["silently_unresolved"] == 0
            and out["peak"]["silently_unresolved"] == 0,
        "invariants_clean": not out["invariant_violations"],
    }
    out["storm_pass"] = all(out["gates"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--mult-lo", type=float, default=2.0)
    ap.add_argument("--mult-hi", type=float, default=10.0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: short phases, 2-4x bursts, relaxed "
                         "ratio/frac bars (shared-box noise), same "
                         "zero-silent-drop + invariant teeth")
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args(argv)

    if args.smoke:
        rec = run_storm(seed=args.seed, duration_s=6.0,
                        peak_duration_s=3.0, mult_lo=3.0, mult_hi=6.0,
                        slo_s=1.2, kill_period_s=3.0, ratio_bar=2.0,
                        frac_bar=0.5)
    else:
        rec = run_storm(seed=args.seed, duration_s=args.duration,
                        mult_lo=args.mult_lo, mult_hi=args.mult_hi)
    print("storm:", json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=2)
        print("record ->", args.json, flush=True)
    print("OVERLOAD STORM:", "GREEN" if rec["storm_pass"] else "RED",
          flush=True)
    return 0 if rec["storm_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
