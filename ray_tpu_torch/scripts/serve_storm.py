"""Serve storm: closed-loop load against the serve fast path under chaos,
with an SLO gate.

    python -m ray_tpu_torch.scripts.serve_storm [--seed N] [--duration S]
        [--clients C] [--replicas R] [--no-chaos] [--compare] [--smoke]
        [--json FILE]

Builds an embedded cluster (one STABLE node pinning the serve controller +
churn nodes), deploys a ``fast_path=True`` synthetic model, and drives it
with C closed-loop client threads while a seeded chaos thread alternates
REPLICA KILLS (worker process of a pair-attached replica) and NODE KILLS
(a churn node, replaced after a beat). Every response is value-checked.

Measured: p50/p99/p999 latency, goodput (verified responses/s), error
budget, and the router's rerouted/duplicate counters. The SLO gate
(``slo_pass``) requires: zero LOST responses (a submitted request whose
result neither arrived nor errored inside its deadline), zero DUPLICATE
deliveries, zero wrong values, error rate within budget (default 1%%),
and p99 under the chaos bound. ``--compare`` also runs the task-layer
serve path (fast_path=False) on the same topology with no chaos and
reports the throughput ratio — the >=5x absorption bar.

Exit code: 0 = SLO green (and, with --compare, ratio >= 5), 1 otherwise.

The embedded cluster's GCS schedules with the default policy, torch_cuda
on the card (set ``RAY_TPU_jax_policy_min_cells=0`` to send rounds this
small to the card, and ``RAY_TPU_scheduler_device=cpu`` where there is
none). Measured runs are in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
from typing import Dict, List, Optional


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def build_cluster(n_churn: int = 2, num_cpus: int = 4):
    """STABLE node (controller pin) + churn nodes (replica fodder)."""
    from ray_tpu_torch.cluster.cluster_utils import Cluster

    cluster = Cluster()
    cluster.add_node(num_cpus=num_cpus, resources={"STABLE": 100},
                     node_id="stable")
    for _ in range(n_churn):
        cluster.add_node(num_cpus=num_cpus)
    cluster.wait_for_nodes(1 + n_churn)
    return cluster


def _deploy(serve, fast_path: bool, replicas: int):
    @serve.deployment(num_replicas=replicas, fast_path=fast_path,
                      max_ongoing_requests=32, name="storm_model")
    def storm_model(x):
        return x * 3 + 1

    return serve.run(storm_model.bind(), name="storm", route_prefix=None)


def _closed_loop(handle, clients: int, duration_s: float,
                 timeout_s: float, stats: Dict, lat: List[float]):
    """C threads, each: submit -> verify -> repeat. Each thread counts
    locally and merges under a lock at exit (the counters are the SLO
    gate's inputs — racing dict `+=` across threads loses updates);
    latencies ride GIL-atomic list.append."""
    stop_at = time.perf_counter() + duration_s
    merge_lock = threading.Lock()

    def worker(k: int):
        local = {"ok": 0, "errors": 0, "lost": 0, "value_errors": 0}
        i = k * 1_000_000
        while time.perf_counter() < stop_at:
            i += 1
            t0 = time.perf_counter()
            try:
                v = handle.remote(i).result(timeout=timeout_s)
            except Exception as e:  # noqa: BLE001 - counted, not fatal
                from ray_tpu_torch.core.exceptions import GetTimeoutError

                if isinstance(e, GetTimeoutError):
                    local["lost"] += 1  # no response inside the deadline
                else:
                    local["errors"] += 1
                continue
            lat.append(time.perf_counter() - t0)
            if v != i * 3 + 1:
                local["value_errors"] += 1
            else:
                local["ok"] += 1
        with merge_lock:
            for key, n in local.items():
                stats[key] += n

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _chaos_loop(cluster, stop: threading.Event, seed: int,
                kill_period_s: float, stats: Dict):
    """Seeded chaos: alternate replica-worker kills and churn-node kills
    (node replaced after a beat so capacity recovers)."""
    rng = random.Random(seed)
    while not stop.wait(kill_period_s * (0.7 + 0.6 * rng.random())):
        try:
            if rng.random() < 0.6:
                # replica kill: a worker with fast-path pairs attached
                victims = [
                    w
                    for d in cluster.daemons
                    for w in list(d.workers.values())
                    if w.serve_pairs and w.proc is not None
                ]
                if not victims:
                    continue
                rng.choice(victims).proc.kill()
                stats["replica_kills"] += 1
            else:
                churn = [d for d in cluster.daemons
                         if d.node_id != "stable"]
                if len(churn) < 2:
                    continue  # keep one churn node alive for failover
                cluster.kill_node(rng.choice(churn))
                stats["node_kills"] += 1
                time.sleep(0.5)
                cluster.add_node(num_cpus=4)
        except Exception as e:  # noqa: BLE001 - chaos must not kill the run
            print("chaos error:", repr(e), file=sys.stderr)


def run_storm(duration_s: float = 20.0, clients: int = 32,
              replicas: int = 3, chaos: bool = True, seed: int = 7,
              kill_period_s: float = 8.0, timeout_s: float = 30.0,
              fast_path: bool = True, cluster=None,
              error_budget: float = 0.01, p99_bound_s: float = 2.0) -> Dict:
    """One storm phase; returns the measured record (see module doc)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    own_cluster = cluster is None
    if own_cluster:
        cluster = build_cluster()
    serve_api.CONTROLLER_OPTIONS = {"resources": {"STABLE": 0.01}}
    ray_tpu_torch.init(address=cluster.address,
                 config={"log_to_driver": False})
    stats = {"ok": 0, "errors": 0, "lost": 0, "value_errors": 0,
             "replica_kills": 0, "node_kills": 0}
    lat: List[float] = []
    try:
        handle = _deploy(serve, fast_path, replicas)
        assert handle.remote(1).result(timeout=30.0) == 4  # warm
        stop = threading.Event()
        chaos_t = None
        if chaos:
            chaos_t = threading.Thread(
                target=_chaos_loop,
                args=(cluster, stop, seed, kill_period_s, stats),
                daemon=True,
            )
            chaos_t.start()
        t0 = time.perf_counter()
        _closed_loop(handle, clients, duration_s, timeout_s, stats, lat)
        wall = time.perf_counter() - t0
        stop.set()
        if chaos_t is not None:
            chaos_t.join(timeout=kill_period_s * 2)
        fp = handle.fastpath_stats() if fast_path else None
    finally:
        serve.shutdown()
        serve_api.CONTROLLER_OPTIONS = {}
        ray_tpu_torch.shutdown()
        if own_cluster:
            cluster.shutdown()
    lat.sort()
    total = stats["ok"] + stats["errors"] + stats["lost"] \
        + stats["value_errors"]
    error_rate = (stats["errors"] + stats["value_errors"]) / max(total, 1)
    rec = {
        "fast_path": fast_path,
        "chaos": chaos,
        "seed": seed,
        "duration_s": round(wall, 2),
        "clients": clients,
        "replicas": replicas,
        "requests": total,
        "ok": stats["ok"],
        "errors": stats["errors"],
        "lost": stats["lost"],
        "value_errors": stats["value_errors"],
        "replica_kills": stats["replica_kills"],
        "node_kills": stats["node_kills"],
        "goodput_rps": round(stats["ok"] / max(wall, 1e-9), 1),
        "error_rate": round(error_rate, 5),
        "p50_ms": round(_percentile(lat, 0.50) * 1e3, 2),
        "p99_ms": round(_percentile(lat, 0.99) * 1e3, 2),
        "p999_ms": round(_percentile(lat, 0.999) * 1e3, 2),
        "rerouted": (fp or {}).get("rerouted", 0),
        "duplicates": (fp or {}).get("duplicates", 0),
    }
    rec["slo_pass"] = bool(
        stats["lost"] == 0
        and rec["duplicates"] == 0
        and stats["value_errors"] == 0
        and error_rate <= error_budget
        and (not chaos or rec["p99_ms"] <= p99_bound_s * 1e3)
        and stats["ok"] > 0
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--clients", type=int, default=48)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--no-chaos", action="store_true",
                    help="pure throughput run, no kills")
    ap.add_argument("--compare", action="store_true",
                    help="also run the task-layer serve path (no chaos) "
                         "and report fastpath/task throughput ratio "
                         "(gate: >= 5x)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: short phases, relaxed p99 bound "
                         "(shared-box scheduling noise), same zero-lost/"
                         "zero-dup/zero-wrong gates")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the full record as JSON")
    args = ap.parse_args(argv)

    duration = 6.0 if args.smoke else args.duration
    p99_bound = 10.0 if args.smoke else 2.0
    kill_period = 2.0 if args.smoke else 8.0
    out: Dict = {"seed": args.seed}

    if args.compare:
        base = run_storm(duration_s=duration, clients=args.clients,
                         replicas=args.replicas, chaos=False,
                         seed=args.seed, fast_path=False)
        print("task-layer baseline:", json.dumps(base), flush=True)
        out["task_layer"] = base
        fast = run_storm(duration_s=duration, clients=args.clients,
                         replicas=args.replicas, chaos=False,
                         seed=args.seed, fast_path=True)
        print("fastpath no-chaos:", json.dumps(fast), flush=True)
        out["fastpath"] = fast
        ratio = fast["goodput_rps"] / max(base["goodput_rps"], 1e-9)
        out["speedup"] = round(ratio, 2)
        print(f"speedup: {out['speedup']}x (gate >= 5)", flush=True)

    storm = run_storm(duration_s=duration, clients=args.clients,
                      replicas=args.replicas, chaos=not args.no_chaos,
                      seed=args.seed, kill_period_s=kill_period,
                      p99_bound_s=p99_bound)
    print("storm:", json.dumps(storm), flush=True)
    out["storm"] = storm

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print("record ->", args.json, flush=True)

    ok = storm["slo_pass"] and (
        not args.compare or out["speedup"] >= 5.0
    )
    print("SLO:", "GREEN" if ok else "RED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
