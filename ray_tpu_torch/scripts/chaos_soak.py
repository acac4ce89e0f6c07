"""Chaos soak: continuous task/actor/PG load under a seeded fault plane.

Not a pytest test (runtime is minutes by design): run as
    python -m ray_tpu_torch.scripts.chaos_soak [--seed N] [--duration S]
and read the rolling stats. Every task result is value-checked; "errors"
must stay 0 — expected_actor_errs counts actor calls in flight at a node
kill (at-most-once semantics, reference behavior).

The fault plane is a ray_tpu_torch.chaos.FaultSchedule: node kills fire from
seeded kill rules consulted once per loop iteration (the step() hook), and
frame-level faults (driver->GCS resets, daemon->GCS drops) ride the RPC
hook points. The workload mix is driven by the same seed, so two runs with
one seed replay the same soak — compare their sched.trace_text() to verify.
Every run is also protocol-traced and invariant-checked post-hoc
(analysis/invariants.py): the process exits 1 on any exactly-once /
capacity-conservation / 2PC / ordering violation.
The cluster's GCS schedules with the default policy, torch_cuda on the
card (``RAY_TPU_jax_policy_min_cells=0`` sends rounds this small to the
card; ``RAY_TPU_scheduler_device=cpu`` where there is none). Measured runs
are in PERF.md.
"""
import argparse
import os
import random
import time

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import chaos
from ray_tpu_torch.cluster.cluster_utils import Cluster

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--seed", type=int, default=7,
                help="fault-schedule + workload seed (same seed = same soak)")
ap.add_argument("--duration", type=float, default=600.0, help="seconds")
ap.add_argument("--trace", default=None, metavar="FILE",
                help="protocol-trace JSONL path (default: a fresh temp "
                     "file); the run is invariant-checked post-hoc and "
                     "exits 1 on violations")
ap.add_argument("--dag", action="store_true",
                help="mix a compiled-DAG pipeline into the workload: "
                     "iterations ride shm channels; node kills break the "
                     "pipeline (ChannelClosedError) and it is torn down "
                     "and recompiled — exercising the rpc_dag_* plane "
                     "under churn")
ap.add_argument("--bursty", action="store_true",
                help="mix seeded submission BURSTS into the workload and "
                     "arm the overload control plane (tight per-driver "
                     "admission bound + pacing + advisory throttle): "
                     "bursts overrun the bound, rejections pace-and-"
                     "retry, and every task still terminally resolves — "
                     "typed ClusterOverloadedError outcomes are counted "
                     "separately, never as errors")
ap.add_argument("--race", action="store_true",
                help="run the whole soak under the happens-before race "
                     "sanitizer (analysis/racer.py): every watched "
                     "control-plane field proxy-instrumented, every "
                     "lock/thread/queue/executor edge vector-clocked; "
                     "EXITS 1 on any detected race, with both access "
                     "stacks in a race-*.jsonl artifact")
ap.add_argument("--stall", action="store_true",
                help="run the whole soak under the wait-graph deadlock & "
                     "stall sanitizer (analysis/waitgraph.py): every "
                     "lock/queue/future/executor wait and channel park "
                     "edges into a live cross-thread wait-for graph; "
                     "EXITS 1 on any deadlock report or any unattributed "
                     "stall > 30s, with stacks in a waitgraph-*.jsonl "
                     "artifact")
ap.add_argument("--gray", action="store_true",
                help="mix seeded gray failures into the fault plane: a "
                     "probabilistic chaos ``slow`` rule stretches task "
                     "executions 12x on whatever node they land on, with "
                     "the gray defense plane armed fast (250ms sweeps, "
                     "2-sweep quarantine sustain, 0.5s probes) — "
                     "exercising suspicion scoring, speculation, and the "
                     "quarantine/probation lifecycle under node churn; "
                     "slowed tasks still terminally resolve, so the 0-"
                     "errors gate is unchanged")
ap.add_argument("--serve", action="store_true",
                help="mix serve fast-path deployments into the workload: "
                     "bursts of channel-plane requests against "
                     "fast_path=True replicas while nodes die; prints "
                     "goodput + rerouted/duplicate counts and EXITS 1 on "
                     "any duplicate or lost response (exactly-once "
                     "delivery under churn)")


def main(argv=None):
    args = ap.parse_args(argv)

    # Every soak run is invariant-checked post-hoc (analysis/invariants.py):
    # "survived" means exactly-once task_done, conserved capacity, legal PG
    # 2PC, ordered actor execs — not just "didn't crash".
    from ray_tpu_torch.analysis import invariants

    if args.trace:
        trace_path = args.trace
        # the tracer appends; a leftover file from a previous run would feed
        # stale events into this run's invariant check
        open(trace_path, "w").close()
    else:
        import tempfile

        _fd, trace_path = tempfile.mkstemp(
            prefix="chaos_soak_trace_", suffix=".jsonl"
        )
        import os as _os

        _os.close(_fd)
    invariants.install(trace_path)

    # --race: the dynamic half of the hybrid race sanitizer rides the whole
    # soak. Installed BEFORE the cluster exists so every lock/thread/queue
    # the control plane allocates is instrumented from birth.
    race_san = None
    if args.race:
        from ray_tpu_torch.analysis import racer as _racer

        race_san = _racer.RaceSanitizer().install()
        assert not race_san.unresolved, race_san.unresolved

    # --stall: the wait-graph sanitizer rides the whole soak maintaining the
    # live wait-for graph. Installed BEFORE the cluster exists (same rule as
    # the racer: every lock/queue/executor/channel the control plane
    # allocates must be instrumented from birth); its stall watchdog
    # attributes any wait older than 30s into waitgraph-*.jsonl artifacts.
    wait_san = None
    if args.stall:
        from ray_tpu_torch.analysis import waitgraph as _waitgraph

        wait_san = _waitgraph.WaitSanitizer(stall_warn_s=30.0).install()

    # Per-operation RPC accounting rides the whole soak (analysis/rpcflow):
    # installed LAST so it wraps whichever tracer is active (the invariant
    # file tracer, or the race sanitizer when --race) and delegates every
    # hook to it. The exit table prints frames/op against the committed
    # budget; an order-of-magnitude breach fails the soak.
    from ray_tpu_torch.analysis import rpcflow as _rpcflow

    rpc_prof = _rpcflow.RpcProfiler().install()
    rpc_budget = _rpcflow.load_budget(
        os.path.join(_rpcflow.repo_root(), _rpcflow.DEFAULT_BUDGET_FILE))

    rng = random.Random(args.seed)  # workload mix (tasks vs actors vs PGs)
    _rules = [
        # ~1 node kill per 25 loop iterations, deterministic per seed
        chaos.kill(label="soak", p=0.04, target="churn"),
        # occasional driver->GCS resets exercise the reconnect plane
        chaos.reset(src="driver-*", dst="gcs", p=0.002, hook="client_send"),
        # lossy daemon->GCS link exercises call retries
        chaos.drop(src="node-*", dst="gcs", p=0.001, hook="client_send"),
    ]
    if args.gray:
        # seeded gray failures: ~3% of executions run 12x slow, anywhere —
        # enough to light up suspicion/speculation/probation without wedging
        # any task past its get() timeout (0.02s * 12 << 60s)
        _rules.append(chaos.slow(node="*", factor=12.0, p=0.03))
    sched = chaos.install(chaos.FaultSchedule(seed=args.seed, rules=_rules))

    _overrides = {}
    if args.gray:
        # arm the defense plane fast so the short soak actually cycles the
        # quarantine/probation lifecycle (the probe path is also chaos-slowed
        # by the same rule, so sticky quarantine gets exercised too)
        _overrides.update({
            "health_check_period_ms": 250.0,
            "quarantine_sustain_sweeps": 2,
            "probe_interval_s": 0.5,
            "speculation_min_elapsed_s": 0.15,
        })
    if args.bursty:
        # arm the overload control plane so the burst mix exercises it: a
        # small per-driver admission bound, fast pacing, and low throttle
        # thresholds (the soak gate still requires 0 task errors — typed
        # overload rejections are budgeted separately below)
        _overrides.update({
            "admission_max_pending_per_driver": 48,
            "admission_retry_after_s": 0.1,
            "admission_pacing_enabled": True,
            "admission_pacing_max_s": 60.0,
            "overload_pending_high_per_cpu": 6.0,
            "overload_pending_low_per_cpu": 2.0,
        })
    from ray_tpu_torch.core.config import Config as _Config

    cluster = Cluster(config=_Config(dict(_overrides)))
    # STABLE resource: the --serve mix pins the serve controller here so the
    # control plane survives churn-node kills (replicas still float and die)
    stable = cluster.add_node(num_cpus=2, node_id="stable",
                              resources={"STABLE": 100})
    for _ in range(2):
        cluster.add_node(num_cpus=2)


    _kill_lock = __import__("threading").Lock()


    def kill_one_churn_node():
        # each fired kill rule runs on its own thread; overlapping invocations
        # would double-kill one victim and over-grow the replacement pool
        if not _kill_lock.acquire(blocking=False):
            return
        try:
            victims = [d for d in cluster.daemons if d.node_id != "stable"]
            if len(victims) < 2:
                return  # keep at least one churn node alive for in-flight work
            cluster.kill_node(victims[0])
            stats["kills"] += 1
            time.sleep(0.5)
            cluster.add_node(num_cpus=2)
        finally:
            _kill_lock.release()


    sched.register_kill("churn", kill_one_churn_node)
    ray_tpu_torch.init(address=cluster.address, config=dict(_overrides) or None)

    @ray_tpu_torch.remote(max_retries=8)
    def work(i, payload):
        time.sleep(0.02)
        return int(payload.sum()) + i

    @ray_tpu_torch.remote(max_restarts=-1)
    class Counter:
        def __init__(self): self.n = 0
        def add(self, k): self.n += k; return self.n

    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group

    actors = [Counter.remote() for _ in range(4)]

    # --- optional compiled-DAG mix (--dag): a 2-stage pipeline driven through
    # its channels; a node kill mid-iteration surfaces as ChannelClosedError
    # (never a hang) and the pipeline is recompiled on surviving nodes ---
    # --- optional serve fast-path mix (--serve): a fast_path=True deployment
    # driven in small bursts; node/replica deaths must reroute in-flight
    # requests with EXACTLY-ONCE delivery (duplicates or losses fail the soak)
    serve_h = None
    if args.serve:
        from ray_tpu_torch import serve as _serve
        from ray_tpu_torch.serve import api as _serve_api

        _serve_api.CONTROLLER_OPTIONS = {"resources": {"STABLE": 0.01}}

        @_serve.deployment(num_replicas=2, fast_path=True, name="soak_model")
        def soak_model(x):
            return x * 7 + 3

        serve_h = _serve.run(soak_model.bind(), name="soak", route_prefix=None)
        assert serve_h.remote(1).result(timeout=30) == 10

    dag_c = None
    if args.dag:
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote(num_cpus=0.1)
        def dag_inc(x): return x + 1

        @ray_tpu_torch.remote(num_cpus=0.1)
        def dag_dbl(x): return x * 2

        def build_dag():
            with InputNode() as inp:
                return dag_dbl.bind(dag_inc.bind(inp)).compile()

        dag_c = build_dag()

    t_end = time.time() + args.duration
    stats = {"tasks": 0, "actor_calls": 0, "pgs": 0, "kills": 0, "errors": 0,
             "expected_actor_errs": 0, "dag_iters": 0, "dag_rebuilds": 0,
             "serve_ok": 0, "serve_errors": 0, "serve_lost": 0,
             "bursts": 0, "overload_rejects": 0}
    last_report = time.time()
    payload = np.arange(1000)
    pending = []
    i = 0
    while time.time() < t_end:
        i += 1
        sched.step("soak")  # kill-at-step hook: seeded node churn
        r = rng.random()
        try:
            if r < 0.6:
                pending.append(("task", work.remote(i, payload), i))
            elif r < 0.85:
                a = rng.choice(actors)
                pending.append(("actor", a.add.remote(1), None))
            elif r < 0.91:
                pg = placement_group([{"CPU": 1}], strategy="PACK")
                pg.ready(timeout=10)
                remove_placement_group(pg)
                stats["pgs"] += 1
            elif args.bursty and r < 0.94:
                # a seeded submission BURST past the admission bound: the
                # control plane must pace-and-retry (or reject TYPED) — each
                # ref still terminally resolves when drained below
                for k in range(40):
                    pending.append(("task", work.remote(i * 100 + k, payload),
                                    i * 100 + k))
                stats["bursts"] += 1
            elif args.serve and r >= 0.97:
                # a burst of fast-path requests (submit all, then collect):
                # overlapping requests are what reroute-on-death must cover
                xs = [i * 10 + k for k in range(4)]
                resps = [(x, serve_h.remote(x)) for x in xs]
                for x, resp in resps:
                    try:
                        v = resp.result(timeout=20)
                        if v != x * 7 + 3:
                            stats["errors"] += 1
                            print("SERVE VALUE ERROR:", v, "want", x * 7 + 3,
                                  flush=True)
                        else:
                            stats["serve_ok"] += 1
                    except Exception as e:
                        from ray_tpu_torch.core.exceptions import GetTimeoutError

                        if isinstance(e, GetTimeoutError):
                            stats["serve_lost"] += 1  # no response at all
                            print("SERVE LOST:", repr(e)[:120], flush=True)
                        else:
                            # replica pool momentarily empty mid-churn: an
                            # ERROR response is a delivered outcome, not a loss
                            stats["serve_errors"] += 1
            elif args.dag and r < 0.97:
                try:
                    if dag_c is None:
                        dag_c = build_dag()
                        stats["dag_rebuilds"] += 1
                    v = dag_c.execute(i, timeout=30.0)
                    if v != (i + 1) * 2:
                        # a WRONG value is data corruption, never churn — it
                        # must fail the soak, not vanish into a rebuild
                        stats["errors"] += 1
                        print("DAG VALUE ERROR:", v, "want", (i + 1) * 2,
                              flush=True)
                    stats["dag_iters"] += 1
                except Exception:
                    # pipeline broken by churn: release it; rebuilt on the
                    # next dag tick (capacity may need a replacement node)
                    try:
                        dag_c.teardown()
                    except Exception:  # noqa: BLE001
                        pass
                    dag_c = None
            # drain some pending
            while len(pending) > 60:
                kind, ref, arg = pending.pop(0)
                try:
                    v = ray_tpu_torch.get(ref, timeout=60)
                    if kind == "task":
                        assert v == int(payload.sum()) + arg, (v, arg)
                        stats["tasks"] += 1
                    else:
                        stats["actor_calls"] += 1
                except Exception as e:
                    from ray_tpu_torch.core.exceptions import ClusterOverloadedError

                    if kind == "actor":
                        stats["expected_actor_errs"] += 1  # calls in flight at node death
                    elif isinstance(e, ClusterOverloadedError):
                        # typed admission outcome (--bursty): a DELIVERED
                        # rejection, the overload contract — never an error
                        stats["overload_rejects"] += 1
                    else:
                        stats["errors"] += 1
                        print("TASK ERROR:", repr(e)[:200], flush=True)
        except Exception as e:
            stats["errors"] += 1
            print("LOOP ERROR:", repr(e)[:200], flush=True)
        if time.time() - last_report > 30:
            print("t=%.0fs %s pending=%d" % (
                args.duration - (t_end - time.time()), stats, len(pending)
            ), flush=True)
            last_report = time.time()

    for kind, ref, arg in pending:
        try:
            ray_tpu_torch.get(ref, timeout=90)
            stats["tasks" if kind == "task" else "actor_calls"] += 1
        except Exception as e:
            from ray_tpu_torch.core.exceptions import ClusterOverloadedError

            if kind == "actor":
                stats["expected_actor_errs"] += 1
            elif isinstance(e, ClusterOverloadedError):
                stats["overload_rejects"] += 1
            else:
                stats["errors"] += 1
    if dag_c is not None:
        try:
            dag_c.teardown()
        except Exception:  # noqa: BLE001
            pass
    serve_dups = 0
    if serve_h is not None:
        fps = serve_h.fastpath_stats() or {}
        serve_dups = fps.get("duplicates", 0)
        print("serve fastpath:", fps, "lost:", stats["serve_lost"], flush=True)
        from ray_tpu_torch import serve as _serve2

        _serve2.shutdown()
    print("FINAL:", stats, flush=True)
    totals = [ray_tpu_torch.get(a.add.remote(0), timeout=60) for a in actors]
    print("actor totals:", totals, flush=True)
    print("fault trace (%d faults):" % len(sched.trace()), flush=True)
    print(sched.trace_text(), flush=True)

    # final metrics snapshot (ray_tpu_torch.obs): printed + written to artifacts/ so
    # soak regressions (latency shifts, retry storms) are diffable across runs
    from ray_tpu_torch.util import metrics as _metrics

    _prom = _metrics.export_prometheus()
    _metrics_path = None
    try:
        import os as _os2

        _os2.makedirs("artifacts", exist_ok=True)
        _metrics_path = _os2.path.join(
            "artifacts", "chaos_soak_metrics_seed%d.prom" % args.seed
        )
        with open(_metrics_path, "w") as _f:
            _f.write(_prom)
    except OSError:
        pass
    print("metrics snapshot (%d series lines -> %s):" % (
        sum(1 for ln in _prom.splitlines() if ln and not ln.startswith("#")),
        _metrics_path,
    ), flush=True)
    print("\n".join(
        ln for ln in _prom.splitlines()
        if ln.startswith(("ray_tpu_rpc_reconnects", "ray_tpu_rpc_resends",
                          "ray_tpu_rpc_blackhole", "ray_tpu_gcs_sched_round_s_c",
                          "ray_tpu_client_tasks_submitted",
                          "ray_tpu_gcs_quarantined_nodes",
                          "ray_tpu_gcs_speculative"))
    ), flush=True)

    ray_tpu_torch.shutdown(); cluster.shutdown(); chaos.uninstall()
    rpc_prof.uninstall()  # first in, last out: restores the wrapped tracer
    races = []
    if race_san is not None:
        race_san.uninstall()
        races = race_san.races
        print("race sanitizer: %d race(s) over %d watched fields"
              % (len(races), race_san.report()["watched_fields"]), flush=True)
        if races:
            print(race_san.format_races(), flush=True)
            print("race artifact:", race_san.dump("chaos-soak"), flush=True)
    deadlocks, bad_stalls = [], []
    if wait_san is not None:
        wait_san.uninstall()
        deadlocks = wait_san.deadlocks
        # queue/cond idle-consumer waits and attributed channel parks are
        # soak noise; a LOCK/future/rpc wait no one resolvably holds for
        # >30s is a liveness failure even if it eventually unwedged
        bad_stalls = [s for s in wait_san.stalls
                      if s.get("unattributed") and s.get("age_s", 0.0) > 30.0]
        print("wait sanitizer: %d deadlock report(s), %d stall report(s) "
              "(%d unattributed > 30s)"
              % (len(deadlocks), len(wait_san.stalls), len(bad_stalls)),
              flush=True)
        if deadlocks or bad_stalls:
            print("waitgraph artifact:", wait_san.dump("chaos-soak"),
                  flush=True)
    invariants.uninstall()
    violations = invariants.check_trace(trace_path)
    print("protocol trace: %s (%d violations)" % (trace_path, len(violations)),
          flush=True)
    for v in violations:
        print("  " + v.format(), flush=True)
    # interleaving coverage: distinct ordered adjacent handler pairs the GCS
    # actually observed — the same coverage language the deterministic
    # explorer reports (analysis/explore.py), so a soak and an exploration
    # are comparable: a pair neither produced was never tested by either
    from ray_tpu_torch.analysis.explore import interleaving_coverage

    pairs = interleaving_coverage(invariants.read_trace(trace_path))
    print("interleaving coverage: %d distinct handler-pair orderings "
          "observed at the GCS" % len(pairs), flush=True)
    # per-operation RPC table: frames/op over the whole soak vs the committed
    # budget. Chaos repair traffic (reroutes, resend-after-reset, reroute
    # re-registration) legitimately exceeds the quiet steady-state ceiling,
    # so the soak only FAILS on an order-of-magnitude breach (> 3x budget
    # + 1 — the N+1 regrowth class); the exact ceiling is enforced on a
    # quiet cluster by `lint_gate --rpc-budget`.
    rpc_per_op = rpc_prof.per_op_rpcs()
    rpc_snap = rpc_prof.snapshot()
    print("per-operation RPC table (frames/op over the soak):", flush=True)
    print("  " + _rpcflow.budget_table(rpc_per_op).replace("\n", "\n  "),
          flush=True)
    print("  unattributed (background planes): %d calls, %d pushes"
          % (rpc_snap["unattributed"]["calls"],
             rpc_snap["unattributed"]["pushes"]), flush=True)
    rpc_over = []
    for _op, _entry in sorted(rpc_budget.items()):
        _got = rpc_per_op.get(_op)
        if _got is not None and _got > float(_entry["rpcs"]) * 3 + 1:
            rpc_over.append("%s: %.2f frames/op vs budget %g (>3x+1)"
                            % (_op, _got, float(_entry["rpcs"])))
    for _line in rpc_over:
        print("RPC BUDGET BREACH: " + _line, flush=True)
    print("SOAK DONE; task errors:", stats["errors"], flush=True)
    if serve_h is not None and (serve_dups or stats["serve_lost"]):
        # exactly-once delivery is the --serve mix's contract: any duplicate
        # or lost response is a correctness failure, not churn noise
        print("SERVE EXACTLY-ONCE VIOLATION: duplicates=%d lost=%d"
              % (serve_dups, stats["serve_lost"]), flush=True)
        raise SystemExit(1)
    if violations or stats["errors"]:
        # leave a black box in the standard flightrec artifact location: the
        # soak ran under the file tracer (which displaced the in-memory
        # recorder), so the artifact is the trace TAIL in the same
        # --check-trace format a production recorder dump would have
        from ray_tpu_torch.obs import save_trace_tail

        print("flight-recorder black box:",
              save_trace_tail(trace_path, "chaos-soak-error"), flush=True)
    if races:
        # the race sanitizer's contract mirrors the invariant checker's:
        # a detected race is a correctness failure, never soak noise
        raise SystemExit(1)
    if deadlocks or bad_stalls:
        # the wait sanitizer's contract: a wait cycle or an unattributed
        # >30s stall is a liveness failure, never soak noise
        raise SystemExit(1)
    if violations:
        raise SystemExit(1)
    if rpc_over:
        # an order-of-magnitude per-op frame breach means a hot path regrew
        # an N+1 (or lost its batching) — a regression, not chaos noise
        raise SystemExit(1)


if __name__ == "__main__":
    main()
