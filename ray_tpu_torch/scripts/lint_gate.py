"""One-command CI / pre-commit gate for the analysis toolchain.

    python -m ray_tpu_torch.scripts.lint_gate [--tier1] [--artifact-dir DIR]

Runs, in order, failing fast with a distinct exit code per contract:

1. the FULL linter (every registered checker) over ``ray_tpu_torch/`` with the
   port's committed ratchet baseline (``.ray-lint-baseline-torch.json``;
   the root ``.ray-lint-baseline.json`` is the reference package's) —
   exit-code contract: 0 clean, 1 new findings, 2 usage/parse errors;
2. the baseline-ratchet check: the committed baseline must be EMPTY
   (violations get fixed or pragma'd, never grandfathered — entries may
   only ever be removed);
3. a ``--dump-protocol`` extraction (the protocol model must stay
   parseable) cross-checked against the invariant checker's METHOD_TABLE
   — every rpc method the dynamic half models must exist statically;
4. optionally (``--explore``) a budgeted run of the deterministic
   control-plane model checker (analysis/explore.py) over the full
   scenario library — wall-capped per scenario for the 2-CPU CI box,
   each ``sched`` step a K1 round on the device the config names
   (``RAY_TPU_scheduler_device``: the card by default);
   any invariant violation on any explored interleaving fails the gate
   (artifact: ``explore.json`` with per-scenario schedule counts and
   handler-pair coverage);
4b. optionally (``--memmodel``) the word-level seqlock-channel model
   checker (analysis/memmodel.py): the op-sequence round-trip gate
   against ``dag/channel.py``, a wall-capped exploration of the channel
   scenario library (kill-at-any-op included), and the seeded-bug
   regression — both ``channel.SEEDED_BUGS`` must be found and shrink
   to <= 12-op replays (artifact: ``memmodel.json``; counterexamples
   land as ``memmodel_replay.json``);
4b2. optionally (``--race``) the hybrid happens-before race sanitizer
   (analysis/racer.py): the watchlist round-trip (every STATIC
   watchlist entry must resolve dynamically — static watchlist ⊆
   instrumented set), the CLEAN probes (any race found in the live
   tree fails the gate — fixed, never suppressed, same EMPTY-baseline
   rule as the linter), and the seeded-bug regression — both
   ``SEEDED_RACES`` (a re-introduced node_daemon fix and the
   alias-laundered fastpath lock) must be detected within <= 2
   quiescence rounds with a two-stack report (artifact: ``race.json``);
4b2b. optionally (``--waitgraph``) the wait-graph liveness gate
   (analysis/waitgraph.py): the static blocking graph over the control
   plane must be cycle-free, the pragma-stripped seeded modules must
   still fire ``blocking-wait-under-lock`` (the static tooth), the
   clean live probes must report no deadlock (live findings get fixed,
   never baselined), and both ``SEEDED_WAITS`` teeth must be detected
   dynamically within <= 2 probe rounds with a two-stack report (the
   GCS tooth additionally carrying the RPC chain) — artifact:
   ``waitgraph.json``;
4b3. optionally (``--rpc-budget``) the per-operation RPC budget ratchet
   (analysis/rpcflow.py): the interprocedural cost table must build with
   no unresolved entries, the committed ``.rpc-budget.json`` must pass
   the ratchet rules (zero-ops pinned at 0, >= 8 budgeted ops), and a
   live re-measurement on an embedded cluster must fit BOTH the
   committed budget and the statically-predicted multiplicity class per
   op (artifact: ``rpc_budget.json``); the cluster's GCS schedules with
   the default policy, torch_cuda on the card;
4c. optionally (``--serve-storm``) the serve fast-path chaos storm in
   smoke mode (scripts/serve_storm.py): closed-loop traffic under seeded
   replica/node kills, gated on zero lost / duplicate / wrong responses
   (artifact: ``serve_storm.json``);
5. optionally (``--tier1``) the tier-1 pytest run with ``--durations=25``,
   teeing output to an artifact file so CI keeps a per-test timing
   budget trail (see BENCH_NOTES.md "Tier-1 wall-cap hygiene").

Artifacts land in ``--artifact-dir`` (default ``artifacts/``):
``lint.json`` (machine-readable findings), ``protocol.json`` (the dumped
model), ``memmodel.json`` (when --memmodel ran), ``rpc_budget.json``
(when --rpc-budget ran), ``tier1_durations.txt`` (when --tier1 ran).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# the port's own ratchet baseline: the root .ray-lint-baseline.json is the
# reference package's
BASELINE = os.path.join(REPO, ".ray-lint-baseline-torch.json")

TIER1_CMD = (
    "set -o pipefail; timeout -k 10 870 env JAX_PLATFORMS=cpu "
    "python -m pytest tests/test_torch_*.py -q -m 'not slow' --durations=25 "
    "--continue-on-collection-errors -p no:cacheprovider"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--explore", action="store_true",
                    help="also run a budgeted exploration of the full "
                         "model-checker scenario library; nonzero exit "
                         "on any violated interleaving")
    ap.add_argument("--explore-budget", type=int, default=1400,
                    help="DFS schedules per scenario (default 1400)")
    ap.add_argument("--explore-samples", type=int, default=800,
                    help="random schedules per scenario (default 800)")
    ap.add_argument("--explore-wall-cap", type=float, default=60.0,
                    help="seconds per scenario (default 60, sized for "
                         "the 2-CPU box)")
    ap.add_argument("--memmodel", action="store_true",
                    help="also run the word-level channel model checker "
                         "(analysis/memmodel.py): op-sequence round-trip "
                         "gate, full scenario library (kill-at-any-op), "
                         "and the seeded-bug regression (both bugs must "
                         "be found and shrink to <= 12 ops)")
    ap.add_argument("--memmodel-budget", type=int, default=1000,
                    help="DFS schedules per channel scenario "
                         "(default 1000)")
    ap.add_argument("--memmodel-samples", type=int, default=300,
                    help="random schedules per channel scenario "
                         "(default 300)")
    ap.add_argument("--memmodel-wall-cap", type=float, default=30.0,
                    help="seconds per channel scenario (default 30)")
    ap.add_argument("--race", action="store_true",
                    help="also run the happens-before race sanitizer "
                         "gate (analysis/racer.py): watchlist "
                         "round-trip, clean probes (any live race "
                         "fails), and the seeded-bug detection bar "
                         "(<= 2 quiescence rounds, two-stack report); "
                         "artifact: race.json")
    ap.add_argument("--race-rounds", type=int, default=2,
                    help="seeded-bug detection bar in quiescence "
                         "rounds (default 2; detection is "
                         "deterministic in round 1)")
    ap.add_argument("--waitgraph", action="store_true",
                    help="also run the wait-graph liveness gate "
                         "(analysis/waitgraph.py): static blocking-"
                         "cycle scan, the pragma-stripped seeded-tooth "
                         "bar, clean live deadlock probes, and the "
                         "seeded dynamic detection bar (<= 2 rounds, "
                         "two-stack report + rpc chain); artifact: "
                         "waitgraph.json")
    ap.add_argument("--waitgraph-rounds", type=int, default=2,
                    help="seeded wait-bug detection bar in probe "
                         "rounds (default 2; detection is "
                         "deterministic in round 1)")
    ap.add_argument("--rpc-budget", action="store_true",
                    help="also run the per-operation RPC budget ratchet "
                         "(analysis/rpcflow.py): static cost table, "
                         "committed-budget ratchet rules, and a live "
                         "re-measurement on an embedded cluster gated "
                         "on budget AND predicted multiplicity class; "
                         "artifact: rpc_budget.json")
    ap.add_argument("--rpc-budget-iters", type=int, default=12,
                    help="measured iterations per driver operation "
                         "(default 12; a warmup pass always precedes "
                         "the measured pass)")
    ap.add_argument("--serve-storm", action="store_true",
                    help="also run the serve fast-path chaos storm in "
                         "SMOKE mode (scripts/serve_storm.py --smoke): "
                         "short closed-loop phases under seeded replica/"
                         "node kills with the SLO gate (zero lost / "
                         "duplicate / wrong responses) wired into the "
                         "exit code; artifact: serve_storm.json")
    ap.add_argument("--overload-storm", action="store_true",
                    help="also run the overload-control storm in SMOKE "
                         "mode (scripts/overload_storm.py --smoke): "
                         "bursty open-loop traffic past saturation with "
                         "the control-plane A/B, gated on zero silent "
                         "drops, the goodput ratio/fraction bars, and a "
                         "clean strict-terminal invariant check "
                         "(artifact: overload_storm.json)")
    ap.add_argument("--gray-storm", action="store_true",
                    help="also run the gray-failure defense storm in "
                         "SMOKE mode (scripts/gray_storm.py --smoke): "
                         "2-of-5 nodes chaos-slowed 25x, A/B over the "
                         "defense plane, gated on the p99/goodput "
                         "recovery bars, the wedged-gang speculation "
                         "rescue, quarantine engagement, and a clean "
                         "strict-terminal invariant check "
                         "(artifact: gray_storm.json)")
    ap.add_argument("--tier1", action="store_true",
                    help="also run the tier-1 suite with --durations=25 "
                         "and save the output as an artifact")
    ap.add_argument("--artifact-dir", default=os.path.join(REPO, "artifacts"))
    args = ap.parse_args(argv)
    os.makedirs(args.artifact_dir, exist_ok=True)

    # (1) full linter, all checkers, ratchet baseline, JSON out
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch",
         "--baseline", BASELINE, "--format", "json"],
        cwd=REPO, capture_output=True, text=True,
    )
    lint_path = os.path.join(args.artifact_dir, "lint.json")
    with open(lint_path, "w") as f:
        f.write(proc.stdout)
    if proc.returncode == 2:
        print("lint_gate: analysis CLI usage/parse error", file=sys.stderr)
        sys.stderr.write(proc.stderr)
        return 2
    try:
        lint = json.loads(proc.stdout)
    except json.JSONDecodeError:
        print("lint_gate: analysis CLI emitted unparseable JSON",
              file=sys.stderr)
        return 2
    if proc.returncode == 1 or lint["new"]:
        print(f"lint_gate: {len(lint['new'])} NEW finding(s) — fix or "
              "pragma them (the baseline only ratchets down):",
              file=sys.stderr)
        for fnd in lint["new"]:
            print(f"  {fnd['path']}:{fnd['line']}: [{fnd['check']}] "
                  f"{fnd['message']}", file=sys.stderr)
        return 1
    print(f"lint: clean ({lint['files_scanned']} files, "
          f"{len(lint['checks'])} checkers, {lint['suppressed']} "
          "pragma-suppressed)")

    # (2) baseline ratchet: committed baseline stays EMPTY
    if os.path.exists(BASELINE):
        with open(BASELINE) as f:
            entries = json.load(f).get("findings", {})
        if entries:
            print(f"lint_gate: committed baseline carries {len(entries)} "
                  "entries — it must stay empty (fix, don't grandfather)",
                  file=sys.stderr)
            return 1
    print("baseline: empty (ratchet holds)")

    # (3) protocol model extraction + dynamic/static cross-check
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch",
         "--dump-protocol"],
        cwd=REPO, capture_output=True, text=True,
    )
    if proc.returncode != 0:
        print("lint_gate: --dump-protocol failed", file=sys.stderr)
        sys.stderr.write(proc.stderr)
        return 2
    with open(os.path.join(args.artifact_dir, "protocol.json"), "w") as f:
        f.write(proc.stdout)
    model = json.loads(proc.stdout)
    from ray_tpu_torch.analysis.invariants import METHOD_TABLE

    missing = sorted(set(METHOD_TABLE) - set(model["handlers"]))
    if missing:
        print("lint_gate: invariant METHOD_TABLE names rpc methods with "
              f"no static handler: {missing}", file=sys.stderr)
        return 1
    print(f"protocol: {len(model['handlers'])} methods, "
          f"{len(model['calls'])} call sites; invariant method table "
          "round-trips")

    # (4) budgeted interleaving exploration of the scenario library
    if args.explore:
        from ray_tpu_torch.analysis import explore as _explore
        from ray_tpu_torch.core.config import Config

        device = Config().scheduler_device

        report = {}
        failed = None
        total = 0
        for name in sorted(_explore.SCENARIOS):
            res = _explore.explore(
                _explore.SCENARIOS[name],
                max_schedules=args.explore_budget,
                samples=args.explore_samples,
                wall_cap_s=args.explore_wall_cap,
                device=device,
            )
            print("explore: " + res.summary())
            total += res.schedules_run
            report[name] = {
                "schedules": res.schedules_run,
                "pruned": res.branches_pruned,
                "coverage_pairs": len(res.coverage),
                "violations": [
                    v.format()
                    for v in (res.violating.violations if res.found else [])
                ],
                "shrunk": res.shrunk,
            }
            if res.found and failed is None:
                failed = name
                cex = os.path.join(args.artifact_dir, "explore_replay.json")
                _explore.write_replay(cex, res)
                print(f"lint_gate: counterexample replay: {cex} "
                      "(python -m ray_tpu_torch.analysis --replay)",
                      file=sys.stderr)
        with open(os.path.join(args.artifact_dir, "explore.json"),
                  "w") as f:
            json.dump(report, f, indent=2)
        if failed is not None:
            print(f"lint_gate: scenario {failed} has a violated "
                  "interleaving", file=sys.stderr)
            return 1
        print(f"explore: {total} schedules across "
              f"{len(report)} scenarios, 0 violations")

    # (4b) word-level channel model checker: static round-trip gate +
    # exhaustive-ish interleaving run + seeded-bug regression teeth
    if args.memmodel:
        from ray_tpu_torch.analysis import memmodel as _memmodel

        failed = False
        report = {"round_trip": [], "scenarios": {}, "seeded": {}}
        report["round_trip"] = _memmodel.verify_op_sequences()
        for msg in report["round_trip"]:
            print(f"lint_gate: memmodel round-trip: {msg}",
                  file=sys.stderr)
            failed = True
        if not report["round_trip"]:
            print("memmodel: op-sequence round-trip holds "
                  "(write/read/close/poke_error vs DECLARED_SEQUENCES)")
        total = 0
        for name in sorted(_memmodel.CHANNEL_SCENARIOS):
            res = _memmodel.explore_channel(
                _memmodel.CHANNEL_SCENARIOS[name],
                max_schedules=args.memmodel_budget,
                samples=args.memmodel_samples,
                wall_cap_s=args.memmodel_wall_cap,
            )
            print("memmodel: " + res.summary())
            total += res.schedules_run
            report["scenarios"][name] = {
                "schedules": res.schedules_run,
                "pruned": res.branches_pruned,
                "ops": res.ops_covered,
                "crash_points": len(res.crash_points),
                "violations": [
                    v.format()
                    for v in (res.violating.violations if res.found else [])
                ],
                "shrunk": res.shrunk,
            }
            if res.found:
                failed = True
                cex = os.path.join(args.artifact_dir,
                                   "memmodel_replay.json")
                _memmodel.write_channel_replay(cex, res)
                print(f"lint_gate: channel counterexample replay: {cex} "
                      "(python -m ray_tpu_torch.analysis --replay)",
                      file=sys.stderr)
        # regression teeth: each seeded bug must be FOUND and shrink small
        for bug, scen in _memmodel.SEEDED_BUG_SCENARIOS:
            res = _memmodel.explore_channel(
                _memmodel.CHANNEL_SCENARIOS[scen],
                max_schedules=args.memmodel_budget,
                samples=args.memmodel_samples,
                seeded_bugs=[bug],
                wall_cap_s=args.memmodel_wall_cap,
            )
            found = res.found and len(res.shrunk or ()) <= 12
            report["seeded"][bug] = {
                "scenario": scen,
                "found": res.found,
                "shrunk_ops": len(res.shrunk or ()) if res.found else None,
            }
            if not found:
                failed = True
                print(f"lint_gate: seeded channel bug {bug!r} "
                      + ("shrank to "
                         f"{len(res.shrunk or res.violating.schedule)} "
                         "ops (> 12)" if res.found else "NOT FOUND")
                      + " — the checker lost its teeth", file=sys.stderr)
            else:
                print(f"memmodel: seeded bug {bug} found in {scen}, "
                      f"shrunk to {len(res.shrunk)} ops")
        with open(os.path.join(args.artifact_dir, "memmodel.json"),
                  "w") as f:
            json.dump(report, f, indent=2)
        if failed:
            print("lint_gate: channel memory model gate failed",
                  file=sys.stderr)
            return 1
        print(f"memmodel: {total} schedules across "
              f"{len(report['scenarios'])} scenarios, 0 violations")

    # (4b2) happens-before race sanitizer: watchlist round-trip, clean
    # probes (EMPTY baseline: live races get fixed, never suppressed),
    # and the seeded-bug regression teeth
    if args.race:
        from ray_tpu_torch.analysis import racer as _racer

        failed = False
        report = {"watchlist": {}, "probes": {}, "seeded": {}}
        wl = _racer.extract_watchlist()
        probe = _racer.RaceSanitizer(watchlist=wl)
        probe.install()
        probe.uninstall()
        report["watchlist"] = {
            "entries": len(wl),
            "classes": sorted({e["cls"] for e in wl}),
            "unresolved": [
                {"entry": e, "error": err} for e, err in probe.unresolved
            ],
        }
        if probe.unresolved:
            failed = True
            for e, err in probe.unresolved:
                print("lint_gate: watchlist entry "
                      f"{e['cls']}.{e['field']} did not resolve "
                      f"dynamically: {err} (static watchlist must be a "
                      "subset of the instrumented set)", file=sys.stderr)
        else:
            print(f"race: watchlist round-trips ({len(wl)} entries, "
                  f"{len(report['watchlist']['classes'])} classes, all "
                  "instrumented)")
        for name in sorted(_racer.RACE_PROBES):
            res = _racer.run_probe(name, rounds=args.race_rounds,
                                   watchlist=wl)
            report["probes"][name] = {
                "rounds": res.rounds,
                "races": res.races,
            }
            if res.detected:
                failed = True
                print(f"lint_gate: race probe {name} found a LIVE race "
                      "— fix it (the baseline stays empty):",
                      file=sys.stderr)
                for r in res.races:
                    print(f"  {r['kind']} on {r['field']}",
                          file=sys.stderr)
            else:
                print(f"race: probe {name} clean "
                      f"({res.rounds} round(s))")
        for bug, _mod, pname in _racer.SEEDED_RACES:
            res = _racer.run_probe(pname, seeded_bugs=[bug],
                                   rounds=args.race_rounds, watchlist=wl)
            two_stack = bool(
                res.races
                and res.races[0]["prior"].get("stack")
                and res.races[0]["current"].get("stack")
            )
            ok = res.detected and res.rounds <= args.race_rounds \
                and two_stack
            report["seeded"][bug] = {
                "probe": pname,
                "detected": res.detected,
                "rounds": res.rounds,
                "two_stack": two_stack,
                "static_claim_violated": bool(
                    res.races and res.races[0]["static_claim_violated"]
                ),
            }
            if not ok:
                failed = True
                print(f"lint_gate: seeded race {bug!r} "
                      + (f"took {res.rounds} rounds (> "
                         f"{args.race_rounds})" if res.detected
                         else "NOT DETECTED")
                      + " — the racer lost its teeth", file=sys.stderr)
            else:
                claim = report["seeded"][bug]["static_claim_violated"]
                print(f"race: seeded bug {bug} detected in "
                      f"{res.rounds} round(s), two-stack report"
                      + (", static claim flagged" if claim else ""))
        with open(os.path.join(args.artifact_dir, "race.json"),
                  "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        if failed:
            print("lint_gate: race sanitizer gate failed",
                  file=sys.stderr)
            return 1

    # (4b2b) wait-graph liveness gate: the static blocking graph must be
    # cycle-free, the pragma-stripped seeded modules must still fire
    # blocking-wait-under-lock (the static tooth), the clean probes must
    # find no live deadlock (EMPTY-baseline rule), and both seeded
    # teeth must be caught dynamically with a two-stack report
    if args.waitgraph:
        import re as _re
        import shutil as _shutil
        import tempfile as _tempfile

        from ray_tpu_torch.analysis.core import analyze_paths as _analyze
        from ray_tpu_torch.analysis import waitgraph as _wg

        failed = False
        report = {"static": {}, "seeded_static": {}, "probes": {},
                  "seeded": {}}

        wg_report = _wg.build_waitgraph(root=REPO)
        report["static"] = {
            "contexts": len(wg_report.contexts),
            "edges": len(wg_report.edges),
            "cycles": [list(c) for c in wg_report.cycles],
        }
        if wg_report.cycles:
            failed = True
            for c in wg_report.cycles:
                print("lint_gate: static blocking cycle: "
                      + " -> ".join(c + [c[0]]), file=sys.stderr)
        else:
            print(f"waitgraph: static blocking graph cycle-free "
                  f"({len(wg_report.contexts)} contexts, "
                  f"{len(wg_report.edges)} rpc edges)")

        # seeded static bar: strip every ray-lint pragma off the two
        # seeded modules and rescan — blocking-wait-under-lock must
        # fire in each, or the static half lost its teeth
        seeded_mods = ("ray_tpu_torch/cluster/gcs.py", "ray_tpu_torch/dag/compiled.py")
        pragma_re = _re.compile(r"#\s*ray-lint:[^\n]*")
        tmp = _tempfile.mkdtemp(prefix="wg-gate-")
        try:
            for rel in seeded_mods:
                dst = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(os.path.join(REPO, rel)) as f:
                    stripped = pragma_re.sub("", f.read())
                with open(dst, "w") as f:
                    f.write(stripped)
            res = _analyze([os.path.join(tmp, "ray_tpu_torch")], root=tmp,
                           select=["blocking-wait-under-lock"])
            fired = {rel: sum(1 for f_ in res.findings if f_.path == rel)
                     for rel in seeded_mods}
            report["seeded_static"] = fired
            for rel, n in fired.items():
                if not n:
                    failed = True
                    print(f"lint_gate: pragma-stripped {rel} raised NO "
                          "blocking-wait-under-lock finding — the "
                          "static tooth is gone", file=sys.stderr)
            if all(fired.values()):
                print("waitgraph: pragma-stripped seeded modules fire "
                      "blocking-wait-under-lock ("
                      + ", ".join(f"{rel}: {n}"
                                  for rel, n in sorted(fired.items()))
                      + ")")
        finally:
            _shutil.rmtree(tmp, ignore_errors=True)

        for name in sorted(_wg.WAIT_PROBES):
            res = _wg.run_probe(name, rounds=args.waitgraph_rounds)
            report["probes"][name] = {
                "rounds": res.rounds,
                "deadlocks": res.deadlocks,
                "stalls": len(res.stalls),
            }
            if res.detected:
                failed = True
                print(f"lint_gate: wait probe {name} found a LIVE "
                      "deadlock — fix it (the baseline stays empty)",
                      file=sys.stderr)
            else:
                print(f"waitgraph: probe {name} clean "
                      f"({res.rounds} round(s))")
        for bug, _mod, pname in _wg.SEEDED_WAITS:
            res = _wg.run_probe(pname, seeded_bugs=[bug],
                                rounds=args.waitgraph_rounds)
            rep0 = res.deadlocks[0] if res.deadlocks else {}
            threads = rep0.get("threads", ())
            two_stack = sum(1 for t in threads if t.get("stack")) >= 2
            # a cycle through an rpc-srv resource must carry the
            # Lamport-stitched chain of in-flight calls; pure
            # lock/channel cycles have no rpc hop to report
            needs_chain = any("rpc" in str(t.get("waiting_on", ""))
                              for t in threads)
            chain_ok = (not needs_chain) or bool(rep0.get("rpc_chain"))
            ok = (res.detected and res.rounds <= args.waitgraph_rounds
                  and two_stack and chain_ok)
            report["seeded"][bug] = {
                "probe": pname,
                "detected": res.detected,
                "rounds": res.rounds,
                "two_stack": two_stack,
                "rpc_chain": len(rep0.get("rpc_chain") or ()),
            }
            if not ok:
                failed = True
                print(f"lint_gate: seeded wait bug {bug!r} "
                      + (f"took {res.rounds} rounds (> "
                         f"{args.waitgraph_rounds}) or lost the "
                         "two-stack/rpc-chain report" if res.detected
                         else "NOT DETECTED")
                      + " — the sanitizer lost its teeth",
                      file=sys.stderr)
            else:
                print(f"waitgraph: seeded bug {bug} detected in "
                      f"{res.rounds} round(s), two-stack report, "
                      f"{report['seeded'][bug]['rpc_chain']} rpc hop(s)")
        with open(os.path.join(args.artifact_dir, "waitgraph.json"),
                  "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        if failed:
            print("lint_gate: wait-graph gate failed", file=sys.stderr)
            return 1

    # (4b3) per-operation RPC budget ratchet: static cost table ->
    # committed budget rules -> live re-measurement (the honesty gate:
    # measured frames must fit the budget AND the predicted class)
    if args.rpc_budget:
        from ray_tpu_torch.analysis import rpcflow as _rpcflow

        failed = False
        budget_path = os.path.join(REPO, _rpcflow.DEFAULT_BUDGET_FILE)
        report = _rpcflow.build_rpcflow(["ray_tpu_torch"], root=REPO)
        art = {"ops": {op: c.to_dict() for op, c in report.ops.items()}}
        if report.unresolved_entries:
            failed = True
            for op, why in report.unresolved_entries:
                print(f"lint_gate: rpcflow entry point {op} unresolved: "
                      f"{why}", file=sys.stderr)
        try:
            budget = _rpcflow.load_budget(budget_path)
        except (OSError, ValueError) as e:
            print(f"lint_gate: cannot load committed RPC budget: {e}",
                  file=sys.stderr)
            return 1
        art["budget"] = budget
        errs = _rpcflow.ratchet_check(budget, budget)
        if len(budget) < 8:
            errs.append(f"budget table has {len(budget)} ops, need >= 8")
        for e in errs:
            failed = True
            print(f"lint_gate: rpc budget: {e}", file=sys.stderr)
        if not failed:
            print(f"rpc-budget: static table ok "
                  f"({len(report.ops)} ops over "
                  f"{report.functions_indexed} functions), committed "
                  f"budget ok ({len(budget)} ops, "
                  f"{', '.join(_rpcflow.ZERO_STEADY_STATE_OPS)} at 0)")
        measured = None
        if not failed:
            res = _rpcflow.measure_rpc_budget(
                iters=args.rpc_budget_iters)
            measured = res["per_op"]
            art["measured"] = measured
            art["profile"] = res["snapshot"]
            for e in _rpcflow.check_measured(measured, budget, report):
                failed = True
                print(f"lint_gate: rpc budget: {e}", file=sys.stderr)
        with open(os.path.join(args.artifact_dir, "rpc_budget.json"),
                  "w") as f:
            json.dump(art, f, indent=2, sort_keys=True)
        if failed:
            print("lint_gate: rpc budget gate failed", file=sys.stderr)
            return 1
        print("rpc-budget: measured frames fit the committed budget "
              "and the predicted classes:")
        print("  " + _rpcflow.budget_table(measured, report)
              .replace("\n", "\n  "))

    # (4c) serve fast-path chaos-storm smoke: the SLO gate (zero lost /
    # duplicate / wrong responses under seeded kills) as a CI check
    if args.serve_storm:
        art = os.path.join(args.artifact_dir, "serve_storm.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.serve_storm",
             "--smoke", "--json", art],
            cwd=REPO, capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            print("lint_gate: serve storm SLO gate RED", file=sys.stderr)
            sys.stderr.write(proc.stderr[-2000:])
            return 1
        print(f"serve_storm: SLO green (artifact: {art})")

    # (4d) overload-control storm smoke: the graceful-degradation gate
    # (no silent drops, goodput holds vs the control-off collapse arm)
    if args.overload_storm:
        art = os.path.join(args.artifact_dir, "overload_storm.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.overload_storm",
             "--smoke", "--json", art],
            cwd=REPO, capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            print("lint_gate: overload storm gate RED (silent drop or "
                  "goodput collapse)", file=sys.stderr)
            sys.stderr.write(proc.stderr[-2000:])
            return 1
        print(f"overload_storm: gate green (artifact: {art})")

    # (4e) gray-failure defense storm smoke: the tail-latency-recovery
    # gate (quarantine engages, speculation rescues the wedged gang,
    # zero duplicate task_done applies in the strict-terminal trace)
    if args.gray_storm:
        art = os.path.join(args.artifact_dir, "gray_storm.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.gray_storm",
             "--smoke", "--json", art],
            cwd=REPO, capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            print("lint_gate: gray storm gate RED (tail latency not "
                  "recovered, wedge not rescued, or invariant "
                  "violation)", file=sys.stderr)
            sys.stderr.write(proc.stderr[-2000:])
            return 1
        print(f"gray_storm: gate green (artifact: {art})")

    # (5) tier-1 with per-test durations as a CI artifact. The pytest
    # process writes a final metrics snapshot at exit (util/metrics.py
    # RAY_TPU_METRICS_DUMP hook) so control-plane regressions — handler
    # latency shifts, retry storms — are diffable across CI runs.
    if args.tier1:
        art = os.path.join(args.artifact_dir, "tier1_durations.txt")
        metrics_art = os.path.join(args.artifact_dir, "tier1_metrics.prom")
        env = dict(os.environ, RAY_TPU_METRICS_DUMP=metrics_art)
        with open(art, "w") as f:
            proc = subprocess.Popen(
                ["bash", "-c", TIER1_CMD], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for line in proc.stdout:
                sys.stdout.write(line)
                f.write(line)
            rc = proc.wait()
        print(f"tier-1 durations artifact: {art}")
        if os.path.exists(metrics_art):
            with open(metrics_art) as f:
                lines = f.read().splitlines()
            series = [ln for ln in lines
                      if ln and not ln.startswith("#")]
            print(f"tier-1 metrics snapshot: {metrics_art} "
                  f"({len(series)} series); handler totals:")
            for ln in series:
                if "_rpc_handler_s_count" in ln or ln.startswith(
                        ("ray_tpu_rpc_reconnects", "ray_tpu_rpc_resends")):
                    print("  " + ln)
        if rc != 0:
            print(f"lint_gate: tier-1 run failed (rc={rc})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
