"""CLI: ``python -m ray_tpu_torch.analysis <paths> [options]``.

Exit codes: 0 = clean (or every finding baselined), 1 = new findings,
2 = usage/parse errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ray_tpu_torch.analysis.core import (
    CHECKERS,
    analyze_paths,
    load_baseline,
    split_by_baseline,
    write_baseline,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.analysis",
        description="ray_tpu_torch distributed-correctness linter",
    )
    p.add_argument("paths", nargs="*", default=["ray_tpu_torch"],
                   help="files/directories to scan (default: ray_tpu_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="JSON ratchet baseline; findings whose fingerprint "
                        "appears there are reported but don't fail")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite --baseline with the current findings")
    p.add_argument("--select", default=None, metavar="CHECKS",
                   help="comma-separated subset of checks to run")
    p.add_argument("--list-checks", action="store_true")
    p.add_argument("--dump-rpcflow", action="store_true",
                   help="print the per-operation RPC cost table "
                        "(interprocedural call-graph multiplicity "
                        "analysis, analysis/rpcflow.py) and exit")
    p.add_argument("--dump-protocol", action="store_true",
                   help="instead of linting, emit the extracted RPC "
                        "protocol model (handlers, call sites, push/"
                        "subscribe topics, config knobs) as JSON")
    p.add_argument("--check-trace", default=None, metavar="TRACE",
                   help="instead of linting, replay a protocol trace "
                        "(JSONL from the invariant sanitizer) and verify "
                        "the happens-before invariants; exit 1 on "
                        "violations")
    p.add_argument("--explore", default=None, metavar="SCENARIO",
                   nargs="?", const="all",
                   help="instead of linting, model-check the control "
                        "plane: explore handler interleavings of one "
                        "scenario (or 'all') through the invariant "
                        "checker; exit 1 on any violation")
    p.add_argument("--memmodel", default=None, metavar="SCENARIO",
                   nargs="?", const="all",
                   help="instead of linting, model-check the compiled-"
                        "dag seqlock channel at word-op granularity: "
                        "explore writer/reader/poker interleavings of "
                        "one channel scenario (or 'all'), kill-at-any-op "
                        "included; exit 1 on any violation")
    p.add_argument("--race", default=None, metavar="PROBE",
                   nargs="?", const="all",
                   help="instead of linting, run the happens-before "
                        "race sanitizer's probe(s) (analysis/racer.py): "
                        "one probe (or 'all') drives real control-plane "
                        "code paths on controlled threads under the "
                        "vector-clock engine; exit 1 on any detected "
                        "race (--seed-bug re-introduces a known bug the "
                        "probe must then catch)")
    p.add_argument("--wait", default=None, metavar="PROBE",
                   nargs="?", const="all",
                   help="instead of linting, run the wait-graph "
                        "deadlock sanitizer's probe(s) "
                        "(analysis/waitgraph.py): one probe (or 'all') "
                        "drives real control-plane code paths on "
                        "controlled threads under the live wait-for "
                        "graph; exit 1 on any deadlock report "
                        "(--seed-bug re-introduces a known blocking "
                        "bug the probe must then catch)")
    p.add_argument("--rounds", type=int, default=3,
                   help="quiescence rounds per race/wait probe "
                        "(default 3)")
    p.add_argument("--dump-waitgraph", action="store_true",
                   help="instead of linting, emit the STATIC blocking "
                        "graph as JSON: (context, blocking-site) nodes "
                        "over cluster//serve//dag/, cross-process RPC "
                        "edges resolved through the protocol index, "
                        "and any blocking cycles found over them")
    p.add_argument("--dump-watchlist", action="store_true",
                   help="instead of linting, emit the race sanitizer's "
                        "STAGE-1 static watchlist as JSON: every "
                        "container/scalar field reachable from >= 2 "
                        "execution contexts in cluster//serve//dag/, "
                        "with the lock attrs the static pass credits "
                        "(validated dynamically by --race)")
    p.add_argument("--list-scenarios", action="store_true",
                   help="list every model-checking/sanitizer scenario, "
                        "kind-prefixed: control-plane interleaving "
                        "scenarios (--explore NAME), 'memmodel:NAME' "
                        "channel scenarios (--memmodel NAME), "
                        "'racer:NAME' race probes (--race NAME), and "
                        "'waitgraph:NAME' deadlock probes (--wait "
                        "NAME)")
    p.add_argument("--budget", type=int, default=500,
                   help="DFS schedule budget per scenario (default 500)")
    p.add_argument("--samples", type=int, default=200,
                   help="seeded-random schedules beyond the DFS bound "
                        "(default 200)")
    p.add_argument("--depth", type=int, default=30,
                   help="DFS branch-depth bound (default 30)")
    p.add_argument("--seed", type=int, default=0,
                   help="random-sampling seed (same seed = byte-"
                        "identical exploration)")
    p.add_argument("--wall-cap", type=float, default=None, metavar="S",
                   help="wall-clock cap in seconds per scenario")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the explored GCS runs its scheduler "
                        "rounds (--explore, --replay): K1 on the card "
                        "(default; raises without one) or its plain "
                        "version on the CPU")
    p.add_argument("--seed-bug", action="append", default=[],
                   metavar="NAME",
                   help="re-introduce a known fixed bug (gcs.SEEDED_BUGS "
                        "for --explore, channel.SEEDED_BUGS for "
                        "--memmodel, node_daemon/fastpath SEEDED_BUGS "
                        "for --race, gcs/compiled SEEDED_BUGS for "
                        "--wait) — the regression harness")
    p.add_argument("--save-replay", default=None, metavar="FILE",
                   help="write the first (shrunk) counterexample here")
    p.add_argument("--replay", default=None, metavar="FILE",
                   help="re-execute a recorded counterexample "
                        "deterministically; exit 1 if it still "
                        "violates. Kind-dispatched on the file's "
                        "'kind' field: 'memmodel' replays through the "
                        "channel model (analysis/memmodel.py), "
                        "anything else through the control-plane "
                        "explorer (analysis/explore.py); race-sanitizer "
                        "artifacts (kind 'race-report') are reports, "
                        "not replays, and are rejected with exit 2")
    args = p.parse_args(argv)

    # Import for side effect: populate the registry before --list-checks.
    from ray_tpu_torch.analysis import checkers as _checkers  # noqa: F401

    if args.list_checks:
        for name in sorted(CHECKERS):
            print(f"{name}: {CHECKERS[name].description}")
        return 0

    if args.list_scenarios:
        from ray_tpu_torch.analysis.explore import SCENARIOS
        from ray_tpu_torch.analysis.memmodel import CHANNEL_SCENARIOS
        from ray_tpu_torch.analysis.racer import RACE_PROBES

        for name in sorted(SCENARIOS):
            print(f"{name}: {SCENARIOS[name].description}")
        for name in sorted(CHANNEL_SCENARIOS):
            print(f"memmodel:{name}: "
                  f"{CHANNEL_SCENARIOS[name].description}")
        for name in sorted(RACE_PROBES):
            doc = (RACE_PROBES[name].__doc__ or "").split("\n")[0].strip()
            print(f"racer:{name}: {doc}")
        from ray_tpu_torch.analysis.waitgraph import WAIT_PROBES

        for name in sorted(WAIT_PROBES):
            doc = (WAIT_PROBES[name].__doc__ or "").split("\n")[0].strip()
            print(f"waitgraph:{name}: {doc}")
        return 0

    if args.replay is not None:
        # memmodel replays carry "kind": "memmodel"; explore replays
        # predate the field — dispatch on it
        try:
            with open(args.replay, "r", encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not isinstance(rec, dict):
            print(f"error: {args.replay} is not a replay object",
                  file=sys.stderr)
            return 2
        kind = rec.get("kind")
        if kind == "race-report":
            print("error: race-sanitizer artifacts are reports, not "
                  "replays (the racer re-detects from the live probes: "
                  "--race)", file=sys.stderr)
            return 2
        try:
            if kind == "memmodel":
                from ray_tpu_torch.analysis import memmodel as _memmodel

                res = _memmodel.replay_channel(args.replay)
            else:
                from ray_tpu_torch.analysis import explore as _explore

                res = _explore.replay(args.replay, device=args.device)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"replayed {len(res.schedule)} steps of {res.scenario}:")
        for step in res.schedule:
            print(f"  {step}")
        for v in res.violations:
            print(v.format())
        print(f"{len(res.violations)} violation(s)")
        return 1 if res.violations else 0

    if args.dump_watchlist:
        from ray_tpu_torch.analysis.racer import extract_watchlist

        paths = None
        if args.paths and args.paths != ["ray_tpu_torch"]:
            missing = [p_ for p_ in args.paths if not os.path.exists(p_)]
            if missing:
                print(f"error: no such path(s): {missing}",
                      file=sys.stderr)
                return 2
            paths = args.paths
        try:
            wl = extract_watchlist(paths=paths)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(wl, indent=2))
        return 0

    if args.race is not None:
        from ray_tpu_torch.analysis import racer as _racer

        requested = args.race.split("racer:", 1)[-1]
        names = (
            sorted(_racer.RACE_PROBES) if requested == "all"
            else [requested]
        )
        unknown = [n for n in names if n not in _racer.RACE_PROBES]
        if unknown:
            print(f"error: unknown race probe(s) {unknown}; have "
                  f"{sorted(_racer.RACE_PROBES)}", file=sys.stderr)
            return 2
        failed = False
        wl = _racer.extract_watchlist()
        for name in names:
            try:
                res = _racer.run_probe(
                    name, seeded_bugs=args.seed_bug, rounds=args.rounds,
                    watchlist=wl,
                )
            except ValueError as e:  # unknown --seed-bug name
                print(f"error: {e}", file=sys.stderr)
                return 2
            print(res.summary())
            if res.unresolved:
                failed = True
                for e, err in res.unresolved:
                    print(f"  unresolved watchlist entry "
                          f"{e['cls']}.{e['field']}: {err}",
                          file=sys.stderr)
            if res.detected:
                failed = True
                for r in res.races:
                    print(f"  RACE {r['kind']} on {r['field']} "
                          f"(static locked={r['static']['locked']})")
                    for side in ("prior", "current"):
                        a = r[side]
                        print(f"    {side}: {a.get('thread')} "
                              f"locks={a.get('locks')}")
                        for fr in a.get("stack", ())[:3]:
                            print(f"      {fr}")
        return 1 if failed else 0

    if args.dump_waitgraph:
        from ray_tpu_torch.analysis import waitgraph as _wg

        paths = None
        if args.paths and args.paths != ["ray_tpu_torch"]:
            missing = [p_ for p_ in args.paths if not os.path.exists(p_)]
            if missing:
                print(f"error: no such path(s): {missing}",
                      file=sys.stderr)
                return 2
            paths = args.paths
        try:
            report = _wg.build_waitgraph(paths=paths)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(report.to_dict(), indent=2))
        return 1 if report.cycles else 0

    if args.wait is not None:
        from ray_tpu_torch.analysis import waitgraph as _wg

        # accept the "waitgraph:NAME" spelling --list-scenarios prints
        requested = args.wait.split("waitgraph:", 1)[-1]
        names = (
            sorted(_wg.WAIT_PROBES) if requested == "all"
            else [requested]
        )
        unknown = [n for n in names if n not in _wg.WAIT_PROBES]
        if unknown:
            print(f"error: unknown wait probe(s) {unknown}; have "
                  f"{sorted(_wg.WAIT_PROBES)}", file=sys.stderr)
            return 2
        failed = False
        for name in names:
            try:
                res = _wg.run_probe(
                    name, seeded_bugs=args.seed_bug, rounds=args.rounds,
                )
            except ValueError as e:  # unknown --seed-bug name
                print(f"error: {e}", file=sys.stderr)
                return 2
            print(res.summary())
            if res.detected:
                failed = True
                for d in res.deadlocks:
                    print(f"  DEADLOCK cycle: "
                          f"{' -> '.join(d.get('cycle', ()))}")
                    for t in d.get("threads", ()):
                        print(f"    {t.get('thread')} waiting on "
                              f"{t.get('waiting_on')} "
                              f"held={t.get('held')}")
                        for fr in (t.get("stack") or ())[-3:]:
                            print(f"      {fr}")
                    for hop in d.get("rpc_chain", ()):
                        print(f"    rpc hop: {hop}")
        return 1 if failed else 0

    if args.memmodel is not None:
        from ray_tpu_torch.analysis import memmodel as _memmodel

        # accept the "memmodel:NAME" spelling --list-scenarios prints
        requested = args.memmodel.split("memmodel:", 1)[-1]
        names = (
            sorted(_memmodel.CHANNEL_SCENARIOS) if requested == "all"
            else [requested]
        )
        unknown = [n for n in names
                   if n not in _memmodel.CHANNEL_SCENARIOS]
        if unknown:
            print(f"error: unknown channel scenario(s) {unknown}; have "
                  f"{sorted(_memmodel.CHANNEL_SCENARIOS)}",
                  file=sys.stderr)
            return 2
        problems = _memmodel.verify_op_sequences()
        for msg in problems:
            print(f"round-trip: {msg}", file=sys.stderr)
        failed = bool(problems)
        for name in names:
            res = _memmodel.explore_channel(
                _memmodel.CHANNEL_SCENARIOS[name],
                max_schedules=args.budget,
                samples=args.samples,
                max_depth=args.depth,
                seed=args.seed,
                seeded_bugs=args.seed_bug,
                wall_cap_s=args.wall_cap,
            )
            print(res.summary())
            if res.found:
                failed = True
                for v in (res.shrunk_violations
                          or res.violating.violations):
                    print("  " + v.format())
                print("  minimal schedule:")
                for step in (res.shrunk or res.violating.schedule):
                    print(f"    {step}")
                if args.save_replay:
                    _memmodel.write_channel_replay(
                        args.save_replay, res, seeded_bugs=args.seed_bug
                    )
                    print(f"  replay written to {args.save_replay} "
                          "(re-run with --replay)")
        return 1 if failed else 0

    if args.explore is not None:
        from ray_tpu_torch.analysis import explore as _explore

        names = (
            sorted(_explore.SCENARIOS) if args.explore == "all"
            else [args.explore]
        )
        unknown = [n for n in names if n not in _explore.SCENARIOS]
        if unknown:
            print(f"error: unknown scenario(s) {unknown}; have "
                  f"{sorted(_explore.SCENARIOS)}", file=sys.stderr)
            return 2
        failed = False
        for name in names:
            res = _explore.explore(
                _explore.SCENARIOS[name],
                max_schedules=args.budget,
                samples=args.samples,
                max_depth=args.depth,
                seed=args.seed,
                seeded_bugs=args.seed_bug,
                wall_cap_s=args.wall_cap,
                device=args.device,
            )
            print(res.summary())
            if res.found:
                failed = True
                for v in (res.shrunk_violations
                          or res.violating.violations):
                    print("  " + v.format())
                print("  minimal schedule:")
                for step in (res.shrunk or res.violating.schedule):
                    print(f"    {step}")
                if args.save_replay:
                    _explore.write_replay(
                        args.save_replay, res, seeded_bugs=args.seed_bug
                    )
                    print(f"  replay written to {args.save_replay} "
                          "(re-run with --replay)")
        return 1 if failed else 0

    if args.check_trace is not None:
        from ray_tpu_torch.analysis.invariants import check_trace

        try:
            violations = check_trace(args.check_trace)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for v in violations:
            print(v.format())
        print(f"{len(violations)} invariant violation(s)")
        return 1 if violations else 0

    if args.dump_rpcflow:
        from ray_tpu_torch.analysis.rpcflow import build_rpcflow, format_rpcflow

        paths = [p_ for p_ in args.paths if os.path.exists(p_)]
        missing = [p_ for p_ in args.paths if not os.path.exists(p_)]
        if missing or not paths:
            print(f"error: no such path(s): {missing}", file=sys.stderr)
            return 2
        report = build_rpcflow(paths, root=os.getcwd())
        if args.format == "json":
            print(json.dumps(report.to_dict(), indent=2))
        else:
            print(format_rpcflow(report))
        return 2 if report.unresolved_entries else 0

    if args.dump_protocol:
        from ray_tpu_torch.analysis.protocol import extract_protocol

        paths = [p_ for p_ in args.paths if os.path.exists(p_)]
        missing = [p_ for p_ in args.paths if not os.path.exists(p_)]
        if missing or not paths:
            print(f"error: no such path(s): {missing}", file=sys.stderr)
            return 2
        try:
            idx = extract_protocol(paths)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(idx.to_dict(), indent=2))
        return 0

    select = (
        [s.strip() for s in args.select.split(",") if s.strip()]
        if args.select
        else None
    )
    if select and args.update_baseline:
        # A partial-check scan would rewrite the baseline without the
        # unselected checks' entries, re-firing them as "new" later.
        print("error: --update-baseline cannot be combined with --select",
              file=sys.stderr)
        return 2
    paths = [p_ for p_ in args.paths if os.path.exists(p_)]
    missing = [p_ for p_ in args.paths if not os.path.exists(p_)]
    if missing or not paths:
        print(f"error: no such path(s): {missing}", file=sys.stderr)
        return 2
    # Fingerprints hash Finding.path, so anchor relpaths to the baseline
    # file's directory: the baseline then works from any cwd.
    root = (
        os.path.dirname(os.path.abspath(args.baseline))
        if args.baseline
        else None
    )
    try:
        result = analyze_paths(paths, root=root, select=select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        if not args.baseline:
            print("error: --update-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        if result.errors:
            # Refuse to write a baseline from a partial scan: findings in
            # the unparseable files would later surface as "new".
            for e in result.errors:
                print(f"parse error: {e}", file=sys.stderr)
            print("error: not updating baseline from a partial scan",
                  file=sys.stderr)
            return 2
        write_baseline(args.baseline, result.findings)
        print(f"wrote {len(result.findings)} finding(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, known = split_by_baseline(result.findings, baseline)

    if args.format == "json":
        print(json.dumps(
            {
                "new": [f.to_dict() for f in new],
                "baselined": [f.to_dict() for f in known],
                "suppressed": result.suppressed,
                "files_scanned": result.files_scanned,
                "errors": result.errors,
                "checks": sorted(select or CHECKERS),
            },
            indent=2,
        ))
    else:
        for f in new:
            print(f.format())
        for f in known:
            print(f"{f.format()}  (baselined)")
        for e in result.errors:
            print(f"parse error: {e}", file=sys.stderr)
        print(
            f"{result.files_scanned} file(s) scanned: {len(new)} new, "
            f"{len(known)} baselined, {result.suppressed} suppressed"
        )
    if result.errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
