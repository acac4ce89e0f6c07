"""CLI: start/stop/status/list/summary/timeline/memory/metrics/
microbenchmark.

Reference: python/ray/scripts/scripts.py (`ray start --head`,
`ray start --address`, `ray stop`, `ray status`, `ray list ...`,
`ray summary`, `ray timeline`, `ray memory`, `ray microbenchmark`) plus
the dashboard metrics view (`ray_tpu_torch metrics` / `--top` / `--prom`, see
ray_tpu_torch.obs). Invoke as ``python -m ray_tpu_torch <command>``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

# under TMPDIR, and named apart from the reference package's session, whose
# `stop` signals every pid its own file lists
_SESSION_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
_ADDR_FILE = os.path.join(_SESSION_DIR, "address")
_PID_FILE = os.path.join(_SESSION_DIR, "pids")
# the reference's 15 s: the head opens the card before it writes its
# address, which took up to 11.66 s on an H100's host (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md); a head that exits is reported at once
HEAD_START_TIMEOUT_S = 15.0


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get("RAY_TPU_ADDRESS")
    if not addr and os.path.exists(_ADDR_FILE):
        addr = open(_ADDR_FILE).read().strip()
    if not addr:
        sys.exit("no cluster address (use --address, RAY_TPU_ADDRESS, or "
                 "start a head node on this machine first)")
    return addr


def _record_pid(pid: int):
    os.makedirs(_SESSION_DIR, exist_ok=True)
    with open(_PID_FILE, "a") as f:
        f.write(f"{pid}\n")


def cmd_start(args):
    res = {"CPU": float(args.num_cpus)}
    if args.num_tpus:
        res["TPU"] = float(args.num_tpus)
    if args.memory:
        res["memory"] = float(args.memory)
    if args.resources:
        res.update(json.loads(args.resources))

    if not args.block:
        # daemonize: re-exec ourselves with --block in the background
        if args.head:
            # a stale address file from a crashed head would be mistaken for
            # the new head's address in the wait loop below
            try:
                os.remove(_ADDR_FILE)
            except OSError:
                pass
        cmd = [sys.executable, "-m", "ray_tpu_torch"] + sys.argv[1:] + ["--block"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        _record_pid(proc.pid)
        # wait for the address file (head) or just report (worker)
        if args.head:
            deadline = time.time() + HEAD_START_TIMEOUT_S
            while time.time() < deadline:
                if os.path.exists(_ADDR_FILE):
                    addr = open(_ADDR_FILE).read().strip()
                    print(f"ray_tpu_torch head started at {addr} (pid {proc.pid})")
                    print(f"connect with: ray_tpu_torch.init(address={addr!r})")
                    return
                if proc.poll() is not None:
                    break  # the head exited: it will not come up
                time.sleep(0.1)
            sys.exit(f"head did not come up within {HEAD_START_TIMEOUT_S:.0f}s")
        print(f"ray_tpu_torch node started (pid {proc.pid})")
        return

    # --block: run the node in THIS process
    from ray_tpu_torch.analysis import waitgraph
    from ray_tpu_torch.cluster.gcs import GcsServer
    from ray_tpu_torch.cluster.node_daemon import NodeDaemon

    # `ray_tpu_torch stacks` protocol: SIGUSR1 makes this process write an
    # annotated all-thread stack dump artifact (wait edges + held locks
    # when the wait sanitizer is live, plain stacks otherwise)
    waitgraph.install_stack_signal()
    if args.head:
        gcs = GcsServer(host="127.0.0.1", port=args.port or 0)
        addr = f"127.0.0.1:{gcs.port}"
        os.makedirs(_SESSION_DIR, exist_ok=True)
        with open(_ADDR_FILE, "w") as f:
            f.write(addr)
        daemon = NodeDaemon(("127.0.0.1", gcs.port), res, host="127.0.0.1")
        print(f"head up at {addr}")
    else:
        host, port = _resolve_address(args).rsplit(":", 1)
        daemon = NodeDaemon((host, int(port)), res, host="127.0.0.1")
        print(f"node joined {host}:{port}")
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.5)
    daemon.shutdown()
    if args.head:
        gcs.shutdown()
        try:
            os.remove(_ADDR_FILE)
        except OSError:
            pass


def cmd_stop(args):
    n = 0
    if os.path.exists(_PID_FILE):
        for line in open(_PID_FILE):
            try:
                os.kill(int(line.strip()), signal.SIGTERM)
                n += 1
            except (OSError, ValueError):
                pass
        os.remove(_PID_FILE)
    for f in (_ADDR_FILE,):
        try:
            os.remove(f)
        except OSError:
            pass
    print(f"stopped {n} process(es)")


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args), ignore_reinit_error=True)
    return ray_tpu_torch


def cmd_stacks(args):
    """Dump all-thread stacks of every locally-started cluster process,
    annotated with the wait sanitizer's current wait edges and held
    locks (the observability face of the wait graph). Protocol: SIGUSR1
    each pid in the session pid file; each process's waitgraph signal
    handler writes a ``waitgraph-<pid>-stacks-*.jsonl`` artifact, which
    this command collects and pretty-prints."""
    from ray_tpu_torch.analysis import waitgraph

    if not os.path.exists(_PID_FILE):
        sys.exit("no local session (start a node with `ray_tpu_torch start` "
                 "first)")
    t0 = time.time()
    pids = []
    for line in open(_PID_FILE):
        try:
            pid = int(line.strip())
            os.kill(pid, signal.SIGUSR1)
            pids.append(pid)
        except (OSError, ValueError):
            pass
    if not pids:
        sys.exit("no live locally-started cluster process to signal")
    art_dir = args.artifact_dir or os.environ.get(
        "RAY_TPU_FLIGHTREC_DIR", "artifacts")
    found = {}
    deadline = t0 + args.timeout
    while time.time() < deadline and len(found) < len(pids):
        if os.path.isdir(art_dir):
            for name in sorted(os.listdir(art_dir)):
                if not name.startswith("waitgraph-") \
                        or "-stacks-" not in name:
                    continue
                try:
                    pid = int(name.split("-")[1])
                except (IndexError, ValueError):
                    continue
                path = os.path.join(art_dir, name)
                # only dumps written in RESPONSE to this signal round:
                # a stale artifact would report last week's stacks
                if pid in pids and pid not in found \
                        and os.path.getmtime(path) >= t0 - 1.0:
                    found[pid] = path
        time.sleep(0.1)
    if not found:
        sys.exit(f"signalled {len(pids)} process(es) but no stack dump "
                 f"appeared under {art_dir}/ within {args.timeout:.0f}s "
                 "(the node must run in the same working directory, or "
                 "set RAY_TPU_FLIGHTREC_DIR)")
    fmt = waitgraph.WaitSanitizer()  # formatting only, never installed
    for pid, path in sorted(found.items()):
        entries = []
        with open(path) as f:
            for ln in f:
                e = json.loads(ln)
                if e.get("kind") != "waitgraph-stacks":
                    entries.append(e)
        print(f"== pid {pid} — {len(entries)} thread(s) ({path})")
        print(fmt.format_stacks(entries))
    missing = sorted(set(pids) - set(found))
    if missing:
        sys.exit(f"no dump from pid(s) {missing}")


def cmd_status(args):
    rt = _connect(args)
    from ray_tpu_torch.util import state

    s = state.summary()
    print("cluster summary:")
    for k, v in s.items():
        print(f"  {k:<20}{v}")
    print("resources:")
    total = rt.cluster_resources()
    avail = rt.available_resources()
    for k in sorted(total):
        print(f"  {k:<12}{avail.get(k, 0):>12.1f} / {total[k]:.1f}")


def cmd_list(args):
    _connect(args)
    from ray_tpu_torch.util import state

    kind = args.kind
    fn = {
        "tasks": lambda: state.list_tasks(args.limit),
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "objects": lambda: state.list_objects(args.limit),
        "placement-groups": state.list_placement_groups,
        "cluster-events": lambda: state.list_cluster_events(args.limit),
    }[kind]
    rows = fn()
    print(json.dumps(rows, indent=1, default=str))


def cmd_summary(args):
    _connect(args)
    from ray_tpu_torch.util import state

    print(json.dumps(state.summarize_tasks(), indent=1))


def cmd_timeline(args):
    _connect(args)
    from ray_tpu_torch.util.state import dump_timeline

    out = args.output or f"timeline_{int(time.time())}.json"
    dump_timeline(out)
    print(f"wrote chrome trace to {out} (open in chrome://tracing or Perfetto)")


def cmd_memory(args):
    _connect(args)
    from ray_tpu_torch.util import state

    objs = state.list_objects(args.limit)
    total = sum(o.get("approx_size", 0) for o in objs)
    print(f"{len(objs)} objects, ~{total/1e6:.1f} MB (driver-visible)")
    for o in objs[:50]:
        print(f"  {o['object_id'][:16]:<18}{o['type']:<16}{o['approx_size']:>10}")


def cmd_microbenchmark(args):
    from ray_tpu_torch.scripts.ray_perf import main as perf_main

    perf_main(address=getattr(args, "address", None), quick=args.quick)


def cmd_metrics(args):
    """Cluster-aggregated metrics view (ray_tpu_torch.obs). Default: compact
    counter/gauge summary. ``--top``: rank GCS/daemon rpc-handler
    self-time — where the per-task control-plane milliseconds go.
    ``--prom``: raw Prometheus text (what the dashboard's /metrics
    serves)."""
    from ray_tpu_torch.cluster.rpc import RpcClient

    host, _, port = _resolve_address(args).rpartition(":")
    c = RpcClient(host, int(port), name="cli-metrics", peer="gcs")
    try:
        if args.prom:
            print(c.call("metrics", {"format": "prometheus"},
                         timeout=15.0)["text"], end="")
            return
        agg = c.call("metrics", {"format": "json"}, timeout=15.0)["metrics"]
        if args.top:
            from ray_tpu_torch.obs import rank_handler_time

            rows = rank_handler_time(agg, limit=args.limit)
            print(f"{'surface':<8}{'method':<28}{'node':<16}"
                  f"{'calls':>8}{'total_s':>10}{'mean_us':>10}")
            for r in rows:
                print(f"{r['surface']:<8}{r['method']:<28}"
                      f"{r['node'][:15]:<16}{r['calls']:>8}"
                      f"{r['total_s']:>10.4f}{r['mean_us']:>10.1f}")
            return
        for name in sorted(agg):
            m = agg[name]
            if m["kind"] == "histogram":
                total = sum(s.get("count", 0) for s in m["series"])
                hsum = sum(s.get("sum", 0.0) for s in m["series"])
                print(f"{name:<44}{m['kind']:<10}n={total} sum={hsum:.4f}s")
            else:
                val = sum(s.get("value", 0.0) for s in m["series"])
                print(f"{name:<44}{m['kind']:<10}{val:g}")
    finally:
        c.close()


def cmd_dashboard(args):
    import time as _time

    from ray_tpu_torch.dashboard import DashboardHead

    head = DashboardHead(_resolve_address(args), port=args.port)
    print(f"dashboard serving at {head.url} (ctrl-c to stop)")
    try:
        while True:
            _time.sleep(1)
    except KeyboardInterrupt:
        head.shutdown()


def cmd_job(args):
    """Job CLI over the dashboard head's REST API (reference:
    python/ray/dashboard/modules/job/cli.py — also a thin HTTP client)."""
    import shlex
    import urllib.error
    import urllib.request

    base = f"http://{args.dashboard}"

    def req(path, payload=None):
        data = json.dumps(payload).encode() if payload is not None else None
        r = urllib.request.Request(
            base + path, data=data,
            headers={"Content-Type": "application/json"},
            method="POST" if data is not None else "GET",
        )
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # the head returns JSON error bodies with 4xx — show them
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001
                body = {"error": str(e)}
            sys.exit(f"error: {body.get('error', body)}")
        except urllib.error.URLError as e:
            sys.exit(f"dashboard not reachable at {base}: {e.reason}")

    if args.job_command == "submit":
        ep = args.entrypoint
        if ep and ep[0] == "--":  # argparse REMAINDER keeps the separator
            ep = ep[1:]
        # shlex.join: the head re-parses this with shell=True, so each argv
        # element must survive re-quoting (spaces, -c scripts, metachars)
        body = {"entrypoint": shlex.join(ep)}
        if args.submission_id:
            body["submission_id"] = args.submission_id
        out = req("/api/jobs", body)
    elif args.job_command == "list":
        out = req("/api/jobs")
    elif args.job_command == "status":
        out = req(f"/api/jobs/{args.job_id}")
    elif args.job_command == "logs":
        out = req(f"/api/jobs/{args.job_id}/logs")
        print(out.get("logs", ""))
        return
    else:  # stop
        out = req(f"/api/jobs/{args.job_id}/stop", {})
    print(json.dumps(out, indent=2))


def cmd_up(args):
    from ray_tpu_torch.autoscaler.launcher import cluster_up
    from ray_tpu_torch.util.usage import record_event

    state = cluster_up(args.config)
    record_event("cluster_up", cluster=state["cluster_name"],
                 nodes=len(state["pids"]) - 1)
    print(f"cluster {state['cluster_name']!r} up at {state['address']} "
          f"({len(state['pids'])} processes)")
    print(f"connect with: ray_tpu_torch.init(address={state['address']!r})")


def cmd_down(args):
    from ray_tpu_torch.autoscaler.launcher import cluster_down

    killed = cluster_down(args.cluster)
    print(f"terminated {len(killed)} processes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="head address for worker nodes")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-cpus", type=float, default=os.cpu_count() or 4)
    sp.add_argument("--num-tpus", type=float, default=0)
    sp.add_argument("--memory", type=float, default=0)
    sp.add_argument("--resources", help="extra resources as JSON")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop locally started nodes")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser(
        "stacks",
        help="dump all-thread stacks of every local cluster process, "
             "annotated with wait edges and held locks (waitgraph)")
    sp.add_argument("--timeout", type=float, default=2.5,
                    help="seconds to wait for the dumps (default 2.5)")
    sp.add_argument("--artifact-dir", default=None,
                    help="where the node processes write waitgraph "
                         "artifacts (default: $RAY_TPU_FLIGHTREC_DIR "
                         "or artifacts/)")
    sp.set_defaults(fn=cmd_stacks)

    for name, fn in (("status", cmd_status), ("summary", cmd_summary),
                     ("timeline", cmd_timeline), ("memory", cmd_memory)):
        sp = sub.add_parser(name)
        sp.add_argument("--address")
        sp.add_argument("--limit", type=int, default=1000)
        if name == "timeline":
            sp.add_argument("-o", "--output")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("list", help="list tasks/actors/nodes/objects/placement-groups/cluster-events")
    sp.add_argument("kind", choices=["tasks", "actors", "nodes", "objects",
                                     "placement-groups", "cluster-events"])
    sp.add_argument("--address")
    sp.add_argument("--limit", type=int, default=1000)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser(
        "metrics", help="cluster metrics: summary, --top handler ranking, "
        "--prom Prometheus text")
    sp.add_argument("--address")
    sp.add_argument("--top", action="store_true",
                    help="rank rpc handler self-time (GCS + daemons)")
    sp.add_argument("--prom", action="store_true",
                    help="print raw Prometheus exposition text")
    sp.add_argument("--limit", type=int, default=20)
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("microbenchmark", help="single-node perf quick check")
    sp.add_argument("--address")
    sp.add_argument("--quick", action="store_true")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("dashboard", help="serve cluster state over HTTP/JSON")
    sp.add_argument("--address")
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("job", help="submit/inspect jobs via the dashboard")
    jsub = sp.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit", help="run an entrypoint as a job")
    js.add_argument("--dashboard", default="127.0.0.1:8265")
    js.add_argument("--submission-id", default=None)
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("list", "status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("--dashboard", default="127.0.0.1:8265")
        if name != "list":
            jp.add_argument("job_id")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("up", help="launch a cluster from a YAML config")
    sp.add_argument("config", help="cluster YAML path")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a launched cluster")
    sp.add_argument("cluster", help="cluster name or YAML path")
    sp.set_defaults(fn=cmd_down)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
