"""Cluster launcher: `up / down` from a YAML config.

Reference: python/ray/autoscaler/_private/commands.py (`ray up` reads the
cluster YAML, boots the head through the provider, brings worker nodes up)
— minus cloud SSH/rsync, which this image cannot exercise: the in-tree
provider launches real SEPARATE PROCESSES on this host (the same topology
production uses per machine), and the provider seam (autoscaler/provider.py
NodeProvider) is where cloud implementations plug in.

State lives in <session_dir_root>/clusters/<name>.json (pids + address), so
`down` can tear down exactly what `up` started. The head and the daemons
run ray_tpu_torch's modules; the head's GcsServer takes its config from the
environment (RAY_TPU_scheduler_device=cpu keeps its rounds on the host),
and by default runs them on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import yaml

from ray_tpu_torch.core.config import GLOBAL_CONFIG


def _state_dir() -> str:
    d = os.path.join(GLOBAL_CONFIG.session_dir_root, "clusters")
    os.makedirs(d, exist_ok=True)
    return d


def _state_path(name: str) -> str:
    return os.path.join(_state_dir(), f"{name}.json")


def load_cluster_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"cluster config {path} is not a mapping")
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "local"})
    if cfg["provider"].get("type", "local") != "local":
        raise ValueError(
            f"provider type {cfg['provider'].get('type')!r} not available "
            "in this image; only 'local' (separate processes on this host) "
            "is built in — cloud providers implement the NodeProvider seam"
        )
    cfg.setdefault("head_node", {})
    cfg.setdefault("worker_nodes", {})
    return cfg


def _log_file(name: str, what: str):
    return open(os.path.join(_state_dir(), f"{name}-{what}.log"), "ab")


def _spawn_head(name: str, env) -> tuple:
    # stderr goes to a log file, NEVER inherited: a launched head holding
    # the CLI's stderr open would wedge anything capturing the CLI's output
    # (the process outlives the `up` command by design)
    with _log_file(name, "head") as log:
        head = subprocess.Popen(
            [sys.executable, "-c",
             "from ray_tpu_torch.cluster.gcs import GcsServer\n"
             "import time\n"
             "g = GcsServer()\n"
             "print(g.port, flush=True)\n"
             "while True: time.sleep(1)\n"],
            stdout=subprocess.PIPE, stderr=log, env=env,
            start_new_session=True,
        )
    line = head.stdout.readline().strip()
    if not line:
        raise RuntimeError("head process failed to start")
    head.stdout.close()
    return head, int(line)


def _spawn_daemon(port: int, resources: Dict[str, float], node_id: str,
                  env) -> subprocess.Popen:
    with _log_file(node_id, "daemon") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.cluster.node_daemon",
             "--gcs-host", "127.0.0.1", "--gcs-port", str(port),
             "--resources", json.dumps(resources),
             "--node-id", node_id],
            stdout=log, stderr=log, env=env, start_new_session=True,
        )


def _node_resources(spec: Dict[str, Any]) -> Dict[str, float]:
    res = {"CPU": float(spec.get("num_cpus", 4))}
    if spec.get("num_tpus"):
        res["TPU"] = float(spec["num_tpus"])
    if spec.get("memory"):
        res["memory"] = float(spec["memory"])
    res.update(spec.get("resources") or {})
    return res


def cluster_up(config_path: str) -> Dict[str, Any]:
    """Boot the cluster described by the YAML; returns {name, address,
    pids}. Refuses if a state file says it is already up."""
    cfg = load_cluster_config(config_path)
    name = cfg["cluster_name"]
    if os.path.exists(_state_path(name)):
        raise RuntimeError(
            f"cluster {name!r} already has a state file "
            f"({_state_path(name)}); run `down` first"
        )
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))) + os.pathsep + env.get("PYTHONPATH", "")
    )
    procs: List[subprocess.Popen] = []
    try:
        head, port = _spawn_head(name, env)
        procs.append(head)
        head_res = _node_resources(cfg["head_node"])
        procs.append(_spawn_daemon(port, head_res, f"{name}-head", env))
        workers = cfg["worker_nodes"]
        count = int(workers.get("count", 0))
        worker_res = _node_resources(workers) if count else {}
        for i in range(count):
            procs.append(
                _spawn_daemon(port, worker_res, f"{name}-worker-{i}", env)
            )
    except BaseException:
        # mid-sequence spawn failure: without a state file `down` could
        # never find the survivors — tear down what already started
        for p in procs:
            try:
                p.terminate()
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001
                pass
        raise
    pids = [p.pid for p in procs]
    state = {
        "cluster_name": name,
        "address": f"127.0.0.1:{port}",
        "pids": pids,
        "started_at": time.time(),
    }
    with open(_state_path(name), "w") as f:
        json.dump(state, f)
    return state


def cluster_down(name_or_config: str) -> List[int]:
    """Tear down a cluster by name or config path; returns killed pids."""
    name = name_or_config
    if os.path.exists(name_or_config) and name_or_config.endswith(
        (".yaml", ".yml")
    ):
        name = load_cluster_config(name_or_config)["cluster_name"]
    path = _state_path(name)
    if not os.path.exists(path):
        raise RuntimeError(f"no state file for cluster {name!r} at {path}")
    with open(path) as f:
        state = json.load(f)
    killed = []
    import signal

    def _is_ours(pid: int) -> bool:
        """PID-reuse guard: only signal processes whose cmdline is one of
        ours (a stale state file's pids may now belong to anything)."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            return False
        return b"ray_tpu" in cmd or b"GcsServer" in cmd

    for pid in state.get("pids", []):
        if not _is_ours(pid):
            continue
        try:
            os.kill(pid, signal.SIGTERM)
            killed.append(pid)
        except ProcessLookupError:
            pass
    deadline = time.time() + 5
    for pid in killed:
        while time.time() < deadline:
            # reap first when we're the parent — a terminated child stays a
            # zombie (kill(pid, 0) still succeeds) until waited on
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
    os.remove(path)
    return killed


def list_clusters() -> List[Dict[str, Any]]:
    out = []
    for fname in sorted(os.listdir(_state_dir())):
        if fname.endswith(".json"):
            with open(os.path.join(_state_dir(), fname)) as f:
                out.append(json.load(f))
    return out
