"""ray_tpu_torch's cluster launcher: ``cluster_up`` / ``cluster_down`` /
``list_clusters`` from a YAML config, the reference's cases
(tests/test_launcher.py) on the port. The head and the daemons it spawns
run ray_tpu_torch (their /proc/<pid>/cmdline says so, and names no module
of ray_tpu), the head's GCS keeps its rounds on the host through
RAY_TPU_scheduler_device=cpu in its environment, the state files lie
under a session root in tmp_path, and nothing of the cluster is left
running after ``down``: not the head, the daemons, nor their workers."""

import os
import re
import time

import pytest
import yaml

import ray_tpu_torch
from ray_tpu_torch.autoscaler.launcher import (
    cluster_down,
    cluster_up,
    list_clusters,
    load_cluster_config,
)
from ray_tpu_torch.core import config as config_mod


@pytest.fixture
def session(tmp_path, monkeypatch):
    from ray_tpu_torch.autoscaler import launcher

    root = tmp_path / "session"
    # the launcher holds the config object it imported; another test of the
    # process may have rebound the module's name since
    for cfg in {id(c): c for c in (config_mod.GLOBAL_CONFIG, launcher.GLOBAL_CONFIG)}.values():
        monkeypatch.setitem(cfg._values, "session_dir_root", str(root))
    monkeypatch.setenv("RAY_TPU_session_dir_root", str(root))
    monkeypatch.setenv("RAY_TPU_scheduler_device", "cpu")
    return root


def _write_cfg(tmp_path, name, workers=1):
    cfg = {
        "cluster_name": name,
        "provider": {"type": "local"},
        "head_node": {"num_cpus": 2},
        "worker_nodes": {"count": workers, "num_cpus": 2},
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _alive(pid):
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _cmdline(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


def _children(pids):
    """Every live process whose parent is one of `pids` (the daemons'
    workers)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().split(")")[-1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid in pids:
            out.append(int(d))
    return out


def _names_the_reference(cmd):
    return re.search(r"(?<![\w])ray_tpu(?!_torch)[.\s]", cmd + " ") is not None


def test_up_run_task_down(tmp_path, session):
    cfg_path = _write_cfg(tmp_path, "t-launch")
    state = cluster_up(cfg_path)
    workers = []
    try:
        assert state["address"].startswith("127.0.0.1:")
        assert len(state["pids"]) == 3  # head + head daemon + 1 worker node
        assert all(_alive(p) for p in state["pids"])
        cmds = [_cmdline(p) for p in state["pids"]]
        assert "from ray_tpu_torch.cluster.gcs import GcsServer" in cmds[0]
        assert all("-m ray_tpu_torch.cluster.node_daemon" in c for c in cmds[1:])
        assert not any(_names_the_reference(c) for c in cmds), cmds
        assert (session / "clusters" / "t-launch.json").exists()
        assert any(c["cluster_name"] == "t-launch" for c in list_clusters())

        ray_tpu_torch.init(address=state["address"])

        @ray_tpu_torch.remote
        def ping():
            return "pong"

        assert ray_tpu_torch.get(ping.remote(), timeout=90) == "pong"
        assert ray_tpu_torch.cluster_resources().get("CPU") == 4.0
        workers = _children(set(state["pids"]))
        assert workers and all(
            "ray_tpu_torch.cluster.worker" in _cmdline(p) for p in workers)
        ray_tpu_torch.shutdown()
    finally:
        try:
            killed = cluster_down(cfg_path)
        except RuntimeError:
            killed = []
    deadline = time.time() + 15
    everything = state["pids"] + workers
    while time.time() < deadline and any(_alive(p) for p in everything):
        time.sleep(0.2)
    assert not any(_alive(p) for p in everything)
    assert sorted(killed) == sorted(state["pids"])
    assert list_clusters() == []


def test_double_up_refused_and_down_unknown(tmp_path, session):
    cfg_path = _write_cfg(tmp_path, "t-dup", workers=0)
    state = cluster_up(cfg_path)
    try:
        with pytest.raises(RuntimeError, match="already has a state file"):
            cluster_up(cfg_path)
    finally:
        cluster_down(cfg_path)
    with pytest.raises(RuntimeError, match="no state file"):
        cluster_down("t-dup")
    deadline = time.time() + 15
    while time.time() < deadline and any(_alive(p) for p in state["pids"]):
        time.sleep(0.2)
    assert not any(_alive(p) for p in state["pids"])


def test_nonlocal_provider_rejected(tmp_path):
    path = tmp_path / "aws.yaml"
    path.write_text(yaml.safe_dump({"cluster_name": "c", "provider": {"type": "aws"}}))
    with pytest.raises(ValueError, match="not available in this image"):
        load_cluster_config(str(path))


def test_config_defaults_and_node_resources_equal_ray_tpu(tmp_path):
    from ray_tpu.autoscaler import launcher as REF
    from ray_tpu_torch.autoscaler import launcher as L

    path = tmp_path / "min.yaml"
    path.write_text(yaml.safe_dump({"worker_nodes": {"count": 2, "num_tpus": 4}}))
    assert L.load_cluster_config(str(path)) == REF.load_cluster_config(str(path))
    for spec in ({}, {"num_cpus": 8, "memory": 2**30}, {"num_tpus": 4},
                 {"resources": {"GPU": 1, "custom": 2}}):
        assert L._node_resources(spec) == REF._node_resources(spec)
    path.write_text("- not a mapping\n")
    with pytest.raises(ValueError, match="is not a mapping"):
        L.load_cluster_config(str(path))
