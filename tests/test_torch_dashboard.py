"""ray_tpu_torch's dashboard head: the reference's cases
(tests/test_dashboard.py) on the port's head over a port cluster, and
every GET route of the port's head against the reference's head over a
reference cluster that ran the same work: the same status and the same
shape (keys, types, list lengths; node and task ids and times masked).

The GCS's policy is torch_cuda with scheduler_device "cpu"."""

import json
import os
import subprocess
import tempfile
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
from ray_tpu.cluster import Cluster as RefCluster
from ray_tpu.core.config import Config as RefConfig
from ray_tpu.dashboard import DashboardHead as RefDashboardHead
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.dashboard import DashboardHead

CPU = {"scheduler_device": "cpu"}
REF_CFG = {"session_dir_root": os.path.join(tempfile.gettempdir(), "ray_tpu_ref")}
# the route comparison runs both clusters without the gray-failure defense:
# under load its quarantines follow timing alone (its suspicion score, which
# is computed all the same, is masked below)
STEADY = {"gray_defense_enabled": False}


def _reap(c):
    procs = [w.proc for d in c.daemons for w in list(d.workers.values())
             if w.proc is not None]
    c.shutdown()
    for p in procs:
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=5)


@pytest.fixture
def dash():
    c = Cluster(config=Config(CPU))
    head = None
    try:
        c.add_node(num_cpus=2, node_id="dash-node")
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
        head = DashboardHead(c.address)
        yield head
    finally:
        if head is not None:
            head.shutdown()
        ray_tpu_torch.shutdown()
        _reap(c)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read()), r.status


def _work(rt):
    @rt.remote
    def work():
        return 1

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    assert rt.get(work.remote(), timeout=60) == 1
    a = A.remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    return a


def test_dashboard_endpoints(dash):
    _work(ray_tpu_torch)
    body, st = _get(dash.url + "/api/summary")
    assert st == 200 and body["nodes_alive"] == 1
    body, _ = _get(dash.url + "/api/nodes")
    assert any(n["NodeID"] == "dash-node" for n in body)
    body, _ = _get(dash.url + "/api/actors")
    assert any(x["state"] == "ALIVE" for x in body)
    body, _ = _get(dash.url + "/api/tasks?limit=10")
    assert isinstance(body, list) and body
    body, _ = _get(dash.url + "/api/cluster_resources")
    assert body["CPU"] == 2.0
    body, _ = _get(dash.url + "/")
    assert "/api/summary" in body["endpoints"]


def test_dashboard_unknown_route(dash):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(dash.url + "/api/nope")
    assert ei.value.code == 404


def test_events_endpoint(dash):
    body, st = _get(dash.url + "/api/events?limit=50")
    assert st == 200
    assert "NODE_ADDED" in {e["label"] for e in body}
    for e in body:
        assert {"timestamp", "severity", "label", "source"} <= set(e)
    body, _ = _get(dash.url + "/api/events?severity=ERROR")
    assert all(e["severity"] == "ERROR" for e in body)


def test_events_not_duplicated_in_shared_process(dash):
    body, _ = _get(dash.url + "/api/events?limit=500")
    keys = [(e["timestamp"], e.get("pid"), e["label"], e.get("message")) for e in body]
    assert len(keys) == len(set(keys)), "duplicate events in merged view"


def test_node_physical_stats(dash):
    """Per-node psutil stats ride heartbeats into the node table."""
    pytest.importorskip("psutil")
    deadline = time.time() + 30
    stats = {}
    while time.time() < deadline:
        body, _ = _get(dash.url + "/api/nodes")
        stats = next((n.get("Stats") or {} for n in body), {})
        if stats:
            break
        time.sleep(0.5)
    assert "cpu_percent" in stats and stats["mem_total"] > 0, stats


def test_metrics_routes(dash):
    body, st = _get(dash.url + "/api/metrics")
    assert st == 200 and isinstance(body, (dict, list))
    with urllib.request.urlopen(dash.url + "/metrics", timeout=10) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")


ROUTES = ["/", "/api/summary", "/api/nodes", "/api/actors", "/api/tasks?limit=50",
          "/api/placement_groups", "/api/cluster_resources",
          "/api/available_resources", "/api/jobs", "/api/jobs/none",
          "/api/nope"]
# values that differ run to run; their keys and types are compared
_MASK = {"NodeID", "node_id", "actor_id", "task_id", "worker_id", "pid", "start",
         "end", "timestamp", "Stats", "address", "port", "NodeManagerAddress",
         "last_beat", "object_store_memory", "memory", "error", "name", "Suspicion"}


def _shape(x, key=None):
    if isinstance(x, dict):
        return {k: _shape(v, k) for k, v in sorted(x.items())
                if k not in ("Stats", "memory", "object_store_memory")}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    if key in _MASK:
        return type(x).__name__
    return x


def _all_routes(url):
    out = {}
    for r in ROUTES:
        try:
            body, st = _get(url + r)
        except urllib.error.HTTPError as e:
            body, st = json.loads(e.read()), e.code
        if r.startswith("/api/tasks"):
            body = sorted((t["name"], t["status"]) for t in body)
        if r == "/api/summary":
            body = {k: v for k, v in body.items() if k != "tasks_by_state"} | {
                "tasks": sorted(body.get("tasks_by_state", {}).items())}
        out[r] = (st, _shape(body))
    return out


def test_every_route_answers_as_ray_tpus_head():
    got = []
    for rt, C, cfg, H in ((ray_tpu_torch, Cluster, Config({**CPU, **STEADY}), DashboardHead),
                          (ray_tpu, RefCluster, RefConfig({**REF_CFG, **STEADY}),
                           RefDashboardHead)):
        c = C(config=cfg)
        head = None
        try:
            c.add_node(num_cpus=2, node_id="route-node")
            c.wait_for_nodes(1)
            rt.init(address=c.address)
            _work(rt)
            time.sleep(0.3)
            head = H(c.address)
            got.append(_all_routes(head.url))
        finally:
            if head is not None:
                head.shutdown()
            rt.shutdown()
            _reap(c)
    port, ref = got
    assert port.keys() == ref.keys()
    for r in ROUTES:
        assert port[r] == ref[r], r
    assert port["/api/nope"][0] == 404 and port["/api/jobs/none"][0] == 404
