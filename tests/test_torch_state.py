"""ray_tpu_torch's state API and timeline against ray_tpu's on the same
tasks: in local mode and on a cluster, each package runs the same
workload and the listings agree in their keys and states, the task
summaries in their counts, and the Chrome trace in its events once the
ids and times are masked. ``chrome_trace`` on given events (the compiled
graph's ``dag_stage`` rows among them) is equal outright.

The port's GCS and local runtime use scheduler_device "cpu"."""

import json
import os
import subprocess
import tempfile
import time

import pytest

import ray_tpu
from ray_tpu.cluster import Cluster as RefCluster
from ray_tpu.core.config import Config as RefConfig
from ray_tpu.util import state as ref_state
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.util import state

CPU = {"scheduler_device": "cpu"}
TORCH_CPU = {"scheduling_policy": "torch_cuda", "scheduler_device": "cpu",
             "jax_policy_min_cells": 0}
REF_CFG = {"session_dir_root": os.path.join(tempfile.gettempdir(), "ray_tpu_ref")}


def _workload(rt, st):
    """Five tasks, three timed steps and one actor; what the state API
    says of them."""

    @rt.remote
    def work(x):
        return x + 1

    @rt.remote
    def step():
        time.sleep(0.01)

    @rt.remote
    class Keeper:
        def get(self):
            return 1

    k = Keeper.remote()
    assert rt.get([work.remote(i) for i in range(5)], timeout=60) == [1, 2, 3, 4, 5]
    rt.get([step.remote() for _ in range(3)], timeout=60)
    assert rt.get(k.get.remote(), timeout=60) == 1
    time.sleep(0.3)  # the last task events reach the GCS
    tasks = st.list_tasks()
    trace = st.chrome_trace()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        st.dump_timeline(path)
        dumped = json.load(open(path))
    finally:
        os.unlink(path)
    return {
        "task_keys": sorted({k for t in tasks for k in t}),
        "tasks": sorted((t["name"], t["status"]) for t in tasks
                        if t.get("name") in ("work", "step")),
        "actors": sorted(a["state"] for a in st.list_actors()),
        "actor_keys": sorted({k for a in st.list_actors() for k in a}),
        "nodes": len(st.list_nodes()),
        "node_keys": sorted({k for n in st.list_nodes() for k in n}),
        "objects": len(st.list_objects()) >= 5,
        "pgs": st.list_placement_groups(),
        "summary_keys": sorted(st.summary()),
        "summarize": {n: v for n, v in st.summarize_tasks().items()
                      if n in ("work", "step")},
        "trace": sorted(
            (e["name"], e["ph"], e["cat"], e["args"]["status"])
            for e in trace if e["name"] in ("work", "step")),
        "trace_keys": sorted({k for e in trace for k in e}),
        "durations_positive": all(e["dur"] > 0 for e in trace if e["name"] == "step"),
        "dumped": len(dumped) == len(trace),
        # the local ring is the process's: other tests in it may have filled
        # or cleared it, so only its form is compared
        "events": all({"timestamp", "severity", "label", "source"} <= set(e)
                      for e in st.list_cluster_events()),
    }


def test_state_api_local_mode_equals_ray_tpu():
    ray_tpu_torch.init(num_cpus=4, _system_config=TORCH_CPU)
    try:
        port = _workload(ray_tpu_torch, state)
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        ref = _workload(ray_tpu, ref_state)
    finally:
        ray_tpu.shutdown()
    assert port == ref
    assert port["summarize"]["work"]["FINISHED"] == 5
    assert port["nodes"] == 1 and port["actors"] == ["ALIVE"]


def _teardown(c, shutdown):
    procs = [w.proc for d in c.daemons for w in list(d.workers.values())
             if w.proc is not None]
    try:
        shutdown()
    finally:
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)


def test_state_api_on_a_cluster_equals_ray_tpu():
    out = []
    for rt, st, C, cfg in ((ray_tpu_torch, state, Cluster, Config(CPU)),
                           (ray_tpu, ref_state, RefCluster, RefConfig(REF_CFG))):
        c = C(config=cfg)
        try:
            c.add_node(num_cpus=2, node_id="s1")
            c.add_node(num_cpus=2, node_id="s2")
            c.wait_for_nodes(2)
            rt.init(address=c.address)
            r = _workload(rt, st)
            r["nodes_alive"] = st.summary()["nodes_alive"]
            out.append(r)
        finally:
            _teardown(c, rt.shutdown)
    port, ref = out
    assert port == ref
    assert port["nodes"] == 2 and port["nodes_alive"] == 2


def _events():
    """Task events of every kind chrome_trace renders: a task, an actor
    task, a compiled graph's stage span, one without an end (left out)."""
    return [
        {"task_id": "t1", "name": "f", "start": 10.0, "end": 10.5,
         "node_id": "n1", "worker_id": "w1", "status": "FINISHED"},
        {"task_id": "t2", "name": "A.m", "start": 10.1, "end": 10.2,
         "node_id": "n1", "actor_id": "a1", "status": "FINISHED"},
        {"task_id": "t3", "start": 11.0, "end": 11.25, "node": "n2",
         "stage": "dag-stage-0", "status": "FINISHED"},
        {"task_id": "t4", "name": "g", "start": 12.0, "end": None},
        {"name": "h", "start": 13.0, "end": 13.001},
    ]


def test_chrome_trace_rows_equal_ray_tpu(tmp_path):
    got = state.chrome_trace(_events())
    assert got == ref_state.chrome_trace(_events())
    assert [e["cat"] for e in got] == ["task", "actor_task", "dag_stage", "task"]
    assert got[2]["tid"] == "dag-stage-0" and got[2]["pid"] == "n2"
    path = state.dump_timeline(str(tmp_path / "t.json"), _events())
    assert json.load(open(path)) == json.load(
        open(ref_state.dump_timeline(str(tmp_path / "r.json"), _events())))


def test_state_names_equal_ray_tpu():
    assert sorted(state.__all__) == sorted(ref_state.__all__)


@pytest.mark.parametrize("filters", [None, {"name": "work"}, {"status": "FINISHED"}])
def test_list_tasks_filters(filters):
    ray_tpu_torch.init(num_cpus=2, _system_config=TORCH_CPU)
    try:
        @ray_tpu_torch.remote
        def work():
            return 1

        @ray_tpu_torch.remote
        def other():
            return 2

        ray_tpu_torch.get([work.remote(), other.remote()], timeout=60)
        got = state.list_tasks(filters=filters)
        assert got
        for k, v in (filters or {}).items():
            assert all(t[k] == v for t in got)
    finally:
        ray_tpu_torch.shutdown()
