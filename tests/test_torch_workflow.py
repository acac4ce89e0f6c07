"""ray_tpu_torch.workflow held against ray_tpu.workflow on the CPU.

- The five cases of tests/test_workflow.py, run by both packages in local
  mode; results and list_all() equal.
- Step ids equal the reference's for the same DAG (a step id is the SHA-1
  of serialization.dumps of the function's module, its qualname and its
  arguments' ids).
- A driver process killed mid-DAG, after its first step's result was
  stored: resume() by id in a fresh process reruns only the missing steps,
  in both packages.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import ray_tpu
from ray_tpu import workflow as ref_workflow
import ray_tpu_torch
from ray_tpu_torch import workflow as port_workflow
from test_torch_runtime import TORCH_CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": (ray_tpu, ref_workflow), "port": (ray_tpu_torch, port_workflow)}


def both(fn, tmp_path):
    """fn(workflow, root) in a fresh local runtime of each package (4
    CPUs), the reference first, each with a storage root of its own."""
    out = {}
    for which, (rt, wf) in PACKAGES.items():
        if which == "ref":
            rt.init(num_cpus=4)
        else:
            rt.init(num_cpus=4, _system_config=TORCH_CPU)
        try:
            root = tmp_path / which
            root.mkdir()
            out[which] = fn(wf, str(root))
        finally:
            rt.shutdown()
    return out["ref"], out["port"]


def _touch_counter(path):
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    return n + 1


# ------------------------------------------ tests/test_workflow.py's 5 cases


def test_linear_workflow_runs(tmp_path):
    def add(a, b):
        return a + b

    def double(x):
        return 2 * x

    def fn(wf, root):
        out = wf.run(wf.step(double)(wf.step(add)(3, 4)), "wf-linear", storage_root=root)
        return out, wf.list_all(root)

    ref, port = both(fn, tmp_path)
    assert port == ref == (14, [{"workflow_id": "wf-linear", "status": "FINISHED",
                                 "steps_done": 2}])


def test_diamond_dag_shares_step(tmp_path):
    def fn(wf, root):
        marker = os.path.join(root, "count.txt")

        def base():
            return _touch_counter(marker)

        def inc(x):
            return x + 1

        def add(a, b):
            return a + b

        b = wf.step(base)()
        dag = wf.step(add)(wf.step(inc)(b), wf.step(inc)(b))
        return wf.run(dag, "wf-diamond", storage_root=root), open(marker).read()

    ref, port = both(fn, tmp_path)
    assert port == ref == (4, "1")


def test_resume_skips_completed_steps(tmp_path):
    def fn(wf, root):
        marker_a = os.path.join(root, "a.txt")
        marker_b = os.path.join(root, "b.txt")
        flag = os.path.join(root, "fail_b")

        def step_a():
            _touch_counter(marker_a)
            return "A"

        def step_b(x):
            _touch_counter(marker_b)
            if os.path.exists(flag):
                raise RuntimeError("transient failure in B")
            return x + "B"

        dag = wf.step(step_b, max_retries=0)(wf.step(step_a)())
        open(flag, "w").close()
        with pytest.raises(Exception, match="transient failure"):
            wf.run(dag, "wf-resume", storage_root=root)
        os.remove(flag)
        failed = wf.list_all(root)
        out = wf.resume("wf-resume", storage_root=root)
        return (failed, out, open(marker_a).read(), open(marker_b).read(),
                wf.list_all(root))

    ref, port = both(fn, tmp_path)
    assert port == ref
    assert port[0] == [{"workflow_id": "wf-resume", "status": "FAILED", "steps_done": 1}]
    assert port[1:4] == ("AB", "1", "2") and port[4][0]["status"] == "FINISHED"


def test_resume_finished_workflow_is_noop_rerun(tmp_path):
    def fn(wf, root):
        marker = os.path.join(root, "m.txt")

        def s():
            _touch_counter(marker)
            return 42

        dag = wf.step(s)()
        return (wf.run(dag, "wf-done", storage_root=root),
                wf.resume("wf-done", storage_root=root), open(marker).read())

    ref, port = both(fn, tmp_path)
    assert port == ref == (42, 42, "1")


def test_step_options_flow_to_tasks(tmp_path):
    def res_probe():
        return "ok"

    ref, port = both(lambda wf, root: wf.run(wf.step(res_probe, num_cpus=2)(), "wf-opts",
                                             storage_root=root), tmp_path)
    assert port == ref == "ok"


# ------------------------------------------------------------------ step ids


def _load(seed, n):
    return np.random.default_rng(seed).normal(size=n)


def _scale(x, factor=1.0):
    return x * factor


def _join(a, b, tag="t"):
    return float(a.sum() + b.sum()), tag


def _dag(wf):
    weights = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = wf.step(_load)(7, 16)
    b = wf.step(_scale)(a, factor=2.5)
    c = wf.step(_scale, num_cpus=1)(wf.step(_load)(8, 16))
    return wf.step(_join)(b, c, tag="join"), [a, b, c, wf.step(_scale)(weights, factor=-1)]


def test_step_ids_equal_reference():
    """The same DAG gets the same ids in both packages (plain arguments:
    ints, floats, strings, numpy arrays, steps, keywords), so a stored
    workflow's results match its steps in either."""
    ref_entry, ref_nodes = _dag(ref_workflow)
    port_entry, port_nodes = _dag(port_workflow)
    assert port_entry.step_id == ref_entry.step_id
    assert [s.step_id for s in port_nodes] == [s.step_id for s in ref_nodes]
    assert len({s.step_id for s in port_nodes + [port_entry]}) == 5
    assert port_workflow.step(_load)(7, 17).step_id != port_nodes[0].step_id


# --------------------------------------------------- a killed driver, resumed

DRIVER = textwrap.dedent('''
    import os, sys, time
    sys.path.insert(0, {root!r})
    import {pkg} as rt
    from {pkg} import workflow as wf
    storage, config = sys.argv[1], {config}

    def bump(path):
        n = int(open(path).read()) if os.path.exists(path) else 0
        with open(path, "w") as f:
            f.write(str(n + 1))

    def first():
        bump(os.path.join(storage, "first.count"))
        return 20

    def second(x):
        bump(os.path.join(storage, "second.count"))
        block = os.path.join(storage, "block")
        deadline = time.time() + 120
        while os.path.exists(block) and time.time() < deadline:
            time.sleep(0.05)
        return x + 1

    def third(x):
        bump(os.path.join(storage, "third.count"))
        return x * 2

    rt.init(num_cpus=2, **config)
    wf.run(wf.step(third)(wf.step(second)(wf.step(first)())), "wf-killed",
           storage_root=storage)
''')


@pytest.mark.parametrize("which", ["ref", "port"])
def test_resume_after_the_driver_is_killed_mid_dag(tmp_path, which):
    """The driver runs first -> second -> third and is killed (SIGKILL)
    while second runs: first's result is stored, the status is RUNNING.
    resume by id, in this process, reruns second and third only."""
    rt, wf = PACKAGES[which]
    pkg = rt.__name__
    config = {"_system_config": TORCH_CPU} if which == "port" else {}
    storage = str(tmp_path)
    open(os.path.join(storage, "block"), "w").close()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRIVER.format(root=ROOT, pkg=pkg, config=repr(config)),
         storage], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while not os.path.exists(os.path.join(storage, "second.count")):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.time() < deadline, "the driver never reached its second step"
            time.sleep(0.05)
        before = wf.list_all(storage)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert before == [{"workflow_id": "wf-killed", "status": "RUNNING", "steps_done": 1}]
    os.remove(os.path.join(storage, "block"))
    if which == "ref":
        rt.init(num_cpus=2)
    else:
        rt.init(num_cpus=2, _system_config=TORCH_CPU)
    try:
        out = wf.resume("wf-killed", storage_root=storage)
    finally:
        rt.shutdown()
    counts = {s: open(os.path.join(storage, f"{s}.count")).read()
              for s in ("first", "second", "third")}
    assert out == 42
    assert counts == {"first": "1", "second": "2", "third": "1"}
    assert wf.list_all(storage) == [{"workflow_id": "wf-killed", "status": "FINISHED",
                                     "steps_done": 3}]
