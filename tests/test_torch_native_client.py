"""ray_tpu_torch's native C++ client (``_native/native_client.cc``, built
by g++ into build/torch_ext/) against the port's dashboard head: the
reference's cases (tests/test_native_client.py) with the port's library,
the named-call gateway running port functions as cluster tasks, REST jobs
whose entrypoint connects to the port's cluster; and the JAX package's
own built client against the same head, answering as the port's does;
and the port's CLI's `job` round trip (``python -m ray_tpu_torch job``).

The GCS's policy is torch_cuda with scheduler_device "cpu"."""

import ctypes
import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import _native
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.dashboard import DashboardHead
from ray_tpu_torch.util import state

CPU = {"scheduler_device": "cpu"}


@pytest.fixture(scope="module")
def dash():
    c = Cluster(config=Config(CPU))
    head = None
    try:
        c.add_node(num_cpus=2, node_id="nc-node")
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
        head = DashboardHead(c.address)
        yield head
    finally:
        if head is not None:
            head.shutdown()
        procs = [w.proc for d in c.daemons for w in list(d.workers.values())
                 if w.proc is not None]
        ray_tpu_torch.shutdown()
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)


@pytest.fixture(scope="module")
def lib():
    return _native.load_library("native_client")


@pytest.fixture(scope="module")
def ref_lib():
    """The JAX package's client, built by its own loader."""
    from ray_tpu._native import load_library

    ref = load_library("native_client")
    for fn in ("rt_get", "rt_post", "rt_call", "rt_submit_job"):
        getattr(ref, fn).restype = ctypes.c_void_p
    ref.rt_free.argtypes = [ctypes.c_void_p]
    return ref


def _take(lib, ptr):
    assert ptr, "native client returned NULL"
    try:
        return json.loads(ctypes.string_at(ptr).decode())
    finally:
        lib.rt_free(ptr)


def test_library_is_built_under_build_torch_ext(lib):
    path = _native.library_path("native_client")
    assert path.parent.name == "torch_ext" and path.parent.parent.name == "build"
    assert path.exists()


def test_native_get_state(dash, lib):
    out = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, b"/api/summary"))
    assert out["nodes_alive"] == 1
    out = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, b"/api/nodes"))
    assert any(n["NodeID"] == "nc-node" for n in out)
    assert [n["NodeID"] for n in out] == [n["NodeID"] for n in state.list_nodes()]


def test_native_call_runs_cluster_task(dash, lib):
    body = json.dumps({"func": "math:hypot", "args": [3, 4], "timeout": 60}).encode()
    assert _take(lib, lib.rt_call(b"127.0.0.1", dash.port, body)) == {"result": 5.0}


def test_native_call_of_a_port_function(dash, lib):
    """A function of the port, named by module:attr, runs in a worker."""
    from ray_tpu_torch.sched import kernel_torch

    for n in (5, 100, 5000):
        body = json.dumps({"func": "ray_tpu_torch.sched.kernel_torch:bucket_size",
                           "args": [n]}).encode()
        out = _take(lib, lib.rt_call(b"127.0.0.1", dash.port, body))
        assert out == {"result": kernel_torch.bucket_size(n)}


def test_native_call_kwargs_and_error(dash, lib):
    body = json.dumps({"func": "builtins:int", "args": ["ff"], "kwargs": {"base": 16}}).encode()
    assert _take(lib, lib.rt_call(b"127.0.0.1", dash.port, body)) == {"result": 255}
    body = json.dumps({"func": "builtins:int", "args": ["nope"]}).encode()
    assert "error" in _take(lib, lib.rt_call(b"127.0.0.1", dash.port, body))
    body = json.dumps({"func": "no_colon"}).encode()
    assert "error" in _take(lib, lib.rt_call(b"127.0.0.1", dash.port, body))


def test_native_job_submit_status_logs(dash, lib):
    script = (
        "import os, math, ray_tpu_torch; "
        "ray_tpu_torch.init(address=os.environ['RAY_TPU_ADDRESS']); "
        "f = ray_tpu_torch.remote(math.sqrt); "
        "print('job-result', ray_tpu_torch.get(f.remote(49.0), timeout=60)); "
        "ray_tpu_torch.shutdown()"
    )
    body = json.dumps({"entrypoint": f'{sys.executable} -c "{script}"'}).encode()
    out = _take(lib, lib.rt_submit_job(b"127.0.0.1", dash.port, body))
    jid = out["job_id"]
    assert out["status"] in ("RUNNING", "SUCCEEDED")
    deadline = time.time() + 120
    while time.time() < deadline:
        st = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, f"/api/jobs/{jid}".encode()))
        if st["status"] != "RUNNING":
            break
        time.sleep(0.5)
    assert st["status"] == "SUCCEEDED", st
    logs = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, f"/api/jobs/{jid}/logs".encode()))
    assert "job-result 7" in logs["logs"]
    listing = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, b"/api/jobs"))
    assert any(j["job_id"] == jid for j in listing)


def test_bad_submission_id_rejected(dash, lib):
    body = json.dumps({"entrypoint": "true", "submission_id": "../../etc/escape"}).encode()
    out = _take(lib, lib.rt_submit_job(b"127.0.0.1", dash.port, body))
    assert "error" in out and "submission_id" in out["error"]


def test_job_stop(dash, lib):
    body = json.dumps(
        {"entrypoint": f"{sys.executable} -c 'import time; time.sleep(300)'"}).encode()
    jid = _take(lib, lib.rt_submit_job(b"127.0.0.1", dash.port, body))["job_id"]
    _take(lib, lib.rt_post(b"127.0.0.1", dash.port, f"/api/jobs/{jid}/stop".encode(), b"{}"))
    deadline = time.time() + 30
    while time.time() < deadline:
        st = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, f"/api/jobs/{jid}".encode()))
        if st["status"] != "RUNNING":
            break
        time.sleep(0.3)
    assert st["status"] in ("STOPPED", "FAILED")


def test_connect_failure_returns_null(lib):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert not lib.rt_get(b"127.0.0.1", port, b"/api/summary")


def test_reference_client_answers_as_the_ports(dash, lib, ref_lib):
    """ray_tpu's built native client against the port's head: every call
    the port's client makes gives the same answer."""
    stable = [b"/api/nodes", b"/api/cluster_resources", b"/api/actors", b"/", b"/api/nope"]
    for path in stable:
        a = _take(lib, lib.rt_get(b"127.0.0.1", dash.port, path))
        b = _take(ref_lib, ref_lib.rt_get(b"127.0.0.1", dash.port, path))
        if path == b"/api/nodes":
            for n in a + b:
                n.pop("Stats", None)
        assert a == b, path
    for body in ({"func": "math:hypot", "args": [5, 12]},
                 {"func": "builtins:int", "args": ["7f"], "kwargs": {"base": 16}}):
        raw = json.dumps(body).encode()
        assert _take(lib, lib.rt_call(b"127.0.0.1", dash.port, raw)) == \
            _take(ref_lib, ref_lib.rt_call(b"127.0.0.1", dash.port, raw))
    bad = json.dumps({"entrypoint": "true", "submission_id": "a/b"}).encode()
    assert _take(lib, lib.rt_submit_job(b"127.0.0.1", dash.port, bad)) == \
        _take(ref_lib, ref_lib.rt_submit_job(b"127.0.0.1", dash.port, bad))


def test_job_cli_roundtrip(dash):
    """tests/test_native_client.py::test_job_cli_roundtrip through the
    port's CLI: `python -m ray_tpu_torch job submit/status/logs/list/stop`
    against the live head."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "job",
         args[0], "--dashboard", f"127.0.0.1:{dash.port}", *args[1:]],
        capture_output=True, text=True, timeout=120, env=env,
    )
    out = run("submit", "--submission-id", "cli-job-1", "--",
              "echo", "cli-job-output")
    assert '"job_id": "cli-job-1"' in out.stdout, out.stdout + out.stderr
    deadline = time.time() + 60
    while time.time() < deadline:
        st = run("status", "cli-job-1")
        if '"SUCCEEDED"' in st.stdout:
            break
        time.sleep(0.5)
    assert '"SUCCEEDED"' in st.stdout, st.stdout + st.stderr
    logs = run("logs", "cli-job-1")
    assert "cli-job-output" in logs.stdout
    lst = run("list")
    assert "cli-job-1" in lst.stdout
    # quoting survives the shell round-trip (shlex.join on the client,
    # shell=True on the head)
    out = run("submit", "--submission-id", "cli-job-q", "--",
              sys.executable, "-c", "print('quo ted')")
    assert '"cli-job-q"' in out.stdout, out.stdout + out.stderr
    deadline = time.time() + 60
    while time.time() < deadline:
        st = run("status", "cli-job-q")
        if '"SUCCEEDED"' in st.stdout:
            break
        time.sleep(0.5)
    assert '"SUCCEEDED"' in st.stdout, st.stdout + st.stderr
    assert "quo ted" in run("logs", "cli-job-q").stdout
    # stop a long-running job through the CLI
    out = run("submit", "--submission-id", "cli-job-s", "--",
              sys.executable, "-c", "import time; time.sleep(300)")
    assert '"cli-job-s"' in out.stdout
    run("stop", "cli-job-s")
    deadline = time.time() + 30
    while time.time() < deadline:
        st = run("status", "cli-job-s")
        if '"RUNNING"' not in st.stdout:
            break
        time.sleep(0.3)
    assert '"STOPPED"' in st.stdout or '"FAILED"' in st.stdout, st.stdout
    # server-side errors surface as clean messages, not tracebacks
    err = run("status", "no-such-job")
    assert err.returncode != 0 and "no job" in (err.stdout + err.stderr)
    assert "Traceback" not in err.stderr
