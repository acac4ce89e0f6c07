"""The port's CLI (``python -m ray_tpu_torch``, ray_tpu_torch/scripts/cli.py)
and its microbenchmark (scripts/ray_perf.py) against the reference's
(ray_tpu/scripts/cli.py, scripts/ray_perf.py): the parser's surface
subcommand by subcommand, the CLI driven end to end as a user would, and
the counterparts of the reference's CLI cases (tests/test_state_cli.py,
tests/test_obs.py, tests/test_waitgraph.py).

Every process runs with ``RAY_TPU_scheduler_device=cpu`` (the head's GCS
runs K1's plain version) and a private ``TMPDIR``: the port's session
files lie under ``$TMPDIR/ray_tpu_torch``, apart from the reference's
``/tmp/ray_tpu``, whose ``stop`` signals every pid its file lists."""

import argparse
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from ray_tpu.scripts import cli as ref_cli
from ray_tpu.scripts import ray_perf as ref_perf
from ray_tpu_torch.scripts import cli as port_cli
from ray_tpu_torch.scripts import ray_perf as port_perf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"scheduler_device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other; one thread for this module, the count restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the parser


def _subparsers(parser):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices
    return {}


def _surface(parser):
    """Every argument's name, kind, default, type, choices, nargs and
    whether it is required; nested subcommands (``job``) by name."""
    args = []
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        args.append({
            "options": tuple(a.option_strings), "dest": a.dest,
            "action": type(a).__name__, "default": a.default,
            "type": getattr(a.type, "__name__", a.type), "choices": a.choices,
            "nargs": a.nargs, "required": a.required, "const": a.const,
        })
    subs = {name: _surface(p) for name, p in _subparsers(parser).items()}
    return {"args": args, "subcommands": subs}


SUBCOMMANDS = sorted(_subparsers(ref_cli.build_parser()))


def test_parser_subcommands_equal_reference():
    assert sorted(_subparsers(port_cli.build_parser())) == SUBCOMMANDS
    assert len(SUBCOMMANDS) == 14
    assert _surface(port_cli.build_parser())["args"] == \
        _surface(ref_cli.build_parser())["args"]


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_parser_subcommand_surface_equals_reference(command):
    ref = _subparsers(ref_cli.build_parser())[command]
    port = _subparsers(port_cli.build_parser())[command]
    assert _surface(port) == _surface(ref)
    assert port.description == ref.description
    # the same handler, by name, for every subcommand
    assert port.get_default("fn").__name__ == ref.get_default("fn").__name__


# ------------------------------------------------------- the CLI end to end


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    env["RAY_TPU_scheduler_device"] = "cpu"
    env.pop("RAY_TPU_ADDRESS", None)
    return env


def _runner(tmp_path, **kw):
    env = _env(tmp_path)
    return lambda *args: subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path),
        **kw)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:  # a zombie of a daemonized child is dead to us
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][:1] != "Z"
    except OSError:
        return False


def _reap(pids, timeout=20.0):
    """Wait for `pids` to end; SIGKILL what is left. Returns the pids that
    outlived the wait."""
    deadline = time.time() + timeout
    while time.time() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.2)
    left = [p for p in pids if _alive(p)]
    for p in left:
        try:
            os.killpg(p, signal.SIGKILL)
        except OSError:
            pass
    return left


def _reference_session_pids():
    try:
        with open(ref_cli._PID_FILE) as f:
            return {int(x) for x in f.read().split() if x.strip().isdigit()}
    except OSError:
        return set()


def _round_count(prom):
    m = re.search(r"^ray_tpu_gcs_sched_round_s_count(?:\{[^}]*\})? (\S+)$", prom, re.M)
    return float(m.group(1)) if m else 0.0


def test_cli_end_to_end(tmp_path):
    """tests/test_state_cli.py::test_cli_end_to_end through ``python -m
    ray_tpu_torch``: start a head (daemonized) and a worker node, status,
    list, summary, microbenchmark, metrics, stop. The session files lie
    under $TMPDIR/ray_tpu_torch, and nothing of this session reaches the
    reference's /tmp/ray_tpu."""
    run = _runner(tmp_path)
    session = tmp_path / "ray_tpu_torch"
    ref_pids_before = _reference_session_pids()
    out = run("start", "--head", "--num-cpus", "2")
    assert "head started" in out.stdout, out.stdout + out.stderr
    addr = out.stdout.split("at ")[1].split(" ")[0]
    pids = [int(x) for x in (session / "pids").read_text().split()]
    try:
        assert (session / "address").read_text().strip() == addr
        assert len(pids) == 1
        with open(f"/proc/{pids[0]}/cmdline", "rb") as f:
            cmdline = f.read().split(b"\0")
        assert cmdline[1:3] == [b"-m", b"ray_tpu_torch"], cmdline
        node = run("start", "--address", addr, "--num-cpus", "2")
        assert "node started" in node.stdout, node.stdout + node.stderr
        pids = [int(x) for x in (session / "pids").read_text().split()]
        assert len(pids) == 2
        deadline = time.time() + 60
        while time.time() < deadline:
            st = run("status", "--address", addr)
            if "nodes_alive         2" in st.stdout:
                break
            time.sleep(0.5)
        assert "cluster summary" in st.stdout, st.stdout + st.stderr
        assert "nodes_alive         2" in st.stdout, st.stdout
        ls = run("list", "nodes", "--address", addr)
        assert "NodeID" in ls.stdout or "node" in ls.stdout.lower()
        mb = run("microbenchmark", "--address", addr, "--quick")
        assert "tasks_per_second" in mb.stdout, mb.stdout + mb.stderr
        for key in ("actor_calls_per_second", "put_get_gbps_shm", "arg_view_gbps"):
            assert key in mb.stdout
        summ = run("summary")  # the address from the session file
        assert summ.returncode == 0 and "noop" in summ.stdout, summ.stdout + summ.stderr
        prom = run("metrics", "--prom")
        assert prom.returncode == 0, prom.stderr
        assert _round_count(prom.stdout) > 0
        top = run("metrics", "--top")
        assert "submit_task" in top.stdout and "surface" in top.stdout
        assert addr not in (open(ref_cli._ADDR_FILE).read()
                            if os.path.exists(ref_cli._ADDR_FILE) else "")
        assert not set(pids) & _reference_session_pids()
    finally:
        stop = run("stop")
        left = _reap(pids)
    assert "stopped 2 process(es)" in stop.stdout, stop.stdout + stop.stderr
    assert not left, f"still alive 20 s after stop: {left}"
    assert not (session / "pids").exists() and not (session / "address").exists()
    assert not set(pids) & (_reference_session_pids() | ref_pids_before)


def test_head_start_deadline_differs_from_reference():
    """The port waits the reference's 15 s for its head; the stated
    difference: it stops waiting when the head exits."""
    import inspect

    assert "time.time() + 15\n" in inspect.getsource(ref_cli.cmd_start)
    assert "proc.poll()" not in inspect.getsource(ref_cli.cmd_start)
    assert port_cli.HEAD_START_TIMEOUT_S == 15.0
    assert "proc.poll() is not None" in inspect.getsource(port_cli.cmd_start)


def test_cli_head_start_without_card_reports_no_head(tmp_path):
    """Without RAY_TPU_scheduler_device=cpu the head's GCS asks for the
    card; here that raises in the daemonized head (no quiet fallback), and
    the parent reports that no head came up, as the reference does for a
    head that fails (at once: the head has exited)."""
    env = _env(tmp_path)
    env.pop("RAY_TPU_scheduler_device")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the head would come up")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--num-cpus", "1"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    pids = [int(x) for x in (tmp_path / "ray_tpu_torch" / "pids").read_text().split()]
    assert _reap(pids, timeout=5) == []
    assert out.returncode != 0
    assert "head did not come up within 15s" in out.stderr
    # in the foreground the head's own error shows
    fg = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--num-cpus", "1",
         "--block"], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert fg.returncode != 0 and "CUDA" in fg.stderr, fg.stderr[-2000:]


# ------------------------------------------- the reference's other CLI cases


@pytest.fixture
def two_node_cluster():
    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    c = Cluster(config=Config(CPU))
    c.add_node(num_cpus=2, node_id="obs-a")
    c.add_node(num_cpus=2, node_id="obs-b")
    ray_tpu_torch.init(address=c.address, ignore_reinit_error=True)
    yield c, ray_tpu_torch
    ray_tpu_torch.shutdown()
    c.shutdown()


_PROM_SERIES = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (\S+)$'
)


def _assert_prom_valid(text):
    """tests/test_obs.py's check of the exposition text."""
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")), line
            continue
        m = _PROM_SERIES.match(line)
        assert m, f"invalid prometheus line: {line!r}"
        float(m.group(4))


def test_cli_metrics_commands(two_node_cluster, capsys, monkeypatch):
    """tests/test_obs.py::test_cli_metrics_commands on the port."""
    c, ray_tpu_torch = two_node_cluster

    @ray_tpu_torch.remote
    def f():
        return 1

    assert ray_tpu_torch.get(f.remote(), timeout=60) == 1
    monkeypatch.setenv("RAY_TPU_ADDRESS", c.address)
    port_cli.main(["metrics"])
    out = capsys.readouterr().out
    assert "ray_tpu_gcs_rpc_handler_s" in out
    port_cli.main(["metrics", "--top"])
    out = capsys.readouterr().out
    assert "submit_task" in out and "surface" in out
    port_cli.main(["metrics", "--prom"])
    out = capsys.readouterr().out
    _assert_prom_valid(out)
    assert _round_count(out) > 0


def test_cli_stacks_no_session_exits_nonzero(tmp_path, monkeypatch):
    """tests/test_waitgraph.py::test_cli_stacks_no_session_exits_nonzero."""
    monkeypatch.setattr(port_cli, "_PID_FILE", str(tmp_path / "no-such-pids"))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["stacks"])
    assert exc.value.code != 0


def test_cli_no_address_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.delenv("RAY_TPU_ADDRESS", raising=False)
    monkeypatch.setattr(port_cli, "_ADDR_FILE", str(tmp_path / "no-such-address"))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["status"])
    assert "no cluster address" in str(exc.value.code)


def test_session_files_under_the_port_root():
    import tempfile

    assert port_cli._SESSION_DIR == os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    assert os.path.dirname(port_cli._ADDR_FILE) == port_cli._SESSION_DIR
    assert os.path.dirname(port_cli._PID_FILE) == port_cli._SESSION_DIR
    assert port_cli._SESSION_DIR != ref_cli._SESSION_DIR


# ------------------------------------------------------ the microbenchmark


def test_run_microbenchmark_quick_keys_equal_reference(monkeypatch):
    """Local mode in both packages: the same result keys, each rate
    positive and finite."""
    import ray_tpu
    import ray_tpu_torch

    monkeypatch.setenv("RAY_TPU_scheduler_device", "cpu")
    try:
        ref = ref_perf.run_microbenchmark(quick=True)
    finally:
        ray_tpu.shutdown()
    try:
        port = port_perf.run_microbenchmark(quick=True)
    finally:
        ray_tpu_torch.shutdown()
    assert list(port) == list(ref)
    assert list(port) == ["tasks_per_second", "actor_calls_per_second",
                          "put_get_gbps_memstore"]
    for k, v in port.items():
        assert 0 < v < float("inf"), (k, v)
