"""The port's soaks (ray_tpu_torch/scripts/{chaos,gcs,data,serve,workflow}_soak.py),
each run as ``python -m`` in a fresh process at a short duration, as a user
runs them: each exits 0 with its ``errors`` at 0, and the chaos soak's
post-hoc invariant check is clean. Every process runs with
``RAY_TPU_scheduler_device=cpu`` and a private ``TMPDIR``."""

import ast
import re
import subprocess
import sys

import pytest

from test_torch_scripts import _env


def _soak(tmp_path, *args, timeout=300):
    proc = subprocess.run(
        [sys.executable, "-m", f"ray_tpu_torch.scripts.{args[0]}", *args[1:]],
        cwd=str(tmp_path), env=_env(tmp_path), capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


def _final(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("FINAL: ")]
    return ast.literal_eval(line[len("FINAL: "):])


def test_chaos_soak(tmp_path):
    out = _soak(tmp_path, "chaos_soak", "--seed", "7", "--duration", "10")
    stats = _final(out)
    assert stats["errors"] == 0, stats
    assert stats["tasks"] > 0 and stats["actor_calls"] > 0, stats
    assert re.search(r"^protocol trace: .* \(0 violations\)$", out, re.M), out[-2000:]
    assert "SOAK DONE; task errors: 0" in out
    assert "RPC BUDGET BREACH" not in out
    # the metrics snapshot lands in the working directory's artifacts/
    assert (tmp_path / "artifacts" / "chaos_soak_metrics_seed7.prom").exists()


@pytest.mark.parametrize("script, seconds, work", [
    ("gcs_soak", "8", "tasks"), ("data_soak", "8", "pipelines"),
    ("serve_soak", "8", "handle_ok")])
def test_timed_soak(tmp_path, script, seconds, work):
    stats = _final(_soak(tmp_path, script, seconds))
    errors = stats.get("errors", stats.get("handle_err"))
    assert errors == 0, stats
    assert stats[work] > 0, stats
    if script == "gcs_soak":  # the tables persist under the port's session root
        assert (tmp_path / "ray_tpu_torch" / "gcs_soak_tables.pkl").exists()


def test_workflow_soak(tmp_path):
    out = _soak(tmp_path, "workflow_soak")
    assert "WF SOAK OK" in out and "missing: []" in out
    m = re.search(r"^completed after (\d+) attempts$", out, re.M)
    assert m, out[-2000:]


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_async_actor_killed_mid_call_fails_the_call_as_dead(package, monkeypatch):
    """The fault serve_soak shows: a deployment re-run kills its replicas
    (async actors in local mode) with requests in flight. The reference
    fails such a call with a TaskError (the loop's CancelledError), which
    the serve handle does not retry, so the soak counts handle errors; the
    port fails it with ActorDiedError, as a killed worker does in cluster
    mode, and the handle retries it on a live replica."""
    import importlib
    import threading
    import time

    rt = importlib.import_module(package)
    exc = importlib.import_module(f"{package}.core.exceptions")
    monkeypatch.setenv("RAY_TPU_scheduler_device", "cpu")
    rt.init(num_cpus=2)
    try:
        @rt.remote(max_concurrency=4)
        class Slow:
            async def wait(self, s):
                import asyncio

                await asyncio.sleep(s)
                return s

        a = Slow.remote()
        assert rt.get(a.wait.remote(0.0), timeout=30) == 0.0
        ref = a.wait.remote(30.0)
        time.sleep(0.3)
        threading.Thread(target=rt.kill, args=(a,), daemon=True).start()
        with pytest.raises(Exception) as info:
            rt.get(ref, timeout=30)
        if package == "ray_tpu_torch":
            assert isinstance(info.value, exc.ActorDiedError), repr(info.value)
        else:
            assert isinstance(info.value, exc.TaskError), repr(info.value)
            assert "CancelledError" in str(info.value)
    finally:
        rt.shutdown()


def _gcs(package):
    import importlib

    gcs_mod = importlib.import_module(f"{package}.cluster.gcs")
    testing = importlib.import_module(f"{package}.cluster.testing")
    config = importlib.import_module(f"{package}.core.config")
    device = {"scheduler_device": "cpu"} if package == "ray_tpu_torch" else {}
    g = gcs_mod.GcsServer(config=config.Config(
        {"scheduler_round_interval_ms": 60_000.0, **device}))
    testing.park_scheduler_loop(g)
    testing.register_fake_nodes(g, 2, lambda i: {"CPU": 4})
    return g, testing.FakeConn()


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_actor_creation_sent_again_after_it_finished_is_a_duplicate(package):
    """The fault the chaos soak's capacity check shows (a release "on
    node X but the allocation lives on stable"): a creation's submit_task
    whose ack was lost with a reset connection is resent by the client's
    ack watchdog after the actor came up. The reference admits it again
    and starts a second live incarnation, whose hold replaces the first
    one's (never released); the port answers it as a duplicate."""
    g, conn = _gcs(package)
    try:
        g.rpc_register_actor({"actor_id": "actor-a", "max_restarts": -1}, conn)
        meta = {"task_id": "acreate-a", "class_key": 1, "resources": {"CPU": 1},
                "num_returns": 1, "owner": "drv", "actor_id": "actor-a",
                "actor_creation": True}
        assert g.rpc_submit_task(dict(meta), conn) == {"ok": True}
        g._schedule_round()
        node = g.running["acreate-a"]["node_id"]
        g.rpc_task_done({"task_id": "acreate-a", "node_id": node, "status": "FINISHED",
                         "actor_id": "actor-a", "actor_creation": True, "results": [],
                         "start": 1.0, "end": 2.0}, conn)
        assert g.actors["actor-a"]["state"] == "ALIVE"
        assert sorted(g.running) == ["actor-hold-actor-a"]
        reply = g.rpc_submit_task(dict(meta), conn)
        g._schedule_round()
        if package == "ray_tpu_torch":
            assert reply == {"ok": True, "duplicate": True}
            assert g.actors["actor-a"]["state"] == "ALIVE"
            assert sorted(g.running) == ["actor-hold-actor-a"]
        else:
            assert reply == {"ok": True}
            assert g.actors["actor-a"]["state"] == "STARTING"
            assert sorted(g.running) == ["acreate-a", "actor-hold-actor-a"]
    finally:
        g.shutdown()


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_bounced_call_never_replays_behind_a_call_whose_fate_is_unknown(package):
    """An actor's calls 0, 1, 2 go out on one connection; 0 and 1 bounce
    (the actor is not yet on its worker) and 2 reaches the worker, but its
    connection dies before the answer. The reference's replay guard counts
    only answered calls as run, so it sends 0 again after 2: the actor
    would run 0 after 2. The port counts 2 as possibly run and fails 0 and
    1 as dead (at most once), as it fails a bounced call behind an
    answered one."""
    import importlib
    import threading
    import time
    import types
    from concurrent.futures import Future

    client = importlib.import_module(f"{package}.cluster.client")
    rpc = importlib.import_module(f"{package}.cluster.rpc")
    exc = importlib.import_module(f"{package}.core.exceptions")
    q = client._ActorQueue()
    sent, futs, failed = [], {}, {}

    class Daemon:
        def call_async(self, method, meta):
            f = Future()
            sent.append(meta["seq"])
            futs.setdefault(meta["seq"], []).append(f)
            return f

    def replay(actor_id, seq, meta, refs):
        q.put_replay(seq, meta, refs, delay=0.0)
        return True

    fake = types.SimpleNamespace(
        store=types.SimpleNamespace(
            put=lambda ref, v, is_exception=False: failed.__setitem__(ref, v)),
        _finalize_actor_call=lambda refs, err: None,
        _release_task_deps=lambda tid: None,
        _actor_location=lambda aid, wait=True, timeout=60: {
            "state": "ALIVE", "node_id": "n", "addr": "127.0.0.1", "port": 1},
        _daemon=lambda nid, addr, port: Daemon(),
        _maybe_replay_actor_call=replay,
        _apply_borrows=lambda p: None, _ingest_result=lambda p, refs: None)
    loop = threading.Thread(target=client.ClusterClient._actor_dispatch_loop,
                            args=(fake, "actor-a", q), daemon=True)
    loop.start()

    def until(cond):
        deadline = time.time() + 30
        while not cond():
            assert time.time() < deadline, (sent, failed)
            time.sleep(0.01)

    try:
        for i in range(3):
            q.put({"task_id": f"atask-{i}"}, [f"ref-{i}"])
        until(lambda: len(sent) == 3)
        bounce = {"status": "ACTOR_UNREACHABLE", "results": []}
        futs[0][0].set_result(bounce)
        futs[1][0].set_result(bounce)
        futs[2][0].set_exception(rpc.ConnectionLost("connection lost"))
        if package == "ray_tpu_torch":
            until(lambda: len(failed) == 3)
            assert sent == [0, 1, 2]
            assert all(isinstance(failed[f"ref-{i}"], exc.ActorDiedError) for i in range(3))
        else:
            until(lambda: len(sent) == 4)
            assert sent == [0, 1, 2, 0]
    finally:
        q.close()
        for f in [f for fs in list(futs.values()) for f in fs if not f.done()]:
            f.set_exception(rpc.ConnectionLost("test over"))
        loop.join(timeout=30)
