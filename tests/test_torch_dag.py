"""ray_tpu_torch's compiled execution graphs (ray_tpu_torch.dag) held to the
reference's: every case of tests/test_dag.py runs on the port's modules —
the seqlock channel, lazy bind/execute parity with the task layer,
compiled pipelines over pinned workers in a two-node port cluster, worker
and node death, and the channel invariant checker — and the port is held
to ray_tpu itself: the same eager DAG gives equal results in both
packages, the channel header's layout and word offsets are equal, and a
frame one package's channel writes is read whole by the other's on the
same file.

The clusters run the GCS's rounds through the plain PyTorch versions of
the kernels (scheduler_device "cpu"). The chaos cases record the protocol
with the port's own recorder (ray_tpu_torch.analysis.invariants), not the
conftest's `invariant_sanitizer`, which installs the JAX package's."""

import subprocess
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.dag import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.util.chrome_trace import complete_event

CPU = {"scheduler_device": "cpu"}


@pytest.fixture
def port_local():
    """A fresh local runtime of the port per test (plain kernels)."""
    ray_tpu_torch.init(num_cpus=4, _system_config=CPU)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def port_invariants(tmp_path):
    """The port's protocol recorder over the test (rpc frames, apply
    events, channel seq alternation); the test fails on any violation the
    offline checker finds in the trace."""
    from ray_tpu_torch.analysis import invariants

    trace_path = str(tmp_path / "protocol_trace.jsonl")
    tracer = invariants.install(trace_path)
    try:
        yield tracer
    finally:
        invariants.uninstall()
        violations = invariants.check_trace(trace_path)
        assert not violations, (
            "protocol invariant violation(s):\n"
            + "\n".join(v.format() for v in violations)
            + f"\n(full trace: {trace_path})")


def _shutdown_cluster(cluster):
    """Shut the cluster down and reap every worker process it started."""
    procs = [w.proc for d in cluster.daemons for w in list(d.workers.values())
             if w.proc is not None]
    cluster.shutdown()
    for p in procs:
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=5)


def _dag_stage_rows(events):
    """The timeline's DAG_ITER events as chrome-trace rows, one lane a
    stage, through the port's renderer (util/chrome_trace.py)."""
    return [
        complete_event(
            e.get("name") or e.get("task_id", "task"), e["start"], e["end"],
            pid=e.get("node") or e.get("node_id") or "node",
            tid=e.get("actor_id") or e.get("stage") or e.get("worker_id") or "tasks",
            cat="dag_stage" if e.get("stage")
            else "actor_task" if e.get("actor_id") else "task",
            args={"task_id": e.get("task_id"), "status": e.get("status")})
        for e in events if e.get("start") is not None and e.get("end") is not None
    ]


# ============================================================ channel layer


def test_channel_write_read_roundtrip(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    assert w.write(b"hello") == 1
    assert r.read(timeout=5) == (1, b"hello")
    assert w.write(b"world") == 2
    assert r.read(timeout=5) == (2, b"world")


def test_channel_backpressure_blocks_writer(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    w.write(b"one")
    with pytest.raises(ChannelTimeoutError):
        w.write(b"two", timeout=0.2)  # frame 1 unconsumed
    r.read(timeout=5)
    assert w.write(b"two", timeout=5) == 2


def test_channel_grows_past_capacity(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 16, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    big = b"x" * 5000
    w.write(big)
    assert r.read(timeout=5) == (1, big)
    bigger = b"y" * 20000
    w.write(bigger)
    assert r.read(timeout=5) == (2, bigger)


def test_channel_close_wakes_reader(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    got = []

    def reader():
        try:
            r.read(timeout=10)
        except ChannelClosedError as e:
            got.append(e)

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)
    w.close()
    t.join(5)
    assert got, "reader never woke on close"


def test_channel_close_drains_pending_frame(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    w.write(b"last")
    w.close()
    assert r.read(timeout=5) == (1, b"last")  # graceful close drains
    with pytest.raises(ChannelClosedError):
        r.read(timeout=5)


def test_channel_error_poke_preempts_drain(tmp_path):
    from ray_tpu_torch.dag.channel import poke_error

    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    w.write(b"frame")
    assert poke_error(path)  # daemon's worker-death wakeup
    with pytest.raises(ChannelClosedError):
        r.read(timeout=5)
    with pytest.raises(ChannelClosedError):
        w.write(b"next", timeout=5)
    assert not poke_error(str(tmp_path / "missing.chan"))


# ========================================================== lazy API (eager)


def test_eager_execute_matches_remote(port_local):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    @ray_tpu_torch.remote
    def g(x):
        return x * 2

    with InputNode() as inp:
        dag = g.bind(f.bind(inp))
    assert ray_tpu_torch.get(dag.execute(5)) == ray_tpu_torch.get(g.remote(f.remote(5)))
    assert ray_tpu_torch.get(dag.execute(7)) == 16


def test_eager_multi_output(port_local):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    @ray_tpu_torch.remote
    def g(x):
        return x * 2

    with InputNode() as inp:
        shared = f.bind(inp)
        dag = MultiOutputNode([g.bind(shared), shared])
    refs = dag.execute(3)
    assert ray_tpu_torch.get(refs) == [8, 4]


def test_eager_actor_method_bind(port_local):
    @ray_tpu_torch.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

    a = Acc.remote()
    with InputNode() as inp:
        dag = a.add.bind(inp)
    assert ray_tpu_torch.get(dag.execute(2)) == 2
    assert ray_tpu_torch.get(dag.execute(3)) == 5  # actor state persists


def test_compile_requires_cluster_mode(port_local):
    @ray_tpu_torch.remote
    def f(x):
        return x

    with InputNode() as inp:
        dag = f.bind(inp)
    with pytest.raises(RuntimeError, match="cluster mode"):
        dag.compile()


# ====================================================== compiled pipelines


@pytest.fixture(scope="module")
def dag_cluster():
    """Two labeled-resource nodes so stages can be pinned apart (cross-node
    edges) — shared by the compiled tests; chaos tests build their own."""
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=3, resources={"A": 10})
    cluster.add_node(num_cpus=3, resources={"B": 10})
    cluster.wait_for_nodes(2)
    ray_tpu_torch.init(address=cluster.address)
    yield cluster
    ray_tpu_torch.shutdown()
    _shutdown_cluster(cluster)


def test_compiled_matches_eager(dag_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    @ray_tpu_torch.remote
    def g(x):
        return x * 2

    with InputNode() as inp:
        dag = g.bind(f.bind(inp))
    compiled = dag.compile()
    try:
        for i in range(10):
            assert compiled.execute(i) == ray_tpu_torch.get(dag.execute(i))
    finally:
        compiled.teardown()
    # the exec loops flush per-iteration spans on exit; they surface in the
    # task-event timeline as per-stage DAG_ITER rows
    deadline = time.time() + 10
    while time.time() < deadline:
        evs = [e for e in ray_tpu_torch.timeline()
               if e.get("status") == "DAG_ITER" and e.get("stage")]
        if len(evs) >= 2:
            break
        time.sleep(0.2)
    assert len(evs) >= 2, "dag iteration spans never reached the timeline"
    rows = _dag_stage_rows(evs)
    assert rows and all(r["cat"] == "dag_stage" for r in rows)
    # the reference's timeline renders the port's events to the same rows
    from ray_tpu.util.state.timeline import chrome_trace as ref_chrome_trace

    assert ref_chrome_trace(evs) == rows


def test_compiled_cross_node_edge(dag_cluster):
    """Stages pinned to different nodes: the edge's frames ride the daemon
    transfer path (rpc_dag_push deposits into the reader daemon's channel)."""

    @ray_tpu_torch.remote(resources={"A": 1})
    def f(x):
        return x + 1

    @ray_tpu_torch.remote(resources={"B": 1})
    def g(x):
        return x * 10

    with InputNode() as inp:
        dag = g.bind(f.bind(inp))
    compiled = dag.compile()
    try:
        # the two stages really are on different nodes
        nodes = {p["node_id"] for p in compiled._placements.values()}
        assert len(nodes) == 2
        for i in range(5):
            assert compiled.execute(i) == (i + 1) * 10
    finally:
        compiled.teardown()


def test_compiled_actor_stage_keeps_state(dag_cluster):
    @ray_tpu_torch.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

    a = Acc.remote()
    with InputNode() as inp:
        dag = a.add.bind(inp)
    compiled = dag.compile()
    try:
        assert [compiled.execute(i) for i in (1, 2, 3)] == [1, 3, 6]
        # the actor is still callable through the normal path afterwards,
        # and saw the compiled iterations' state
        compiled.teardown()
        assert ray_tpu_torch.get(a.add.remote(0)) == 6
    finally:
        compiled.teardown()


def test_compiled_multi_output(dag_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    @ray_tpu_torch.remote
    def g(x):
        return x * 2

    with InputNode() as inp:
        shared = f.bind(inp)
        dag = MultiOutputNode([g.bind(shared), shared])
    compiled = dag.compile()
    try:
        assert compiled.execute(3) == [8, 4]
        assert compiled.execute(4) == [10, 5]
    finally:
        compiled.teardown()


def test_compiled_multi_output_duplicate_member(dag_cluster):
    """The same stage listed twice gets two channels (an SPSC channel
    cannot feed two driver readers), not a shared deadlocking edge."""

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    with InputNode() as inp:
        node = f.bind(inp)
        dag = MultiOutputNode([node, node])
    compiled = dag.compile()
    try:
        assert compiled.execute(1) == [2, 2]
        assert compiled.execute(2) == [3, 3]
    finally:
        compiled.teardown()


def test_compiled_stage_error_propagates_and_pipeline_survives(dag_cluster):
    @ray_tpu_torch.remote
    def h(x):
        if x == 13:
            raise ValueError("boom13")
        return x

    with InputNode() as inp:
        dag = h.bind(inp)
    compiled = dag.compile()
    try:
        assert compiled.execute(1) == 1
        with pytest.raises(Exception, match="boom13"):
            compiled.execute(13)
        # the error is per-iteration, not fatal to the pipeline
        assert compiled.execute(2) == 2
    finally:
        compiled.teardown()


def test_double_compile_and_teardown_idempotent(dag_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    with InputNode() as inp:
        dag = f.bind(inp)
    c1 = dag.compile()
    c2 = dag.compile()  # independent pipeline over the same graph
    try:
        assert c1.execute(1) == 2
        assert c2.execute(2) == 3
    finally:
        c1.teardown()
        c1.teardown()  # idempotent
        c2.teardown()
        c2.teardown()
    with pytest.raises(ChannelClosedError):
        c1.execute(3)


def test_compiled_forced_remote_io(dag_cluster):
    """_force_remote_io drives the driver's input/output through
    rpc_dag_push / rpc_dag_pull even on one host — the remote-driver path."""

    @ray_tpu_torch.remote
    def f(x):
        return x * 3

    with InputNode() as inp:
        dag = f.bind(inp)
    compiled = dag.compile(_force_remote_io=True)
    try:
        for i in range(4):
            assert compiled.execute(i) == i * 3
    finally:
        compiled.teardown()


# ================================================================== chaos


def test_dag_worker_kill_raises_channel_closed(port_invariants,
                                               monkeypatch):
    """Kill a pinned DAG worker mid-iteration: the driver gets
    ChannelClosedError (not a hang), teardown still releases everything —
    and the whole run replays clean through the invariant checker
    (including the channel seq-alternation events)."""
    ray_tpu_torch.shutdown()  # drop the module fixture's shared runtime, if any
    # worker subprocesses join the same trace file, so the channel
    # alternation events cover BOTH ends of every edge
    monkeypatch.setenv("RAY_TPU_TRACE_FILE", port_invariants.path)
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(2)
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        @ray_tpu_torch.remote
        def g(x):
            return x * 2

        with InputNode() as inp:
            dag = g.bind(f.bind(inp))
        compiled = dag.compile()
        for i in range(10):
            assert compiled.execute(i) == (i + 1) * 2
        victim = None
        for d in cluster.daemons:
            for w in d.workers.values():
                if w.dag_stages:
                    victim = w
                    break
            if victim:
                break
        assert victim is not None, "no pinned dag worker found"
        victim.proc.kill()
        with pytest.raises(ChannelClosedError):
            deadline = time.time() + 30
            while time.time() < deadline:
                compiled.execute(0, timeout=5.0)
                time.sleep(0.02)
            pytest.fail("execute never raised after worker kill")
        compiled.teardown()
        compiled.teardown()
        # worker pins released: normal tasks still run on both nodes
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == 2
    finally:
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


def test_dag_worker_crash_inside_commit_window_never_torn(monkeypatch):
    """Kill a pinned worker at a SEEDED mid-commit op — inside the torn
    window the memmodel checker verifies: payload + len stored, version
    not yet bumped (channel.py's RAY_TPU_CHAN_CRASH_AT hook, honored
    only in daemon-spawned workers). The driver must see
    ChannelClosedError; a returned value would be a torn or stale-seq
    frame leaking through, a hang a lost wakeup."""
    ray_tpu_torch.shutdown()  # drop the module fixture's shared runtime, if any
    # worker processes inherit the env at spawn; the driver (this
    # process) has no RAY_TPU_WORKER_ID, so only pinned workers die
    monkeypatch.setenv("RAY_TPU_CHAN_CRASH_AT", "pre-version")
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(1)
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        @ray_tpu_torch.remote
        def g(x):
            return x * 2

        with InputNode() as inp:
            dag = g.bind(f.bind(inp))
        compiled = dag.compile()
        with pytest.raises(ChannelClosedError):
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    out = compiled.execute(1, timeout=5.0)
                except ChannelTimeoutError:
                    continue  # death sweep not landed yet: keep waiting
                pytest.fail(
                    f"execute returned {out!r} though every stage "
                    "writer dies inside the commit window — a torn or "
                    "stale frame leaked through"
                )
            pytest.fail("execute never raised after mid-commit crash")
        compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


def test_dag_node_kill_raises_channel_closed():
    """Kill a whole node hosting a pinned stage: the GCS's death sweep
    marks the DAG broken and the driver raises instead of hanging."""
    ray_tpu_torch.shutdown()  # drop the module fixture's shared runtime, if any
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=2, resources={"A": 1})
    victim_node = cluster.add_node(num_cpus=2, resources={"B": 1})
    cluster.wait_for_nodes(2)
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote(resources={"A": 0.1})
        def f(x):
            return x + 1

        @ray_tpu_torch.remote(resources={"B": 0.1})
        def g(x):
            return x * 2

        with InputNode() as inp:
            dag = g.bind(f.bind(inp))
        compiled = dag.compile()
        assert compiled.execute(1) == 4
        cluster.kill_node(victim_node)
        with pytest.raises(ChannelClosedError):
            deadline = time.time() + 60
            while time.time() < deadline:
                compiled.execute(1, timeout=5.0)
                time.sleep(0.05)
            pytest.fail("execute never raised after node kill")
        compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


def test_driver_disconnect_sweeps_dags():
    """A driver that vanishes without teardown() must not leak pinned
    workers/capacity: the GCS tears its DAGs down on disconnect."""
    ray_tpu_torch.shutdown()  # drop the module fixture's shared runtime, if any
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=3)
    cluster.wait_for_nodes(1)
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x

        with InputNode() as inp:
            compiled = f.bind(inp).compile()
        assert compiled.execute(1) == 1
        assert cluster.gcs.dags
        compiled._torn_down = True  # driver dies WITHOUT tearing down
        ray_tpu_torch.shutdown()
        deadline = time.time() + 20
        while time.time() < deadline and cluster.gcs.dags:
            time.sleep(0.1)
        assert not cluster.gcs.dags, "GCS kept the dead driver's dags"
        assert not any(
            k.startswith("dag-hold-") for k in cluster.gcs.running
        ), "stage capacity holds leaked"
    finally:
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


# ============================================== channel invariant checking


def _check_events(events):
    from ray_tpu_torch.analysis.invariants import InvariantChecker

    evs = [dict(e, t="apply", c=i + 1) for i, e in enumerate(events)]
    return InvariantChecker().run(evs)


def test_channel_invariant_clean_alternation():
    v = _check_events([
        {"k": "chan_write", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_write", "chan": "e0", "seq": 2},
        {"k": "chan_read", "chan": "e0", "seq": 2},
    ])
    assert v == []


def test_channel_invariant_write_seq_gap():
    v = _check_events([
        {"k": "chan_write", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_write", "chan": "e0", "seq": 3},
    ])
    assert any(x.kind == "channel" and "gap" in x.message for x in v)


def test_channel_invariant_read_before_write():
    v = _check_events([
        {"k": "chan_write", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 2},
    ])
    assert any("read-before-write" in x.message for x in v)


def test_channel_invariant_writer_overrun():
    v = _check_events([
        {"k": "chan_write", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_write", "chan": "e0", "seq": 2},
        {"k": "chan_write", "chan": "e0", "seq": 3},  # frame 2 unconsumed
    ])
    assert any("backpressure" in x.message for x in v)


def test_channel_invariant_write_only_trace_is_quiet():
    """A topology where only the writer process traces must not self-flag
    (the alternation check arms only once reads are witnessed)."""
    v = _check_events([
        {"k": "chan_write", "chan": "e0", "seq": 1},
        {"k": "chan_write", "chan": "e0", "seq": 2},
        {"k": "chan_write", "chan": "e0", "seq": 3},
    ])
    assert v == []


def test_channel_invariant_read_only_trace_is_quiet():
    """Symmetrically, a driver-only trace (reads of worker-written edges)
    must not flag read-before-write; same-side continuity still holds."""
    v = _check_events([
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 2},
    ])
    assert v == []
    v = _check_events([
        {"k": "chan_read", "chan": "e0", "seq": 1},
        {"k": "chan_read", "chan": "e0", "seq": 3},  # skipped a frame
    ])
    assert any(x.kind == "channel" for x in v)


# ================================================ held to the JAX package


def test_eager_dag_equals_the_reference():
    """The same eager DAG of the same functions — a fan-out through a
    MultiOutputNode and an actor's method — gives equal results in the
    port's local runtime and the reference's."""

    def run(rt, **init_kw):
        rt.init(num_cpus=4, **init_kw)
        try:
            @rt.remote
            def f(x):
                return x + 1

            @rt.remote
            def g(x, k=3):
                return x * k

            @rt.remote
            class Acc:
                def __init__(self):
                    self.n = 0

                def add(self, x):
                    self.n += x
                    return self.n

            a = Acc.remote()
            mod = ray_tpu_torch.dag if rt is ray_tpu_torch else ray_tpu.dag
            with mod.InputNode() as inp:
                shared = f.bind(inp)
                dag = mod.MultiOutputNode([g.bind(shared, k=5), shared, a.add.bind(shared)])
            return [rt.get(dag.execute(i)) for i in range(6)]
        finally:
            rt.shutdown()

    import ray_tpu.dag  # noqa: F401 - the reference's DAG layer

    got = run(ray_tpu_torch, _system_config=CPU)
    want = run(ray_tpu)
    assert got == want
    assert got[5] == [30, 6, 21]


def test_header_layout_and_offsets_equal_the_reference():
    from ray_tpu.dag import channel as ref
    from ray_tpu_torch.dag import channel as port

    assert port.HEADER_LAYOUT == ref.HEADER_LAYOUT
    assert port.WORDS == ref.WORDS
    assert (port.MAGIC, port.HDR) == (ref.MAGIC, ref.HDR)
    offsets = sorted(n for n in dir(ref) if n.startswith("_W_"))
    assert offsets == sorted(n for n in dir(port) if n.startswith("_W_"))
    assert len(offsets) == len(ref.HEADER_LAYOUT)
    assert [getattr(port, n) for n in offsets] == [getattr(ref, n) for n in offsets]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frames_cross_between_the_packages_on_one_file(tmp_path, writer):
    """A frame one package's channel writes is read whole by the other's
    on the same file: small frames, a frame that grows the file past its
    capacity, a packed record (the exec loop's frame), backpressure, and
    the error poke preempting the drain."""
    from ray_tpu.core import serialization as ref_ser
    from ray_tpu.dag import channel as ref
    from ray_tpu_torch.core import serialization as port_ser
    from ray_tpu_torch.dag import channel as port

    w_mod, r_mod = (port, ref) if writer == "port" else (ref, port)
    w_ser, r_ser = (port_ser, ref_ser) if writer == "port" else (ref_ser, port_ser)
    path = str(tmp_path / "x.chan")
    w = w_mod.Channel.create(path, 16, "k")
    r = r_mod.Channel.open_wait(path, "k", timeout=5)
    assert w.write(b"hello") == 1
    assert r.read(timeout=5) == (1, b"hello")
    big = bytes(range(256)) * 40
    assert w.write(big) == 2
    assert r.read(timeout=5) == (2, big)
    rec = {"v": [1, 2.5, "three", {"k": (4, None)}], "e": False}
    w.write(w_ser.pack(rec))
    seq, payload = r.read(timeout=5)
    assert seq == 3 and r_ser.unpack(payload) == rec
    w.write(b"one")
    with pytest.raises(w_mod.ChannelTimeoutError):
        w.write(b"two", timeout=0.1)  # frame 4 unconsumed
    assert r.read(timeout=5) == (4, b"one")
    w.write(b"pending")
    assert r_mod.poke_error(path)
    with pytest.raises(r_mod.ChannelClosedError, match="peer died"):
        r.read(timeout=5)
    with pytest.raises(w_mod.ChannelClosedError, match="peer died"):
        w.write(b"next", timeout=5)
    w.detach()
    r.detach()
