"""ray_tpu_torch's cluster mode: one GCS, node daemons with the native shm
store, subprocess workers and the driver's ClusterClient, held against
ray_tpu's cluster. Every case of tests/test_cluster.py runs on the port's
modules (the placement case without the reference's race: its tasks meet
at a barrier, so it tests placement, not timing), the local-mode workload
of test_torch_runtime runs on a port cluster and on a ray_tpu cluster with
equal results, and a small transformer is served from an actor in a
worker process against the JAX forward.

The GCS's policy is torch_cuda with scheduler_device "cpu" here (the plain
PyTorch versions of the kernels); the default, on the card, raises
without one. Every get has a timeout, and every cluster is shut down in
`finally` with its worker processes reaped."""

import os
import subprocess
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.cluster import Cluster as RefCluster
from ray_tpu.core.config import Config as RefConfig
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.exceptions import TaskError
from ray_tpu_torch.sched import kernel_torch as KT
from test_torch_runtime import TORCH_CPU, _workload

CPU = {"scheduler_device": "cpu"}
# Both sides of a workload comparison run without the gray-failure
# defense: under load it can quarantine a slow node (or launch a
# speculative copy of a task), which takes the node out of
# cluster_resources() on one side and not the other, by timing alone.
STEADY = {"gray_defense_enabled": False}
PORT_STEADY = {**TORCH_CPU, **STEADY}
# the reference's clusters keep their session files under TMPDIR as well
REF_STEADY = {"session_dir_root": os.path.join(tempfile.gettempdir(), "ray_tpu_ref"),
              **STEADY}


def _worker_procs(c):
    return [w.proc for d in c.daemons for w in list(d.workers.values())
            if w.proc is not None]


def _teardown(c):
    """Driver first, then the cluster; every worker process it started is
    reaped (killed if it outlives its daemon's SIGTERM)."""
    procs = _worker_procs(c)
    try:
        ray_tpu_torch.shutdown()
    finally:
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)


@pytest.fixture
def cluster():
    c = Cluster(config=Config(CPU))
    try:
        yield c
    finally:
        _teardown(c)


def _connect(c):
    return ray_tpu_torch.init(address=c.address)


# --------------------------------------------------------------------------
# The cases of tests/test_cluster.py on the port
# --------------------------------------------------------------------------


def test_cluster_startup_and_resources(cluster):
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=3)
    cluster.wait_for_nodes(2)
    _connect(cluster)
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 5.0
    assert len(ray_tpu_torch.nodes()) == 2
    # every daemon is on the native shm store, under the port's own prefix
    assert all(d.shm_name and d.shm_name.startswith("/rtt_") for d in cluster.daemons)


def test_session_files_stay_under_tmpdir(tmp_path):
    """A daemon's spill files and DAG channel dir lie under the port's
    session root, which follows TMPDIR and is not the reference package's
    (whose clusters use the same node ids)."""
    import sys

    import ray_tpu.core.config as ref_config

    root = Config().session_dir_root
    assert root.startswith(tempfile.gettempdir() + os.sep)
    assert root != ref_config.Config().session_dir_root
    # the default is read from TMPDIR when the package is imported
    out = subprocess.run(
        [sys.executable, "-c", "from ray_tpu_torch.core.config import Config;"
         "print(Config().session_dir_root)"],
        env={**os.environ, "TMPDIR": str(tmp_path)}, capture_output=True,
        text=True, timeout=60, check=True)
    assert out.stdout.strip() == str(tmp_path / "ray_tpu_torch")

    c = Cluster(config=Config({**CPU, "object_store_memory_bytes": 2 * 1024 * 1024}))
    try:
        c.add_node(num_cpus=1, node_id="node-a")
        c.wait_for_nodes(1)
        _connect(c)
        # 8 objects of 512 KiB against a 2 MiB store: the early ones spill
        arrs = [np.full(64 * 1024, i, dtype=np.float64) for i in range(8)]
        refs = [ray_tpu_torch.put(a) for a in arrs]
        d = c.daemons[0]
        assert d.shm_name, "daemon fell back to the dict store"
        assert d.store.spill_dir == os.path.join(root, "spill", "node-a")
        assert d.chan_dir == os.path.join(root, "dagchan", "node-a")
        spilled = dict(d.store._spilled)
        assert spilled, "nothing spilled under pressure"
        assert all(os.path.dirname(p) == d.store.spill_dir and os.path.exists(p)
                   for p in spilled.values())
        for a, r in zip(arrs, refs):
            np.testing.assert_array_equal(ray_tpu_torch.get(r, timeout=30), a)
    finally:
        _teardown(c)


def test_cluster_task_roundtrip(cluster):
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(2, 3), timeout=60) == 5


def test_cluster_parallel_across_nodes(cluster, tmp_path):
    """Two 1-CPU nodes, 8 tasks. Each task marks its node in a barrier
    directory and waits (60 s deadline) until both nodes have a mark: the
    first task holds its node's only CPU while it waits, so the scheduler
    must place another on the other node. Both nodes show up however the
    tasks are timed; a placement that never uses the second node fails at
    the deadline instead of passing by luck."""
    cluster.add_node(num_cpus=1, node_id="node-a")
    cluster.add_node(num_cpus=1, node_id="node-b")
    cluster.wait_for_nodes(2)
    _connect(cluster)
    barrier = str(tmp_path)

    @ray_tpu_torch.remote(num_cpus=1)
    def where(barrier_dir):
        import os
        import time

        node = os.environ.get("RAY_TPU_NODE_ID")
        open(os.path.join(barrier_dir, node), "w").close()
        deadline = time.time() + 60
        while len(os.listdir(barrier_dir)) < 2:
            if time.time() > deadline:
                raise TimeoutError(f"only {os.listdir(barrier_dir)} reached the barrier")
            time.sleep(0.01)
        return node

    nodes = set(ray_tpu_torch.get([where.remote(barrier) for _ in range(8)], timeout=90))
    assert nodes == {"node-a", "node-b"}


def test_cluster_large_object_transfer(cluster):
    cluster.add_node(num_cpus=1, node_id="prod")
    cluster.add_node(num_cpus=1, node_id="cons")
    cluster.wait_for_nodes(2)
    _connect(cluster)

    @ray_tpu_torch.remote(resources={"CPU": 1, "only_prod": 0})
    def produce():
        return np.arange(500_000, dtype=np.float32)  # ~2MB, above inline cap

    @ray_tpu_torch.remote
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    total = ray_tpu_torch.get(consume.remote(ref), timeout=90)
    assert total == float(np.arange(500_000, dtype=np.float32).sum())
    # driver-side fetch of the large object too
    arr = ray_tpu_torch.get(ref, timeout=60)
    assert arr.shape == (500_000,)


def test_cluster_put_get(cluster):
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(1)
    _connect(cluster)
    ref = ray_tpu_torch.put({"hello": np.ones(10)})
    out = ray_tpu_torch.get(ref, timeout=30)
    assert out["hello"].sum() == 10


def test_cluster_task_error(cluster):
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("cluster boom")

    with pytest.raises(TaskError, match="cluster boom"):
        ray_tpu_torch.get(boom.remote(), timeout=60)


def test_cluster_actor(cluster):
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def inc(self, k=1):
            self.v += k
            return self.v

    c = Counter.remote(100)
    vals = ray_tpu_torch.get([c.inc.remote() for _ in range(5)], timeout=60)
    assert vals == [101, 102, 103, 104, 105]


def test_cluster_actor_on_chosen_node(cluster):
    cluster.add_node(num_cpus=1, node_id="n-x")
    cluster.add_node(num_cpus=1, num_tpus=4, node_id="n-tpu")
    cluster.wait_for_nodes(2)
    _connect(cluster)

    @ray_tpu_torch.remote(num_tpus=1)
    class TpuActor:
        def where(self):
            import os

            return os.environ.get("RAY_TPU_NODE_ID")

    a = TpuActor.remote()
    assert ray_tpu_torch.get(a.where.remote(), timeout=60) == "n-tpu"


def test_cluster_node_death_task_retry(cluster):
    cluster.add_node(num_cpus=1, node_id="stable")
    victim = cluster.add_node(num_cpus=1, node_id="victim", resources={"victim": 1})
    cluster.wait_for_nodes(2)
    _connect(cluster)

    @ray_tpu_torch.remote(max_retries=2, resources={"CPU": 1})
    def slow_then_ok(t):
        time.sleep(t)
        return "done"

    # pin first run to the victim by saturating stable's cpu
    @ray_tpu_torch.remote(num_cpus=1)
    def blocker():
        time.sleep(2.0)
        return 1

    b = blocker.remote()
    ref = slow_then_ok.remote(1.5)
    time.sleep(0.7)  # task should be running on the victim now
    cluster.kill_node(victim)
    # retry lands on the stable node once blocker finishes
    assert ray_tpu_torch.get(ref, timeout=90) == "done"
    assert ray_tpu_torch.get(b, timeout=30) == 1


def test_cluster_infeasible_then_feasible(cluster):
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote(resources={"special": 1, "CPU": 1})
    def needs_special():
        return "got it"

    ref = needs_special.remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=1.0)
    assert ready == []  # infeasible: queued
    cluster.add_node(num_cpus=1, resources={"special": 2})
    assert ray_tpu_torch.get(ref, timeout=90) == "got it"


def test_cluster_timeline_and_summary(cluster):
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote
    def traced():
        return 1

    ray_tpu_torch.get(traced.remote(), timeout=60)
    events = ray_tpu_torch.timeline()
    assert any(e.get("name") == "traced" for e in events)


def test_dependency_aware_dispatch_holds_no_resources(cluster):
    """Tasks with unmet deps wait at the GCS holding neither a worker nor
    resources; dependency chains longer than worker count complete
    (reference: dependency_manager.cc + local_task_manager.cc dispatch-
    only-when-args-local)."""
    cluster.add_node(num_cpus=1)  # one slot: waiting consumers would deadlock it
    _connect(cluster)

    @ray_tpu_torch.remote
    def src():
        import time as _t
        _t.sleep(0.8)
        return 7

    @ray_tpu_torch.remote
    def plus(x, y):
        return x + y

    s = src.remote()
    consumers = [plus.remote(s, i) for i in range(6)]
    time.sleep(0.4)  # src still sleeping on the only CPU
    gcs = cluster.gcs
    with gcs._lock:
        waiting = len(gcs.waiting_tasks)
        avail_cpu = gcs.state.available_map().get(
            gcs.state.node_ids[0], {}).get("CPU", 0.0)
    # all consumers parked at the dep gate; only src holds the CPU
    assert waiting == 6, f"expected 6 waiting, got {waiting}"
    assert avail_cpu == 0.0
    out = ray_tpu_torch.get(consumers, timeout=30.0)
    assert out == [7 + i for i in range(6)]

    # a chain much longer than the worker pool also completes
    r = ray_tpu_torch.put(0)

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    for _ in range(25):
        r = inc.remote(r)
    assert ray_tpu_torch.get(r, timeout=60.0) == 25


# --------------------------------------------------------------------------
# The slice held against ray_tpu's cluster
# --------------------------------------------------------------------------


def _cluster_workload(rt):
    """test_torch_runtime's workload (tasks with dependencies, an actor's
    running sums, a multi-resource class, the infeasible task), then a
    dependency chain, the resources once the work has drained, and the
    nodes; returns what a caller observes."""
    out = _workload(rt)

    @rt.remote
    def inc(x):
        return x + 1

    r = rt.put(0)
    for _ in range(12):
        r = inc.remote(r)
    out["chain"] = rt.get(r, timeout=60)
    # drained: the available view settles (the actor keeps what it holds)
    deadline = time.time() + 20
    prev = rt.available_resources()
    while time.time() < deadline:
        time.sleep(0.25)
        cur = rt.available_resources()
        if cur == prev:
            break
        prev = cur
    out["available"] = prev
    out["cluster"] = rt.cluster_resources()
    nodes = rt.nodes()
    out["n_nodes"] = len(nodes)
    out["node_resources"] = sorted(
        sorted(n["Resources"].items()) for n in nodes if n["Alive"])
    return out


NODE_CPUS = (4, 2)


@pytest.fixture(scope="module")
def reference_workload():
    c = RefCluster(config=RefConfig(REF_STEADY))
    try:
        for n in NODE_CPUS:
            c.add_node(num_cpus=n)
        c.wait_for_nodes(len(NODE_CPUS))
        ray_tpu.init(address=c.address)
        want = _cluster_workload(ray_tpu)
    finally:
        ray_tpu.shutdown()
        c.shutdown()
    return want


@pytest.fixture
def plain_kernel_calls(monkeypatch):
    """Counts this process's calls of the plain K1 (the scan round) and of
    refresh_view's two modes (K2 rows, K3 delta): the GCS's rounds on the
    CPU. K4, the sparse download, is not on this path: TorchScheduler
    compacts a round's [C, N] result only where C * N > 5 * cap, cap the
    smallest bucket (1 024 up) that holds the round's tasks, so at least
    where C * N > 5 120: a round of one class or a few would need
    thousands of nodes."""
    calls = {"K1": 0, "K2": 0, "K3": 0}
    for key, name in (("K1", "_schedule_classes_plain"), ("K2", "_scatter_rows_plain_"),
                      ("K3", "_delta_clip_plain")):
        orig = getattr(KT, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(KT, name, counted)
    return calls


def test_cluster_workload_equals_ray_tpu_cluster(reference_workload, plain_kernel_calls):
    """init(address=...) on a port cluster (torch_cuda policy on the CPU,
    jax_policy_min_cells 0: every round on the plain kernels) gives what
    a ray_tpu cluster of the same nodes gives."""
    c = Cluster(config=Config(PORT_STEADY))
    try:
        for n in NODE_CPUS:
            c.add_node(num_cpus=n)
        c.wait_for_nodes(len(NODE_CPUS))
        _connect(c)
        gcs = c.gcs
        got = _cluster_workload(ray_tpu_torch)
    finally:
        _teardown(c)
    assert gcs.policy.name == "torch_cuda" and gcs.policy.device.type == "cpu"
    # the GCS's rounds went through the plain kernels (jax_policy_min_cells 0)
    calls = plain_kernel_calls
    assert calls["K1"] > 0 and calls["K2"] + calls["K3"] > 0, calls
    assert got == reference_workload
    assert got["chain"] == 12 and got["n_nodes"] == 2


def test_init_cluster_true_runs_the_workload(plain_kernel_calls):
    """init(cluster=True) boots an embedded cluster (num_cpus per node),
    runs the workload with the results of a ray_tpu embedded cluster, and
    shutdown() leaves no worker process alive."""
    kw = dict(cluster=True, num_nodes=2, num_cpus=3)
    ray_tpu_torch.init(**kw, _system_config=PORT_STEADY)
    procs = []
    try:
        c = ray_tpu_torch.core.api._embedded_cluster
        assert len(c.daemons) == 2 and all(d.shm_name for d in c.daemons)
        got = _cluster_workload(ray_tpu_torch)
        procs = _worker_procs(c)
        assert procs, "no worker process ran the workload"
        assert all(p.pid != os.getpid() for p in procs)
    finally:
        ray_tpu_torch.shutdown()
    assert ray_tpu_torch.core.api._embedded_cluster is None
    for p in procs:
        p.wait(timeout=15)
    assert plain_kernel_calls["K1"] > 0, plain_kernel_calls
    ray_tpu.init(**kw, _system_config=REF_STEADY)
    try:
        want = _cluster_workload(ray_tpu)
    finally:
        ray_tpu.shutdown()
    assert got == want


def test_cluster_mode_connects_and_default_config_needs_the_card(monkeypatch):
    """address= and cluster=True connect (they raised NotImplementedError
    before cluster mode was ported); a cluster with the default config
    (torch_cuda on the card) raises without one, as local mode does, and
    leaves nothing initialized."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Cluster()
    with pytest.raises(RuntimeError, match="is_available"):
        ray_tpu_torch.init(cluster=True)
    assert not ray_tpu_torch.is_initialized()
    assert ray_tpu_torch.core.api._embedded_cluster is None
    ray_tpu_torch.init(cluster=True, _system_config=CPU)
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.put(7), timeout=30) == 7
        with pytest.raises(RuntimeError, match="called twice"):
            ray_tpu_torch.init(address="tcp://localhost:1")
    finally:
        ray_tpu_torch.shutdown()
    c = Cluster(config=Config(CPU))
    try:
        c.add_node(num_cpus=1)
        c.wait_for_nodes(1)
        rt = ray_tpu_torch.init(address=f"tcp://{c.address}")
        assert type(rt).__name__ == "ClusterClient"

        @ray_tpu_torch.remote
        def attached():
            import sys

            # the worker runs as `python -m ray_tpu_torch.cluster.worker`
            return sys.modules["__main__"]._shm is not None

        # the worker mapped its node's shm store (no quiet RPC fallback)
        assert ray_tpu_torch.get(attached.remote(), timeout=60) is True
    finally:
        _teardown(c)


def test_dag_and_serve_parts_raise_naming_their_roadmap_items(cluster, tmp_path):
    """The daemon's DAG handlers and serve attach, and the worker's DAG
    loop and serve attach, are the reference's (they raised
    NotImplementedError naming ROADMAP items 6 and 9 before the DAG layer
    and serve were ported): the daemon answers an unknown dag, channel,
    pair or actor as the reference's does, the worker's exec loop runs a
    function stage between two channels until stopped, and its serve
    attach reports a hosted replica ready."""
    import threading

    from ray_tpu_torch.cluster import worker as W
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.dag.channel import Channel
    from ray_tpu_torch.dag.compiled import _EdgeArg

    d = cluster.add_node(num_cpus=1)

    class _Conn:
        meta = {"worker_id": "w-none"}

    assert d.rpc_dag_push({"key": "nope", "payload": b""}, None)["ok"] is False
    assert d._dag_pull_frame("nope", 0.1) == {"ok": False, "closed": True}
    assert d.rpc_dag_stage_ready({"dag_id": "d", "stage": 0}, None) == {"ok": True}
    assert d.rpc_dag_stage_exit({"dag_id": "d", "stage": 0}, _Conn()) == {"ok": True}
    assert d.rpc_dag_spans({"dag_id": "d", "stage": 0, "spans": []}, None) == {"ok": True}
    out = d.rpc_dag_start_stage({"dag_id": "d", "stage": 0, "actor_id": "a-none",
                                 "spec": {"in_edges": [], "out_edges": []}}, None)
    assert out["ok"] is False and "not hosted" in out["error"]
    d._on_dag_teardown({"dag_id": "d"})  # nothing to release: a no-op
    out = d.rpc_serve_attach({"pair_id": "p", "actor_id": "a-none"}, None)
    assert out["ok"] is False and out["retry"] is True
    assert d.rpc_serve_replica_ready({"pair_id": "p"}, None) == {"ok": True}
    d._on_serve_teardown({"pair_id": "p"})

    sent = []

    class _Client:
        def notify(self, method, params):
            sent.append((method, params))

    # the exec loop: input channel -> x * 3 -> output channel
    src, dst = str(tmp_path / "in.chan"), str(tmp_path / "out.chan")
    w_in = Channel.create(src, 256, "in")
    spec = {"dag_id": "d1", "stage": 0, "name": "triple", "capacity": 256,
            "actor_id": None, "func_b": serialization.dumps(lambda x: x * 3),
            "args_template": serialization.dumps(((_EdgeArg(0),), {})),
            "in_edges": [{"key": "in", "path": src}],
            "out_edges": [{"key": "out", "path": dst}]}
    t = threading.Thread(target=W._dag_loop, args=(_Client(), spec), daemon=True)
    t.start()
    r_out = Channel.open_wait(dst, "out", timeout=30)
    for i in range(3):
        w_in.write(W._pack_value(i), timeout=30)
        _, frame = r_out.read(timeout=30)
        assert serialization.unpack(frame) == {"e": False, "v": 3 * i}
    W._on_dag_stop({"dag_id": "d1"})
    t.join(30)
    assert not t.is_alive()
    kinds = [m for m, _ in sent]
    assert kinds[0] == "dag_stage_ready" and kinds[-1] == "dag_stage_exit"
    assert sum(len(p["spans"]) for m, p in sent if m == "dag_spans") == 3

    # the serve attach of a hosted replica: its fast path maps the pair
    paths = [str(tmp_path / f"p-{k}.chan") for k in ("rq", "rs")]
    chans = [Channel.create(path, 256, path) for path in paths]

    class _Echo:
        def __call__(self, x):
            return x

    sent.clear()
    W._actor_instances["a-echo"] = _Echo()
    try:
        W._serve_attach(_Client(), {"pair_id": "p1", "actor_id": "a-echo",
                                    "req_path": paths[0], "resp_path": paths[1]})
        assert sent == [("serve_replica_ready", {"pair_id": "p1", "ok": True})]
    finally:
        fp = W._serve_fp.pop("a-echo", None)
        if fp is not None:
            fp.stop()
        W._actor_instances.pop("a-echo", None)
        for ch in chans:
            ch.close()
            ch.detach()


def test_model_actor_in_a_worker_matches_jax_forward(cluster):
    """A small transformer (2 layers, d 64, f32; weights from the JAX
    package's init_params) served from an actor in a worker process of a
    port cluster: its answers, the last position's logits, are held to
    the JAX forward within GOLDEN_TOL["f32"]."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as JT
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.models.transformer import GOLDEN_TOL

    kw = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)
    cfg_j = JT.TransformerConfig(dtype=jnp.float32, **kw)
    cfg = PT.TransformerConfig(dtype=torch.float32, **kw)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, kw["vocab_size"], s).astype(np.int32)
                for s in ((2, 17), (1, 64), (3, 5), (1, 1))]

    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(1)
    _connect(cluster)

    @ray_tpu_torch.remote
    class ModelServer:
        def __init__(self, weights):
            from ray_tpu_torch.parallel import make_forward_step

            self.model = PT.params_from_numpy(weights, cfg, device="cpu")
            self.fwd = make_forward_step(cfg, "cpu")

        def last_logits(self, tokens):
            return self.fwd(self.model, tokens)[:, -1].numpy()

        def pid(self):
            import os

            return os.getpid()

    server = ModelServer.remote(tree)
    assert ray_tpu_torch.get(server.pid.remote(), timeout=120) != os.getpid()
    answers = ray_tpu_torch.get([server.last_logits.remote(t) for t in requests],
                                timeout=120)
    atol, _, share = GOLDEN_TOL["f32"]
    for tokens, got in zip(requests, answers):
        want = np.asarray(JT.forward(params, jnp.asarray(tokens), cfg_j))[:, -1]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert np.mean(got.argmax(-1) == want.argmax(-1)) >= share


@pytest.mark.cuda
def test_cuda_cluster_gcs_rounds_on_the_card():
    """On the card: a cluster with the default config runs its GCS's
    rounds on the CUDA kernels (K1 and refresh_view launched in this
    process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    KT.reset_launch_counts()
    c = Cluster(config=Config({"jax_policy_min_cells": 0}))
    try:
        assert c.gcs.policy.name == "torch_cuda" and c.gcs.policy.device.type == "cuda"
        c.add_node(num_cpus=2)
        c.add_node(num_cpus=2)
        c.wait_for_nodes(2)
        _connect(c)

        @ray_tpu_torch.remote
        def square(x):
            return x * x

        assert ray_tpu_torch.get([square.remote(i) for i in range(50)],
                                 timeout=120) == [i * i for i in range(50)]
    finally:
        _teardown(c)
    counts = KT.launch_counts()
    assert counts["schedule_classes"] > 0, counts
    assert counts["scatter_rows"] + counts["delta_clip"] > 0, counts
