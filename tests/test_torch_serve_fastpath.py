"""ray_tpu_torch's serve fast path (ray_tpu_torch.serve.fastpath) held to
the reference's: every case of tests/test_serve_fastpath.py runs on the
port's modules — the zero-RPC request plane on compiled-graph channels
(no driver RPC in steady state, read from the flight recorder), errors,
continuous batching, relay pairs through the daemons, a replica killed
mid-request rerouting exactly once, a node killed, teardown and the GCS's
sweeps, the task-layer fallback in local mode, and the adaptive batch
sizer — and the small transformer of test_torch_serve.py is served
through the fast path of a one-node cluster, its answers bit-equal to the
port's local-mode answers. A `cuda` case serves it from a replica on the
card (it skips without one).

The clusters run the GCS's rounds through the plain PyTorch versions of
the kernels (scheduler_device "cpu") with the reference's 60 s router
refresh. The chaos case records the protocol with the port's recorder
(ray_tpu_torch.analysis.invariants), not the conftest's
`invariant_sanitizer`, which installs the JAX package's."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.dag.channel import Channel, ChannelClosedError
from ray_tpu_torch.serve.batching import AdaptiveBatchSizer
from test_torch_dag import _shutdown_cluster, port_invariants  # noqa: F401 - fixture
from test_torch_serve import SmallModel, small_model_case

CPU = {"scheduler_device": "cpu"}


@pytest.fixture
def fp_cluster():
    """One-node embedded cluster with a long router-refresh period (the
    zero-RPC assertions need a quiet background plane)."""
    ray_tpu_torch.shutdown()
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes(1)
    ray_tpu_torch.init(address=cluster.address,
                       config={"serve_fastpath_refresh_s": 60.0,
                               "log_to_driver": False})
    yield cluster
    serve.shutdown()
    ray_tpu_torch.shutdown()
    _shutdown_cluster(cluster)


# ============================================================== data path


def test_fastpath_roundtrip_function_and_class(fp_cluster):
    @serve.deployment(fast_path=True)
    def echo(payload):
        return {"echo": payload}

    h = serve.run(echo.bind(), route_prefix=None)
    assert h.remote({"x": 1}).result(timeout=30) == {"echo": {"x": 1}}

    @serve.deployment(num_replicas=2, fast_path=True, name="Model")
    class Model:
        def __init__(self, scale):
            self.scale = scale
            self.n = 0

        def __call__(self, x):
            self.n += 1
            return x * self.scale

        def count(self):
            return self.n

    h2 = serve.run(Model.bind(10), name="m", route_prefix=None)
    assert [h2.remote(i).result(timeout=30) for i in range(10)] \
        == [i * 10 for i in range(10)]
    # method-handle sugar rides the SAME router (shared channel pairs)
    counts = [h2.count.remote().result(timeout=30) for _ in range(4)]
    assert all(isinstance(c, int) and c >= 1 for c in counts)
    st = h2.fastpath_stats()
    assert st["completed"] == st["submitted"] >= 14
    assert st["duplicates"] == 0 and st["failed"] == 0


def test_fastpath_error_propagates_and_pipeline_survives(fp_cluster):
    @serve.deployment(fast_path=True)
    def boom(x):
        if x == 13:
            raise ValueError("boom13")
        return x

    h = serve.run(boom.bind(), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 1
    with pytest.raises(Exception, match="boom13"):
        h.remote(13).result(timeout=30)
    # per-request error, not fatal to the plane
    assert h.remote(2).result(timeout=30) == 2


def test_fastpath_zero_gcs_rpcs_steady_state(fp_cluster):
    """Steady-state request handling issues ZERO
    RPCs from this driver — asserted via the always-on flight recorder
    (every client send in this process lands in its ring)."""
    from ray_tpu_torch.cluster import rpc as _rpc
    from ray_tpu_torch.core import api as _api

    @serve.deployment(num_replicas=2, fast_path=True)
    def double(x):
        return x * 2

    h = serve.run(double.bind(), route_prefix=None)
    for i in range(10):  # warm: pairs registered, channels mapped
        assert h.remote(i).result(timeout=30) == i * 2
    # drain stragglers (ref frees, controller chatter) out of the window
    import gc

    gc.collect()
    time.sleep(1.0)
    rec = _rpc.TRACE
    assert rec is not None and getattr(rec, "is_flight_recorder", False), \
        "test needs the default flight recorder installed"
    me = _api._runtime.worker_id
    before = len([e for e in rec.snapshot()
                  if e[0] in ("send", "push") and e[2] == me])
    for i in range(200):
        assert h.remote(i).result(timeout=30) == i * 2
    after = len([e for e in rec.snapshot()
                 if e[0] in ("send", "push") and e[2] == me])
    assert after == before, (
        f"{after - before} driver RPC send(s) during 200 steady-state "
        "fast-path requests — the hot path must be channel-only"
    )
    st = h.fastpath_stats()
    assert st["completed"] >= 210 and st["duplicates"] == 0


def test_fastpath_batch_handler_vectorized(fp_cluster):
    """@serve.batch handlers get the continuous batcher's whole dispatch
    group as ONE list call (no second rendezvous window)."""

    @serve.deployment(fast_path=True, max_ongoing_requests=32)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=32, batch_wait_timeout_s=0.05)
        def __call__(self, xs):
            self.sizes.append(len(xs))
            return [x + 1 for x in xs]

        def seen(self):
            return list(self.sizes)

    h = serve.run(Batched.bind(), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 2
    n = 48
    resps = [h.remote(i) for i in range(n)]
    assert [r.result(timeout=30) for r in resps] == [i + 1 for i in range(n)]
    sizes = h.seen.remote().result(timeout=30)
    assert sum(sizes) >= n
    assert max(sizes) > 1, (
        f"concurrent submits never coalesced into a vectorized batch "
        f"(sizes={sizes})"
    )


def test_fastpath_relay_mode_rides_daemon_transfer_path(fp_cluster):
    """force_remote pairs use the dag_push/dag_pull relay — the
    cross-node / remote-driver fallback — end to end."""
    from ray_tpu_torch.serve.fastpath import FastPathRouter

    @serve.deployment(num_replicas=1, fast_path=True)
    def triple(x):
        return x * 3

    h = serve.run(triple.bind(), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 3  # local-path sanity
    router = FastPathRouter("triple", "default", h._fetch_membership,
                            force_remote=True)
    try:
        router.refresh_now()
        for i in range(5):
            assert router.submit(None, (i,), {}).result(timeout=30) == i * 3
        assert router.stats["completed"] == 5
        assert router.stats["duplicates"] == 0
    finally:
        router.shutdown()


# ================================================================== chaos


def test_fastpath_replica_killed_mid_request(port_invariants,
                                             monkeypatch):
    """Kill a replica worker mid-request. The router
    must see ChannelClosedError (via the daemon death sweep's channel
    poke), reroute the in-flight requests to the surviving replica, and
    deliver each response exactly once — and the whole run must replay
    clean through the invariant checker, channel seq alternation
    included."""
    ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_TRACE_FILE", port_invariants.path)
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes(1)
    ray_tpu_torch.init(address=cluster.address,
                       config={"serve_fastpath_refresh_s": 60.0,
                               "log_to_driver": False})
    try:
        @serve.deployment(num_replicas=2, fast_path=True,
                          max_ongoing_requests=8)
        def slow(x):
            time.sleep(0.6)
            return x + 1000

        h = serve.run(slow.bind(), route_prefix=None)
        assert h.remote(0).result(timeout=30) == 1000
        # fire a volley, then kill a pair-attached replica mid-flight
        resps = [h.remote(i) for i in range(6)]
        time.sleep(0.25)
        router = h._fp_router[0]
        victim = None
        attached = set(router._pairs)
        for d in cluster.daemons:
            for w in d.workers.values():
                if w.serve_pairs and w.actor_id in attached:
                    victim = w
                    break
            if victim:
                break
        assert victim is not None, "no pair-attached replica worker found"
        victim.proc.kill()
        got = [r.result(timeout=60) for r in resps]
        assert got == [i + 1000 for i in range(6)]
        st = h.fastpath_stats()
        assert st["duplicates"] == 0, "a response was delivered twice"
        assert st["failed"] == 0
        assert st["rerouted"] >= 1, (
            "the kill landed mid-request but nothing rerouted"
        )
        # the plane keeps serving afterwards
        assert h.remote(7).result(timeout=60) == 1007
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


def test_fastpath_node_kill_reroutes(monkeypatch):
    """Kill a whole node hosting replicas: channels can't be poked (the
    daemon died too) — the router's node-snapshot probe wakes parked
    reads and requests land on surviving replicas."""
    ray_tpu_torch.shutdown()
    cluster = Cluster(config=Config(CPU))
    cluster.add_node(num_cpus=4, resources={"KEEP": 10})
    victim_node = cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes(2)
    ray_tpu_torch.init(address=cluster.address,
                       config={"serve_fastpath_refresh_s": 60.0,
                               "log_to_driver": False})
    try:
        @serve.deployment(num_replicas=3, fast_path=True)
        def inc(x):
            return x + 1

        h = serve.run(inc.bind(), route_prefix=None)
        for i in range(10):
            assert h.remote(i).result(timeout=30) == i + 1
        cluster.kill_node(victim_node)
        # every request must still complete (reroute or already-healthy
        # pair); allow the generous window the death sweep needs
        deadline = time.time() + 60
        done = 0
        while done < 20 and time.time() < deadline:
            assert h.remote(done).result(timeout=60) == done + 1
            done += 1
        assert done == 20
        st = h.fastpath_stats()
        assert st["duplicates"] == 0
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)


# ============================================================== lifecycle


def test_fastpath_teardown_idempotent_and_gcs_sweep(fp_cluster):
    @serve.deployment(num_replicas=2, fast_path=True)
    def f(x):
        return x

    h = serve.run(f.bind(), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 1
    gcs = fp_cluster.gcs
    assert gcs.serve_pairs, "pair registration never reached the GCS"
    router = h._fp_router[0]
    router.shutdown()
    router.shutdown()  # idempotent
    deadline = time.time() + 10
    while time.time() < deadline and gcs.serve_pairs:
        time.sleep(0.05)
    assert not gcs.serve_pairs, "teardown left pair registrations behind"
    # daemon channel index swept too (the teardown PUSH is async: give it
    # its delivery window before asserting)
    deadline = time.time() + 10
    while time.time() < deadline and any(
            d._serve_pairs for d in fp_cluster.daemons):
        time.sleep(0.05)
    for d in fp_cluster.daemons:
        assert not d._serve_pairs


def test_fastpath_driver_disconnect_sweeps_pairs(fp_cluster):
    @serve.deployment(fast_path=True)
    def f(x):
        return x

    h = serve.run(f.bind(), route_prefix=None)
    assert h.remote(1).result(timeout=30) == 1
    gcs = fp_cluster.gcs
    assert gcs.serve_pairs
    # driver vanishes WITHOUT teardown: the GCS sweeps its pairs
    for r in list(__import__("ray_tpu_torch.serve.fastpath",
                             fromlist=["_ROUTERS"])._ROUTERS):
        r._closed = True  # suppress the graceful teardown path
    ray_tpu_torch.shutdown()
    deadline = time.time() + 20
    while time.time() < deadline and gcs.serve_pairs:
        time.sleep(0.1)
    assert not gcs.serve_pairs, "GCS kept the dead driver's serve pairs"


def test_fastpath_local_mode_falls_back_to_task_layer():
    """fast_path=True in local mode (no cluster runtime) must serve
    through the task layer rather than fail."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, _system_config=CPU)
    try:
        @serve.deployment(fast_path=True)
        def f(x):
            return x * 5

        h = serve.run(f.bind(), route_prefix=None)
        assert h.remote(2).result(timeout=10) == 10
        assert h._fp_router[0] is None, "local mode must not build a router"
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


# ================================================================== units


def test_channel_try_read_nonblocking(tmp_path):
    path = str(tmp_path / "c.chan")
    w = Channel.create(path, 64, "k")
    r = Channel.open_wait(path, "k", timeout=5)
    assert r.try_read() is None  # empty: no frame, no block
    w.write(b"one")
    assert r.try_read() == (1, b"one")
    assert r.try_read() is None  # consumed
    w.write(b"two")
    w.close()
    assert r.try_read() == (2, b"two")  # closed drains pending frames
    with pytest.raises(ChannelClosedError):
        r.try_read()  # closed AND drained


def test_adaptive_batch_sizer_targets_latency():
    s = AdaptiveBatchSizer(target_latency_s=0.1, max_batch=64)
    assert s.target() == 64  # no signal: take what's queued (see target())
    s.record(4, 0.04)  # 10ms per item -> ~10 items fit the target
    assert 5 <= s.target() <= 12
    for _ in range(50):
        s.record(1, 0.0001)  # fast handler: EMA converges down
    assert s.target() == 64  # clamped at max_batch
    for _ in range(50):
        s.record(1, 0.5)  # slow handler: latency-first
    assert s.target() == 1
    assert 0.0005 <= s.wait_budget() <= 0.025


def test_adaptive_batch_sizer_ignores_empty():
    s = AdaptiveBatchSizer(target_latency_s=0.02, max_batch=8)
    s.record(0, 1.0)
    assert s.target() == 8  # empty record ignored: still untrained


# ========================================================= the small model


def test_small_model_through_the_fast_path_equals_local_mode(fp_cluster):
    """The small transformer served by two fast-path replicas in worker
    processes of a one-node cluster: every answer bit-equal to the same
    deployment's answers in local mode (replicas in this process through
    the task layer), which test_torch_serve.py holds to the JAX forward.
    The requests ride the channel pairs only: completed == submitted, no
    failure, no duplicate."""
    tree, requests, want = small_model_case()
    h = serve.run(serve.deployment(num_replicas=2, fast_path=True)(SmallModel).bind(tree),
                  name="small", route_prefix=None)
    got = [h.remote(t).result(timeout=120) for t in requests]
    got += [r.result(timeout=120) for r in [h.remote(t) for t in requests]]
    st = h.fastpath_stats()
    assert st["completed"] == st["submitted"] == 2 * len(requests)
    assert st["failed"] == 0 and st["duplicates"] == 0
    serve.shutdown()
    ray_tpu_torch.shutdown()

    ray_tpu_torch.init(num_cpus=4, _system_config=CPU)
    try:
        h = serve.run(serve.deployment(fast_path=True)(SmallModel).bind(tree),
                      name="small", route_prefix=None)
        assert h._fp_router[0] is None  # local mode: the task layer
        local = [h.remote(t).result(timeout=60) for t in requests]
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    for i, g in enumerate(got):
        w = local[i % len(requests)]
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), i
    # and local mode is the JAX forward within the forward tests' tolerance
    from ray_tpu_torch.models.transformer import GOLDEN_TOL

    for g, w in zip(local, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GOLDEN_TOL["f32"][0])


@pytest.mark.cuda
def test_cuda_small_model_replica_on_the_card():
    """On the card: a fast-path replica that asks for the GPU
    (ray_actor_options num_gpus 1) lands on the node offering it, builds
    the small model on cuda and answers as the direct forward on the card
    (bit-equal) and as the plain forward on the CPU within
    GOLDEN_TOL["f32"]; K8 launched in the replica's process. No JAX here:
    the weights are the port's numpy_params."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    from test_torch_serve import MODEL_KW, REQUEST_SHAPES
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.models.transformer import GOLDEN_TOL

    tree = PT.numpy_params(PT.TransformerConfig(dtype=torch.float32, **MODEL_KW), 0)
    rng = np.random.default_rng(19)
    requests = [rng.integers(0, MODEL_KW["vocab_size"], s).astype(np.int32)
                for s in REQUEST_SHAPES]
    direct = SmallModel(tree, "cuda")
    direct_answers = [direct(t) for t in requests]
    plain = SmallModel(tree, "cpu")
    want = [plain(t) for t in requests]
    cluster = Cluster(config=Config(CPU))
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2, resources={"GPU": 1}, node_id="gpu-node")
        cluster.wait_for_nodes(2)
        ray_tpu_torch.init(address=cluster.address)
        dep = serve.deployment(fast_path=True, ray_actor_options={"num_gpus": 1})(SmallModel)
        h = serve.run(dep.bind(tree, "cuda"), name="card", route_prefix=None)
        got = [h.remote(t).result(timeout=300) for t in requests]
        launches, tc = h.launches.remote().result(timeout=60)
        hosts = {d.node_id for d in cluster.daemons
                 for w in list(d.workers.values()) if w.serve_pairs}
        assert hosts == {"gpu-node"}, hosts
        st = h.fastpath_stats()
        assert st["failed"] == 0 and st["duplicates"] == 0
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        _shutdown_cluster(cluster)
    for g, d, w in zip(got, direct_answers, want):
        assert np.array_equal(g, d)
        np.testing.assert_allclose(g, w, rtol=0, atol=GOLDEN_TOL["f32"][0])
    assert launches["attention"] > 0, launches


class _BufferedResponse:
    """A pair's response end holding one frame the replica committed
    before it died: read() hands it over once `release` is set, then
    behaves as a closed, drained channel (the should_stop probe ends it)."""

    def __init__(self, frame):
        self.frame = frame
        self.release = threading.Event()

    def read(self, timeout=None, should_stop=None):
        if self.frame is not None and self.release.wait(timeout=30):
            frame, self.frame = self.frame, None
            return 1, frame
        while not (should_stop and should_stop()):
            time.sleep(0.01)
        raise ChannelClosedError("stage stopping")

    def detach(self):
        pass


def _bare_router(rt):
    """A FastPathRouter with its state and no runtime: the pairs are the
    test's."""
    from ray_tpu_torch.serve import fastpath as fp

    router = fp.FastPathRouter.__new__(fp.FastPathRouter)
    router._rt = rt
    router.deployment_name = "d"
    router._lock = threading.Lock()
    router._stats_lock = threading.Lock()
    router.stats = {"submitted": 0, "completed": 0, "rerouted": 0, "duplicates": 0,
                    "failed": 0, "rejected": 0, "shed": 0}
    router._pairs, router._waiters, router._dead = {}, {}, set()
    router._closed = False
    router._m_lat, router._m_key = [], fp._M_REQ_SECONDS.series_key({"deployment": "d"})
    return router


@pytest.mark.parametrize("replica_answered", [True, False])
def test_failed_pair_reads_what_its_replica_wrote_before_rerouting(replica_answered):
    """A flusher whose write fails (the replica was killed) fails the pair
    while the pair's reader may still hold a response the replica committed
    before it died. The reader reads it first and only what is still
    unanswered is rerouted: the reference reroutes at once, so the request
    runs again on another replica and its second answer counts as a
    duplicate (seen in the serve storm under load). Without a buffered
    answer, the request is rerouted once the reader has drained."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.serve import fastpath as fp

    class Runtime:
        def serve_teardown(self, pair_id):
            pass

        def node_alive(self, node_id):
            return True

    class Writer:
        def detach(self):
            pass

    router = _bare_router(Runtime())
    rerouted = []
    router._reroute = lambda w, dead_actor, reason: rerouted.append(w.rid)
    frame = serialization.dumps([("req-1", False, 42)]) if replica_answered else None
    resp = _BufferedResponse(frame)
    pair = fp._Pair("pair-1", "actor-1", "node-1", Writer(), resp)
    w = fp._Waiter("req-1", ("req-1", None, (41,), {}, None))
    router._pairs["actor-1"] = pair
    router._waiters["req-1"], w.pair, pair.inflight = w, pair, 1
    pair.reader = threading.Thread(target=router._read_loop, args=(pair,), daemon=True)
    pair.reader.start()
    router._fail_pair(pair, "write failed: replica killed")  # the flusher's call
    resp.release.set()
    pair.reader.join(timeout=30)
    assert not pair.reader.is_alive()
    if replica_answered:
        assert w.done and w.value == 42 and not w.is_err
        assert rerouted == []
    else:
        assert not w.done and rerouted == ["req-1"]
    assert router.stats["duplicates"] == 0 and "req-1" not in router._waiters
