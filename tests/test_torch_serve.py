"""ray_tpu_torch.serve held to the reference's: every case of
tests/test_serve.py runs on the port's modules in local mode (deployments,
handles, composition, the HTTP proxy, redeploys, autoscaling,
@serve.batch, retries around dead replicas, async replicas), and a small
transformer served by serve.run answers as the JAX package's forward on
the same weights, carried across by params_from_numpy.

The local runtime runs the plain PyTorch versions of the scheduling
kernels (scheduler_device "cpu")."""

import json
import os
import sys
import time
import urllib.request

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve

CPU = {"scheduler_device": "cpu"}
# the small model the serving tests share: 2 layers, d 64, float32
MODEL_KW = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_seq_len=64)
REQUEST_SHAPES = ((2, 17), (1, 64), (3, 5), (1, 1))


@pytest.fixture
def port8():
    ray_tpu_torch.init(num_cpus=8, _system_config=CPU)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


class SmallModel:
    """User code a deployment serves: the port's transformer built from a
    numpy weight tree on an explicit device, answering with the last
    position's logits as a host array."""

    def __init__(self, weights, device="cpu"):
        from ray_tpu_torch.models import transformer as PT
        from ray_tpu_torch.parallel import make_forward_step

        self.device = torch.device(device)
        cfg = PT.TransformerConfig(dtype=torch.float32, **MODEL_KW)
        self.model = PT.params_from_numpy(weights, cfg, device=self.device)
        self.fwd = make_forward_step(cfg, self.device)

    def __call__(self, tokens):
        return self.fwd(self.model, tokens)[:, -1].cpu().numpy()

    def launches(self):
        from ray_tpu_torch.models import kernels as MK

        return MK.launch_counts(), MK.tc_launch_counts()


# a cluster's worker processes cannot import this test module: ship its
# classes (SmallModel above all) by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def small_model_case():
    """The JAX package's weights (init_params, key 0) as a numpy tree, the
    requests, and the JAX forward's last-position logits for each."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as JT

    cfg_j = JT.TransformerConfig(dtype=jnp.float32, **MODEL_KW)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(19)
    requests = [rng.integers(0, MODEL_KW["vocab_size"], s).astype(np.int32)
                for s in REQUEST_SHAPES]
    want = [np.asarray(JT.forward(params, jnp.asarray(t), cfg_j))[:, -1] for t in requests]
    return tree, requests, want


def test_function_deployment_and_handle(port8):
    @serve.deployment
    def echo(payload):
        return {"echo": payload}

    h = serve.run(echo.bind(), route_prefix=None)
    assert h.remote({"x": 1}).result(timeout=10) == {"echo": {"x": 1}}


def test_class_deployment_methods_and_replicas(port8):
    @serve.deployment(num_replicas=3)
    class Model:
        def __init__(self, scale):
            self.scale = scale
            self.count = 0

        def __call__(self, x):
            self.count += 1
            return x * self.scale

        def info(self):
            return self.count

    h = serve.run(Model.bind(10), route_prefix=None)
    outs = [h.remote(i).result(timeout=10) for i in range(9)]
    assert outs == [i * 10 for i in range(9)]
    st = serve.status()
    assert st["default"]["Model"]["num_replicas"] == 3
    # method routing sugar
    counts = [h.info.remote().result(timeout=10) for _ in range(3)]
    assert all(isinstance(c, int) for c in counts)


def test_model_composition(port8):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Combiner:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            y = self.pre.remote(x).result(timeout=10)
            return y * 2

    app = Combiner.bind(Preprocess.bind())
    h = serve.run(app, route_prefix=None)
    assert h.remote(5).result(timeout=15) == 12


def test_http_proxy_roundtrip(port8):
    @serve.deployment
    def classify(payload):
        return {"label": "even" if payload["n"] % 2 == 0 else "odd"}

    serve.run(classify.bind(), route_prefix="/classify")
    port = serve.http_port()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/classify",
        data=json.dumps({"n": 4}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=15) as resp:
        body = json.loads(resp.read())
    assert body == {"label": "even"}
    # 404 for unknown route when no "/" route exists
    req2 = urllib.request.Request(f"http://127.0.0.1:{port}/nope")
    with pytest.raises(Exception):
        urllib.request.urlopen(req2, timeout=15)


def test_redeploy_updates_in_place(port8):
    @serve.deployment
    def v(payload=None):
        return "v1"

    h = serve.run(v.bind(), route_prefix=None)
    assert h.remote().result(timeout=10) == "v1"

    @serve.deployment(name="v")
    def v2(payload=None):
        return "v2"

    h2 = serve.run(v2.bind(), route_prefix=None)
    deadline = time.time() + 10
    while time.time() < deadline:
        if h2.remote().result(timeout=10) == "v2":
            break
        time.sleep(0.1)
    assert h2.remote().result(timeout=10) == "v2"


def test_autoscaling_up_and_down(port8):
    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
            upscale_delay_s=0.2, downscale_delay_s=0.5,
        ),
        max_ongoing_requests=8,
    )
    def slow(payload=None):
        time.sleep(0.4)
        return "done"

    h = serve.run(slow.bind(), route_prefix=None)
    # flood: sustained ongoing > target -> scale up
    resps = [h.remote() for _ in range(40)]
    deadline = time.time() + 15
    scaled_up = False
    while time.time() < deadline:
        n = serve.status()["default"]["slow"]["num_replicas"]
        if n >= 2:
            scaled_up = True
            break
        time.sleep(0.2)
    assert scaled_up, "never scaled up under load"
    for r in resps:
        r.result(timeout=30)
    # idle -> scale back toward min
    deadline = time.time() + 20
    scaled_down = False
    while time.time() < deadline:
        if serve.status()["default"]["slow"]["num_replicas"] == 1:
            scaled_down = True
            break
        time.sleep(0.25)
    assert scaled_down, "never scaled down when idle"


def test_delete_application(port8):
    @serve.deployment
    def f(p=None):
        return 1

    serve.run(f.bind(), name="appx", route_prefix=None)
    assert "appx" in serve.status()
    serve.delete("appx")
    assert "appx" not in serve.status()


def test_redeploy_removes_absent_deployments(port8):
    """Regression: deployments dropped from the app spec are torn down."""
    @serve.deployment
    class A:
        def __call__(self, p=None):
            return "a"

    @serve.deployment
    class B:
        def __init__(self, a):
            self.a = a

        def __call__(self, p=None):
            return "b" + self.a.remote().result(timeout=10)

    serve.run(B.bind(A.bind()), route_prefix=None)
    assert set(serve.status()["default"]) == {"A", "B"}
    serve.run(A.bind(), route_prefix=None)
    assert set(serve.status()["default"]) == {"A"}


def test_http_get_with_query_string(port8):
    """Regression: the route matcher strips the query string."""
    @serve.deployment
    def ping(payload=None):
        return {"ok": True}

    serve.run(ping.bind(), route_prefix="/ping")
    port = serve.http_port()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/ping?x=1", timeout=15
    ) as resp:
        assert json.loads(resp.read()) == {"ok": True}


def test_serve_batch_coalesces_concurrent_requests(port8):
    """@serve.batch: concurrent calls arrive as ONE list invocation
    (reference: python/ray/serve/batching.py)."""
    import threading

    from ray_tpu_torch import serve

    @serve.deployment(max_ongoing_requests=16)
    class Doubler:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        def sizes(self):
            return self.batch_sizes

    h = serve.run(Doubler.bind(), name="batched")
    results = [None] * 8
    errs = []

    def call(i):
        try:
            results[i] = h.remote(i).result(timeout=60)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not errs, errs
    assert results == [i * 2 for i in range(8)]
    sizes = h.sizes.remote().result(timeout=30)
    assert sum(sizes) == 8
    assert max(sizes) > 1, f"never batched: {sizes}"


def test_serve_batch_respects_max_batch_size():
    """Batches never exceed max_batch_size, and every caller gets its own
    result even when arrivals outnumber one batch (leader drains)."""
    import threading

    from ray_tpu_torch.serve.batching import _Batcher

    sizes = []

    def fn(xs):
        sizes.append(len(xs))
        return [x + 1 for x in xs]

    b = _Batcher(fn, max_batch_size=8, batch_wait_timeout_s=0.2)
    results = [None] * 30
    threads = [
        threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.submit(None, i)))
        for i in range(30)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == [i + 1 for i in range(30)]
    assert max(sizes) <= 8, sizes
    assert sum(sizes) == 30


def test_serve_batch_never_concurrent():
    """The batch function must never run concurrently on one batcher (the
    point of batching is single-threaded model access)."""
    import threading
    import time as _time

    from ray_tpu_torch.serve.batching import _Batcher

    active = [0]
    peak = [0]
    guard = threading.Lock()

    def fn(xs):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        _time.sleep(0.05)
        with guard:
            active[0] -= 1
        return xs

    b = _Batcher(fn, max_batch_size=2, batch_wait_timeout_s=0.01)
    threads = []
    for i in range(8):
        t = threading.Thread(target=lambda i=i: b.submit(None, i))
        t.start()
        threads.append(t)
        _time.sleep(0.02)  # staggered arrivals during flushes
    for t in threads:
        t.join(timeout=30)
    assert peak[0] == 1, f"batch fn ran {peak[0]}-way concurrent"


def test_handle_retries_on_dead_replica(port8):
    """Scale-down/crash mid-request: result() resubmits to a live replica
    (reference: the router's retry-on-dead-replica)."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=3)
    class Sq:
        def __call__(self, x):
            return x * x

    h = serve.run(Sq.bind(), name="retry")
    assert h.remote(3).result(timeout=30) == 9
    # rescale down: two of the three replicas die while the handle still
    # holds the old membership
    serve.run(Sq.options(num_replicas=1).bind(), name="retry")
    ok = 0
    for i in range(40):
        assert h.remote(i).result(timeout=30) == i * i
        ok += 1
    assert ok == 40


def test_handle_retries_on_crashed_replica_without_rescale(port8):
    """A replica CRASH bumps no controller version; the handle must still
    route around the dead actor (exclusion + unconditional refresh)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import _get_controller

    @serve.deployment(num_replicas=2)
    class Sq:
        def __call__(self, x):
            return x + 100

    h = serve.run(Sq.bind(), name="crash")
    assert h.remote(1).result(timeout=30) == 101
    # kill one replica actor directly — no rescale, version unchanged
    ctrl = _get_controller()
    reps = ray_tpu_torch.get(ctrl.get_replicas.remote("crash", "Sq"))["replicas"]
    ray_tpu_torch.kill(reps[0])
    ok = 0
    for i in range(30):
        assert h.remote(i).result(timeout=30) == i + 100
        ok += 1
    assert ok == 30


def test_async_deployment_in_replica_concurrency(port8):
    """Async handlers interleave on the replica's event loop: N requests
    park on an asyncio.Event inside ONE replica and a later request
    releases them — impossible without in-replica asyncio concurrency
    (reference: serve's asyncio replica runtime)."""
    import asyncio

    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Gate:
        def __init__(self):
            self.ev = asyncio.Event()

        async def __call__(self, cmd):
            if cmd == "open":
                self.ev.set()
                return "opened"
            await self.ev.wait()
            return "released"

    h = serve.run(Gate.bind(), route_prefix=None)
    waiters = [h.remote("wait") for _ in range(5)]
    time.sleep(0.3)
    assert h.remote("open").result(timeout=10) == "opened"
    assert [w.result(timeout=10) for w in waiters] == ["released"] * 5


def test_replica_request_counters_without_lock(port8):
    """Regression for the reference's ray-lint blocking-in-async fix: the replica's
    ongoing/total counters are loop-confined (no threading.Lock shared
    with the metrics thread, which used to be able to stall the event
    loop). Counters must stay exact across interleaved async requests."""
    import asyncio

    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Counted:
        async def __call__(self, x):
            await asyncio.sleep(0.01)
            return x

    h = serve.run(Counted.bind(), route_prefix=None)
    n = 12
    assert [r.result(timeout=10) for r in [h.remote(i) for i in range(n)]] \
        == list(range(n))

    from ray_tpu_torch.serve.api import _get_controller

    ctrl = _get_controller()
    info = ray_tpu_torch.get(ctrl.get_replicas.remote("default", "Counted"))
    (replica,) = info["replicas"]
    stats = ray_tpu_torch.get(replica.stats.remote())
    assert stats == {"ongoing": 0, "total": n, "fp_ongoing": 0}


def test_slow_replica_constructor_is_not_killed(port8, tmp_path):
    """A replica whose constructor outlasts the controller's 5 s startup
    grace and 2 s probe (a model loading onto the card) is still starting,
    not dead: it is constructed once and answers. The reference's
    controller kills it and every replacement (ROADMAP.md, queue 3)."""

    class Slow:
        def __init__(self, d):
            open(os.path.join(d, f"{time.time()}"), "w").close()
            time.sleep(8)

        def __call__(self, x):
            return x + 1

    h = serve.run(serve.deployment(Slow).bind(str(tmp_path)), name="slow",
                  route_prefix=None)
    assert h.remote(1).result(timeout=60) == 2
    assert len(os.listdir(tmp_path)) == 1
    assert serve.status()["slow"]["Slow"]["num_replicas"] == 1


def test_small_model_served_matches_jax_forward(port8):
    """A small transformer (2 layers, d 64, float32) deployed by serve.run
    with two replicas: each answer, the last position's logits, is held to
    the JAX package's forward on the same weights within
    GOLDEN_TOL["f32"] (the port's forward tests' tolerance at this width
    and type), its argmax agreeing on that tolerance's share of rows."""
    from ray_tpu_torch.models.transformer import GOLDEN_TOL

    tree, requests, want = small_model_case()
    h = serve.run(serve.deployment(num_replicas=2)(SmallModel).bind(tree),
                  name="small", route_prefix=None)
    got = [h.remote(t).result(timeout=60) for t in requests]
    atol, _, share = GOLDEN_TOL["f32"]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        assert np.mean(g.argmax(-1) == w.argmax(-1)) >= share
    # the replicas answer alike: each request again, bit-equal
    again = [h.remote(t).result(timeout=60) for t in requests]
    assert all(np.array_equal(a, b) for a, b in zip(got, again))
