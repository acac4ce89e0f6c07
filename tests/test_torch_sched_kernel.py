"""ray_tpu_torch's scheduler kernels (plain PyTorch versions, on the CPU)
held against ray_tpu's kernel_jax and kernel_np on the same seeded inputs.

K1 schedule_classes, K2 scatter_rows_, K3 delta_clip, K4 compact_nonzero and
TorchScheduler (built by load_cluster_view from a JaxScheduler's arrays)
must agree with the JAX package: assignments bit-identical, availability
within atol=1e-3 (the tolerance of tests/test_sched_kernel.py's golden
test). The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py; tests that need the card are marked `cuda`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.sched import kernel_jax, kernel_np
from ray_tpu.sched.kernel_jax import JaxScheduler
from ray_tpu.sched.resources import NodeResourceState, ResourceSpace, pack_demands
from ray_tpu_torch.sched import kernel_torch as KT

R = 16


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def golden_problem():
    """tests/test_sched_kernel.py::test_np_jax_golden_equality's inputs."""
    rng = np.random.default_rng(42)
    N, C = 64, 7
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = st.available * rng.uniform(
        0.3, 1.0, size=st.available.shape).astype(np.float32)
    st.available = np.floor(st.available)
    demand_maps = []
    for _ in range(C):
        d = {"CPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            d["TPU"] = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            d["memory"] = float(rng.integers(1, 8))
        demand_maps.append(d)
    demands = pack_demands(space, demand_maps)
    counts = rng.integers(1, 200, size=C).astype(np.int32)
    return st.available, st.total, st.alive, demands, counts


def random_problem(seed, N=64, C=16):
    """Dead nodes, a masked custom resource (column 5 on ~10% of nodes),
    over-subscribed classes, fragmented availability."""
    rng = np.random.default_rng(seed)
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(1, 33, N)
    total[:, 3] = rng.integers(4, 129, N)
    total[:, 5] = np.where(rng.random(N) < 0.1, rng.integers(1, 5, N), 0)
    alive = rng.random(N) > 0.15
    avail = np.floor(total * rng.uniform(0.0, 1.0, total.shape)).astype(np.float32)
    avail *= alive[:, None]
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    demands[:, 3] = np.where(rng.random(C) < 0.5, rng.integers(1, 9, C), 0)
    demands[:, 5] = np.where(rng.random(C) < 0.2, 1, 0)
    counts = rng.integers(0, 300, C).astype(np.int32)
    return avail, total, alive, demands, counts


def _run_all(avail, total, alive, demands, counts):
    np_a, np_v = kernel_np.schedule_classes(avail, total, alive, demands, counts)
    jx_a, jx_v = kernel_jax.schedule_classes(
        jnp.asarray(avail), jnp.asarray(total), jnp.asarray(alive),
        jnp.asarray(demands), jnp.asarray(counts),
    )
    th_a, th_v = KT.schedule_classes(T(avail), T(total), T(alive), T(demands), T(counts))
    return (np_a, np_v), (np.asarray(jx_a), np.asarray(jx_v)), (th_a.numpy(), th_v.numpy())


def test_k1_golden_equals_jax_and_numpy():
    (np_a, np_v), (jx_a, jx_v), (th_a, th_v) = _run_all(*golden_problem())
    assert th_a.dtype == np.int32 and th_v.dtype == np.float32
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_a, jx_a)
    np.testing.assert_allclose(th_v, np_v, atol=1e-3)
    np.testing.assert_allclose(th_v, jx_v, atol=1e-3)
    assert th_a.sum() > 0


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_k1_random_problems_equal_jax_and_numpy(seed):
    avail, total, alive, demands, counts = random_problem(seed)
    (np_a, np_v), (jx_a, jx_v), (th_a, th_v) = _run_all(
        avail, total, alive, demands, counts
    )
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_a, jx_a)
    np.testing.assert_allclose(th_v, np_v, atol=1e-3)
    np.testing.assert_allclose(th_v, jx_v, atol=1e-3)
    # dead nodes never receive tasks; over-subscribed classes stay partial
    assert th_a[:, ~alive].sum() == 0
    assert (th_a.sum(axis=1) <= counts).all()


def test_k1_padded_matches_unpadded():
    avail, total, alive, demands, counts = golden_problem()
    d, k = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    assert d.shape[0] == 16
    a_pad, v_pad = KT.schedule_classes(T(avail), T(total), T(alive), T(d), T(k))
    a, v = KT.schedule_classes(T(avail), T(total), T(alive), T(demands), T(counts))
    np.testing.assert_array_equal(a_pad[: len(demands)].numpy(), a.numpy())
    assert int(a_pad[len(demands):].sum()) == 0
    np.testing.assert_array_equal(v_pad.numpy(), v.numpy())


def test_k1_does_not_modify_input_and_counts_no_cpu_launch():
    avail, total, alive, demands, counts = golden_problem()
    t_avail = T(avail.copy())
    before = KT.launch_counts()
    KT.schedule_classes(t_avail, T(total), T(alive), T(demands), T(counts))
    np.testing.assert_array_equal(t_avail.numpy(), avail)
    # the CPU path runs the plain version: no kernel launched
    assert KT.launch_counts() == before


def test_k2_scatter_rows_equals_jax_with_pad_index():
    rng = np.random.default_rng(0)
    N = 300
    avail = rng.integers(0, 100, (N, R)).astype(np.float32)
    for n, pad in ((1, 16), (16, 16), (17, 64), (200, 256)):
        idx = np.full(pad, N, np.int32)  # N = one past the end: dropped
        idx[:n] = rng.choice(N, n, replace=False)
        rows = rng.integers(0, 50, (pad, R)).astype(np.float32)
        want = np.asarray(kernel_jax._scatter_rows(
            jnp.asarray(avail), jnp.asarray(idx), jnp.asarray(rows)))
        got = KT.scatter_rows_(T(avail.copy()), T(idx), T(rows)).numpy()
        np.testing.assert_array_equal(got, want)


def test_k3_delta_clip_equals_jnp_clip():
    rng = np.random.default_rng(1)
    total = rng.integers(0, 64, (128, R)).astype(np.float32)
    avail = np.floor(total * rng.uniform(0, 1, total.shape)).astype(np.float32)
    delta = rng.integers(-40, 40, total.shape).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.asarray(avail) + jnp.asarray(delta), 0.0,
                               jnp.asarray(total)))
    got = KT.delta_clip(T(avail), T(delta), T(total)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "cap,dtypes",
    [
        (1024, (torch.int16, torch.int16, torch.uint8)),
        (1024, (torch.int32, torch.int32, torch.int32)),
        (40, (torch.int16, torch.int32, torch.uint8)),  # nnz > cap: truncated
    ],
)
def test_k4_compact_nonzero_equals_jnp_nonzero(cap, dtypes):
    rng = np.random.default_rng(2)
    C, N = 16, 96
    out = np.where(rng.random((C, N)) < 0.08, rng.integers(1, 200, (C, N)), 0)
    out = out.astype(np.int32)
    out[0, 0] = 7  # padding slots replicate cell (0, 0) and this value
    ci, ni = jnp.nonzero(jnp.asarray(out), size=cap, fill_value=0)
    vals = jnp.asarray(out)[ci, ni]
    got = KT.compact_nonzero(T(out), cap, *dtypes)
    for g, w, dt in zip(got, (ci, ni, vals), dtypes):
        assert g.dtype == dt and g.shape == (cap,)
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _jax_and_torch_views(N, seed):
    rng = np.random.default_rng(seed)
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(4, 33, N)
    total[:, 3] = rng.integers(16, 129, N)
    alive = rng.random(N) > 0.05
    js = JaxScheduler(total, alive)
    ts = KT.load_cluster_view(
        np.asarray(js.total), np.asarray(js.alive), np.asarray(js.avail),
        device="cpu",
    )
    return rng, js, ts


def _class_problem(rng, C, max_count):
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 4, C)
    demands[:, 3] = np.where(rng.random(C) < 0.4, rng.integers(1, 8, C), 0)
    counts = rng.integers(0, max_count, C).astype(np.int32)
    return demands, counts


def test_torch_scheduler_schedule_equals_jax():
    rng, js, ts = _jax_and_torch_views(64, 3)
    for _ in range(3):  # state carries across rounds on both sides
        demands, counts = _class_problem(rng, 7, 60)
        np.testing.assert_array_equal(ts.schedule(demands, counts),
                                      js.schedule(demands, counts))
        np.testing.assert_allclose(ts.avail.numpy(), np.asarray(js.avail), atol=1e-3)


@pytest.mark.parametrize("N,max_count", [(512, 60), (64, 60), (64, 400)])
def test_torch_scheduler_async_fetch_equals_jax(N, max_count):
    """N=512: the sparse (COO) download; N=64: the dense one, uint8 and
    int16 narrowed."""
    rng, js, ts = _jax_and_torch_views(N, 4)
    demands, counts = _class_problem(rng, 12, max_count)
    hj = js.schedule_async(demands, counts)
    ht = ts.schedule_async(demands, counts)
    assert ("sparse" in ht) == ("sparse" in hj)
    assert ("sparse" in ht) == (N == 512)
    a = ts.fetch(ht)
    np.testing.assert_array_equal(a, js.fetch(hj))
    np.testing.assert_array_equal(ts.fetch(ht), a)  # fetch is idempotent
    assert a.dtype == np.int32 and a.sum() > 0


def test_torch_scheduler_update_rows_and_delta_equal_jax():
    """Scatter-row refresh across the 16/64/256 buckets and the n >= N
    full upload (mirrors test_jax_policy_gcs::test_update_rows_matches_set_
    available), then a delta."""
    rng = np.random.default_rng(0)
    N = 300
    total = rng.integers(1, 100, (N, R)).astype(np.float32)
    alive = np.ones(N, bool)
    js = JaxScheduler(total, alive)
    ts = KT.load_cluster_view(total, alive, total, device="cpu")
    avail = total.copy()
    for n_dirty in (1, 15, 16, 17, 200, 300):
        idx = sorted(rng.choice(N, n_dirty, replace=False))
        avail[idx] = rng.integers(0, 50, (n_dirty, R)).astype(np.float32)
        js.update_rows(idx, avail[idx])
        ts.update_rows(idx, avail[idx])
        np.testing.assert_array_equal(ts.avail.numpy(), np.asarray(js.avail))
        np.testing.assert_array_equal(ts.avail.numpy(), avail)
    delta = rng.integers(-60, 60, (N, R)).astype(np.float32)
    js.apply_delta(delta)
    ts.apply_delta(delta)
    np.testing.assert_array_equal(ts.avail.numpy(), np.asarray(js.avail))


def test_torch_scheduler_unported_algos_raise():
    """Every scheduler_kernel_algo has its kernel now (scan K1, rounds K5,
    chunked K6); a name with no kernel raises instead of quietly running
    another algorithm."""
    ts = KT.TorchScheduler(np.ones((4, R), np.float32), np.ones(4, bool), device="cpu")
    demands = np.zeros((1, R), np.float32)
    demands[0, 0] = 1
    for algo in KT.ALGOS:
        assert ts.schedule(demands, np.array([1], np.int32), algo=algo).sum() == 1
    for algo in ("sharded", "classes"):
        with pytest.raises(ValueError, match="scheduler_kernel_algo"):
            ts.schedule(demands, np.array([1], np.int32), algo=algo)


def test_negative_availability_round_that_places_nothing():
    """Pins ROADMAP queue 3's first fault: on a view with a negative entry
    and a round that places nothing, kernel_jax clamps the view at 0 (its
    _one_class applies max(avail - take*d, 0) in every executed pass) while
    kernel_np breaks before its update and keeps the negative value. The
    decisions agree; the port follows kernel_np, the stated authority."""
    N = 8
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 4.0
    total[:, 3] = 16.0
    alive = np.ones(N, bool)
    avail = total.copy()
    avail[:, 0] = 0.0  # no CPU anywhere: nothing can place
    avail[2, 3] = -3.0  # over-released memory (reacquire after get)
    demands = np.zeros((2, R), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 2.0
    demands[1, 3] = 1.0
    counts = np.array([5, 3], np.int32)
    (np_a, np_v), (jx_a, jx_v), (th_a, th_v) = _run_all(avail, total, alive, demands, counts)
    assert np_a.sum() == 0
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_a, jx_a)
    np.testing.assert_array_equal(th_v, np_v)
    assert th_v[2, 3] == -3.0
    assert jx_v[2, 3] != np_v[2, 3]  # the divergence the port does not follow


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        KT.TorchScheduler(np.ones((4, R), np.float32), np.ones(4, bool))
    with pytest.raises(RuntimeError, match="is_available"):
        KT.resolve_device("cuda")
    assert KT.resolve_device("cpu").type == "cpu"


def test_wrappers_raise_on_mixed_devices():
    a = torch.zeros((4, R))
    with pytest.raises(ValueError):
        KT.delta_clip(a, a, a.to("meta"))


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_on_card():
    """On the card: each kernel against its plain version (exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    avail, total, alive, demands, counts = random_problem(5, N=1024, C=32)
    args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
    a_k, v_k = KT.schedule_classes(*args)
    a_p, v_p = KT._schedule_classes_plain(*args)
    assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p)
    delta = T(np.full_like(avail, -1.0)).to(dev)
    assert torch.equal(KT.delta_clip(args[0], delta, args[1]),
                       KT._delta_clip_plain(args[0], delta, args[1]))
    idx = T(np.array([3, 1024, 7], np.int32)).to(dev)
    rows = T(np.ones((3, R), np.float32)).to(dev)
    assert torch.equal(KT.scatter_rows_(args[0].clone(), idx, rows),
                       KT._scatter_rows_plain_(args[0].clone(), idx, rows))
    for x, y in zip(KT.compact_nonzero(a_k, 1024), KT._compact_nonzero_plain(
            a_k, 1024, torch.int32, torch.int32, torch.int32)):
        assert torch.equal(x, y)
