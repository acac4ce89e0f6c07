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


K4_DTYPE_SETS = [
    (torch.int16, torch.int16, torch.uint8),
    (torch.int32, torch.int16, torch.int32),
    (torch.int16, torch.int32, torch.uint8),
    (torch.int32, torch.int32, torch.int32),
]
K4_CASES = ["zeros", "nnz_eq_cap", "nnz_cap_plus_1", "last_block_only", "corner_zero",
            "corner_nonzero"]


def k4_case(name, C, N, seed=3):
    """An assignment [C, N] and a cap for one of K4's edges: no nonzero;
    exactly cap nonzeros; cap + 1 (the last one cut); nonzeros only in the
    last 100 cells (the last block's range); out[0, 0] zero or not (the
    padding's value). Values below 256, so every value width holds them."""
    rng = np.random.default_rng(seed)
    out = np.where(rng.random((C, N)) < 0.05, rng.integers(1, 256, (C, N)), 0).astype(np.int32)
    nnz = int((out != 0).sum())
    cap = nnz + 64
    if name == "zeros":
        out[:] = 0
    elif name == "nnz_eq_cap":
        cap = nnz
    elif name == "nnz_cap_plus_1":
        cap = nnz - 1
    elif name == "last_block_only":
        flat = out.reshape(-1)
        flat[:-100] = 0
        flat[-100::3] = rng.integers(1, 256, len(flat[-100::3]))
        cap = int((flat != 0).sum()) + 7
    out[0, 0] = 0 if name == "corner_zero" else (out[0, 0] if name != "corner_nonzero" else 5)
    return out, cap


def k4_numpy(out, cap):
    """np.nonzero's order, cut at cap, padded with cell (0, 0) and its value."""
    ci, ni = np.nonzero(out)
    ci, ni = ci[:cap], ni[:cap]
    pad = cap - len(ci)
    ci = np.concatenate([ci, np.zeros(pad, np.int64)])
    ni = np.concatenate([ni, np.zeros(pad, np.int64)])
    return ci, ni, out[ci, ni]


@pytest.mark.parametrize("dtypes", K4_DTYPE_SETS, ids=lambda d: "-".join(str(t)[6:] for t in d))
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_edges_equal_jnp_nonzero_and_numpy(case, dtypes):
    """The plain K4 at its edges, M = 7 x 301 (not a multiple of 4), slot
    for slot equal to jnp.nonzero(size=cap, fill_value=0) and np.nonzero's
    order."""
    out, cap = k4_case(case, 7, 301)
    ci, ni = jnp.nonzero(jnp.asarray(out), size=cap, fill_value=0)
    want = (np.asarray(ci), np.asarray(ni), np.asarray(jnp.asarray(out)[ci, ni]))
    got = KT.compact_nonzero(T(out), cap, *dtypes)
    for g, w, n, dt in zip(got, want, k4_numpy(out, cap), dtypes):
        assert g.dtype == dt and g.shape == (cap,)
        np.testing.assert_array_equal(g.numpy().astype(np.int64), w.astype(np.int64))
        np.testing.assert_array_equal(g.numpy().astype(np.int64), n.astype(np.int64))


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


# ------------------------------------------- K2 / K3: the view's refresh


REFRESH_PADS = (16, 64, 256, 1024, 4096)


@pytest.mark.parametrize("pad", REFRESH_PADS)
def test_refresh_rows_mode_equals_jax_scatter(pad):
    """K2's plain version (refresh_view_kernel's rows mode) at every row
    bucket, the padding index N dropped and the first and last node among
    the rows: bit-equal to kernel_jax._scatter_rows, in place."""
    rng = np.random.default_rng(pad)
    N = 5000
    avail = rng.integers(-3, 100, (N, R)).astype(np.float32)
    n = pad - pad // 4
    idx = np.full(pad, N, np.int32)
    idx[:n] = rng.permutation(np.concatenate([  # distinct, the first and last node among them
        [0, N - 1], rng.choice(np.arange(1, N - 1), n - 2, replace=False)]))
    rows = rng.integers(0, 50, (pad, R)).astype(np.float32)
    want = np.asarray(kernel_jax._scatter_rows(jnp.asarray(avail), jnp.asarray(idx),
                                               jnp.asarray(rows)))
    t_avail = T(avail.copy())
    assert KT.scatter_rows_(t_avail, T(idx), T(rows)) is t_avail
    np.testing.assert_array_equal(t_avail.numpy(), want)


@pytest.mark.parametrize("shape", [(128, R), (1000, 1), (777, 5)])
def test_refresh_delta_mode_clips_every_entry_as_jnp_clip(shape):
    """K3's plain version (refresh_view_kernel's delta mode): jnp.clip(avail
    + delta, 0, total) bit for bit, negative entries clipped to 0 where the
    delta is 0 (a view from set_available may hold them); a new tensor,
    avail untouched."""
    rng = np.random.default_rng(shape[0])
    total = rng.integers(0, 64, shape).astype(np.float32)
    avail = np.floor(total * rng.uniform(-0.5, 1.2, shape)).astype(np.float32)
    delta = rng.integers(-40, 40, shape).astype(np.float32)
    delta[rng.random(shape) < 0.3] = 0.0
    assert ((avail < 0) & (delta == 0)).any()
    want = np.asarray(jnp.clip(jnp.asarray(avail) + jnp.asarray(delta), 0.0,
                               jnp.asarray(total)))
    t_avail = T(avail.copy())
    np.testing.assert_array_equal(KT.delta_clip(t_avail, T(delta), T(total)).numpy(), want)
    np.testing.assert_array_equal(t_avail.numpy(), avail)
    assert (want >= 0).all() and (want <= total).all()


def test_round_view_is_avail_itself_only_in_place():
    """The view a round writes: avail itself where the caller lets the round
    work in place (TorchScheduler), else a copy; a view that is not
    contiguous float32 is always a new tensor."""
    a = T(np.arange(12, dtype=np.float32).reshape(4, 3))
    assert KT._round_view(a, True) is a
    copy = KT._round_view(a, False)
    assert copy.data_ptr() != a.data_ptr() and torch.equal(copy, a)
    for other in (a.t(), a.to(torch.float64)):
        view = KT._round_view(other, True)
        assert view.dtype == torch.float32 and view.is_contiguous()
        assert view.data_ptr() != a.data_ptr() and torch.equal(view, other.to(torch.float32))


def _apply(ops, sched, N, rng_seed):
    """Run one refresh sequence (REFRESH_SEQUENCES) on `sched`, a
    JaxScheduler or a TorchScheduler: the same seeded updates on both.
    Returns the views read in the middle (the "read" step)."""
    rng = np.random.default_rng(rng_seed)
    total = _host(sched.total)
    reads = []
    for op in ops:
        if op == "rows":
            idx = sorted(rng.choice(N, 20, replace=False))
            sched.update_rows(idx, rng.integers(0, 30, (20, R)).astype(np.float32))
        elif op == "rows_all":  # n >= N: the full upload
            sched.update_rows(list(range(N)) + [0], rng.integers(0, 30, (N + 1, R)).astype(
                np.float32))
        elif op == "delta":
            delta = rng.integers(-20, 20, (N, R)).astype(np.float32)
            delta[rng.random((N, R)) < 0.5] = 0.0
            sched.apply_delta(delta)
        elif op == "set":
            sched.set_available(np.floor(total * rng.uniform(0, 1, total.shape)).astype(
                np.float32))
        elif op == "read":
            reads.append(_host(sched.avail))
    return reads


def _host(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


REFRESH_SEQUENCES = {
    "rows": ("rows",),
    "delta": ("delta",),
    "rows_delta": ("rows", "delta"),
    "delta_delta": ("delta", "delta"),
    "delta_set": ("delta", "set"),
    "delta_read": ("delta", "read"),
    "rows_all": ("delta", "rows_all"),
}


REFRESHES = ("rows", "delta")


def expected_refreshes(ops, algo):
    """The launches the refreshes of `ops` (REFRESH_SEQUENCES' steps) cost,
    then a round of `algo`: {"standalone": {"rows": n, "delta": n}, "fused":
    {...}} before the round (key "before") and after it ("after"), and the
    refresh left pending before the round ("pending", a mode or None). A
    refresh waits; a second refresh or a read applies it alone,
    set_available (and the whole-view update_rows) drops it; a scan round
    applies it in K1's launch."""
    count = {"standalone": dict.fromkeys(REFRESHES, 0), "fused": dict.fromkeys(REFRESHES, 0)}
    pending = None
    for op in ops:
        if op in REFRESHES or op == "read":
            if pending:
                count["standalone"][pending] += 1
            pending = op if op in REFRESHES else None
        elif op in ("set", "rows_all"):
            pending = None
    before = {k: dict(v) for k, v in count.items()}
    if pending:
        count["fused" if algo == "scan" else "standalone"][pending] += 1
    return {"before": before, "after": count, "pending": pending}


def refresh_counts():
    """The launch counters of K2 and K3 by form, from KT.launch_counts()."""
    c = KT.launch_counts()
    fused = {"rows": c["scatter_rows_fused"], "delta": c["delta_clip_fused"]}
    return {"standalone": {"rows": c["scatter_rows"] - fused["rows"],
                           "delta": c["delta_clip"] - fused["delta"]},
            "fused": fused}


def _refresh_sequence_views(N, seed):
    """A JaxScheduler and a TorchScheduler (CPU) on one seeded view with
    negative entries (over-released resources), as set_available leaves
    them."""
    rng, js, ts = _jax_and_torch_views(N, seed)
    avail = np.floor(np.asarray(js.total) * rng.uniform(0, 1, (N, R))).astype(np.float32)
    avail[rng.random((N, R)) < 0.05] = -2.0
    js.set_available(avail)
    ts.set_available(avail)
    return rng, js, ts


@pytest.mark.parametrize("algo", KT.ALGOS)
@pytest.mark.parametrize("call", ["schedule", "schedule_async"])
@pytest.mark.parametrize("seq", sorted(REFRESH_SEQUENCES))
def test_torch_scheduler_refresh_sequences_equal_jax(seq, call, algo):
    """Each refresh sequence, then a round (schedule, or schedule_async and
    fetch) and a second round: TorchScheduler on the CPU gives
    JaxScheduler's decisions and avail (the refreshes and a read of avail
    bit for bit, a round's avail within 1e-3 as elsewhere)."""
    N = 96
    rng, js, ts = _refresh_sequence_views(N, 11)
    ops = REFRESH_SEQUENCES[seq]
    reads_j = _apply(ops, js, N, 5)
    reads_t = _apply(ops, ts, N, 5)
    for a, b in zip(reads_t, reads_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_host(ts.avail), np.asarray(js.avail))
    for _ in range(2):
        demands, counts = _class_problem(rng, 9, 40)
        if call == "schedule":
            got = ts.schedule(demands, counts, algo=algo)
            want = js.schedule(demands, counts, algo=algo)
        else:
            got = ts.fetch(ts.schedule_async(demands, counts, algo=algo))
            want = js.fetch(js.schedule_async(demands, counts, algo=algo))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(ts.avail.numpy(), np.asarray(js.avail), atol=1e-3)
    assert got.sum() > 0


def test_torch_scheduler_refresh_is_uploaded_at_call_time():
    """update_rows and apply_delta copy their operands when called: the
    caller's arrays may be reused at once."""
    N = 64
    rng, js, ts = _refresh_sequence_views(N, 12)
    delta = rng.integers(-5, 5, (N, R)).astype(np.float32)
    idx = np.arange(0, N, 7)
    rows = rng.integers(0, 9, (len(idx), R)).astype(np.float32)
    for s in (js, ts):
        s.update_rows(idx, rows)
        s.apply_delta(delta)
    rows[:] = -99.0
    delta[:] = 1e6
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


@pytest.mark.cuda
def test_cuda_k4_one_launch_edges_equal_plain_and_numpy():
    """On the card: K4, one cooperative launch a call, slot for slot equal
    to its plain version and to np.nonzero's order at every edge and dtype
    set, at [37, 1001] (M not a multiple of a chunk or of 4), the stream's
    [256, 10 000] (the register form) and [256, 40 000] (the looped form,
    which reads its chunks twice); two calls give the same bits, as do two
    hundred calls in a row on one stream's block counts, and a call on a
    second stream, which gets counts of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    forms = set()
    for C, N in ((37, 1001), (256, 10_000), (256, 40_000)):
        blocks, per, looped = KT.k4_launch_plan(C * N, dev)
        forms.add(looped)
        assert blocks * per * 4096 >= C * N > (blocks * per - per) * 4096 or blocks == 1
        for case in K4_CASES:
            out, cap = k4_case(case, C, N)
            x = T(out).to(dev)
            want = k4_numpy(out, cap)
            for dts in K4_DTYPE_SETS:
                before = KT.compact_nonzero.launches
                got = KT.compact_nonzero(x, cap, *dts)
                assert KT.compact_nonzero.launches == before + 1
                for g, p, n in zip(got, KT._compact_nonzero_plain(x, cap, *dts), want):
                    assert torch.equal(g, p), (C, N, case, dts)
                    g = g.cpu().numpy()  # int16 wraps past 32 767, as numpy's cast does
                    np.testing.assert_array_equal(g, n.astype(g.dtype))
                again = KT.compact_nonzero(x, cap, *dts)
                assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert forms == {False, True}
    out, cap = k4_case("corner_nonzero", 256, 10_000)
    x = T(out).to(dev)
    first = KT.compact_nonzero(x, cap, *K4_DTYPE_SETS[0])
    for _ in range(200):
        got = KT.compact_nonzero(x, cap, *K4_DTYPE_SETS[0])
        assert all(torch.equal(a, b) for a, b in zip(first, got))
    # a second stream has block counts of its own
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = KT.compact_nonzero(x, cap, *K4_DTYPE_SETS[0])
    side.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, got))
    assert (x.device.index, side.cuda_stream) in KT._k4_scratch
    # a view 4 bytes past an aligned start: copied to an aligned buffer first
    view = T(np.concatenate([[0], out.reshape(-1)]).astype(np.int32)).to(dev)[1:]
    got = KT.compact_nonzero(view.view(256, 10_000), cap, *K4_DTYPE_SETS[0])
    assert all(torch.equal(a, b) for a, b in zip(first, got))
    torch.cuda.synchronize()


# ------------------------------------------------------- K1's cluster layout


def test_k1_plan_pads_nodes_to_the_cluster_and_picks_the_row_form():
    """K1's host-side layout (k1_plan, the mirror of the source's): N padded
    up to a multiple of the cluster size with dead nodes, the rows and the
    per-node state in shared memory while a block's share fits, else the
    rows in global memory with a global scratch of the per-node state."""
    p = KT.k1_plan(10_000, R, 16)
    assert p == KT.K1Plan(16, 625, True, 88_752, 0)  # 8*16*625 + 14*625, 16-aligned
    assert p.smem_bytes == KT.k1_block_bytes(625, R, True)
    p = KT.k1_plan(10_007, R, 16)  # not a multiple of 16: 15 full blocks, one of 617
    assert p.nodes_per_block == 626 and 15 * 626 < 10_007 <= 16 * 626
    assert p.rows_in_smem and p.smem_bytes == (8 * R * 627 + 14 * 626 + 15) // 16 * 16
    p = KT.k1_plan(40_000, R, 16)  # past the shared-memory form
    assert p == KT.K1Plan(16, 2500, False, 0, 16 * 35_008 // 4)
    assert KT.k1_plan(40_000, R, 8).scratch_words == 8 * 70_000 // 4
    assert KT.k1_plan(3000, 5, 16) == KT.K1Plan(16, 188, True, 10_192, 0)  # stride 189
    assert KT.k1_plan(1, R, 16) == KT.K1Plan(16, 1, True, 144, 0)
    # the form's edge near 24k nodes at R = 16 and a 16-block cluster
    edge = max(n for n in range(20_000, 30_000, 16) if KT.k1_plan(n, R, 16).rows_in_smem)
    assert 23_000 < edge < 25_000
    assert not KT.k1_plan(edge + 16, R, 16).rows_in_smem
    for n, c in ((10_000, 8), (64, 16), (17, 16), (24_001, 8)):
        p = KT.k1_plan(n, R, c)
        assert p.cluster == c and p.nodes_per_block * c >= n > (p.nodes_per_block - 1) * c
        assert p.smem_bytes <= KT.K1_SMEM_BUDGET and p.smem_bytes % 16 == 0
        assert (p.scratch_words == 0) == p.rows_in_smem
    assert KT.K1_CLUSTER_SIZES == (16, 8)


def narrow_problem(seed, N=3000, C=24, n_res=5):
    """random_problem's kind over R = 5 columns (K1's generic column path)."""
    rng = np.random.default_rng(seed)
    total = np.zeros((N, n_res), np.float32)
    total[:, 0] = rng.integers(1, 65, N)
    total[:, 2] = rng.integers(4, 257, N)
    total[:, 4] = np.where(rng.random(N) < 0.2, rng.integers(1, 9, N), 0)
    alive = rng.random(N) > 0.05
    avail = np.floor(total * rng.uniform(0.0, 1.0, total.shape)).astype(np.float32)
    avail *= alive[:, None]
    demands = np.zeros((C, n_res), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    demands[:, 2] = np.where(rng.random(C) < 0.5, rng.integers(1, 9, C), 0)
    demands[:, 4] = np.where(rng.random(C) < 0.2, 1, 0)
    counts = rng.integers(0, 3000, C).astype(np.int32)
    return avail, total, alive, demands, counts


def saturation_problem(N=1000):
    """Counts near 2**23 - 1 over nodes of 2**21 CPUs: a bucket's prefix
    passes 2**23 inside the cluster."""
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 2.0 ** 21
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[5::97] = False
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = [1.0, 1.0, 2.0, 1.0]
    counts = np.array([2**23 - 1, 2**23 - 7, 3_000_000, 2**23 - 1], np.int32)
    return (total * alive[:, None]).astype(np.float32), total, alive, demands, counts


def negative_problem():
    """test_negative_availability_round_that_places_nothing's inputs."""
    N = 8
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 4.0
    total[:, 3] = 16.0
    avail = total.copy()
    avail[:, 0] = 0.0
    avail[2, 3] = -3.0
    demands = np.zeros((2, R), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 2.0
    demands[1, 3] = 1.0
    return avail, total, np.ones(N, bool), demands, np.array([5, 3], np.int32)


@pytest.mark.parametrize("name", ["r5", "saturation"])
def test_k1_edge_problems_plain_equals_numpy(name):
    """The plain K1 on the edge problems the card also runs: R = 5 and
    counts near 2**23 (prefixes past 2**23), bit-identical to kernel_np."""
    avail, total, alive, demands, counts = (
        narrow_problem(13, N=600) if name == "r5" else saturation_problem(200))
    np_a, np_v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
    th_a, th_v = KT.schedule_classes(T(avail), T(total), T(alive), T(demands), T(counts))
    np.testing.assert_array_equal(th_a.numpy(), np_a)
    np.testing.assert_array_equal(th_v.numpy(), np_v)
    assert np_a.sum() > 0
    if name == "saturation":
        assert (np_a.sum(axis=1) > 2**23 - 2**21).any()


@pytest.mark.cuda
def test_cuda_k1_cluster_edges_equal_plain_and_numpy():
    """On the card: K1 (one thread-block cluster) against its plain version
    and kernel_np, exactly, with N not a multiple of the cluster, the rows in
    global memory (N = 40 000), R = 5, counts near 2**23 and a round that
    places nothing over a negative entry; a second launch gives the same
    bits, and the source's layout agrees with k1_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    from ray_tpu_torch.sched import _build

    dev = torch.device("cuda")
    lib = _build.load()
    problems = [random_problem(21, N=10_007, C=48), random_problem(22, N=40_000, C=24),
                narrow_problem(13), saturation_problem(), negative_problem()]
    forms = set()
    for avail, total, alive, demands, counts in problems:
        args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
        a_k, v_k = KT.schedule_classes(*args)
        N, n_res = total.shape
        plan = KT.k1_launch_plan(N, n_res, dev)
        forms.add(plan.rows_in_smem)
        assert plan.cluster in KT.K1_CLUSTER_SIZES and plan == KT.k1_plan(N, n_res, plan.cluster)
        assert lib.sched_k1_scratch_words(N, n_res, plan.cluster) == plan.scratch_words
        again = KT.schedule_classes(*args)
        assert torch.equal(a_k, again[0]) and torch.equal(v_k, again[1])
        a_p, v_p = KT._schedule_classes_plain(*args)
        assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p), N
        np_a, np_v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        np.testing.assert_array_equal(a_k.cpu().numpy(), np_a)
        np.testing.assert_array_equal(v_k.cpu().numpy(), np_v)
    assert forms == {True, False}
    torch.cuda.synchronize()


# ------------------------------------------- K2 / K3 on the card


@pytest.mark.cuda
def test_cuda_refresh_view_every_mode_equals_plain():
    """On the card: refresh_view_kernel bit-equal (torch.equal) to its plain
    version in both modes, rows (scatter_rows_, in place) at every row
    bucket with the first and last node among the rows and indices -1 and
    N + 5 dropped, delta (delta_clip, a new tensor) over negative entries,
    at N not a multiple of a block and past the delta grid's cap (a grid
    stride), R = 1, 5 and 16; each mode counts its launches as K2's or
    K3's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    for N, n_res in ((10_000, R), (10_007, R), (40_003, R), (777, 5), (1000, 1), (3, R)):
        rng = np.random.default_rng(N + n_res)
        total = rng.integers(0, 64, (N, n_res)).astype(np.float32)
        avail = np.floor(total * rng.uniform(-0.5, 1.2, (N, n_res))).astype(np.float32)
        a = T(avail).to(dev)
        KT.reset_launch_counts()
        delta = rng.integers(-40, 40, (N, n_res)).astype(np.float32)
        delta[rng.random((N, n_res)) < 0.3] = 0.0
        d, t = T(delta).to(dev), T(total).to(dev)
        assert torch.equal(KT.delta_clip(a, d, t), KT._delta_clip_plain(a, d, t)), (N, n_res)
        for pad in REFRESH_PADS:
            n_in = min(pad - 2, N)
            idx = np.full(pad, N, np.int32)
            idx[:n_in] = rng.permutation(np.concatenate([
                [0, N - 1][:n_in], rng.choice(np.arange(1, N - 1), max(n_in - 2, 0),
                                              replace=False)]))
            idx[n_in:n_in + 2] = (-1, N + 5)
            rows = T(rng.integers(0, 50, (pad, n_res)).astype(np.float32)).to(dev)
            ti = T(idx).to(dev)
            b = a.clone()
            assert KT.scatter_rows_(b, ti, rows) is b
            assert torch.equal(b, KT._scatter_rows_plain_(a.clone(), ti, rows)), (N, pad)
        assert torch.equal(a, T(avail).to(dev))  # delta_clip left avail alone
        counts = KT.launch_counts()
        assert (counts["scatter_rows"], counts["delta_clip"]) == (len(REFRESH_PADS), 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", KT.ALGOS)
def test_cuda_refresh_sequences_equal_cpu(algo):
    """On the card: each refresh sequence and two rounds (schedule, or
    schedule_async and fetch) give the CPU TorchScheduler's decisions and
    avail bit for bit; each refresh is one launch of its mode, counted by
    form (expected_refreshes): alone where a later refresh or a read
    applied it or the algorithm is not scan, in K1's launch where a scan
    round did, none where set_available dropped it; the view is one tensor
    throughout (rounds and refreshes write it in place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    N = 4000
    for seq in sorted(REFRESH_SEQUENCES):
        ops = REFRESH_SEQUENCES[seq]
        want_counts = expected_refreshes(ops, algo)
        for call in ("schedule", "schedule_async"):
            rng, _, cpu = _refresh_sequence_views(N, 11)
            card = KT.load_cluster_view(cpu.total.numpy(), cpu.alive.numpy(),
                                        cpu.avail.numpy(), device="cuda")
            KT.reset_launch_counts()
            for a, b in zip(_apply(ops, card, N, 5), _apply(ops, cpu, N, 5)):
                np.testing.assert_array_equal(a, b)
            assert refresh_counts() == want_counts["before"], (seq, KT.launch_counts())
            view = card._view
            for _ in range(2):
                demands, counts = _class_problem(rng, 9, 400)
                if call == "schedule":
                    got = card.schedule(demands, counts, algo=algo)
                    want = cpu.schedule(demands, counts, algo=algo)
                else:
                    got = card.fetch(card.schedule_async(demands, counts, algo=algo))
                    want = cpu.fetch(cpu.schedule_async(demands, counts, algo=algo))
                np.testing.assert_array_equal(got, want)
                assert card._view is view, (seq, call)
            assert refresh_counts() == want_counts["after"], (seq, call, KT.launch_counts())
            assert torch.equal(card.avail.cpu(), cpu.avail), (seq, call)
    torch.cuda.synchronize()
