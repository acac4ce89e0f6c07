"""The view's pending refresh: TorchScheduler holds a pushed refresh (K2's
dirty rows or K3's delta) until the next scan round applies it in K1's own
launch, or a second refresh, a read of `avail`, the rounds and chunked
algorithms or a round that launches no K1 apply it by K2/K3 alone;
set_available drops it.

On the CPU the plain versions follow the same flow (K1's plain version
takes the same refresh operand and applies K2's or K3's plain version
first), held here against JaxScheduler and kernel_jax bit for bit and
against kernel_np. The `cuda` tests hold the fused K1 to its plain version
on the card, in both of K1's forms at both cluster sizes, K7 to K1, and the
counters to the path a refresh took.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.sched import kernel_jax, kernel_np
from ray_tpu_torch.sched import kernel_shard as KS, kernel_torch as KT
from test_torch_sched_kernel import (REFRESH_SEQUENCES, REFRESHES, _apply, _class_problem,
                                     _host, _refresh_sequence_views, expected_refreshes,
                                     random_problem, refresh_counts)

R = 16


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------- the flow against JaxScheduler


@pytest.mark.parametrize("read", [False, True], ids=["pending", "read_between"])
@pytest.mark.parametrize("algo", KT.ALGOS)
@pytest.mark.parametrize("call", ["schedule", "schedule_async"])
@pytest.mark.parametrize("seq", sorted(REFRESH_SEQUENCES))
def test_pending_refresh_flow_equals_jax(seq, call, algo, read):
    """Each refresh sequence, then two rounds: the pending refresh reaches
    the first round (`pending`: no read before it, so a scan round's K1
    applies it; the other algorithms apply it alone first) or is applied by
    a read of `avail` after every step (`read_between`, each read bit-equal
    to JaxScheduler's view). Decisions equal JaxScheduler's, the view
    within 1e-3 after a round as elsewhere; nothing is left pending."""
    N = 96
    rng, js, ts = _refresh_sequence_views(N, 11)
    ops = REFRESH_SEQUENCES[seq]
    if read:
        ops = tuple(x for op in ops for x in (op, "read"))
    reads_j = _apply(ops, js, N, 5)
    reads_t = _apply(ops, ts, N, 5)
    assert len(reads_t) == len(reads_j) == ops.count("read")
    for a, b in zip(reads_t, reads_j):
        np.testing.assert_array_equal(a, b)
    pending = expected_refreshes(ops, algo)["pending"]
    assert (None if ts._pending is None else ts._pending.mode) == pending, seq
    assert read or seq in ("delta_set", "delta_read", "rows_all") or pending
    for _ in range(2):
        demands, counts = _class_problem(rng, 9, 40)
        if call == "schedule":
            got = ts.schedule(demands, counts, algo=algo)
            want = js.schedule(demands, counts, algo=algo)
        else:
            got = ts.fetch(ts.schedule_async(demands, counts, algo=algo))
            want = js.fetch(js.schedule_async(demands, counts, algo=algo))
        np.testing.assert_array_equal(got, want)
        assert ts._pending is None
        np.testing.assert_allclose(ts.avail.numpy(), np.asarray(js.avail), atol=1e-3)
    assert got.sum() > 0


@pytest.mark.parametrize("first", REFRESHES)
def test_set_available_drops_the_pending_refresh(first):
    """set_available after a refresh supersedes it: the view is the
    uploaded one, bit for bit as JaxScheduler's, nothing pending."""
    N = 64
    rng, js, ts = _refresh_sequence_views(N, 13)
    for s in (js, ts):
        _apply((first,), s, N, 3)
    assert ts._pending is not None and ts._pending.mode == first
    fresh = np.floor(np.asarray(js.total) * rng.uniform(0, 1, (N, R))).astype(np.float32)
    js.set_available(fresh)
    ts.set_available(fresh)
    assert ts._pending is None
    np.testing.assert_array_equal(ts._view.numpy(), fresh)
    np.testing.assert_array_equal(_host(ts.avail), np.asarray(js.avail))


@pytest.mark.parametrize("second", REFRESHES)
@pytest.mark.parametrize("first", REFRESHES)
def test_second_refresh_applies_the_first(first, second):
    """Two refreshes in a row: the second applies the first to the view
    (K2/K3 alone) and waits itself; the view then holds JaxScheduler's after
    the first, and after the second once read."""
    N = 64
    rng, js, ts = _refresh_sequence_views(N, 14)
    _apply((first,), js, N, 4)
    after_first = np.asarray(js.avail).copy()
    _apply((second,), js, N, 6)
    _apply((first,), ts, N, 4)
    _apply((second,), ts, N, 6)
    assert ts._pending is not None and ts._pending.mode == second
    np.testing.assert_array_equal(ts._view.numpy(), after_first)
    np.testing.assert_array_equal(_host(ts.avail), np.asarray(js.avail))
    assert ts._pending is None


def test_update_rows_sends_one_buffer():
    """update_rows stages idx (padded with N) and the rows (padded with
    zeros) in one buffer: the pending refresh's idx and rows are views of
    one tensor, idx first."""
    N = 300
    ts = KT.TorchScheduler(np.ones((N, R), np.float32), np.ones(N, bool), device="cpu")
    idx = [5, 17, 299]
    rows = np.arange(3 * R, dtype=np.float32).reshape(3, R)
    ts.update_rows(idx, rows)
    ref = ts._pending
    assert ref.mode == "rows" and ref.idx.dtype == torch.int32 and ref.pad == 16
    assert ref.src.untyped_storage().data_ptr() == ref.idx.untyped_storage().data_ptr()
    assert ref.src.data_ptr() == ref.idx.data_ptr() + 16 * 4
    np.testing.assert_array_equal(ref.idx.numpy(), idx + [N] * 13)
    np.testing.assert_array_equal(ref.src.numpy()[:3], rows)
    assert not ref.src.numpy()[3:].any()


def test_round_that_launches_no_k1_applies_the_refresh():
    """A refresh passed to K1 where the round has no class or no node is
    applied all the same (on a card by K2/K3 alone): the returned view
    holds it."""
    N = 20
    total = np.full((N, R), 8.0, np.float32)
    view = T(total.copy())
    idx = T(np.array([3, N, 7], np.int32))
    rows = T(np.full((3, R), 2.0, np.float32))
    ref = KT.Refresh("rows", idx, rows)
    empty = T(np.zeros((0, R), np.float32)), T(np.zeros(0, np.int32))
    a, v = KT.schedule_classes(view, T(total), T(np.ones(N, bool)), *empty, _refresh=ref)
    assert a.shape == (0, N)
    want = total.copy()
    want[[3, 7]] = 2.0
    np.testing.assert_array_equal(v.numpy(), want)
    np.testing.assert_array_equal(view.numpy(), total)  # not in place: a copy


# ------------------------------------ K1's plain version with a refresh operand


def k1_edges(cluster):
    """K1's layout edges at R = 16 for `cluster` blocks (k1_plan): the most
    nodes whose block rows fit in shared memory (every block full), one
    node more (the rows in global memory, a short last block), and a short
    last block below the edge."""
    edge = max(n for n in range(cluster, 40_000, cluster)
               if KT.k1_plan(n, R, cluster).rows_in_smem)
    assert not KT.k1_plan(edge + 1, R, cluster).rows_in_smem
    return {"rows_full": edge, "global_short": edge + 1, "rows_short": edge - 5}


def refresh_problem(N, mode, seed, C=8):
    """A round's problem over N nodes with negative entries in the view and
    a refresh: rows (1 000 dirty rows or fewer, the first and last node
    among them, in the last block's range too, padded with N and with
    indices outside the view, negative rows kept verbatim) or a delta of
    both signs, zero where entries are negative (clipped to 0 all the
    same)."""
    avail, total, alive, demands, counts = random_problem(seed, N=N, C=C)
    rng = np.random.default_rng(seed + 1)
    avail[rng.random(avail.shape) < 0.03] = -2.0
    if mode == "rows":
        n = min(1000, N - 2)
        pad = KT.bucket_size(n + 2)
        idx = np.full(pad, N, np.int32)
        idx[:n] = rng.permutation(np.concatenate([[0, N - 1], rng.choice(
            np.arange(1, N - 1), n - 2, replace=False)]))
        idx[n:n + 2] = (-1, N + 7)
        rows = rng.integers(0, 40, (pad, R)).astype(np.float32)
        rows[rng.random(rows.shape) < 0.02] = -1.0
        ref = ("rows", idx, rows)
    else:
        delta = rng.integers(-20, 20, (N, R)).astype(np.float32)
        delta[avail < 0] = 0.0
        ref = ("delta", None, delta)
    return (avail, total, alive, demands, counts), ref


def _refreshed_np(avail, total, ref):
    mode, idx, src = ref
    out = avail.copy()
    if mode == "rows":
        keep = (idx >= 0) & (idx < len(avail))
        out[idx[keep]] = src[keep]
        return out
    return np.clip(avail + src, 0.0, total)


def _refresh_t(ref, dev="cpu"):
    mode, idx, src = ref
    return KT.Refresh(mode, None if idx is None else T(idx).to(dev), T(src).to(dev))


@pytest.mark.parametrize("mode", REFRESHES)
@pytest.mark.parametrize("N", [17, 250, 1003])
def test_plain_k1_with_refresh_equals_refresh_then_k1(N, mode):
    """K1's plain version with a refresh operand equals K2's or K3's plain
    version followed by K1's, bit for bit; the refreshed view equals
    kernel_jax's _scatter_rows or jnp.clip, and the round kernel_np's on it.
    N = 17 leaves 7 of 16 blocks empty, 1 003 a short last block."""
    problem, ref = refresh_problem(N, mode, seed=N)
    avail, total, alive, demands, counts = problem
    args = [T(x) for x in problem]
    a_f, v_f = KT._schedule_classes_plain(*args, refresh=_refresh_t(ref))
    view = KT._refresh_plain(T(avail.copy()), T(total), _refresh_t(ref))
    a_s, v_s = KT._schedule_classes_plain(view, *args[1:])
    assert torch.equal(a_f, a_s) and torch.equal(v_f, v_s)
    np.testing.assert_array_equal(args[0].numpy(), avail)  # the input untouched
    if mode == "rows":  # JAX wraps a negative index (no caller makes one): as N here
        jidx = np.where(ref[1] < 0, N, ref[1])
        jx = kernel_jax._scatter_rows(jnp.asarray(avail), jnp.asarray(jidx),
                                      jnp.asarray(ref[2]))
    else:
        jx = jnp.clip(jnp.asarray(avail) + jnp.asarray(ref[2]), 0.0, jnp.asarray(total))
    np.testing.assert_array_equal(view.numpy(), np.asarray(jx))
    refreshed = _refreshed_np(avail, total, ref)
    np.testing.assert_array_equal(view.numpy(), refreshed)
    assert (refreshed < 0).any() == (mode == "rows")  # rows verbatim, delta clipped
    np_a, np_v = kernel_np.schedule_classes(refreshed, total, alive, demands, counts)
    np.testing.assert_array_equal(a_f.numpy(), np_a)
    np.testing.assert_array_equal(v_f.numpy(), np_v)
    assert np_a.sum() > 0


@pytest.mark.parametrize("cluster", KT.K1_CLUSTER_SIZES)
def test_k1_form_edges_with_refresh_plain_equals_numpy(cluster):
    """At K1's layout edges (k1_edges: both forms, a short last block) for
    each cluster size, the plain K1 with each refresh equals kernel_np on
    the refreshed view."""
    for name, N in k1_edges(cluster).items():
        for mode in REFRESHES:
            problem, ref = refresh_problem(N, mode, seed=3, C=4)
            avail, total, alive, demands, counts = problem
            a, v = KT._schedule_classes_plain(*[T(x) for x in problem],
                                              refresh=_refresh_t(ref))
            np_a, np_v = kernel_np.schedule_classes(_refreshed_np(avail, total, ref), total,
                                                    alive, demands, counts)
            np.testing.assert_array_equal(a.numpy(), np_a, err_msg=f"{name} {mode}")
            np.testing.assert_array_equal(v.numpy(), np_v, err_msg=f"{name} {mode}")


def test_k1_edges_at_both_cluster_sizes_cover_both_forms():
    """k1_edges' shapes give each form at each cluster size, the edge near
    24k nodes at 16 blocks and near 12k at 8, and a short last block."""
    for cluster, (lo, hi) in zip(KT.K1_CLUSTER_SIZES, ((23_000, 25_000), (11_500, 12_500))):
        e = k1_edges(cluster)
        assert lo < e["rows_full"] < hi and e["rows_full"] % cluster == 0
        for name, N in e.items():
            plan = KT.k1_plan(N, R, cluster)
            assert plan.rows_in_smem == name.startswith("rows"), (cluster, name)
            last = N - (cluster - 1) * plan.nodes_per_block
            assert (last < plan.nodes_per_block) == name.endswith("short"), (cluster, name)


@pytest.mark.parametrize("mode", REFRESHES)
def test_refresh_operand_checked(mode):
    """A refresh K1 cannot take (wrong shape or dtype) raises ValueError
    naming it; the same checks hold on the card before any launch."""
    ref = (KT.Refresh("rows", T(np.zeros(4, np.int64)), T(np.zeros((4, R), np.float32)))
           if mode == "rows" else KT.Refresh("delta", None, T(np.zeros((3, R), np.float32))))
    with pytest.raises(ValueError, match=f"refresh '{mode}'"):
        ref.check(8, R, torch.device("cpu"))
    good = (KT.Refresh("rows", T(np.zeros(4, np.int32)), T(np.zeros((4, R), np.float32)))
            if mode == "rows" else KT.Refresh("delta", None, T(np.zeros((8, R), np.float32))))
    good.check(8, R, torch.device("cpu"))


def test_cpu_refresh_counts_nothing():
    """On the CPU no kernel launches: a scan round with a pending refresh
    leaves every counter, the fused ones too, where it was."""
    rng, js, ts = _refresh_sequence_views(64, 15)
    before = KT.launch_counts()
    assert {"scatter_rows_fused", "delta_clip_fused"} <= set(before)
    _apply(("rows",), ts, 64, 2)
    ts.schedule(*_class_problem(rng, 5, 30))
    _apply(("delta",), ts, 64, 3)
    ts.fetch(ts.schedule_async(*_class_problem(rng, 5, 30)))
    assert KT.launch_counts() == before


# ---------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_fused_k1_equals_plain_in_both_forms_and_cluster_sizes():
    """On the card: K1 with each refresh in its launch against its plain
    version (0 differing cells, avail bit-equal), with negative entries,
    padding and out-of-range indices, at K1's layout edges (both forms, a
    short last block) for each cluster size (8 by K1's cached plan), and
    at N 17 (empty blocks); counted as a K1 launch and a fused K2 or K3;
    and K2's rows off a 16-byte boundary."""
    dev = _card()
    forms = set()
    for cluster in KT.K1_CLUSTER_SIZES:
        for name, N in {**k1_edges(cluster), "tiny": 17, "stream": 10_000}.items():
            key = (dev.index, N, R)
            saved = KT._K1_CLUSTER.pop(key, None)
            KT.k1_launch_plan(N, R, dev)
            if cluster != KT.K1_CLUSTER_SIZES[0]:
                KT._K1_CLUSTER[key] = cluster
            plan = KT.k1_launch_plan(N, R, dev)
            assert plan.cluster == cluster, (name, plan)
            forms.add((cluster, plan.rows_in_smem))
            try:
                for mode in REFRESHES:
                    problem, ref = refresh_problem(N, mode, seed=N % 97, C=24)
                    args = [T(x).to(dev) for x in problem]
                    a_p, v_p = KT._schedule_classes_plain(*args, refresh=_refresh_t(ref, dev))
                    KT.reset_launch_counts()
                    view = args[0].clone()
                    a_k, v_k = KT.schedule_classes(view, *args[1:], _in_place=True,
                                                   _refresh=_refresh_t(ref, dev))
                    assert v_k is view
                    assert torch.equal(a_k, a_p), (cluster, name, mode, int((a_k != a_p).sum()))
                    assert torch.equal(v_k, v_p), (cluster, name, mode)
                    c = refresh_counts()
                    assert KT.launch_counts()["schedule_classes"] == 1
                    assert c["fused"][mode] == 1 and not any(c["standalone"].values()), c
                    # no pass: the launch still stages the rows with the refresh
                    a_0, v_0 = KT.schedule_classes(*args, max_passes=0,
                                                   _refresh=_refresh_t(ref, dev))
                    assert not a_0.any() and torch.equal(
                        v_0, KT._refresh_plain(args[0].clone(), args[1], _refresh_t(ref, dev)))
            finally:
                KT._K1_CLUSTER.pop(key, None)
                if saved is not None:
                    KT._K1_CLUSTER[key] = saved
    assert forms == {(c, f) for c in KT.K1_CLUSTER_SIZES for f in (True, False)}, forms
    # rows 4 bytes past a 16-byte boundary, as update_rows stages them past a
    # pad that is no bucket: read a column at a time
    problem, (mode, idx, rows) = refresh_problem(10_007, "rows", seed=5, C=24)
    args = [T(x).to(dev) for x in problem]
    flat = torch.cat([torch.zeros(1), T(rows).reshape(-1)]).to(dev)[1:]
    ref = KT.Refresh("rows", T(idx).to(dev), flat.view(rows.shape))
    assert ref.src.data_ptr() % 16 == 4
    a_k, v_k = KT.schedule_classes(*args, _refresh=ref)
    a_p, v_p = KT._schedule_classes_plain(*args, refresh=ref)
    assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k7_unchanged_by_the_refresh_modes():
    """On the card: K7 (K1's kernel with no refresh, p = 8 and 4) equals K1
    and the plain K1 on the stream-sized problem and a straddle."""
    dev = _card()
    for N in (10_000, 8192):
        problem = random_problem(31, N=N, C=32)
        args = [T(x).to(dev) for x in problem]
        a_1, v_1 = KT.schedule_classes(*args)
        a_p, v_p = KT._schedule_classes_plain(*args)
        assert torch.equal(a_1, a_p) and torch.equal(v_1, v_p)
        for p in (8, 4):
            a_7, v_7 = KS.schedule_classes_sharded(*args, shards=p)
            assert torch.equal(a_7, a_1) and torch.equal(v_7, v_1), (N, p)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", KT.ALGOS)
def test_cuda_scan_round_applies_the_refresh_in_k1(algo):
    """On the card: a refresh and a round through TorchScheduler (schedule
    after update_rows, schedule_async after apply_delta) equal the CPU's;
    a scan round's refresh ran in K1's launch (fused 1, standalone 0), the
    other algorithms' alone; the view stays one tensor throughout."""
    dev = _card()
    N = 4000
    rng, _, cpu = _refresh_sequence_views(N, 16)
    card = KT.load_cluster_view(cpu.total.numpy(), cpu.alive.numpy(), cpu.avail.numpy(),
                                device=dev)
    view = card._view
    for mode, call in (("rows", "schedule"), ("delta", "schedule_async")):
        KT.reset_launch_counts()
        _apply((mode,), card, N, 7)
        _apply((mode,), cpu, N, 7)
        assert refresh_counts()["fused"][mode] == refresh_counts()["standalone"][mode] == 0
        demands, counts = _class_problem(rng, 9, 400)
        if call == "schedule":
            got, want = card.schedule(demands, counts, algo=algo), cpu.schedule(
                demands, counts, algo=algo)
        else:
            got = card.fetch(card.schedule_async(demands, counts, algo=algo))
            want = cpu.fetch(cpu.schedule_async(demands, counts, algo=algo))
        np.testing.assert_array_equal(got, want)
        c = refresh_counts()
        fused = 1 if algo == "scan" else 0
        assert c["fused"][mode] == fused and c["standalone"][mode] == 1 - fused, (algo, c)
        assert card._view is view
        assert torch.equal(card.avail.cpu(), cpu.avail)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_refresh_on_another_stream_is_waited_for():
    """On the card: a refresh pushed on one stream and a scan round on
    another: the round's stream waits for the copy; the result equals the
    CPU's."""
    dev = _card()
    N = 4000
    rng, _, cpu = _refresh_sequence_views(N, 17)
    card = KT.load_cluster_view(cpu.total.numpy(), cpu.alive.numpy(), cpu.avail.numpy(),
                                device=dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)  # the copy lands well after the round is enqueued
        _apply(("delta",), card, N, 9)
    _apply(("delta",), cpu, N, 9)
    demands, counts = _class_problem(rng, 9, 400)
    np.testing.assert_array_equal(card.schedule(demands, counts),
                                  cpu.schedule(demands, counts))
    assert torch.equal(card.avail.cpu(), cpu.avail)
    torch.cuda.synchronize()
