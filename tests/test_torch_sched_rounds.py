"""K5 (schedule_classes_rounds) and K6 (schedule_classes_chunked) of
ray_tpu_torch against ray_tpu's kernel_np and kernel_jax on the same
numpy-seeded inputs.

On the CPU the wrappers run their plain PyTorch versions; decisions must be
bit-identical to both references (the reference's exactness bound:
integer-granular demands, counts < 2**23), availability within the
reference tests' own atol=1e-2. Ports the properties of
tests/test_sched_rounds.py and tests/test_sched_chunked.py, and holds
TorchScheduler(device="cpu") to JaxScheduler under both algorithms.

The CUDA kernel runs the whole call on one thread-block cluster; its
decomposition (per-block prefixes and exchanged totals, tiles of 16
classes, the skip of finished tiles, the cached inactive-column terms, the
clamp at each phase's end) is evaluated here in NumPy by cluster_rounds, a
helper of this file, and held bit for bit to kernel_np and kernel_jax at the
layout's edges; rounds_plan, the host's mirror of the kernel's layout, is
held to the source's constants. The `cuda` tests run the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.sched import kernel_jax, kernel_np
from ray_tpu.sched.kernel_jax import JaxScheduler
from ray_tpu.sched.resources import NodeResourceState, ResourceSpace, pack_demands
from ray_tpu_torch.sched import kernel_torch as KT

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other's (one plain K1 call on config_5's round took
    ~200 s with six processes at once, ~1 s at one thread each). One
    thread for this module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R = 16


def _random_problem(seed, N=64, C=7):
    """tests/test_sched_rounds.py's generator, copied: a test file that
    imports through the `tests.` package does not collect where another
    package named `tests` is installed (ROADMAP §3)."""
    rng = np.random.default_rng(seed)
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = np.floor(
        st.available * rng.uniform(0.3, 1.0, size=st.available.shape)
    ).astype(np.float32)
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
    return st, demands, counts


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _view(st):
    return st.available, st.total, st.alive


def _torch(fn, avail, total, alive, demands, counts, **kw):
    a, v = fn(T(avail), T(total), T(alive), T(demands), T(counts), **kw)
    return a.numpy(), v.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k5_equals_numpy_and_jax(seed):
    """tests/test_sched_rounds.py::test_rounds_np_jax_golden_equality's
    problems through the port's K5."""
    st, demands, counts = _random_problem(seed, N=96, C=9)
    np_a, np_v = kernel_np.schedule_classes_rounds(*_view(st), demands, counts)
    jx_a, jx_v = kernel_jax.schedule_classes_rounds(
        jnp.asarray(st.available), jnp.asarray(st.total), jnp.asarray(st.alive),
        jnp.asarray(demands), jnp.asarray(counts),
    )
    th_a, th_v = _torch(KT.schedule_classes_rounds, *_view(st), demands, counts)
    assert th_a.dtype == np.int32 and th_v.dtype == np.float32
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_a, np.asarray(jx_a))
    np.testing.assert_allclose(th_v, np_v, atol=1e-2)
    np.testing.assert_allclose(th_v, np.asarray(jx_v), atol=1e-2)
    assert th_a.sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k6_equals_numpy_and_jax(seed):
    """tests/test_sched_chunked.py's golden problems (padded to 12 classes,
    chunk=4, as the jax path requires) through the port's K6."""
    st, demands, counts = _random_problem(seed, N=96, C=9)
    d, k = kernel_jax.pad_problem(demands, counts, 12)
    np_a, np_v = kernel_np.schedule_classes_chunked(*_view(st), d, k, chunk=4)
    jx_a, jx_v = kernel_jax.schedule_classes_chunked(
        jnp.asarray(st.available), jnp.asarray(st.total), jnp.asarray(st.alive),
        jnp.asarray(d), jnp.asarray(k), chunk=4,
    )
    th_a, th_v = _torch(KT.schedule_classes_chunked, *_view(st), d, k, chunk=4)
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_a, np.asarray(jx_a))
    np.testing.assert_allclose(th_v, np_v, atol=1e-2)
    np.testing.assert_allclose(th_v, np.asarray(jx_v), atol=1e-2)
    assert th_a[len(counts):].sum() == 0  # pad classes stay inert


@pytest.mark.parametrize("algo", ["rounds", "chunked"])
def test_active_columns_match_jax_active_idx(algo):
    """With the active columns given (as JaxScheduler passes them), the
    port equals kernel_jax with the same active_idx and kernel_np over all
    columns."""
    st, demands, counts = _random_problem(11, N=64, C=16)
    active = tuple(int(i) for i in np.flatnonzero((demands > 0).any(axis=0)))
    assert len(active) < R
    fn_jx = (kernel_jax.schedule_classes_rounds if algo == "rounds"
             else kernel_jax.schedule_classes_chunked)
    fn_np = (kernel_np.schedule_classes_rounds if algo == "rounds"
             else kernel_np.schedule_classes_chunked)
    fn_th = KT.schedule_classes_rounds if algo == "rounds" else KT.schedule_classes_chunked
    jx_a, _ = fn_jx(jnp.asarray(st.available), jnp.asarray(st.total),
                    jnp.asarray(st.alive), jnp.asarray(demands), jnp.asarray(counts),
                    active_idx=active)
    np_a, np_v = fn_np(*_view(st), demands, counts)
    th_a, th_v = _torch(fn_th, *_view(st), demands, counts, active_idx=active)
    np.testing.assert_array_equal(th_a, np.asarray(jx_a))
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_v, np_v)


def test_bad_active_columns_raise():
    st, demands, counts = _random_problem(1, N=8, C=2)
    with pytest.raises(ValueError, match="active_idx"):
        _torch(KT.schedule_classes_rounds, *_view(st), demands, counts, active_idx=(0, R))


@pytest.mark.parametrize("algo", ["rounds", "chunked"])
def test_respects_capacity(algo):
    """tests/test_sched_rounds.py::test_rounds_respects_capacity and
    tests/test_sched_chunked.py::test_chunked_respects_capacity."""
    if algo == "rounds":
        st, demands, counts = _random_problem(1)
        assigned, avail = _torch(KT.schedule_classes_rounds, *_view(st), demands, counts)
    else:
        st, demands, counts = _random_problem(3, N=64, C=13)
        assigned, avail = _torch(KT.schedule_classes_chunked, *_view(st), demands,
                                 counts, chunk=4)
    assert (assigned.sum(axis=1) <= counts).all()
    assert (avail >= -1e-3).all()
    used = assigned.astype(np.float32).T @ demands
    assert (used <= st.available + 1e-2).all()


@pytest.mark.parametrize("algo", ["rounds", "chunked"])
def test_places_when_feasible(algo):
    total = np.zeros((4, R), np.float32)
    total[:, 0] = 16.0
    demands = np.zeros((1, R), np.float32)
    demands[0, 0] = 1.0
    counts = np.array([40], np.int32)
    fn = KT.schedule_classes_rounds if algo == "rounds" else KT.schedule_classes_chunked
    assigned, avail = _torch(fn, total.copy(), total, np.ones(4, bool), demands, counts)
    assert assigned.sum() == 40
    np.testing.assert_array_equal(avail[:, 0], total[:, 0] - assigned[0])


def test_chunk1_matches_rounds_per_class():
    """tests/test_sched_chunked.py::test_chunked_chunk1_matches_rounds_per_class:
    chunk=1 degenerates to per-class sequential rounds placement."""
    st, demands, counts = _random_problem(5, N=48, C=6)
    chunked, _ = _torch(KT.schedule_classes_chunked, *_view(st), demands, counts,
                        chunk=1, rounds=4)
    avail = st.available.copy()
    rows = []
    for c in range(len(counts)):
        a, avail = _torch(KT.schedule_classes_rounds, avail, st.total, st.alive,
                          demands[c:c + 1], counts[c:c + 1], rounds=4)
        rows.append(a)
    np.testing.assert_array_equal(chunked, np.concatenate(rows, axis=0))
    ref, _ = kernel_np.schedule_classes_chunked(*_view(st), demands, counts, chunk=1,
                                                rounds=4)
    np.testing.assert_array_equal(chunked, ref)


def test_does_not_modify_input_and_counts_no_cpu_launch():
    st, demands, counts = _random_problem(2, N=32, C=5)
    t_avail = T(st.available.copy())
    before = KT.launch_counts()
    KT.schedule_classes_rounds(t_avail, T(st.total), T(st.alive), T(demands), T(counts))
    KT.schedule_classes_chunked(t_avail, T(st.total), T(st.alive), T(demands), T(counts))
    np.testing.assert_array_equal(t_avail.numpy(), st.available)
    # the CPU path runs the plain versions: no kernel launched
    assert KT.launch_counts() == before
    assert {"schedule_classes_rounds", "schedule_classes_chunked"} <= set(KT.KERNELS)


def _jax_and_torch_views(N, seed):
    rng = np.random.default_rng(seed)
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(4, 33, N)
    total[:, 3] = rng.integers(16, 129, N)
    alive = rng.random(N) > 0.05
    js = JaxScheduler(total, alive)
    ts = KT.load_cluster_view(np.asarray(js.total), np.asarray(js.alive),
                              np.asarray(js.avail), device="cpu")
    return rng, js, ts


def _class_problem(rng, C, max_count):
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 4, C)
    demands[:, 3] = np.where(rng.random(C) < 0.4, rng.integers(1, 8, C), 0)
    counts = rng.integers(0, max_count, C).astype(np.int32)
    return demands, counts


@pytest.mark.parametrize("algo", ["rounds", "chunked"])
def test_torch_scheduler_schedule_equals_jax(algo):
    """Padding, the active set with resource 0 kept for the pad guard, and
    the state carried across rounds, as JaxScheduler.schedule does."""
    rng, js, ts = _jax_and_torch_views(64, 3)
    for _ in range(3):
        demands, counts = _class_problem(rng, 20, 60)  # pads to 64 classes
        np.testing.assert_array_equal(ts.schedule(demands, counts, algo=algo),
                                      js.schedule(demands, counts, algo=algo))
        np.testing.assert_allclose(ts.avail.numpy(), np.asarray(js.avail), atol=1e-2)


@pytest.mark.parametrize("algo", ["rounds", "chunked"])
@pytest.mark.parametrize("N,max_count", [(512, 60), (64, 400)])
def test_torch_scheduler_async_fetch_equals_jax(algo, N, max_count):
    """N=512: the sparse (COO) download (K4); N=64: the dense one."""
    rng, js, ts = _jax_and_torch_views(N, 4)
    demands, counts = _class_problem(rng, 12, max_count)
    hj = js.schedule_async(demands, counts, algo=algo)
    ht = ts.schedule_async(demands, counts, algo=algo)
    assert ("sparse" in ht) == ("sparse" in hj) == (N == 512)
    a = ts.fetch(ht)
    np.testing.assert_array_equal(a, js.fetch(hj))
    assert a.dtype == np.int32 and a.sum() > 0
    np.testing.assert_allclose(ts.avail.numpy(), np.asarray(js.avail), atol=1e-2)


@pytest.mark.cuda
def test_k5_k6_equal_plain_and_numpy_on_card():
    """On the card: K5 and K6 against their plain versions and kernel_np
    (exact assignments and availability)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    st, demands, counts = _random_problem(2, N=1024, C=40)
    args = [T(x).to(dev) for x in (*_view(st), demands, counts)]
    for kern, plain, ref in (
            (KT.schedule_classes_rounds, KT._schedule_classes_rounds_plain,
             kernel_np.schedule_classes_rounds),
            (KT.schedule_classes_chunked, KT._schedule_classes_chunked_plain,
             kernel_np.schedule_classes_chunked)):
        a_k, v_k = kern(*args)
        a_p, v_p = plain(*args)
        assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p)
        np.testing.assert_array_equal(a_k.cpu().numpy(), ref(*_view(st), demands, counts)[0])


# ------------------------------------------- the kernel's cluster decomposition

SAT_I = 1 << 23
TILE = 16
F32 = np.float32


def _frac(x, t):
    """critical_util's terms: used / max(total, eps), 0 where total is 0."""
    return np.where(t > 0, (t - x) / np.maximum(t, F32(kernel_np.EPS)), F32(0)).astype(F32)


def _sat_prefix(x):
    """Inclusive prefix along the last axis of nonnegative integers, clipped
    at SAT."""
    return np.minimum(np.cumsum(x.astype(np.int64), axis=-1), SAT_I)


def cluster_rounds(avail, total, alive, demands, counts, spread_threshold=0.5, rounds=4,
                   chunk=None, active=None, cluster=16, stats=None):
    """K5 (chunk None: every class at once) and K6 as the CUDA kernel
    decomposes them over a cluster of `cluster` blocks, evaluated in NumPy:
    block r owns nodes [r*Nb, (r+1)*Nb); tiles of 16 classes; each block's
    prefix of a tile's caps saturating at SAT and the lower blocks' exchanged
    totals as its base; a tile whose classes all have remaining 0 skipped;
    phase A's placed counts settled in phase B's count exchange, phase B's
    after the phase (not after a chunk's last); the inactive columns'
    utilization term cached from the view as given and after the first
    phase's clamp; the debit and clamp at a phase's end. `stats` (a dict)
    receives the tiles run and skipped, and the blocks in which a prefix
    reached SAT from a base below it."""
    avail = np.asarray(avail, F32)
    total = np.asarray(total, F32)
    alive = np.asarray(alive, bool)
    demands = np.asarray(demands, F32)
    N, R = avail.shape
    C = len(demands)
    chunk = max(C, 1) if chunk is None else chunk
    active = list(range(R)) if active is None else sorted(active)
    inact = [r for r in range(R) if r not in active]
    thr = F32(spread_threshold)
    eps = F32(kernel_np.EPS)
    nb = -(-N // cluster)
    blocks = [(min(r * nb, N), min((r + 1) * nb, N)) for r in range(cluster)]
    av = avail[:, active].copy()
    tt = total[:, active]
    d_act = demands[:, active]
    d_div = np.maximum(d_act, F32(1e-9))

    def inactive_term(x):
        if not inact:
            return np.full(N, -np.inf, F32)
        return _frac(x, total[:, inact]).max(axis=1)

    uin = inactive_term(avail[:, inact])
    rem = np.asarray(counts).astype(F32)
    assigned = np.zeros((C, N), np.int64)
    run_tiles = skipped = 0
    sat_blocks = set()
    first_phase = True
    for cs in range(0, C, chunk):
        cc = min(chunk, C - cs)
        for rd in range(rounds):
            for phase_b in (False, True):
                if not phase_b:
                    util = uin
                    if active:
                        util = np.maximum(uin, _frac(av, tt).max(axis=1))
                    under = alive & (util < thr)
                acc = np.zeros((N, len(active)), np.float64)
                use = np.zeros((N, len(active)), np.float64)
                placed = np.zeros(C, np.int64)
                ran = False
                for t0 in range(cs, cs + cc, TILE):
                    cls = np.arange(t0, min(t0 + TILE, cs + cc))
                    if not (rem[cls] > 0).any():
                        skipped += 1
                        continue
                    d = d_act[cls]
                    pos = d > 0
                    # 1. caps, node-local
                    fit = np.full((len(cls), N), F32(kernel_np.INF_FIT))
                    for a in range(len(active)):
                        ratio = np.floor((av[:, a][None, :] + eps) / d_div[cls, a][:, None])
                        fit = np.where(pos[:, a][:, None], np.minimum(fit, ratio), fit)
                    fit = np.clip(fit, 0, F32(kernel_np.INF_FIT)).astype(F32)
                    if not phase_b:
                        k = np.full((len(cls), N), F32(kernel_np.INF_FIT))
                        for a in range(len(active)):
                            head = thr * tt[:, a] - (tt[:, a] - av[:, a])
                            cap_r = np.floor((head[None, :] + eps) / d_div[cls, a][:, None])
                            k = np.where(pos[:, a][:, None], np.minimum(k, cap_r), k)
                        k = np.clip(k, 0, F32(kernel_np.INF_FIT)) + F32(1)
                        cap = np.where(under[None, :], np.minimum(fit, k), F32(0))
                    else:
                        fit = fit * alive[None, :].astype(F32)
                        # 2. the count exchange settles phase A's placed
                        n_feas = sum((fit[:, lo:hi] > 0).sum(axis=1) for lo, hi in blocks)
                        rem[cls] = rem[cls] - placed_a[cls].astype(F32)
                        share = np.ceil(rem[cls] / np.maximum(n_feas.astype(F32), F32(1)))
                        if not (rem[cls] > 0).any():
                            skipped += 1
                            continue
                        cap = np.minimum(fit, share[:, None])
                    ran = True
                    run_tiles += 1
                    r_c = rem[cls][:, None]
                    capc = np.minimum(cap, np.minimum(r_c, F32(kernel_np.SAT))).astype(F32)
                    capc = np.where(r_c > 0, capc, F32(0))
                    # 3. block-local prefixes; 4. the exchanged totals
                    incl = np.zeros((len(cls), N), np.int64)
                    base = np.zeros(len(cls), np.int64)
                    for b, (lo, hi) in enumerate(blocks):
                        local = _sat_prefix(capc[:, lo:hi])
                        incl[:, lo:hi] = np.minimum(base[:, None] + local, SAT_I)
                        if ((base < SAT_I) & (incl[:, lo:hi] == SAT_I).any(axis=1)).any():
                            sat_blocks.add(b)
                        if hi > lo:
                            base = np.minimum(base + local[:, -1], SAT_I)
                    want = np.clip(r_c - (incl.astype(F32) - capc), F32(0), capc).astype(F32)
                    want = np.where(r_c > 0, want, F32(0))
                    # 5. the trim, node-local, classes in order
                    for i, c in enumerate(cls):
                        w = want[i]
                        t = w.copy()
                        for a in range(len(active)):
                            u = (w * d[i, a]).astype(F32)
                            acc[:, a] += u
                            if d[i, a] > 0:
                                prev = np.minimum(acc[:, a], kernel_np.SAT).astype(F32) - u
                                head = av[:, a] - prev
                                fr = np.floor((head + eps) / d_div[c, a])
                                t = np.minimum(t, np.clip(fr, 0, F32(kernel_np.SAT)))
                        take = np.clip(t, 0, w).astype(np.int64)
                        assigned[c] += take
                        use += take[:, None].astype(np.float64) * d[i].astype(np.float64)
                        placed[c] = sum(int(take[lo:hi].sum()) for lo, hi in blocks)
                if ran or first_phase:
                    av = np.maximum(av - use.astype(F32), F32(0))
                if first_phase:
                    uin = inactive_term(np.maximum(avail[:, inact], F32(0)))
                first_phase = False
                if not phase_b:
                    placed_a = placed
                elif ran and rd + 1 < rounds:
                    rem = rem - placed.astype(F32)
    out = avail.copy()
    if rounds > 0 and C > 0:
        out[:, inact] = np.maximum(avail[:, inact], F32(0))
        out[:, active] = av
    if stats is not None:
        stats.update(run=run_tiles, skipped=skipped, sat_blocks=sat_blocks)
    return assigned.astype(np.int32), out


def _edge_problems():
    """The layout's edges, each (name, avail, total, alive, demands, counts,
    active or None)."""
    out = []
    for seed in range(4):
        st, demands, counts = _random_problem(seed, N=96, C=9)
        out.append((f"golden{seed}", *_view(st), demands, counts, None))
    # counts near 2**23: phase A caps every node at 130 000 tasks of class 0
    # (half of 259 998 CPUs), so its prefix passes 2**23 in the second block
    # of 63 nodes (63 * 130 000 < 2**23 < 65 * 130 000); nothing is placed
    # past the count (2**23 - count > 130 000), the reference's exact range
    N = 1003
    total = np.zeros((N, R), F32)
    total[:, 0] = 259_998.0
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[70::97] = False
    demands = np.zeros((4, R), F32)
    demands[:, 0] = [1.0, 1.0, 2.0, 1.0]
    counts = np.array([8_200_000, 8_199_993, 3_000_000, 8_000_000], np.int32)
    out.append(("counts_near_2_23", total * alive[:, None], total, alive, demands, counts, None))
    # a negative entry in an inactive column and in an active one
    st, demands, counts = _random_problem(7, N=64, C=12)
    avail = st.available.copy()
    avail[3, 5] = -3.0
    avail[9, 0] = -1.0
    total = st.total.copy()
    total[:, 5] = 4.0
    active = tuple(int(i) for i in np.flatnonzero((demands > 0).any(axis=0)))
    assert 5 not in active and 0 in active
    out.append(("negative_entries", avail, total, st.alive, demands, counts, active))
    # padded classes (INF_FIT of resource 0, count 0), C = 21 -> 32
    st, demands, counts = _random_problem(8, N=200, C=21)
    d, k = kernel_jax.pad_problem(demands, counts, 32)
    out.append(("padded", *_view(st), d, k, None))
    # C not a multiple of 16, N not a multiple of 16
    st, demands, counts = _random_problem(9, N=1003, C=21)
    out.append(("n1003_c21", *_view(st), demands, counts * 20, None))
    return out


def _edge_ids(p):
    return p[0]


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("problem", _edge_problems(), ids=_edge_ids)
def test_cluster_decomposition_equals_numpy_k5(problem, cluster):
    """The kernel's decomposition of K5 (per-block prefixes and exchanged
    totals, tiles, the skip, the cached inactive terms, the clamp) is
    kernel_np.schedule_classes_rounds bit for bit, and kernel_jax's."""
    name, avail, total, alive, demands, counts, active = problem
    for rounds in (0, 1, 4):
        a, v = cluster_rounds(avail, total, alive, demands, counts, rounds=rounds,
                              active=active, cluster=cluster)
        a_n, v_n = kernel_np.schedule_classes_rounds(avail, total, alive, demands, counts,
                                                     rounds=rounds)
        np.testing.assert_array_equal(a, a_n)
        np.testing.assert_array_equal(v, v_n)
        if rounds:
            a_j, v_j = kernel_jax.schedule_classes_rounds(
                jnp.asarray(avail), jnp.asarray(total), jnp.asarray(alive),
                jnp.asarray(demands), jnp.asarray(counts), rounds=rounds, active_idx=active)
            np.testing.assert_array_equal(a, np.asarray(a_j))
        th_a, th_v = _torch(KT.schedule_classes_rounds, avail, total, alive, demands, counts,
                            rounds=rounds, active_idx=active)
        np.testing.assert_array_equal(th_a, a)
        np.testing.assert_array_equal(th_v, v)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("problem", _edge_problems(), ids=_edge_ids)
def test_cluster_decomposition_equals_numpy_k6(problem, cluster):
    """The same for K6: chunks of 16 with a trailing partial chunk where C
    is not a multiple of 16 (kernel_np's form), chunks of 4 on the padded
    problem as kernel_jax takes them."""
    name, avail, total, alive, demands, counts, active = problem
    for chunk, rounds in ((16, 2), (16, 1), (4, 2), (16, 0)):
        a, v = cluster_rounds(avail, total, alive, demands, counts, rounds=rounds,
                              chunk=chunk, active=active, cluster=cluster)
        a_n, v_n = kernel_np.schedule_classes_chunked(avail, total, alive, demands, counts,
                                                      chunk=chunk, rounds=rounds)
        np.testing.assert_array_equal(a, a_n)
        np.testing.assert_array_equal(v, v_n)
        if rounds and len(counts) % chunk == 0:
            a_j, _ = kernel_jax.schedule_classes_chunked(
                jnp.asarray(avail), jnp.asarray(total), jnp.asarray(alive),
                jnp.asarray(demands), jnp.asarray(counts), chunk=chunk, rounds=rounds,
                active_idx=active)
            np.testing.assert_array_equal(a, np.asarray(a_j))


def test_cluster_decomposition_skips_finished_tiles_exactly():
    """Padded classes and classes placed in full are skipped tile by tile,
    and the result is unchanged: 21 classes padded to 64 run two tiles in
    the first phase A and skip the two tiles of padding in every phase."""
    st, demands, counts = _random_problem(8, N=400, C=21)
    d, k = kernel_jax.pad_problem(demands, counts, 64)
    stats = {}
    a, v = cluster_rounds(*_view(st), d, k, rounds=4, stats=stats)
    a_n, v_n = kernel_np.schedule_classes_rounds(*_view(st), d, k, rounds=4)
    np.testing.assert_array_equal(a, a_n)
    np.testing.assert_array_equal(v, v_n)
    assert stats["skipped"] >= 2 * 8 and stats["run"] >= 2
    assert a[21:].sum() == 0


def test_cluster_decomposition_saturates_across_a_block_boundary():
    """counts_near_2_23's prefix reaches SAT in a block after the first:
    the exchanged base and the block's own prefix saturate together."""
    name, avail, total, alive, demands, counts, active = next(
        p for p in _edge_problems() if p[0] == "counts_near_2_23")
    stats = {}
    a, _ = cluster_rounds(avail, total, alive, demands, counts, rounds=4, stats=stats)
    assert max(stats["sat_blocks"]) >= 1
    np.testing.assert_array_equal(
        a, kernel_np.schedule_classes_rounds(avail, total, alive, demands, counts)[0])
    assert (a.sum(axis=1) <= counts).all() and a.sum() > 2**23


def test_rounds_plan_layout():
    """rounds_plan, the host's mirror of the source's: N padded to the
    cluster, the stride, the group of the placed exchange, the edge where
    the node state leaves shared memory, and the scratch words."""
    src = KT._build.LIBRARY.src.read_text()
    for name, value in (("kRTile", KT.ROUNDS_TILE), ("kRMaxGroup", KT.ROUNDS_MAX_GROUP)):
        assert f"constexpr int {name} = {value};" in src
    assert (f"constexpr size_t kRSmemBudget = {KT.ROUNDS_SMEM_BUDGET // 1024} * 1024;"
            in src)
    assert KT.ROUNDS_CLUSTER_SIZES == (16, 8)
    p = KT.rounds_plan(10_000, 3, 256, 256, 16)
    assert (p.cluster, p.nodes_per_block, p.stride, p.group) == (16, 625, 640, 256)
    assert p.rows_in_smem and p.scratch_words == 2 * 16 * 256
    assert p.smem_bytes == KT.rounds_exchange_bytes(16, 256) + KT.rounds_node_bytes(640, 3)
    assert p.smem_bytes <= KT.ROUNDS_SMEM_BUDGET
    p6 = KT.rounds_plan(10_000, 3, 256, 16, 16)
    assert p6.group == 16 and p6.smem_bytes < p.smem_bytes
    p = KT.rounds_plan(10_007, 3, 64, 16, 16)
    assert p.nodes_per_block == 626 and p.stride == 640
    assert KT.rounds_plan(21, 1, 21, 4, 16).group == 16
    # the edge: the largest N whose node state fits beside the exchanges
    def fits(n):
        return KT.rounds_plan(n, 3, 256, 256, 16).rows_in_smem
    n = 10_000
    while fits(n + 16):
        n += 16
    assert n > 16_000
    assert fits(n) and not fits(n + 16)
    q = KT.rounds_plan(n + 16, 3, 256, 256, 16)
    assert q.smem_bytes == KT.rounds_exchange_bytes(16, 256)
    assert q.scratch_words == 2 * 16 * 256 + 16 * KT.rounds_node_bytes(q.stride, 3) // 4
    assert KT.rounds_plan(40_000, 3, 32, 16, 16).rows_in_smem is False
    assert KT.rounds_plan(10_000, 17, 64, 64, 16).rows_in_smem is False
    assert KT.rounds_node_bytes(640, 3) == (24 * 3 + 75) * 640


def _wide_problem(seed, N, C, n_res, n_active):
    """Dead nodes and `n_active` demanded columns of `n_res`, every one of
    them demanded by some class."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(n_res, n_active, replace=False))
    total = np.zeros((N, n_res), F32)
    total[:, cols] = rng.integers(4, 129, (N, n_active))
    avail = np.floor(total * rng.uniform(0.3, 1.0, total.shape)).astype(F32)
    alive = rng.random(N) > 0.05
    demands = np.zeros((C, n_res), F32)
    demands[:, cols[0]] = rng.integers(1, 4, C)
    for a, r in enumerate(cols[1:], 1):
        demands[:, r] = np.where(rng.random(C) < 0.5, rng.integers(1, 4, C), 0)
        demands[a % C, r] = 1.0
    counts = rng.integers(0, 300, C).astype(np.int32)
    return avail * alive[:, None], total, alive, demands, counts


@pytest.mark.cuda
def test_cuda_k5_k6_cluster_edges_equal_plain_and_numpy():
    """On the card, K5 and K6 at K6's cluster layout's edges: node state in
    shared and in global memory, A = 1, 4, 8 and 17 active columns (K5's
    three kernels in their 4-, 16- and 64-column register forms), counts
    near 2**23, negative entries, padded classes, C and N not multiples of
    16, rounds 1: assignments and availability exactly the plain versions'
    and kernel_np's, two launches bit-equal, one counted launch a call
    (chip_smoke.py phase 1 counts K5's kernels: its zero fill and six a
    round), and the C entry point's scratch words those of rounds_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    lib = KT._build.load()
    problems = [(n, a, t, al, d, k) for n, a, t, al, d, k, _ in _edge_problems()]
    problems += [
        ("a1", *_wide_problem(1, 3001, 40, 16, 1)),
        ("a4", *_wide_problem(2, 10_007, 64, 16, 4)),
        ("a8", *_wide_problem(5, 2000, 40, 16, 8)),
        ("a17_global", *_wide_problem(3, 10_000, 24, 20, 17)),
        ("n40000_global", *_wide_problem(4, 40_000, 32, 16, 3)),
    ]
    forms = set()
    for name, avail, total, alive, demands, counts in problems:
        args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
        N, n_res = total.shape
        active = tuple(int(i) for i in np.flatnonzero((demands > 0).any(axis=0)))
        for kern, plain, ref, kw in (
                (KT.schedule_classes_rounds, KT._schedule_classes_rounds_plain,
                 kernel_np.schedule_classes_rounds, {"rounds": 4}),
                (KT.schedule_classes_rounds, KT._schedule_classes_rounds_plain,
                 kernel_np.schedule_classes_rounds, {"rounds": 1}),
                (KT.schedule_classes_chunked, KT._schedule_classes_chunked_plain,
                 kernel_np.schedule_classes_chunked, {"chunk": 16, "rounds": 2}),
                (KT.schedule_classes_chunked, KT._schedule_classes_chunked_plain,
                 kernel_np.schedule_classes_chunked, {"chunk": 4, "rounds": 2})):
            what = f"{name} {kern.__name__} {kw}"
            before = kern.launches
            a_k, v_k = kern(*args, **kw, active_idx=active)
            assert kern.launches == before + 1, what
            a_2, v_2 = kern(*args, **kw, active_idx=active)
            a_p, v_p = plain(*args, **kw, active_idx=active)
            a_n, v_n = ref(avail, total, alive, demands, counts, **kw)
            assert torch.equal(a_k, a_2) and torch.equal(v_k, v_2), what
            assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p), what
            np.testing.assert_array_equal(a_k.cpu().numpy(), a_n, err_msg=what)
            np.testing.assert_array_equal(v_k.cpu().numpy(), v_n, err_msg=what)
            if kern is KT.schedule_classes_rounds:
                continue
            chunk = kw["chunk"]
            plan = KT.rounds_launch_plan(N, n_res, len(active), len(counts), chunk, dev)
            forms.add(plan.rows_in_smem)
            for p in KT.ROUNDS_CLUSTER_SIZES:
                assert lib.sched_rounds_scratch_words(N, len(active), len(counts), chunk, p) \
                    == KT.rounds_plan(N, len(active), len(counts), chunk, p).scratch_words
    assert forms == {True, False}
