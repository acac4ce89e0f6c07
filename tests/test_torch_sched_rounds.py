"""K5 (schedule_classes_rounds) and K6 (schedule_classes_chunked) of
ray_tpu_torch against ray_tpu's kernel_np and kernel_jax on the same
numpy-seeded inputs.

On the CPU the wrappers run their plain PyTorch versions; decisions must be
bit-identical to both references (the reference's exactness bound:
integer-granular demands, counts < 2**23), availability within the
reference tests' own atol=1e-2. Ports the properties of
tests/test_sched_rounds.py and tests/test_sched_chunked.py, and holds
TorchScheduler(device="cpu") to JaxScheduler under both algorithms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.sched import kernel_jax, kernel_np
from ray_tpu.sched.kernel_jax import JaxScheduler
from ray_tpu_torch.sched import kernel_torch as KT
from tests.test_sched_rounds import _random_problem

R = 16


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
