"""K7, the node-axis-sharded scheduler of ray_tpu_torch, against ray_tpu's
make_sharded_scheduler (shard_map on the 8-device virtual CPU mesh that
tests/conftest.py sets up), kernel_np (the JAX package's and the port's
copy) and the port's K1, on the same numpy-seeded inputs.

On the CPU the wrapper runs its plain version, the shard axis written out
in one process; across ranks, make_sharded_scheduler(group) runs one shard
a rank over gloo. Assignments and availability must be exactly equal to the
references (the JAX program's saturating float32 prefixes and the port's
exact int64 ones agree while counts stay below 2**23). The CUDA kernel is
held against the plain version on the card by the `cuda`-marked test and by
chip_smoke.py phase 8. K7r, the group form's kernel on CUDA tensors (three
steps a pass), is held here by its plain versions, pass by pass, against
_sharded_body; on the card by the `cuda` tests below (one process, and 2
gloo ranks on one card) and by chip_smoke.py phase 11.
"""

import functools
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh

from ray_tpu.sched import kernel_np
from ray_tpu.sched.kernel_shard import make_sharded_scheduler as jax_sharded
from ray_tpu_torch.sched import kernel_np as port_np
from ray_tpu_torch.sched import kernel_shard as KS
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


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(rng, n_nodes, n_classes, dense=False):
    """tests/test_sched_shard.py's generator."""
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(4, 65, n_nodes)
    total[:, 3] = rng.integers(16, 257, n_nodes)
    if not dense:
        total[:, 2] = np.where(rng.random(n_nodes) < 0.3, 8.0, 0.0)
    alive = rng.random(n_nodes) < 0.95
    demands = np.zeros((n_classes, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, n_classes)
    mem = rng.random(n_classes) < 0.5
    demands[mem, 3] = rng.integers(1, 9, mem.sum())
    tpu = rng.random(n_classes) < 0.2
    demands[tpu, 2] = rng.integers(1, 3, tpu.sum())
    counts = rng.integers(0, 200, n_classes).astype(np.int32)
    return total, alive, demands, counts


def bench_problem():
    """bench.py sharded_kernel_bench's problem: N 2048, C 32, seed 0."""
    rng = np.random.default_rng(0)
    N, C = 2048, 32
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(16, 65, N)
    total[:, 3] = rng.integers(64, 513, N)
    alive = np.ones(N, bool)
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    counts = rng.integers(0, 500, C).astype(np.int32)
    return total.copy(), total, alive, demands, counts


def dryrun_problem(n_devices=8):
    """__graft_entry__.dryrun_multichip's scheduler part: 16 nodes a
    device, 4 classes, seed 0."""
    rng = np.random.default_rng(0)
    n_nodes = 16 * n_devices
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(4, 33, n_nodes)
    alive = np.ones(n_nodes, bool)
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = rng.integers(1, 4, 4)
    counts = rng.integers(0, 50, 4).astype(np.int32)
    return total.copy(), total, alive, demands, counts


def _port(p, avail, total, alive, demands, counts, thr=0.5):
    a, v = KS.make_sharded_scheduler(p, device="cpu")(avail, total, alive, demands, counts,
                                                      thr)
    assert a.dtype == torch.int32 and v.dtype == torch.float32
    return a.numpy(), v.numpy()


@functools.lru_cache(maxsize=None)
def _jax_fn(p):
    devs = jax.devices()
    if len(devs) < p:
        pytest.skip(f"needs the {p}-device CPU mesh of tests/conftest.py")
    return jax_sharded(Mesh(np.array(devs[:p]), ("nodes",)))


def _jax(p, *args):
    a, v = _jax_fn(p)(*args, 0.5)
    return np.asarray(a), np.asarray(v)


def _np_refs(avail, total, alive, demands, counts):
    """kernel_np of the JAX package and the port's copy; both must agree."""
    a, v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
    a2, v2 = port_np.schedule_classes(avail.copy(), total, alive, demands, counts)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(v, v2)
    return a, v


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_equals_jax_sharded(p, seed):
    """tests/test_sched_shard.py's problems (64 nodes a shard, 24 classes)
    through JAX's mesh of p devices and the port's p in-process shards."""
    total, alive, demands, counts = _problem(np.random.default_rng(seed), 64 * p, 24)
    avail = (total * alive[:, None]).astype(np.float32)
    th_a, th_v = _port(p, avail, total, alive, demands, counts)
    jx_a, jx_v = _jax(p, avail, total, alive, demands, counts)
    np.testing.assert_array_equal(th_a, jx_a)
    np.testing.assert_array_equal(th_v, jx_v)
    np_a, np_v = _np_refs(avail, total, alive, demands, counts)
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_v, np_v)
    assert th_a.sum() > 0


def test_carried_state_rounds_equal_kernel_np():
    """tests/test_sched_shard.py::test_sharded_carried_state_rounds: four
    rounds, each fed the availability the last one left."""
    total, alive, demands, counts = _problem(np.random.default_rng(11), 32 * 8, 8)
    fn = KS.make_sharded_scheduler(8, device="cpu")
    av_th = (total * alive[:, None]).astype(np.float32)
    av_np = av_th.copy()
    for rnd in range(4):
        k = np.maximum(counts - rnd * 30, 0).astype(np.int32)
        a_th, v_th = fn(av_th, total, alive, demands, k)
        a_np, av_np = _np_refs(av_np, total, alive, demands, k)
        np.testing.assert_array_equal(a_th.numpy(), a_np, err_msg=f"round {rnd}")
        np.testing.assert_array_equal(v_th.numpy(), av_np, err_msg=f"round {rnd}")
        av_th = v_th  # the tensor carries over, as JAX's sharded array does


@pytest.mark.parametrize("name,problem", [("dryrun", dryrun_problem),
                                          ("bench", bench_problem)])
def test_reference_problems_equal_kernel_np_and_jax(name, problem):
    avail, total, alive, demands, counts = problem()
    th_a, th_v = _port(8, avail, total, alive, demands, counts)
    np_a, np_v = _np_refs(avail, total, alive, demands, counts)
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_v, np_v)
    np.testing.assert_array_equal(th_a, _jax(8, avail, total, alive, demands, counts)[0])
    assert th_a.sum() > 0


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_negative_availability_follows_kernel_np(p):
    """tests/test_torch_sched_kernel.py::test_negative_availability_round_
    that_places_nothing's view: the port's K7 keeps the negative entry, as
    kernel_np and the port's K1 do (JAX's K7 clamps it, as kernel_jax)."""
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
    th_a, th_v = _port(p, avail, total, alive, demands, counts)
    k1_a, k1_v = KT._schedule_classes_plain(T(avail), T(total), T(alive), T(demands),
                                            T(counts))
    np.testing.assert_array_equal(th_a, k1_a.numpy())
    np.testing.assert_array_equal(th_v, k1_v.numpy())
    np_a, np_v = _np_refs(avail, total, alive, demands, counts)
    np.testing.assert_array_equal(th_v, np_v)
    assert th_a.sum() == 0 and th_v[2, 3] == -3.0
    assert _jax(p, avail, total, alive, demands, counts)[1][2, 3] == 0.0


def saturation_problem():
    """Counts near 2**23 - 1 and capacities whose prefix passes 2**23 in
    the second of 8 shards: 64 nodes of 2**21 CPUs (a cap of 2**20 + 1
    under the threshold), one demanded column."""
    N = 64
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 2.0 ** 21
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[5] = False
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = [1.0, 1.0, 2.0, 1.0]
    counts = np.array([2**23 - 1, 2**23 - 7, 3_000_000, 2**23 - 1], np.int32)
    return (total * alive[:, None]).astype(np.float32), total, alive, demands, counts


def test_saturation_near_2_pow_23():
    avail, total, alive, demands, counts = saturation_problem()
    np_a, np_v = _np_refs(avail, total, alive, demands, counts)
    assert (np_a.sum(axis=1) > 2**23 - 2**21).any()  # a prefix passed 2**23
    for p in (1, 2, 4, 8):
        th_a, th_v = _port(p, avail, total, alive, demands, counts)
        np.testing.assert_array_equal(th_a, np_a)
        np.testing.assert_array_equal(th_v, np_v)
        jx_a, jx_v = _jax(p, avail, total, alive, demands, counts)
        np.testing.assert_array_equal(th_a, jx_a)
        np.testing.assert_array_equal(th_v, jx_v)


def straddle_problem(N=8192):
    """One bucket holds every node under the threshold (a threshold cap of
    3 each: 2 CPUs to the threshold, plus one) and every seventh node sits
    above it (the equal share); the first class's count ends inside bucket
    0 at its 5 001st node, which lies past block 0 for p >= 2; the second
    class spills over the higher buckets."""
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 4.0
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[3::101] = False
    avail = total.copy()
    avail[::7, 3] = 16.0  # 75 % used: at or above the threshold
    avail *= alive[:, None]
    demands = np.zeros((2, R), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 1.0
    demands[1, 3] = 2.0
    counts = np.array([3 * 5000 + 1, 6000], np.int32)
    return avail, total, alive, demands, counts


def _straddle_node(avail, total, alive, counts):
    """The node in which the first pass of class 0 ends, in the fill's
    (bucket, node) order: bucket 0's nodes in node order, a cap of 3 each."""
    under = np.flatnonzero(alive & (avail[:, 3] > 32.0))
    return int(under[(int(counts[0]) - 1) // 3])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_straddle_in_a_later_block_equals_kernel_np(p):
    """The bucket that straddles the count lies in a block other than 0
    (for p >= 2): the plain K7 equals kernel_np there (the card holds the
    kernel to the same problem in the `cuda` test below)."""
    avail, total, alive, demands, counts = straddle_problem()
    n = _straddle_node(avail, total, alive, counts)
    if p > 1:
        assert n // (len(total) // p) > 0
    th_a, th_v = _port(p, avail, total, alive, demands, counts)
    np_a, np_v = _np_refs(avail, total, alive, demands, counts)
    np.testing.assert_array_equal(th_a, np_a)
    np.testing.assert_array_equal(th_v, np_v)
    assert th_a[0, n] == 1 and th_a[0, :n].sum() == 3 * 5000 and th_a[1].sum() == 6000


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_k7_layout_is_k1_plan_at_p_blocks(p):
    """K7 launches K1's kernel on p blocks in k1_plan's layout: with N
    divisible by p a block's nodes are one shard, and the row form is the
    one k1_plan picks, which the C entry point computes the same way (held
    to it on the card): the rows in shared memory at the stream's 10 000
    nodes for p = 8 and in global memory below, in global memory at 40 000
    nodes for every p."""
    for n in (10_000, 40_000, 8192, 128):
        plan = KT.k1_plan(n, R, p)
        assert plan.cluster == p and plan.nodes_per_block * p == n
        assert plan.rows_in_smem == (KT.k1_block_bytes(n // p, R, True) <= KT.K1_SMEM_BUDGET)
        assert (plan.scratch_words == 0) == plan.rows_in_smem
        if not plan.rows_in_smem:
            assert plan.scratch_words == p * KT.k1_block_bytes(n // p, R, False) // 4
    assert KT.k1_plan(10_000, R, p).rows_in_smem == (p == 8)
    assert not KT.k1_plan(40_000, R, p).rows_in_smem
    assert KT.k1_plan(8192, R, p).rows_in_smem == (p == 8)
    src = KT._build.LIBRARY.src.read_text()
    assert f"constexpr int kK7ThreadsRows = {KS.K7_THREADS_ROWS};" in src
    assert f"constexpr int kK7ThreadsGlobal = {KS.K7_THREADS_GLOBAL};" in src
    assert KS.k7_threads(10_000, R, p) == (512 if p == 8 else 1024)
    assert f"constexpr size_t kK1SmemBudget = {KT.K1_SMEM_BUDGET // 1024} * 1024;" in src


def _args(N=16, C=3):
    avail, total, alive, demands, counts = dryrun_problem(1)
    return [T(x) for x in (avail[:N], total[:N], alive[:N], demands[:C], counts[:C])]


@pytest.mark.parametrize("case,match", [
    ("counts_2_pow_23", "2\\*\\*23"),
    ("N_not_divisible", "divide"),
    ("shards_3", "shards=3"),
    ("shards_16", "shards=16"),
    ("shards_0", "shards=0"),
    ("total_shape", "shape mismatch"),
    ("alive_shape", "shape mismatch"),
    ("counts_shape", "shape mismatch"),
    ("demands_width", "shape mismatch"),
    ("float_counts", "integer"),
])
def test_wrapper_raises(case, match):
    a = _args()
    shards = 8
    if case == "counts_2_pow_23":
        a[4] = torch.tensor([1, 2**23, 3], dtype=torch.int32)
    elif case == "N_not_divisible":
        a = _args(N=12)
    elif case.startswith("shards_"):
        shards = int(case.split("_")[1])
    elif case == "total_shape":
        a[1] = a[1][:8]
    elif case == "alive_shape":
        a[2] = a[2][:8]
    elif case == "counts_shape":
        a[4] = a[4][:2]
    elif case == "demands_width":
        a[3] = a[3][:, :8]
    elif case == "float_counts":
        a[4] = a[4].to(torch.float32)
    with pytest.raises(ValueError, match=match):
        KS.schedule_classes_sharded(*a, shards=shards)
    if case.startswith("shards_"):
        with pytest.raises(ValueError, match=match):
            KS.make_sharded_scheduler(shards, device="cpu")


def test_make_sharded_scheduler_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        KS.make_sharded_scheduler(8)
    KS.make_sharded_scheduler(8, device="cpu")


def test_exported_and_cpu_runs_count_no_launch():
    from ray_tpu_torch.sched import make_sharded_scheduler

    assert make_sharded_scheduler is KS.make_sharded_scheduler
    KS.reset_launch_counts()
    a = _args()
    before = a[0].clone()
    KS.schedule_classes_sharded(*a, shards=4)
    assert torch.equal(a[0], before)  # avail is not modified
    assert KS.launch_counts() == {"schedule_classes_sharded": 0, "rank_pass": 0}
    assert "schedule_classes_sharded" not in KT.KERNELS


def _gloo_rank(rank, world, init_file, data_file):
    """One rank of the gloo test: its block through make_sharded_scheduler
    (group), both results whole, equal to the in-process ones."""
    torch.set_num_threads(1)  # four ranks share the machine's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    try:
        d = np.load(data_file)
        fn = KS.make_sharded_scheduler(dist.group.WORLD, device="cpu")
        args = [d[k] for k in ("avail", "total", "alive", "demands", "counts")]
        a, v = fn(*args)
        np.testing.assert_array_equal(a.numpy(), d["assigned"])
        np.testing.assert_array_equal(v.numpy(), d["new_avail"])
        # a second round on the carried availability, the counts halved
        a2, _ = fn(v, *args[1:4], args[4] // 2)
        np.testing.assert_array_equal(a2.numpy(), d["assigned2"])
        if rank == 0:  # the CUDA group form (K7r) builds its kernels: here, without
            # nvcc, it stops at the build with the build's own error
            torch.cuda.is_available = lambda: True
            with pytest.raises(RuntimeError, match="nvcc") as err:
                KS.make_sharded_scheduler(dist.group.WORLD, device="cuda:0")
            assert not isinstance(err.value, NotImplementedError)
    finally:
        dist.destroy_process_group()


def test_across_four_gloo_ranks_equals_in_process(tmp_path):
    total, alive, demands, counts = _problem(np.random.default_rng(5), 64 * 4, 24)
    avail = (total * alive[:, None]).astype(np.float32)
    a, v = _port(4, avail, total, alive, demands, counts)
    a2, _ = _port(4, v, total, alive, demands, counts // 2)
    np.testing.assert_array_equal(a, _np_refs(avail, total, alive, demands, counts)[0])
    data = tmp_path / "problem.npz"
    np.savez(data, avail=avail, total=total, alive=alive, demands=demands, counts=counts,
             assigned=a, new_avail=v, assigned2=a2)
    ctx = mp.start_processes(_gloo_rank, args=(4, str(tmp_path / "rendezvous"), str(data)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    try:
        while not ctx.join(timeout=0.1):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


@pytest.mark.cuda
def test_k7_equals_plain_k1_and_numpy_on_card():
    """On the card: K7 for every shard count against its plain version, K1
    and kernel_np, exactly, over seeds and at 10k nodes x 256 classes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    problems = []
    for seed in range(4):
        total, alive, demands, counts = _problem(np.random.default_rng(seed), 2048, 48)
        problems.append(((total * alive[:, None]).astype(np.float32), total, alive,
                         demands, counts))
    problems += [bench_problem(), dryrun_problem(), saturation_problem()]
    total, alive, demands, counts = _problem(np.random.default_rng(9), 10_000, 256,
                                             dense=True)
    problems.append((total * alive[:, None], total, alive, demands, counts * 40))
    for avail, total, alive, demands, counts in problems:
        args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
        k1_a, k1_v = KT.schedule_classes(*args)
        np_a, np_v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        for p in KS.SHARDS:
            a_k, v_k = KS.schedule_classes_sharded(*args, shards=p)
            a_p, v_p = KS._schedule_classes_sharded_plain(*args, shards=p)
            assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p), p
            assert torch.equal(a_k, k1_a) and torch.equal(v_k, k1_v), p
            np.testing.assert_array_equal(a_k.cpu().numpy(), np_a)
            np.testing.assert_array_equal(v_k.cpu().numpy(), np_v)


def _big_problem(seed=4, N=40_000, C=32):
    """40 000 nodes: K7's rows in global memory at every shard count."""
    total, alive, demands, counts = _problem(np.random.default_rng(seed), N, C, dense=True)
    return (total * alive[:, None]).astype(np.float32), total, alive, demands, counts * 60


@pytest.mark.cuda
def test_cuda_k7_global_rows_and_a_later_straddle_equal_plain_k1_and_numpy():
    """On the card: K7 (K1's kernel on p blocks) for every shard count on a
    40 000-node problem (the rows in global memory at every p) and on
    straddle_problem (the bucket that straddles the count in a block other
    than 0), equal to its plain version, K1 and kernel_np, two launches
    bit-equal; the C entry point's scratch words those of k1_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    lib = KT._build.load()
    for avail, total, alive, demands, counts in (_big_problem(), straddle_problem()):
        N = len(total)
        args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
        k1_a, k1_v = KT.schedule_classes(*args)
        np_a, np_v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        for p in KS.SHARDS:
            assert lib.sched_k1_scratch_words(N, R, p) == KT.k1_plan(N, R, p).scratch_words
            a_k, v_k = KS.schedule_classes_sharded(*args, shards=p)
            a_2, v_2 = KS.schedule_classes_sharded(*args, shards=p)
            a_p, v_p = KS._schedule_classes_sharded_plain(*args, shards=p)
            assert torch.equal(a_k, a_2) and torch.equal(v_k, v_2), (N, p)
            assert torch.equal(a_k, a_p) and torch.equal(v_k, v_p), (N, p)
            assert torch.equal(a_k, k1_a) and torch.equal(v_k, k1_v), (N, p)
            np.testing.assert_array_equal(a_k.cpu().numpy(), np_a)
            np.testing.assert_array_equal(v_k.cpu().numpy(), np_v)
        assert np_a.sum() > 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k7_one_block_exchanges_with_itself():
    """On the card, K7 at p = 1: every st.async of both exchanges goes to
    the block itself and must complete its own mbarrier's byte count, pass
    after pass (a wait that never completes traps, and the launch fails).
    Many passes a class, rows in shared and in global memory, equal to K1
    and kernel_np."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    total, alive, demands, counts = _problem(np.random.default_rng(21), 1024, 64)
    small = ((total * alive[:, None]).astype(np.float32), total, alive, demands, counts * 30)
    for avail, total, alive, demands, counts in (small, straddle_problem(), _big_problem(5)):
        assert KT.k1_plan(len(total), R, 1).rows_in_smem == (len(total) == 1024)
        args = [T(x).to(dev) for x in (avail, total, alive, demands, counts)]
        a_k, v_k = KS.schedule_classes_sharded(*args, shards=1)
        torch.cuda.synchronize()
        k1_a, k1_v = KT.schedule_classes(*args)
        assert torch.equal(a_k, k1_a) and torch.equal(v_k, k1_v)
        np_a, _ = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        np.testing.assert_array_equal(a_k.cpu().numpy(), np_a)


# ------------------------------------------------------------------ K7r


def _k7r_problems():
    total, alive, demands, counts = _problem(np.random.default_rng(31), 256, 24)
    dense = ((total * alive[:, None]).astype(np.float32), total, alive, demands, counts * 20)
    neg = dense[0].copy()
    neg[3, 3] = -5.0  # a negative entry, cleared by the round's first placing pass
    return {"dense": dense, "negative_cleared": (neg,) + dense[1:],
            "bench": bench_problem(), "dryrun": dryrun_problem(),
            "straddle": straddle_problem(4096), "saturation": saturation_problem()}


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["dense", "negative_cleared", "bench", "dryrun", "straddle",
                                  "saturation"])
def test_k7r_steps_plain_pass_by_pass_equal_sharded_body(name, p):
    """K7r's three steps' plain versions (terms, caps, fill with the next
    pass's terms) in _rank_body's loop, p shards in one process, against
    _sharded_body: the same (class, pass, feasible count, placed count) at
    every pass, and the same assignments and availability."""
    avail, total, alive, demands, counts = _k7r_problems()[name]
    N = len(total)
    sh = lambda x: T(x).reshape(p, N // p, *x.shape[1:])  # noqa: E731
    args = (sh(avail), sh(total), sh(alive), T(demands), T(counts), 0.5, KT.MAX_PASSES,
            torch.arange(p))
    want_trace, got_trace = [], []
    a_ref, v_ref = KS._sharded_body(*args, lambda x: int(x.sum()), lambda t: t,
                                    trace=want_trace)
    KS.reset_launch_counts()
    a, v = KS._rank_body(*args, lambda x: x.sum(dim=0).tolist(), lambda t: t,
                         trace=got_trace)
    assert got_trace == want_trace
    assert torch.equal(a, a_ref) and torch.equal(v, v_ref)
    assert KS.launch_counts()["rank_pass"] == 0  # plain versions on the CPU
    assert torch.equal(sh(avail), T(avail).reshape(p, N // p, R))  # not modified
    if name == "dense":  # classes that take more than one pass
        assert any(t[1] > 0 for t in want_trace)


def test_k7r_modes_match_the_source():
    src = KT._build.LIBRARY.src.read_text()
    assert (f"constexpr int kK7rTerms = {KS.TERMS}, kK7rCaps = {KS.CAPS}, "
            f"kK7rFill = {KS.FILL};") in src


def _k7r_steps_on_card_and_cpu(prob, dev):
    """_rank_loop over one shard, every step on the card (K7r) and on the
    CPU (its plain version) from the same state; each step's output must
    be equal. Returns the card's (assigned, avail)."""
    avail, total, alive, demands, counts = prob
    states = [KS.RankRound(T(avail)[None].to(d), T(total)[None].to(d), T(alive)[None].to(d),
                           T(demands).to(d), 0.5) for d in (dev, torch.device("cpu"))]

    def step(mode, c, all_tot=None, **kw):  # every state gets its tensors on its device
        outs = [KS.rank_pass(mode, st, c, shard_index=[0], **kw, all_tot=None if all_tot
                             is None else all_tot.to(st.dev)) for st in states]
        assert torch.equal(outs[0].cpu(), outs[1]), (mode, c, kw)
        return outs[1]

    KS._rank_loop(step, counts, KT.MAX_PASSES, lambda x: x.sum(dim=0).tolist(), lambda t: t)
    for a, b in zip((states[0].assigned, states[0].avail), (states[1].assigned, states[1].avail)):
        assert torch.equal(a.cpu(), b)
    return states[0].assigned[:, 0], states[0].avail[0]


@pytest.mark.cuda
def test_cuda_k7r_every_step_equals_plain_k1_and_numpy():
    """On the card, one process: every K7r step (terms, caps, fill) equal to
    its plain version on the CPU from the same state, pass after pass, on
    the negative-availability problem, the straddle problem and problems
    with many passes a class; the round equal to K1 and kernel_np."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    dev = torch.device("cuda")
    probs = list(_k7r_problems().values())
    total, alive, demands, counts = _problem(np.random.default_rng(9), 10_000, 256, dense=True)
    probs.append((total * alive[:, None], total, alive, demands, counts * 40))
    for avail, total, alive, demands, counts in probs:
        avail = np.asarray(avail, np.float32)
        a, v = _k7r_steps_on_card_and_cpu((avail, total, alive, demands, counts), dev)
        k1_a, k1_v = KT.schedule_classes(*(T(x).to(dev) for x in (avail, total, alive,
                                                                  demands, counts)))
        assert torch.equal(a, k1_a) and torch.equal(v, k1_v)
        np_a, np_v = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        np.testing.assert_array_equal(a.cpu().numpy(), np_a)
        np.testing.assert_array_equal(v.cpu().numpy(), np_v)


def _cuda_rank(rank, world, init_file, out_file):
    """One rank of the 2-rank K7r test on one card: make_sharded_scheduler
    (group) on CUDA tensors, each problem's results saved by rank 0."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    try:
        fn = KS.make_sharded_scheduler(dist.group.WORLD)
        out = {}
        for name, prob in (("negative", _negative_problem()), ("straddle", straddle_problem())):
            KS.reset_launch_counts()
            a, v = fn(*prob)
            out[f"{name}_a"], out[f"{name}_v"] = a.cpu().numpy(), v.cpu().numpy()
            out[f"{name}_launches"] = np.int64(KS.launch_counts()["rank_pass"])
        np.savez(f"{out_file}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _negative_problem():
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


@pytest.mark.cuda
def test_cuda_k7r_on_two_gloo_ranks_on_one_card_equals_k1_and_numpy(tmp_path):
    """On the card: 2 gloo ranks on the one card, each its block through
    K7r, on the negative-availability problem (nothing placed, the negative
    entry kept) and on the straddle problem (the count ends in rank 1's
    block), equal to K1 and kernel_np; both ranks get the same whole
    results."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card (see README)")
    KT._build.load()  # build once, before the ranks load it
    out = str(tmp_path / "res")
    ctx = mp.start_processes(_cuda_rank, args=(2, str(tmp_path / "rendezvous"), out),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    try:
        while not ctx.join(timeout=0.1):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    res = [np.load(f"{out}.{r}.npz") for r in range(2)]
    dev = torch.device("cuda")
    for name, prob in (("negative", _negative_problem()), ("straddle", straddle_problem())):
        k1_a, k1_v = KT.schedule_classes(*(T(x).to(dev) for x in prob))
        np_a, np_v = kernel_np.schedule_classes(prob[0].copy(), *prob[1:])
        for r in range(2):
            np.testing.assert_array_equal(res[r][f"{name}_a"], k1_a.cpu().numpy())
            np.testing.assert_array_equal(res[r][f"{name}_v"], k1_v.cpu().numpy())
            np.testing.assert_array_equal(res[r][f"{name}_a"], np_a)
            np.testing.assert_array_equal(res[r][f"{name}_v"], np_v)
            assert res[r][f"{name}_launches"] > 0
        n = _straddle_node(*prob[:3], prob[4]) if name == "straddle" else 0
        if name == "straddle":
            assert n >= len(prob[1]) // 2  # in rank 1's block
    assert res[0]["negative_v"][2, 3] == -3.0
