"""ray_tpu_torch's autoscaler (v1) against ray_tpu's: the launch decision
on the reference's four cases and on seeded random problems, equal; one
scale-up-and-down over a live port cluster (the reference marks its own
slow; this one keeps its own 30 s deadline); and K1's plain version
against kernel_np at every spread threshold the autoscaler and the users'
``scheduler_spread_threshold`` reach, on phase 1's problems of
chip_smoke.py and config_5's first round with 20 % of the fleet held back.

The GCS's policy is torch_cuda with scheduler_device "cpu" (the plain
PyTorch versions of the kernels)."""

import subprocess
import time

import numpy as np
import pytest
import torch

from ray_tpu.autoscaler import NodeTypeConfig as RefNodeTypeConfig
from ray_tpu.autoscaler.autoscaler import get_nodes_to_launch as ref_get_nodes_to_launch
from ray_tpu.sched import kernel_np as ref_kernel_np
from ray_tpu.sched.resources import ResourceSpace as RefResourceSpace
import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, FakeNodeProvider, NodeTypeConfig
from ray_tpu_torch.autoscaler.autoscaler import get_nodes_to_launch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.sched import kernel_np
from ray_tpu_torch.sched import kernel_torch as KT
from ray_tpu_torch.sched.resources import ResourceSpace

import chip_smoke as CS

CPU = {"scheduler_device": "cpu"}
THRESHOLDS = (0.0, 0.25, 0.5, 0.75, 1.0)


# ------------------------------------------------------- the launch decision


def _decide(nodes, demand, types, current):
    """The same problem, given by resource dicts, through both packages;
    each builds its matrices with its own ResourceSpace."""
    out = []
    for space, fn, NT in ((ResourceSpace(), get_nodes_to_launch, NodeTypeConfig),
                          (RefResourceSpace(), ref_get_nodes_to_launch,
                           RefNodeTypeConfig)):
        R = space.max_resources
        if nodes:
            avail = np.stack([space.vector(a) for a, _ in nodes])
            total = np.stack([space.vector(t) for _, t in nodes])
        else:
            avail = np.zeros((0, R), np.float32)
            total = np.zeros((0, R), np.float32)
        alive = np.ones(len(nodes), bool)
        out.append(fn(space, avail, total, alive, demand,
                      [NT(*t) for t in types], dict(current)))
    return out


REFERENCE_CASES = {
    # tests/test_autoscaler.py:29-85, with the reference's own expectations
    "simple_demand": ([], [{"resources": {"CPU": 1}, "count": 10}],
                      [("cpu4", {"CPU": 4}, 0, 10)], {}, {"cpu4": 3}),
    "max_workers": ([], [{"resources": {"CPU": 1}, "count": 100}],
                    [("cpu4", {"CPU": 4}, 0, 2)], {}, {"cpu4": 2}),
    "matching_type": ([], [{"resources": {"TPU": 1, "CPU": 1}, "count": 2}],
                      [("cpu-only", {"CPU": 16}, 0, 5),
                       ("tpu-host", {"CPU": 8, "TPU": 4}, 0, 5)], {},
                      {"tpu-host": 1}),
    "existing_fits": ([({"CPU": 8}, {"CPU": 8})],
                      [{"resources": {"CPU": 1}, "count": 4}],
                      [("cpu4", {"CPU": 4}, 0, 10)], {}, {}),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_launch_decision_reference_cases_equal_ray_tpu(case):
    nodes, demand, types, current, expected = REFERENCE_CASES[case]
    port, ref = _decide(nodes, demand, types, current)
    assert port == ref == expected


def _random_launch_problem(seed):
    """Nodes 0-64 (some partly used, sometimes enough to fit the demand),
    classes 1-16, two or three node types with mixed max_workers and
    current counts."""
    rng = np.random.default_rng(seed)
    names = ["CPU", "memory", "GPU", "accel"]
    nodes = []
    for _ in range(int(rng.integers(0, 65))):
        total = {"CPU": float(rng.integers(1, 33)),
                 "memory": float(rng.integers(4, 129))}
        if rng.random() < 0.3:
            total["GPU"] = float(rng.integers(1, 9))
        avail = {k: float(np.floor(v * rng.uniform(0.0, 1.0 if seed % 3 else 0.2)))
                 if rng.random() < 0.7 else v for k, v in total.items()}
        nodes.append((avail, total))
    demand = []
    for _ in range(int(rng.integers(1, 17))):
        res = {"CPU": float(rng.integers(1, 5))}
        for k in names[1:]:
            if rng.random() < 0.25:
                res[k] = float(rng.integers(1, 5))
        demand.append({"resources": res, "count": int(rng.integers(1, 40))})
    types = []
    for i in range(int(rng.integers(2, 4))):
        res = {"CPU": float(rng.choice([2, 4, 8, 16])),
               "memory": float(rng.choice([16, 64, 128]))}
        if rng.random() < 0.5:
            res["GPU"] = float(rng.choice([1, 4, 8]))
        if rng.random() < 0.3:
            res["accel"] = float(rng.choice([1, 4]))
        types.append((f"t{i}", res, 0, int(rng.integers(0, 30))))
    current = {t[0]: int(rng.integers(0, 5)) for t in types if rng.random() < 0.5}
    return nodes, demand, types, current


@pytest.mark.parametrize("block", range(4))
def test_launch_decision_random_problems_equal_ray_tpu(block):
    """60 seeded problems in four cases of 15; launches, no launches and
    capped types all occur."""
    kinds = set()
    for seed in range(block * 15, block * 15 + 15):
        port, ref = _decide(*_random_launch_problem(seed))
        assert port == ref, seed
        kinds.add("none" if not port else "some")
    assert kinds == {"none", "some"} or block > 0


# ------------------------------------------------- K1 at every threshold


def _threshold_problems():
    """chip_smoke.py phase 1's K1 problems that the plain version runs at
    CPU speed (the layout edges at 10 007 and 40 000 nodes concern the
    card's kernel only), the negative-availability edge among them, and
    config_5's first round: the stream fleet with its last 20 % held
    back, a tenth of each class's count."""
    return {
        "golden": CS.golden_problem(),
        "random1": CS.random_problem(1),
        "random2": CS.random_problem(2),
        "r5": CS.narrow_problem(13, N=600),
        "counts_near_2_23": CS.saturation_problem(200),
        "negative": CS.negative_problem(),
        "config5_first_round": CS.stream_first_round(),
    }


PROBLEMS = _threshold_problems()


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_k1_plain_equals_kernel_np_at_every_spread_threshold(name, thr):
    """0 differing cells in `assigned` and `avail` bit-equal, against the
    port's kernel_np and the reference's (the stated authority)."""
    avail, total, alive, demands, counts = PROBLEMS[name]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    a_p, v_p = KT.schedule_classes(T(avail), T(total), T(alive), T(demands), T(counts),
                                   spread_threshold=thr)
    a_n, v_n = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts,
                                          spread_threshold=thr)
    a_r, v_r = ref_kernel_np.schedule_classes(avail.copy(), total, alive, demands,
                                              counts, spread_threshold=thr)
    np.testing.assert_array_equal(a_n, a_r)
    np.testing.assert_array_equal(v_n, v_r)
    assert int((a_p.numpy() != a_n).sum()) == 0
    assert v_p.numpy().tobytes() == v_n.tobytes()
    if name != "negative":
        assert a_n.sum() > 0


def test_thresholds_reach_the_bucket_edges():
    """At 1.0 the denominator is 1e-6: a node at util exactly 1 takes
    bucket 1, one past it (negative availability) bucket 63; at 0.0 every
    live node is at or over the threshold, so `under` is empty."""
    util = np.array([0.999999, 1.0, 1.5, 0.0, -0.25], np.float32)
    assert kernel_np._score_bucket(util, 1.0).tolist() == [0, 1, 63, 0, 0]
    assert kernel_np._score_bucket(util, 0.0).tolist() == [62, 63, 63, 1, 0]
    avail, total, alive, demands, counts = PROBLEMS["config5_first_round"]
    util = kernel_np.critical_util(avail, total)
    assert not (util[alive] < 0.0).any()


# ---------------------------------------------------------- end to end


def _procs(c):
    return [w.proc for d in c.daemons for w in list(d.workers.values())
            if w.proc is not None]


def test_autoscaler_scales_up_and_down_on_the_port_cluster():
    """No node at the start: demand brings cpu2 nodes up (never more than
    max_workers), the tasks finish, and the idle nodes are terminated,
    each daemon's worker processes with them, inside 30 s."""
    t0 = time.time()
    c = Cluster(config=Config(CPU))
    provider = FakeNodeProvider((c.host, c.gcs.port), config=c.config)
    scaler = Autoscaler(
        (c.host, c.gcs.port), provider,
        [NodeTypeConfig("cpu2", {"CPU": 2, "memory": 2**30}, max_workers=3)],
        idle_timeout_s=1.0, update_interval_s=0.2,
    ).start()
    procs = []
    launched = set()
    try:
        ray_tpu_torch.init(address=c.address)

        @ray_tpu_torch.remote(num_cpus=1)
        def work(i):
            time.sleep(0.3)
            return i

        refs = [work.remote(i) for i in range(6)]
        assert sorted(ray_tpu_torch.get(refs, timeout=25)) == list(range(6))
        launched = set(scaler._launched) | set(provider.non_terminated_nodes())
        assert 1 <= len(launched) <= 3
        for d in provider._daemons.values():
            procs += [w.proc for w in d.workers.values() if w.proc is not None]
        def alive_in_gcs():
            nodes = c.gcs.rpc_autoscaler_state({}, None)["nodes"]
            return [nid for nid, n in nodes.items() if nid in launched and n["alive"]]

        # the GCS learns of a terminated daemon a little after the provider
        while time.time() - t0 < 30 and (provider.non_terminated_nodes() or alive_in_gcs()):
            time.sleep(0.2)
        assert provider.non_terminated_nodes() == []
        assert alive_in_gcs() == []
    finally:
        ray_tpu_torch.shutdown()
        scaler.shutdown()
        provider.shutdown()
        c.shutdown()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
    assert time.time() - t0 < 30
