"""ray_tpu_torch's local runtime through its user entry points, with every
scheduling round on the torch_cuda policy (scheduler_device="cpu": the
plain PyTorch versions of the kernels), held against ray_tpu's runtime on
the same workload."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

TORCH_CPU = {"scheduling_policy": "torch_cuda", "scheduler_device": "cpu",
             "jax_policy_min_cells": 0}


def _workload(rt, seed=0):
    """Tasks with dependencies, an actor, a multi-resource class and an
    infeasible task; returns what a caller observes."""
    rng = np.random.default_rng(seed)
    xs = [int(v) for v in rng.integers(0, 100, 40)]

    @rt.remote
    def square(x):
        return x * x

    @rt.remote(num_cpus=2)
    def add(a, b):
        return a + b

    @rt.remote(num_cpus=1, memory=1024)
    def tagged(x):
        return ("m", x)

    @rt.remote
    class Acc:
        def __init__(self, start):
            self.total = start

        def add(self, v):
            self.total += v
            return self.total

    sq = [square.remote(x) for x in xs]
    pairs = [add.remote(sq[i], sq[i + 1]) for i in range(0, len(sq), 2)]
    acc = Acc.remote(5)
    running = [acc.add.remote(v) for v in range(10)]
    out = {
        "pairs": rt.get(pairs, timeout=60),
        "tagged": rt.get([tagged.remote(i) for i in range(6)], timeout=60),
        "acc": rt.get(running, timeout=60),
    }
    big = square.options(num_cpus=10_000).remote(3)  # never feasible
    with pytest.raises(rt.GetTimeoutError):
        rt.get(big, timeout=0.5)
    out["resources"] = rt.cluster_resources()
    return out


def test_local_runtime_equals_ray_tpu_on_torch_cuda_policy():
    ray_tpu_torch.init(num_cpus=4, _system_config=TORCH_CPU)
    try:
        rt_obj = ray_tpu_torch.core.api._runtime
        assert rt_obj.policy.name == "torch_cuda"
        assert rt_obj.policy.device.type == "cpu"
        got = _workload(ray_tpu_torch)
        # the rounds went through the device-side scheduler (plain K1 on CPU)
        assert rt_obj.policy._torch is not None
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        want = _workload(ray_tpu)
    finally:
        ray_tpu.shutdown()
    assert got == want
    assert got["acc"] == [5 + sum(range(k + 1)) for k in range(10)]


def test_default_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ray_tpu_torch.init(num_cpus=2, _system_config={
            "scheduling_policy": "torch_cuda"})
    assert not ray_tpu_torch.is_initialized()
    # the default policy needs no device at all
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.put(7)) == 7
    finally:
        ray_tpu_torch.shutdown()


def test_cluster_mode_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ray_tpu_torch.init(address="tcp://localhost:1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ray_tpu_torch.init(cluster=True)
    assert not ray_tpu_torch.is_initialized()


def test_strict_pack_batch_torch_backend_equals_numpy():
    from ray_tpu_torch.sched.bundles import strict_pack_batch

    rng = np.random.default_rng(4)
    N, P, R = 32, 20, 16
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(4, 33, N)
    total[:, 3] = rng.integers(8, 65, N)
    alive = np.ones(N, bool)
    pg = np.zeros((P, R), np.float32)
    pg[:, 0] = rng.integers(1, 9, P)
    pg[:, 3] = rng.integers(0, 9, P)
    n_np, a_np = strict_pack_batch(total.copy(), total, alive, pg, backend="numpy")
    n_th, a_th = strict_pack_batch(total.copy(), total, alive, pg, backend="torch",
                                   device="cpu")
    np.testing.assert_array_equal(n_th, n_np)
    np.testing.assert_allclose(a_th, a_np, atol=1e-4)
