"""Single-node microbenchmark (reference: python/ray/_private/ray_perf.py,
the `ray microbenchmark` CLI): tasks/s, actor calls/s, put/get throughput.
These are the canonical quick numbers SURVEY §6 tracks."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


def run_microbenchmark(address=None, quick: bool = False) -> Dict[str, float]:
    import ray_tpu_torch

    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    results: Dict[str, float] = {}

    @ray_tpu_torch.remote
    def noop():
        return None

    # warmup
    ray_tpu_torch.get([noop.remote() for _ in range(10)])

    n_tasks = 200 if quick else 2000
    t0 = time.perf_counter()
    ray_tpu_torch.get([noop.remote() for _ in range(n_tasks)])
    dt = time.perf_counter() - t0
    results["tasks_per_second"] = n_tasks / dt

    @ray_tpu_torch.remote
    class A:
        def m(self):
            return None

    a = A.remote()
    ray_tpu_torch.get(a.m.remote())  # warmup/creation
    n_calls = 500 if quick else 5000
    t0 = time.perf_counter()
    ray_tpu_torch.get([a.m.remote() for _ in range(n_calls)])
    dt = time.perf_counter() - t0
    results["actor_calls_per_second"] = n_calls / dt

    mb = 8 if quick else 64
    arr = np.zeros(mb * 1024 * 1024 // 8, dtype=np.float64)
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    dt = time.perf_counter() - t0
    # honest labels: in local mode put/get is a MemoryStore dict round-trip
    # (no serialization, no shm) — a cache-speed number, not data-plane
    # bandwidth. Cluster mode measures the real pack->shm->unpack path.
    key = "put_get_gbps_shm" if address else "put_get_gbps_memstore"
    results[key] = (arr.nbytes * 2 / dt) / 1e9
    assert out.nbytes == arr.nbytes

    if address:
        # worker-side zero-copy consumption: a task reading a large shm
        # object through the pinned-view path
        @ray_tpu_torch.remote
        def consume(a):
            return a.nbytes

        t0 = time.perf_counter()
        nbytes = ray_tpu_torch.get(consume.remote(ref))
        dt = time.perf_counter() - t0
        results["arg_view_gbps"] = (nbytes / dt) / 1e9

    return results


def main(address=None, quick=False):
    results = run_microbenchmark(address, quick)
    print(f"{'benchmark':<28}{'value':>14}")
    for k, v in results.items():
        print(f"{k:<28}{v:>14.1f}")
    return results


if __name__ == "__main__":
    main()
