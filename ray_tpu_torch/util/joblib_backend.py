"""joblib parallel backend over ray_tpu_torch tasks.

Reference: python/ray/util/joblib/ (register_ray + RayBackend) — lets
scikit-learn-style `Parallel(n_jobs=...)` fan work out to the cluster by
setting `parallel_backend("ray_tpu_torch")`.
"""

from __future__ import annotations

from typing import Any, Callable, List


def register_ray_tpu() -> None:
    """Register the 'ray_tpu_torch' joblib backend (reference: register_ray)."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)


try:
    from joblib._parallel_backends import ThreadingBackend as _Base
except Exception:  # pragma: no cover - joblib internals moved
    _Base = object


class RayTpuBackend(_Base):
    """Each joblib batch executes as one remote task; results resolve
    through ray_tpu_torch.get. Builds on ThreadingBackend so joblib's own
    dispatch/retrieval machinery drives completion — the threads only
    block in ray_tpu_torch.get, the work runs in cluster workers."""

    supports_timeout = True

    def effective_n_jobs(self, n_jobs: int) -> int:
        import ray_tpu_torch

        if n_jobs == -1:
            try:
                return max(int(ray_tpu_torch.cluster_resources().get("CPU", 1)), 1)
            except Exception:  # noqa: BLE001
                return 1
        return max(n_jobs, 1)

    def apply_async(self, func: Callable, callback=None):
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def _run_batch(f) -> List[Any]:
            return f()

        ref = _run_batch.remote(func)

        class _AsyncResult:
            def get(self, timeout: float = None):
                return ray_tpu_torch.get(ref, timeout=timeout)

        res = _AsyncResult()
        if callback is not None:
            # resolve on a pool thread so apply_async stays non-blocking
            super_apply = super().apply_async

            def _wait_and_call():
                out = res.get()
                return out

            return super_apply(_wait_and_call, callback)
        return res
