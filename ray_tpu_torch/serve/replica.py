"""Replica actor: hosts one copy of a deployment.

Reference: python/ray/serve/_private/replica.py (UserCallableWrapper /
RayServeReplica — counts ongoing requests, calls user code, supports
function and class deployments, reconfigure via user_config).

The replica is an ASYNC actor (handle_request is a coroutine), matching
the reference's asyncio replica: ``async def`` user handlers interleave
on the replica's event loop (in-replica concurrency without threads),
while sync handlers are pushed to the loop's default executor so a
blocking model call never stalls the loop — the reference's
run-sync-in-threadpool behavior.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.util import metrics as _metrics

# observability (ray_tpu_torch.obs): replica queue depth, exported on the same
# side-thread cadence as the autoscaling stats push (never on the
# request path) and tagged per deployment
_M_REPLICA_ONGOING = _metrics.Gauge(
    "ray_tpu_serve_replica_ongoing",
    "in-flight requests on serve replicas (summed per deployment)",
    tag_keys=("deployment",),
)


@ray_tpu_torch.remote
class ServeReplica:
    def __init__(self, func_or_class, init_args, init_kwargs,
                 user_config: Optional[Dict] = None,
                 identity: Optional[tuple] = None,
                 metrics_period_s: float = 0.2,
                 max_ongoing_requests: int = 32):
        # No lock around these counters: handle_request and stats() both
        # execute on the actor's event-loop thread (async-actor contract),
        # so mutation is single-threaded; the metrics thread only does a
        # GIL-atomic int read. A threading.Lock here would block the loop
        # whenever the metrics thread held it (found by ray-lint
        # blocking-in-async).
        self._ongoing = 0
        self._total = 0
        # requests pending/executing on the fast-path loop (single writer:
        # the ReplicaFastPath drain thread; readers do GIL-atomic loads) —
        # folded into the autoscaling stats push so channel-plane load
        # drives the same scale signal as task-layer load
        self._fp_ongoing = 0
        # sync handlers run here, NOT on the loop's default executor: the
        # default caps at min(32, cpus+4) threads, which would silently
        # cap sync concurrency below max_ongoing_requests (and starve
        # @serve.batch rendezvous larger than the cap)
        from concurrent.futures import ThreadPoolExecutor

        self._sync_pool = ThreadPoolExecutor(
            max_workers=max(int(max_ongoing_requests), 2),
            thread_name_prefix="serve-sync",
        )
        if inspect.isclass(func_or_class):
            self._callable = func_or_class(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = func_or_class
            self._is_function = True
        if user_config is not None and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        # Autoscaling metrics are PUSHED from a side thread (reference:
        # replica.py pushes to the controller): a poll through the mailbox
        # would queue behind pending requests and always observe drained
        # state.
        self._metrics_stopped = False
        if identity is not None:
            self._identity = identity
            threading.Thread(
                target=self._push_metrics_loop, args=(metrics_period_s,),
                daemon=True,
            ).start()

    def stop_metrics(self):
        self._metrics_stopped = True
        return True

    def _push_metrics_loop(self, period: float):
        import time as _time

        import ray_tpu_torch as _rt
        from ray_tpu_torch.core import api as _api

        rt0 = _api._runtime  # the runtime this replica belongs to
        ctrl = None
        while True:
            _time.sleep(period)
            if self._metrics_stopped or _api._runtime is not rt0:
                return  # replica retired, or runtime shut down/replaced
            try:
                if ctrl is None:
                    ctrl = _rt.get_actor("serve:controller")
                ongoing = self._ongoing + self._fp_ongoing
                if _metrics.ENABLED:
                    _M_REPLICA_ONGOING.set(
                        ongoing, {"deployment": str(self._identity[0])}
                    )
                # fire-and-forget metrics push; a lost sample is harmless
                # and the next tick re-reports
                ctrl.record_stats.remote(list(self._identity), ongoing)  # ray-lint: disable=dropped-object-ref
            except Exception:
                ctrl = None  # controller gone/respawned; re-resolve

    async def handle_request(self, method_name: str, args, kwargs):
        self._ongoing += 1
        self._total += 1
        try:
            if self._is_function:
                target = self._callable
            else:
                target = getattr(self._callable, method_name or "__call__")
            if inspect.iscoroutinefunction(target):
                return await target(*args, **kwargs)
            # sync handler: off the loop, onto the replica's own pool —
            # @serve.batch rendezvous and blocking model calls keep their
            # thread semantics and can overlap with coroutine handlers
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                self._sync_pool, lambda: target(*args, **kwargs)
            )
        finally:
            self._ongoing -= 1

    def reconfigure(self, user_config: Dict):
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def stats(self) -> Dict[str, Any]:
        # runs on the loop thread, so both counters are read consistently
        return {"ongoing": self._ongoing, "total": self._total,
                "fp_ongoing": self._fp_ongoing}

    def health_check(self) -> bool:
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True
