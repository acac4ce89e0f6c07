"""DeploymentHandle: the client-side router.

Reference: python/ray/serve/handle.py (DeploymentHandle) +
serve/_private/replica_scheduler/pow_2_scheduler.py — requests go to the
less-loaded of two randomly chosen replicas, load measured by THIS
handle's in-flight count per replica (locally observed, no extra RPC).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef (reference:
    serve.handle.DeploymentResponse). If the chosen replica died before
    answering (scale-down, crash), result() resubmits to a live replica —
    the reference router's retry-on-dead-replica behavior; requests are
    assumed safe to re-run, as there."""

    MAX_DEAD_REPLICA_RETRIES = 3

    def __init__(self, ref, resubmit=None):
        self._ref = ref
        self._resubmit = resubmit
        self._retries_left = self.MAX_DEAD_REPLICA_RETRIES

    def result(self, timeout: Optional[float] = None):
        import time as _time

        from ray_tpu_torch.core.exceptions import ActorDiedError

        # one overall deadline across retries — a rolling rescale must not
        # multiply the caller's timeout by the retry budget
        deadline = None if timeout is None else _time.time() + timeout
        while True:
            remaining = (
                None if deadline is None
                else max(deadline - _time.time(), 0.01)
            )
            try:
                out = ray_tpu_torch.get(self._ref, timeout=remaining)
                self._resubmit = None  # free the pinned request payload
                return out
            except ActorDiedError:
                if self._resubmit is None or self._retries_left <= 0:
                    raise
                self._retries_left -= 1
                self._ref = self._resubmit()

    @property
    def ref(self):
        return self._ref


def _rebuild_handle(deployment_name, app_name, method_name,
                    deadline_s=None):
    h = DeploymentHandle(deployment_name, app_name, method_name)
    h._deadline_s = deadline_s
    return h


class DeploymentHandle:
    # how often a hot handle re-checks the replica-set version with the
    # controller (reference: router long-polls; a per-request RPC would make
    # the controller a global bottleneck)
    VERSION_CHECK_INTERVAL_S = 0.5

    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: Optional[str] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._lock = threading.Lock()
        self._replicas: List = []
        self._replica_version = -1
        self._last_version_check = 0.0
        self._inflight: Dict[str, List] = {}  # replica actor_id -> pending refs
        self._method_handles: Dict[str, "DeploymentHandle"] = {}
        self._rng = random.Random()
        # serve fast path (ray_tpu_torch/serve/fastpath.py): engaged when the
        # deployment is fast_path=True AND the runtime is a cluster client
        # (local mode has no daemon to pin channels on). The router holder
        # is a one-slot list SHARED across method handles, so
        # handle.method.remote() reuses the parent's channel pairs.
        self._fast_path = False
        self._fp_router: List = [None]
        # optional per-request deadline (seconds) stamped into every
        # fast-path frame from this handle: expired requests are SHED by
        # the replica drain loop with a typed DeadlineExceededError (the
        # task-layer fallback ignores it — use result(timeout=) there)
        self._deadline_s: Optional[float] = None

    # picklable: handles travel into other replicas for composition
    # (deadline_s rides along — a composed inner handle keeps its SLO)
    def __reduce__(self):
        return (_rebuild_handle,
                (self.deployment_name, self.app_name, self._method_name,
                 self._deadline_s))

    def options(self, method_name: Optional[str] = None,
                deadline_s: Optional[float] = None) -> "DeploymentHandle":
        """Unset fields INHERIT from this handle: options(deadline_s=...)
        on a method-bound handle keeps its method, and vice versa."""
        h = DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name if method_name is not None else self._method_name,
        )
        h._fast_path = self._fast_path
        h._fp_router = self._fp_router  # share the channel pairs
        h._deadline_s = deadline_s if deadline_s is not None \
            else self._deadline_s
        return h

    # --------------------------------------------------------------- routing
    def _refresh_replicas(self):
        from ray_tpu_torch.serve.api import _get_controller

        ctrl = _get_controller()
        info = ray_tpu_torch.get(
            ctrl.get_replicas.remote(self.app_name, self.deployment_name)
        )
        with self._lock:
            self._replicas = info["replicas"]
            self._replica_version = info["version"]
            self._fast_path = bool(info.get("fast_path"))
            live = {r._actor_id for r in self._replicas}
            self._inflight = {
                aid: refs for aid, refs in self._inflight.items() if aid in live
            }

    def _maybe_refresh(self, force: bool = False):
        import time as _time

        now = _time.time()
        with self._lock:
            due = (
                force
                or self._replica_version < 0
                or now - self._last_version_check > self.VERSION_CHECK_INTERVAL_S
            )
            if due:
                self._last_version_check = now
        if not due:
            return
        from ray_tpu_torch.serve.api import _get_controller

        ctrl = _get_controller()
        v = ray_tpu_torch.get(
            ctrl.get_replica_version.remote(self.app_name, self.deployment_name)
        )
        if v != self._replica_version:
            self._refresh_replicas()

    def _pick_replica(self, exclude: Optional[set] = None):
        """Power of two choices on locally-observed in-flight counts
        (reference: pow_2_scheduler.py). Returns the replica handle —
        chosen and read under ONE lock so a concurrent refresh can't
        invalidate the index. `exclude`: actor ids known dead (a crashed
        replica stays in stale membership looking idle — pow-2 would be
        biased TOWARD it)."""
        with self._lock:
            replicas = self._replicas
            if exclude:
                alive = [r for r in replicas if r._actor_id not in exclude]
                replicas = alive or replicas  # all excluded: last resort
            n = len(replicas)
            if n == 0:
                raise RuntimeError(
                    f"deployment {self.deployment_name} has no replicas"
                )
            # prune completed refs
            for aid, refs in self._inflight.items():
                if refs:
                    done, pending = ray_tpu_torch.wait(
                        refs, num_returns=len(refs), timeout=0
                    )
                    self._inflight[aid] = list(pending)
            if n == 1:
                return replicas[0]
            a, b = self._rng.sample(range(n), 2)
            ra, rb = replicas[a], replicas[b]
            la = len(self._inflight.get(ra._actor_id, ()))
            lb = len(self._inflight.get(rb._actor_id, ()))
            return ra if la <= lb else rb

    def _submit(self, args, kwargs, exclude: Optional[set] = None):
        self._maybe_refresh()
        try:
            replica = self._pick_replica(exclude)
        except RuntimeError:
            self._maybe_refresh(force=True)  # empty set may be stale
            replica = self._pick_replica(exclude)
        ref = replica.handle_request.remote(self._method_name, args, kwargs)
        with self._lock:
            self._inflight.setdefault(replica._actor_id, []).append(ref)
        return ref, replica._actor_id

    # ------------------------------------------------------------ fast path

    def _fetch_membership(self):
        """Router callback: replica actor ids + version, via the
        controller. Called from the router's BACKGROUND refresher and its
        failure paths — never the steady-state request path."""
        from ray_tpu_torch.serve.api import _get_controller

        ctrl = _get_controller()
        info = ray_tpu_torch.get(
            ctrl.get_replicas.remote(self.app_name, self.deployment_name)
        )
        return [r._actor_id for r in info["replicas"]], info["version"]

    def _router(self):
        """The shared FastPathRouter, built on first use (after a refresh
        discovered fast_path=True on a cluster runtime)."""
        r = self._fp_router[0]
        if r is not None:
            return r
        with self._lock:
            if self._fp_router[0] is None:
                from ray_tpu_torch.serve.fastpath import FastPathRouter

                self._fp_router[0] = FastPathRouter(
                    self.deployment_name, self.app_name,
                    self._fetch_membership,
                )
            r = self._fp_router[0]
        r.refresh_now()
        return r

    def _use_fastpath(self) -> bool:
        if not self._fast_path:
            return False
        from ray_tpu_torch.core import api as _api

        rt = _api._runtime
        # cluster clients expose the serve pair control plane; local mode
        # (and torn-down runtimes) fall back to the task layer
        return rt is not None and hasattr(rt, "serve_register")

    def fastpath_stats(self) -> Optional[Dict[str, int]]:
        """Router counters (submitted/completed/rerouted/duplicates/
        failed) — what the chaos gates assert on; None before first use."""
        r = self._fp_router[0]
        return dict(r.stats) if r is not None else None

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # engaged fast path first: no version-check RPC on the hot path —
        # membership upkeep lives on the router's refresher thread
        r = self._fp_router[0]
        if r is not None and self._use_fastpath():
            return r.submit(self._method_name, args, kwargs,
                            deadline_s=self._deadline_s)
        self._maybe_refresh()
        if self._use_fastpath():
            return self._router().submit(self._method_name, args, kwargs,
                                         deadline_s=self._deadline_s)
        ref, aid = self._submit(args, kwargs)
        dead: set = set()  # populated by resubmit as deaths occur
        last = [aid]

        def resubmit():
            # the replica that just died may still sit in stale membership
            # (a crash bumps no controller version — version-gated refresh
            # would be a no-op), so fetch membership unconditionally AND
            # exclude known-dead replicas from the pick
            dead.add(last[0])
            try:
                self._refresh_replicas()
            except Exception:  # noqa: BLE001 - controller mid-restart
                pass
            ref, aid2 = self._submit(args, kwargs, exclude=dead)
            last[0] = aid2
            return ref

        return DeploymentResponse(ref, resubmit=resubmit)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        # handle.method.remote(...) sugar — cached so repeated calls keep
        # their router state instead of refreshing per access
        with self._lock:
            h = self._method_handles.get(name)
            if h is None:
                h = self.options(method_name=name)
                self._method_handles[name] = h
            return h
