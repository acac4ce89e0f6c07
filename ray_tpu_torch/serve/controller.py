"""ServeController: reconciles deployment state to replica actors.

Reference: python/ray/serve/_private/controller.py (ServeController) +
deployment_state.py (target vs running replica reconciliation) +
autoscaling_policy.py (ongoing-requests-per-replica policy).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.serve.replica import ServeReplica


class _DeploymentState:
    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.replicas: List = []
        self.version = 0
        self.target = spec["num_replicas"]
        self.last_scale_time = 0.0
        self.scale_signal_since: Optional[float] = None
        self.scale_signal_dir = 0
        self.next_replica_id = 0
        self.replica_ids: List[int] = []  # parallel to self.replicas
        # replica_id -> (ongoing, timestamp), pushed by replicas
        self.stats: Dict[int, tuple] = {}
        # replica_id -> spawn time: a replica gets a startup grace window
        # before the liveness sweep may declare it dead on silence
        self.spawned_at: Dict[int, float] = {}
        # replica_ids whose constructor has returned (a stats push or an
        # answered probe): until then a probe that times out means the
        # constructor is still running (a model loading), not a dead replica
        self.ready: set = set()


@ray_tpu_torch.remote(num_cpus=0)
class ServeController:
    def __init__(self):
        self._lock = threading.RLock()
        # app -> deployment name -> state
        self._apps: Dict[str, Dict[str, _DeploymentState]] = {}
        self._ingress: Dict[str, str] = {}
        self._stop = False
        self._loop = threading.Thread(target=self._control_loop, daemon=True)
        self._loop.start()

    # ------------------------------------------------------------ deploy API
    def deploy_application(self, app_name: str, specs: List[Dict[str, Any]],
                           ingress: Optional[str] = None):
        with self._lock:
            if ingress is not None:
                self._ingress[app_name] = ingress
            app = self._apps.setdefault(app_name, {})
            new_names = {spec["name"] for spec in specs}
            # deployments dropped from the app spec are torn down (reference:
            # deployment_state reconciles the FULL target set)
            for name in list(app):
                if name not in new_names:
                    for r in list(app[name].replicas):
                        self._kill_replica(app[name], r)
                    del app[name]
            for spec in specs:
                name = spec["name"]
                old = app.get(name)
                if old is not None:
                    # in-place update: new code/config, replace replicas
                    for r in list(old.replicas):
                        self._kill_replica(old, r)
                    old.spec = spec
                    old.replicas = []
                    old.replica_ids = []
                    old.target = spec["num_replicas"]
                    old.version += 1
                else:
                    app[name] = _DeploymentState(spec)
            self._reconcile_locked()
        return True

    def delete_application(self, app_name: str):
        with self._lock:
            app = self._apps.pop(app_name, {})
            for st in app.values():
                for r in list(st.replicas):
                    self._kill_replica(st, r)
        return True

    def shutdown(self):
        with self._lock:
            self._stop = True
            for app in self._apps.values():
                for st in app.values():
                    for r in list(st.replicas):
                        self._kill_replica(st, r)
            self._apps.clear()
        return True

    # -------------------------------------------------------------- queries
    def get_replicas(self, app_name: str, deployment_name: str):
        with self._lock:
            st = self._state(app_name, deployment_name)
            return {
                "replicas": list(st.replicas),
                "version": st.version,
                "fast_path": bool(st.spec.get("fast_path")),
            }

    def get_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            return self._ingress.get(app_name)

    def get_replica_version(self, app_name: str, deployment_name: str) -> int:
        with self._lock:
            st = self._apps.get(app_name, {}).get(deployment_name)
            return st.version if st else -1

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                app: {
                    name: {
                        "num_replicas": len(st.replicas),
                        "target": st.target,
                        "version": st.version,
                    }
                    for name, st in deps.items()
                }
                for app, deps in self._apps.items()
            }

    def _state(self, app_name, deployment_name) -> _DeploymentState:
        st = self._apps.get(app_name, {}).get(deployment_name)
        if st is None:
            raise KeyError(f"unknown deployment {app_name}/{deployment_name}")
        return st

    # ----------------------------------------------------------- reconcile
    def _kill(self, replica):
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def _kill_replica(self, st: "_DeploymentState", replica):
        """Kill + retire: drop the rid from live set and stats so a leaked
        metrics thread (daemon threads can't be interrupted in local mode)
        can never re-register a dead replica into autoscaling."""
        try:
            idx = st.replicas.index(replica)
        except ValueError:
            idx = -1
        if idx >= 0 and idx < len(st.replica_ids):
            rid = st.replica_ids[idx]
            st.stats.pop(rid, None)
            st.spawned_at.pop(rid, None)
            st.ready.discard(rid)
        try:
            # best-effort, fire-and-forget thread stop on a replica that is
            # about to be killed — there is no result worth fetching
            replica.stop_metrics.remote()  # ray-lint: disable=dropped-object-ref
        except Exception:
            pass
        self._kill(replica)

    def _reconcile_locked(self):
        for app_name, deps in self._apps.items():
            for name, st in deps.items():
                delta = st.target - len(st.replicas)
                if delta > 0:
                    spec = st.spec
                    opts = dict(spec["ray_actor_options"])
                    opts.setdefault("num_cpus", 0.1)
                    opts["max_concurrency"] = max(
                        int(spec["max_ongoing_requests"]), 2
                    )
                    for _ in range(delta):
                        rid = st.next_replica_id
                        st.next_replica_id += 1
                        st.replicas.append(
                            ServeReplica.options(**opts).remote(
                                spec["func_or_class"],
                                spec["init_args"],
                                spec["init_kwargs"],
                                spec.get("user_config"),
                                identity=(app_name, name, rid),
                                max_ongoing_requests=int(
                                    spec["max_ongoing_requests"]
                                ),
                            )
                        )
                        st.replica_ids.append(rid)
                        st.spawned_at[rid] = time.time()
                    st.version += 1
                elif delta < 0:
                    for r in list(st.replicas[st.target:]):
                        self._kill_replica(st, r)
                    st.replicas = st.replicas[: st.target]
                    st.replica_ids = st.replica_ids[: st.target]
                    st.version += 1

    # --------------------------------------------------------- autoscaling
    # a replica whose stats push has been silent this long (and that is
    # past its startup grace) gets a health probe; probe failure = dead.
    # Generous on purpose: GIL contention on a loaded 2-CPU host delays
    # pushes, and a false kill churns the very replicas serving traffic.
    REPLICA_SILENT_S = 5.0

    def _control_loop(self):
        while not self._stop:
            time.sleep(0.25)
            try:
                self._autoscale_tick()
            except Exception:
                pass
            try:
                self._liveness_tick()
            except Exception:
                pass

    def _liveness_tick(self):
        """Detect crashed replicas and respawn them (reference:
        deployment_state's replica health reconciliation). A replica
        killed by a node/worker death stops pushing stats; after the
        silence window it gets one direct health probe, and a failed
        probe retires it so _reconcile_locked brings the deployment back
        to target — the reconciliation the serve_storm chaos runs lean on
        (the task-layer handle AND the fast-path router both just need
        fresh membership; re-routing is theirs)."""
        now = time.time()
        suspects = []  # (st, replica, rid)
        with self._lock:
            for deps in self._apps.values():
                for st in deps.values():
                    for idx, rid in enumerate(st.replica_ids):
                        if now - st.spawned_at.get(rid, now) < \
                                self.REPLICA_SILENT_S:
                            continue
                        rec = st.stats.get(rid)
                        if rec is not None and \
                                now - rec[1] < self.REPLICA_SILENT_S:
                            continue
                        suspects.append((st, st.replicas[idx], rid))
        dead = []
        for st, replica, rid in suspects[:4]:  # bound probe work per tick
            try:
                ray_tpu_torch.get(replica.health_check.remote(), timeout=2.0)
                with self._lock:
                    # answered: treat the probe as a fresh stats sample so
                    # a quiet-but-alive replica isn't re-probed every tick
                    st.stats.setdefault(rid, (0, time.time()))
                    st.stats[rid] = (st.stats[rid][0], time.time())
                    st.ready.add(rid)
            except GetTimeoutError:
                # no answer: dead only once its constructor had returned;
                # before that the probe waits behind the constructor (a
                # replica that fails to construct answers with an error)
                if rid in st.ready:
                    dead.append((st, replica, rid))
            except Exception:  # noqa: BLE001 - dead/unreachable
                dead.append((st, replica, rid))
        if not dead:
            return
        with self._lock:
            for st, replica, rid in dead:
                try:
                    idx = st.replicas.index(replica)
                except ValueError:
                    continue  # already retired by a racing path
                st.replicas.pop(idx)
                rid = st.replica_ids.pop(idx)
                st.stats.pop(rid, None)
                st.spawned_at.pop(rid, None)
                st.ready.discard(rid)
                self._kill_replica(st, replica)
                st.version += 1
            self._reconcile_locked()

    def record_stats(self, identity, ongoing: int):
        app_name, dep_name, rid = identity
        with self._lock:
            st = self._apps.get(app_name, {}).get(dep_name)
            if st is not None and rid in st.replica_ids:
                st.stats[rid] = (ongoing, time.time())
                st.ready.add(rid)
        return True

    def _autoscale_tick(self):
        with self._lock:
            states = [
                st
                for deps in self._apps.values()
                for st in deps.values()
                if st.spec.get("autoscaling_config") is not None
            ]
        for st in states:
            cfg = st.spec["autoscaling_config"]
            now = time.time()
            with self._lock:
                if not st.replicas:
                    continue
                # drop records from replicas that stopped reporting (killed)
                st.stats = {
                    rid: rec for rid, rec in st.stats.items()
                    if now - rec[1] < 10.0
                }
                fresh = [
                    ongoing for ongoing, ts in st.stats.values()
                    if now - ts < 2.0
                ]
            if not fresh:
                continue
            avg_ongoing = sum(fresh) / len(fresh)
            if avg_ongoing > cfg.target_ongoing_requests and st.target < cfg.max_replicas:
                direction, delay = 1, cfg.upscale_delay_s
            elif (
                avg_ongoing < cfg.target_ongoing_requests * 0.5
                and st.target > cfg.min_replicas
            ):
                direction, delay = -1, cfg.downscale_delay_s
            else:
                direction, delay = 0, 0.0
            with self._lock:
                if direction == 0 or direction != st.scale_signal_dir:
                    st.scale_signal_dir = direction
                    st.scale_signal_since = now if direction else None
                    continue
                if now - (st.scale_signal_since or now) >= delay:
                    st.target = min(
                        max(st.target + direction, cfg.min_replicas),
                        cfg.max_replicas,
                    )
                    st.scale_signal_since = now
                    self._reconcile_locked()
