"""Local-mode runtime: tasks, actors, and objects in one process.

This is the core-worker-equivalent (reference: src/ray/core_worker/
core_worker.cc — SubmitTask/ExecuteTask/Get/Put) for a single node: worker
threads instead of worker processes, the in-process MemoryStore as the object
store, and the *real* batched scheduling kernel in the loop — the same
policy/kernel path the multi-node control plane uses, so scheduling semantics
don't fork between modes.

Threading model: a scheduler thread runs batched rounds (reference hot loop:
ClusterTaskManager::ScheduleAndDispatchTasks, cluster_task_manager.cc);
execution runs on a thread pool gated by resource accounting, not pool size;
each actor gets a dedicated mailbox thread (per-caller FIFO ordering —
reference: actor_submit_queue.h). Workers that block in get() release their
resources while blocked (reference: CoreWorker::NotifyDirectCallTaskBlocked).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    TaskError,
)
from ray_tpu_torch.core.memory_store import MemoryStore
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskSpec, new_id
from ray_tpu_torch.sched.policy import make_policy_from_config
from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace
from ray_tpu_torch.util.task_events import TaskEventLog

_context = threading.local()


def _env_stepped(gen, _rtenv, env):
    """Re-enter the (process-global) runtime env around each production
    step of a local-mode streaming generator, so the env lock is held
    only while user code actually runs — never across backpressure
    parking."""
    env_vars, cwd, py_paths = env
    while True:
        with _rtenv.applied(env_vars, cwd, py_paths=py_paths):
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item


def _cut_by_loop_shutdown(e: BaseException) -> bool:
    """Whether an async actor's call ended because its event loop shut
    down (ActorEventLoop.shutdown cancels every in-flight coroutine)."""
    import asyncio
    import concurrent.futures

    if isinstance(e, (asyncio.CancelledError, concurrent.futures.CancelledError)):
        return True
    return isinstance(e, RuntimeError) and "actor event loop shut down" in str(e)


class _ActorState:
    def __init__(self, actor_id: str, node_idx: int, demand: np.ndarray):
        self.actor_id = actor_id
        self.node_idx = node_idx
        self.demand = demand
        self.mailbox: deque = deque()
        self.cv = threading.Condition()
        self.instance = None
        self.dead = False
        self.death_cause: Optional[str] = None
        self.thread: Optional[threading.Thread] = None
        self.num_restarts = 0
        self.aio = None  # ActorEventLoop when the class has async methods


class LocalRuntime:
    """One-process cluster: single scheduling node, thread workers."""

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        config: Optional[Config] = None,
    ):
        self.config = config or Config()
        self.node_id = new_id("node")
        self.worker_id = new_id("driver")
        num_cpus = num_cpus if num_cpus is not None else (os.cpu_count() or 4)
        res = {"CPU": float(num_cpus), "memory": float(2**33)}
        res.update(resources or {})
        self.space = ResourceSpace()
        self.state = NodeResourceState(space=self.space)
        self.state.add_node(self.node_id, res)
        self.store = MemoryStore()
        self.policy = make_policy_from_config(self.config)

        self._lock = threading.Lock()
        self._pending: deque = deque()  # schedulable TaskSpecs
        self._waiting: Dict[str, Tuple[TaskSpec, set]] = {}  # task_id -> (spec, missing oids)
        self._dep_index: Dict[str, List[str]] = defaultdict(list)  # oid -> task_ids
        self._infeasible: deque = deque()
        self._running: Dict[str, TaskSpec] = {}
        self._actors: Dict[str, _ActorState] = {}
        self._pgs: Dict[str, dict] = {}
        self._streams: Dict[str, dict] = {}  # task_id -> backpressure state
        # timeline (ray timeline equivalent): same bounded-memory backend
        # as the GCS — recent window + incremental aggregates + anonymous
        # JSONL spill (removed on shutdown) so 1M-task local runs keep a
        # full queryable timeline without unbounded RSS
        self._task_events = TaskEventLog(
            recent_cap=self.config.task_events_recent_cap,
            anonymous_spill=self.config.task_events_spill,
        )
        # internal KV (reference: GCS internal kv, _internal_kv_put — backs
        # named actors, collective group rendezvous, serve state)
        self._kv: Dict[str, bytes] = {}

        self._sched_cv = threading.Condition()
        self._stopped = False
        self._executor = ThreadPoolExecutor(
            max_workers=max(int(num_cpus) * 4, 16), thread_name_prefix="raytpu-worker"
        )
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="raytpu-sched", daemon=True
        )
        self._sched_thread.start()

    # ------------------------------------------------------------------ submit

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        refs = [
            ObjectRef.for_task_output(spec.task_id, i, owner=self.worker_id)
            for i in range(spec.num_returns)
        ]
        if spec.actor_creation:
            # Register the mailbox immediately so method calls submitted
            # before the creation task is scheduled queue up instead of
            # failing (reference: the GCS actor table exists from
            # registration, gcs_actor_manager.cc).
            with self._lock:
                self._actors[spec.actor_id] = _ActorState(spec.actor_id, 0, None)
        ready = False
        with self._lock:
            missing = {
                a.id
                for a in list(spec.args) + list(spec.kwargs.values())
                if isinstance(a, ObjectRef) and not self.store.contains(a)
            }
            if missing:
                self._waiting[spec.task_id] = (spec, missing)
                for oid in missing:
                    self._dep_index[oid].append(spec.task_id)
            else:
                ready = True
        if ready:
            self._make_ready(spec)
        else:
            # Close the submit/complete race: a dependency may have landed
            # between the contains() check and registration above — re-check
            # and fire the ready path for anything now present.
            for oid in list(missing):
                if self.store.contains(ObjectRef(oid)):
                    self._on_object_ready(ObjectRef(oid))
        self._kick()
        return refs

    def _make_ready(self, spec: TaskSpec):
        """Route a dependency-ready task: actor method calls bypass the
        scheduler and go straight to the actor's mailbox (reference: actor
        calls skip the raylet, actor_task_submitter.cc); everything else
        queues for the batched scheduling round."""
        if spec.actor_id is not None and not spec.actor_creation:
            with self._lock:
                self._running[spec.task_id] = spec
            self._enqueue_actor_task(spec)
        else:
            with self._lock:
                self._pending.append(spec)

    def _kick(self):
        with self._sched_cv:
            self._sched_cv.notify()

    def _on_object_ready(self, ref: ObjectRef):
        newly_ready = []
        with self._lock:
            for tid in self._dep_index.pop(ref.id, []):
                entry = self._waiting.get(tid)
                if entry is None:
                    continue
                spec, missing = entry
                missing.discard(ref.id)
                if not missing:
                    del self._waiting[tid]
                    newly_ready.append(spec)
        for spec in newly_ready:
            self._make_ready(spec)
        if newly_ready:
            self._kick()

    # --------------------------------------------------------------- scheduler

    def _scheduler_loop(self):
        interval = self.config.scheduler_round_interval_ms / 1000.0
        while not self._stopped:
            with self._sched_cv:
                self._sched_cv.wait(timeout=interval)
            try:
                self._schedule_round()
            except Exception:  # pragma: no cover - keep the loop alive
                traceback.print_exc()

    def _schedule_round(self):
        """One batched round: group pending by scheduling class, run the
        policy kernel, dispatch. Reference: ScheduleAndDispatchTasks."""
        self._retry_pending_pgs_local()
        with self._lock:
            if not self._pending and not self._infeasible:
                return
            batch = list(self._pending) + list(self._infeasible)
            self._pending.clear()
            self._infeasible.clear()

        rest = []
        for spec in batch:
            if spec.strategy.kind == "PLACEMENT_GROUP":
                # tasks ride inside their bundle's reservation (zero extra
                # demand once the PG is placed)
                pg = self._pgs.get(spec.strategy.placement_group_id)
                if pg is None:
                    # nonexistent/removed PG can never become schedulable
                    self._store_error(spec, TaskError(
                        f"placement group {spec.strategy.placement_group_id} "
                        f"does not exist"))
                    with self._lock:
                        self._running.pop(spec.task_id, None)
                elif pg["state"] == "CREATED":
                    self._dispatch(spec, 0, self.space.vector({}))
                else:
                    with self._lock:
                        self._infeasible.append(spec)
            else:
                rest.append(spec)
        batch = rest
        if not batch:
            return

        classes: Dict[Tuple, List[TaskSpec]] = defaultdict(list)
        for spec in batch:
            classes[spec.scheduling_class()].append(spec)
        keys = list(classes.keys())
        demands = np.stack(
            [self.space.vector(classes[k][0].resources) for k in keys]
        )
        counts = np.array([len(classes[k]) for k in keys], dtype=np.int32)

        with self._lock:
            assigned = self.policy.schedule(self.state, demands, counts)

        for c, key in enumerate(keys):
            specs = classes[key]
            placed = int(assigned[c].sum())
            for spec, _ in zip(specs, range(placed)):
                node_idx = 0  # single node in local mode
                self._dispatch(spec, node_idx, demands[c])
            for spec in specs[placed:]:
                with self._lock:
                    self._infeasible.append(spec)

    def _retry_pending_pgs_local(self):
        from ray_tpu_torch.sched.bundles import schedule_bundles

        for pg in list(self._pgs.values()):
            if pg["state"] != "PENDING":
                continue
            with self._lock:
                mat = np.stack([self.space.vector(b) for b in pg["bundles"]])
                nodes, new_avail = schedule_bundles(
                    self.state.available, self.state.total, self.state.alive,
                    mat, strategy=pg["strategy"],
                )
                if nodes is not None:
                    self.state.available = new_avail
                    pg["state"] = "CREATED"
                    pg["nodes"] = [self.state.node_ids[i] for i in nodes]

    def _dispatch(self, spec: TaskSpec, node_idx: int, demand: np.ndarray):
        with self._lock:
            self._running[spec.task_id] = spec
        if spec.actor_creation:
            self._start_actor(spec, node_idx, demand)
        else:
            self._executor.submit(self._run_task, spec, node_idx, demand)

    # --------------------------------------------------------------- execution

    def _resolve_args(self, spec: TaskSpec):
        entries = {}
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef):
                e = self.store.try_get(a)
                if e is None:
                    raise RuntimeError(f"dependency {a} not ready at dispatch")
                if e.is_exception:
                    raise e.value if isinstance(e.value, BaseException) else TaskError(str(e.value))
                entries[a.id] = e.value
        args = tuple(entries[a.id] if isinstance(a, ObjectRef) else a for a in spec.args)
        kwargs = {
            k: (entries[v.id] if isinstance(v, ObjectRef) else v)
            for k, v in spec.kwargs.items()
        }
        return args, kwargs

    # ------------------------------------------------- streaming generators
    # (reference: _raylet.pyx streaming generator returns; protocol in
    # core/generator.py — items at output indices 1..n, end marker at 0)

    def _drain_stream(self, spec: TaskSpec, gen) -> None:
        """Producer side: publish each yielded item as it is produced,
        then the end marker with the final count. A backpressure window
        parks the generator (not the scheduler) when the consumer lags."""
        from ray_tpu_torch.core.generator import end_marker_ref, item_ref

        bp = spec.backpressure
        st = None
        if bp > 0:
            st = {"acked": 0, "cv": threading.Condition()}
            with self._lock:
                self._streams[spec.task_id] = st
        n = 0
        try:
            for value in gen:  # user errors propagate to _run_task's handler
                self.put_ref(
                    item_ref(spec.task_id, n, owner=self.worker_id), value
                )
                n += 1
                if st is not None:
                    with st["cv"]:
                        while (
                            n - st["acked"] >= bp and not self._stopped
                        ):
                            st["cv"].wait(timeout=0.5)
            self.put_ref(
                end_marker_ref(spec.task_id, owner=self.worker_id), n
            )
        finally:
            if st is not None:
                with self._lock:
                    self._streams.pop(spec.task_id, None)

    def stream_ack(self, task_id: str, consumed: int) -> None:
        """Consumer handed out items [0, consumed): widen the window."""
        with self._lock:
            st = self._streams.get(task_id)
        if st is not None:
            with st["cv"]:
                st["acked"] = max(st["acked"], consumed)
                st["cv"].notify_all()

    def stream_item_ready(self, ref: ObjectRef) -> bool:
        return self.store.contains(ref)

    def stream_read_end(self, ref: ObjectRef):
        """(value, is_exception) of the end marker, without raising."""
        e = self.store.get([ref], timeout=1.0)[0]
        return e.value, e.is_exception

    def stream_wait_any(self, refs, timeout: float) -> None:
        self.store.wait(refs, 1, timeout)

    def _store_results(self, spec: TaskSpec, value: Any):
        refs = [
            ObjectRef.for_task_output(spec.task_id, i, owner=self.worker_id)
            for i in range(spec.num_returns)
        ]
        if spec.num_returns == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} returned {len(values)} values, "
                    f"expected num_returns={spec.num_returns}"
                )
        for ref, v in zip(refs, values):
            self.put_ref(ref, v)

    def _store_error(self, spec: TaskSpec, err: BaseException):
        for i in range(spec.num_returns):
            ref = ObjectRef.for_task_output(spec.task_id, i, owner=self.worker_id)
            self.put_ref(ref, err, is_exception=True)

    def _run_task(self, spec: TaskSpec, node_idx: int, demand: np.ndarray):
        _context.task = spec
        _context.node_idx = node_idx
        _context.demand = demand
        _context.blocked_released = False
        start = time.time()
        try:
            args, kwargs = self._resolve_args(spec)
            from ray_tpu_torch.core import runtime_env as _rtenv

            re = spec.runtime_env or {}
            env = (
                re.get("env_vars"), re.get("working_dir"),
                _rtenv.local_py_paths(re, self.config.session_dir_root),
            )
            with _rtenv.applied(env[0], env[1], py_paths=env[2]):
                value = spec.func(*args, **kwargs)
                if spec.streaming and not hasattr(value, "__next__"):
                    raise TypeError(
                        "num_returns='streaming' requires a generator "
                        f"function; {spec.name} returned {type(value)}"
                    )
                if not spec.streaming:
                    self._store_results(spec, value)
            if spec.streaming:
                # drain OUTSIDE the applied() context: it holds the
                # process-global env lock, and a backpressured stream can
                # park indefinitely — which would deadlock every other
                # runtime_env task in local mode. Instead each production
                # step re-enters the env around next() (user code still
                # runs under its env; the lock is released while parked).
                gen = value
                if any(env):
                    gen = _env_stepped(value, _rtenv, env)
                self._drain_stream(spec, gen)
            status = "FINISHED"
        except BaseException as e:
            if spec.retries_left > 0 and not isinstance(e, TaskError):
                spec.retries_left -= 1
                with self._lock:
                    self._running.pop(spec.task_id, None)
                    self._pending.append(spec)
                self._release_resources(node_idx, demand)
                self._kick()
                _context.task = None
                return
            tb = traceback.format_exc()
            self._store_error(
                spec, TaskError(f"task {spec.name or spec.task_id} failed: {e!r}", tb)
            )
            status = "FAILED"
        finally:
            _context.task = None
        with self._lock:
            self._running.pop(spec.task_id, None)
        if not getattr(_context, "blocked_released", False):
            self._release_resources(node_idx, demand)
        self._task_events.append(
            {
                "task_id": spec.task_id,
                "name": spec.name,
                "start": start,
                "end": time.time(),
                "status": status,
                "node": self.node_id,
            }
        )
        self._kick()

    # ------------------------------------------------------------------ actors

    def _release_resources(self, node_idx: int, demand) -> None:
        """All resource mutations serialize on self._lock with the scheduler's
        copy-compute-replace round, else releases landing mid-round are lost."""
        if demand is None:
            return
        with self._lock:
            self.state.release(node_idx, demand)

    def _fail_actor(self, st: _ActorState, creation_spec: Optional[TaskSpec]):
        """Resolve every ref tied to a dead actor so no caller hangs: the
        creation ref (if the ctor never ran/finished) and all queued calls."""
        err = ActorDiedError(
            f"actor {st.actor_id} is dead: {st.death_cause or 'killed'}"
        )
        if creation_spec is not None:
            self._store_error(creation_spec, err)
            with self._lock:
                self._running.pop(creation_spec.task_id, None)
        with st.cv:
            pending = list(st.mailbox)
            st.mailbox.clear()
        for spec in pending:
            self._store_error(spec, err)
            with self._lock:
                self._running.pop(spec.task_id, None)

    def _start_actor(self, spec: TaskSpec, node_idx: int, demand: np.ndarray):
        with self._lock:
            st = self._actors.get(spec.actor_id)
            if st is None:
                st = _ActorState(spec.actor_id, node_idx, demand)
                self._actors[spec.actor_id] = st
            else:
                st.node_idx = node_idx
                st.demand = demand
        if st.dead:  # killed before creation ran
            self._release_resources(node_idx, demand)
            self._fail_actor(st, creation_spec=spec)
            return
        st.thread = threading.Thread(
            target=self._actor_loop, args=(st, spec), daemon=True,
            name=f"raytpu-actor-{spec.actor_id[:8]}",
        )
        st.thread.start()

    def _actor_loop(self, st: _ActorState, creation_spec: TaskSpec):
        _context.actor_id = st.actor_id
        try:
            args, kwargs = self._resolve_args(creation_spec)
            cls = creation_spec.func
            # local mode runs actors on threads in ONE process: env applies
            # for the constructor only (not keep=) — process-global env
            # can't be owned by one thread-actor for its lifetime
            from ray_tpu_torch.core import runtime_env as _rtenv

            re = creation_spec.runtime_env or {}
            with _rtenv.applied(
                re.get("env_vars"), re.get("working_dir"),
                py_paths=_rtenv.local_py_paths(
                    re, self.config.session_dir_root
                ),
            ):
                st.instance = cls(*args, **kwargs)
            # async actor: every method (coroutine or sync) runs on this
            # dedicated per-actor event loop (reference: python/ray/actor.py
            # async actors); max_concurrency bounds in-flight coroutines
            # via the semaphore-gated dispatch below
            from ray_tpu_torch.core.async_actor import ActorEventLoop, class_is_async

            if class_is_async(type(st.instance)):
                st.aio = ActorEventLoop(
                    name=f"raytpu-actor-{st.actor_id[:8]}-aio"
                )
            self._store_results(creation_spec, st.actor_id)
        except BaseException as e:
            tb = traceback.format_exc()
            st.dead = True
            st.death_cause = tb
            self._store_error(
                creation_spec,
                ActorDiedError(f"actor constructor failed: {e!r}\n{tb}"),
            )
            self._release_resources(st.node_idx, st.demand)
            self._fail_actor(st, creation_spec=None)
            return
        finally:
            with self._lock:
                self._running.pop(creation_spec.task_id, None)

        # Threaded actors (reference: max_concurrency>1 runs methods on a
        # per-actor thread pool, core_worker concurrency groups): methods may
        # overlap and block on each other — needed by barrier-style actors
        # like the train report bus. Daemon threads gated by a semaphore, NOT
        # a ThreadPoolExecutor: its atexit join would deadlock interpreter
        # exit on methods blocked in a barrier that never completes.
        sem: Optional[threading.Semaphore] = None
        if creation_spec.max_concurrency > 1:
            sem = threading.Semaphore(creation_spec.max_concurrency)
        while True:
            with st.cv:
                while not st.mailbox and not st.dead:
                    st.cv.wait(timeout=0.5)
                    if self._stopped:
                        return
                if st.dead:
                    break
                spec = st.mailbox.popleft()
            if sem is None:
                self._run_actor_method(st, spec)
            else:
                sem.acquire()

                def _run(spec=spec):
                    try:
                        self._run_actor_method(st, spec)
                    finally:
                        sem.release()

                threading.Thread(
                    target=_run, daemon=True,
                    name=f"raytpu-actor-{st.actor_id[:8]}-mc",
                ).start()
        # drain mailbox with death errors; cancel in-flight coroutines so
        # dispatch threads blocked on the loop observe the death
        if st.aio is not None:
            st.aio.shutdown()
        self._fail_actor(st, creation_spec=None)
        self._release_resources(st.node_idx, st.demand)

    def _run_actor_method(self, st: _ActorState, spec: TaskSpec):
        _context.actor_id = st.actor_id
        start = time.time()
        try:
            args, kwargs = self._resolve_args(spec)
            method = getattr(st.instance, spec.method_name)
            if st.aio is not None:
                # async actor: user code runs on the actor's event loop
                # (this dispatch thread blocks as the concurrency slot)
                value = st.aio.call(method, args, kwargs)
            else:
                value = method(*args, **kwargs)
            if spec.streaming:
                if hasattr(value, "__anext__"):
                    from ray_tpu_torch.core.async_actor import agen_to_iter

                    value = agen_to_iter(value, st.aio)
                if not hasattr(value, "__next__"):
                    raise TypeError(
                        "num_returns='streaming' requires a generator "
                        f"method; {spec.method_name} returned {type(value)}"
                    )
                self._drain_stream(spec, value)
            else:
                self._store_results(spec, value)
            status = "FINISHED"
        except BaseException as e:
            tb = traceback.format_exc()
            if st.dead and st.aio is not None and _cut_by_loop_shutdown(e):
                # killed mid-call: the event loop's shutdown cancelled the
                # call. That is the actor's death, as in cluster mode, where
                # the worker's exit fails the call; callers that retry on a
                # dead actor (a serve handle) then retry it
                err = ActorDiedError(
                    f"actor {st.actor_id} is dead: {st.death_cause or 'killed'}")
            else:
                err = TaskError(f"actor method {spec.method_name} failed: {e!r}", tb)
            self._store_error(spec, err)
            status = "FAILED"
        with self._lock:
            self._running.pop(spec.task_id, None)
        self._task_events.append(
            {
                "task_id": spec.task_id,
                "name": spec.name,
                "start": start,
                "end": time.time(),
                "status": status,
                "node": self.node_id,
                "actor_id": st.actor_id,
            }
        )

    def _enqueue_actor_task(self, spec: TaskSpec):
        # Actor method calls consume no scheduler resources; the actor holds
        # its allocation for its lifetime (reference: actor tasks bypass the
        # raylet and go straight to the actor's worker, actor_task_submitter.cc).
        st = self._actors.get(spec.actor_id)
        if st is not None:
            with st.cv:
                if not st.dead:
                    st.mailbox.append(spec)
                    st.cv.notify()
                    return
        cause = st.death_cause if st else "unknown actor"
        self._store_error(spec, ActorDiedError(f"actor {spec.actor_id} is dead: {cause}"))
        with self._lock:
            self._running.pop(spec.task_id, None)

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        return self.submit_task(spec)

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        st = self._actors.get(actor_id)
        if st is None:
            return
        with st.cv:
            st.dead = True
            st.death_cause = "ray_tpu.kill() called"
            st.cv.notify()

    # ---------------------------------------------------------------- kv store

    def kv_put(self, key: str, value):
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key: str):
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str):
        with self._lock:
            self._kv.pop(key, None)

    def kv_keys(self, prefix: str = ""):
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # ----------------------------------------------------------------- objects

    def put(self, value: Any) -> ObjectRef:
        ref = ObjectRef(owner=self.worker_id)
        self.put_ref(ref, value)
        return ref

    def put_ref(self, ref: ObjectRef, value: Any, is_exception: bool = False):
        self.store.put(ref, value, is_exception)
        self._on_object_ready(ref)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        self._release_while_blocked(True)
        try:
            entries = self.store.get(refs, timeout)
        finally:
            self._release_while_blocked(False)
        out = []
        for e in entries:
            if e.is_exception:
                raise e.value if isinstance(e.value, BaseException) else TaskError(str(e.value))
            out.append(e.value)
        return out

    def wait(self, refs, num_returns=1, timeout=None):
        self._release_while_blocked(True)
        try:
            return self.store.wait(refs, num_returns, timeout)
        finally:
            self._release_while_blocked(False)

    def _release_while_blocked(self, entering: bool):
        """A worker blocking in get() releases its CPUs so siblings can run
        (reference: CoreWorker::NotifyDirectCallTaskBlocked / Unblocked)."""
        spec = getattr(_context, "task", None)
        if spec is None:
            return
        demand = getattr(_context, "demand", None)
        node_idx = getattr(_context, "node_idx", 0)
        if demand is None:
            return
        if entering:
            self._release_resources(node_idx, demand)
            _context.blocked_released = True
            self._kick()
        else:
            # Reacquire without feasibility check: temporary oversubscription
            # beats deadlock (same tradeoff the reference makes).
            with self._lock:
                self.state.available[node_idx] -= demand
            _context.blocked_released = False

    def free(self, refs: List[ObjectRef]):
        self.store.delete(refs)

    # --------------------------------------------------------- placement groups

    def create_placement_group(self, pg_id, bundles, strategy, name=""):
        """Single-node PG support (reference semantics; the multi-node path
        lives in cluster/gcs.py)."""
        from ray_tpu_torch.sched.bundles import schedule_bundles

        with self._lock:
            mat = np.stack([self.space.vector(b) for b in bundles])
            nodes, new_avail = schedule_bundles(
                self.state.available, self.state.total, self.state.alive,
                mat, strategy=strategy,
            )
            if nodes is None:
                self._pgs[pg_id] = {"pg_id": pg_id, "state": "PENDING",
                                    "bundles": bundles, "strategy": strategy}
                return {"ok": False, "state": "PENDING"}
            self.state.available = new_avail
            self._pgs[pg_id] = {"pg_id": pg_id, "state": "CREATED",
                                "bundles": bundles, "strategy": strategy,
                                "nodes": [self.state.node_ids[i] for i in nodes]}
            return {"ok": True, "state": "CREATED"}

    def remove_placement_group(self, pg_id):
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg and pg.get("state") == "CREATED":
                for b, nid in zip(pg["bundles"], pg["nodes"]):
                    self.state.release(self.state.node_index(nid), self.space.vector(b))
        self._kick()

    def get_placement_group(self, pg_id):
        return self._pgs.get(pg_id)

    # ------------------------------------------------------------------- misc

    def cluster_resources(self) -> Dict[str, float]:
        agg: Dict[str, float] = defaultdict(float)
        for m in self.state.total_map().values():
            for k, v in m.items():
                agg[k] += v
        return dict(agg)

    def available_resources(self) -> Dict[str, float]:
        agg: Dict[str, float] = defaultdict(float)
        for m in self.state.available_map().values():
            for k, v in m.items():
                agg[k] += v
        return dict(agg)

    def nodes(self) -> List[dict]:
        return [
            {
                "NodeID": nid,
                "Alive": bool(self.state.alive[i]),
                "Resources": self.space.unvector(self.state.total[i]),
            }
            for i, nid in enumerate(self.state.node_ids)
        ]

    def timeline(self) -> List[dict]:
        # full history from the spill stream (the in-memory window alone
        # would truncate long runs' timelines)
        return list(self._task_events.scan())

    # -------------------------------------------------- state API (local)
    # reference: python/ray/util/state served from GCS task events

    def list_tasks(self, limit: int = 1000) -> List[dict]:
        return self._task_events.tail(limit)

    def summarize_tasks(self) -> dict:
        total, by_name = self._task_events.stats()
        return {"total": total, "by_name": by_name}

    def list_actors(self) -> List[dict]:
        out = []
        with self._lock:
            for aid, st in self._actors.items():
                out.append({
                    "actor_id": aid,
                    "state": "DEAD" if st.dead else "ALIVE",
                    "node_id": self.node_id,
                    "class_name": type(st.instance).__name__ if st.instance else "",
                    "name": "",
                })
        return out

    def list_placement_groups(self) -> List[dict]:
        with self._lock:
            return [
                {"placement_group_id": pid, **{k: v for k, v in pg.items()
                                               if k in ("state", "strategy", "bundles")}}
                for pid, pg in self._pgs.items()
            ]

    def list_objects(self, limit: int = 1000) -> List[dict]:
        return self.store.list_entries(limit)

    def summary(self) -> dict:
        with self._lock:
            return {
                "nodes_alive": 1,
                "nodes_dead": 0,
                "tasks_pending": len(self._pending) + len(self._waiting),
                "tasks_running": len(self._running),
                "actors": len(self._actors),
                "placement_groups": len(self._pgs),
            }

    def current_task_id(self) -> Optional[str]:
        spec = getattr(_context, "task", None)
        return spec.task_id if spec else None

    def current_actor_id(self) -> Optional[str]:
        return getattr(_context, "actor_id", None)

    def shutdown(self):
        self._stopped = True
        self._task_events.close()
        self._kick()
        for st in list(self._actors.values()):
            with st.cv:
                st.dead = True
                st.cv.notify()
        self._executor.shutdown(wait=False, cancel_futures=True)
        if self._sched_thread.is_alive():
            self._sched_thread.join(timeout=2)
