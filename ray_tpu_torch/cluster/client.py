"""Driver-side cluster runtime: the object behind ray_tpu_torch.init(address=...).

Implements the same runtime interface LocalRuntime exposes (submit_task /
get / put / wait / kill_actor / nodes / ...) so ray_tpu_torch.core.api is
mode-agnostic. Fills the submitter half of the reference's core worker
(src/ray/core_worker/core_worker.cc SubmitTask/Get + task_manager.cc retries
and lineage; transport/normal_task_submitter.cc lease reuse is subsumed by
the GCS's centralized batched rounds — see cluster/__init__.py).

This ALSO absorbs the reference's Ray Client (python/ray/util/client/ —
the `ray.init("ray://host:port")` remote-driver proxy): every driver here
is already a remote client over plain TCP, so no separate proxy
server/stub layer is needed. `init(address="ray_tpu://host:port")` is
accepted for symmetry (_parse_address strips the scheme).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import OrderedDict, defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ClusterOverloadedError,
    GetTimeoutError,
    ObjectLostError,
    TaskError,
)
from ray_tpu_torch.core.memory_store import MemoryStore
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskSpec, new_id
from ray_tpu_torch.cluster.rpc import ConnectionLost, RetryingRpcClient, RpcClient, RpcError
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

# observability (ray_tpu_torch.obs): driver-side submission counters. Visible
# in the cluster aggregate when the driver shares the GCS process
# (embedded/local mode); remote drivers read them via their local export.
_M_TASKS_SUBMITTED = _metrics.Counter(
    "ray_tpu_client_tasks_submitted_total",
    "task submissions through this driver (actor calls tagged)",
    tag_keys=("kind",),
)
_K_SUBMIT_TASK = _M_TASKS_SUBMITTED.series_key({"kind": "task"})
_K_SUBMIT_ACTOR = _M_TASKS_SUBMITTED.series_key({"kind": "actor_call"})


class _ActorQueue:
    """Seq-ordered per-actor submit queue (reference: actor_submit_queue.h
    sequence numbers). Replayed calls re-enter at their ORIGINAL sequence
    number with a small backoff, so a bounced call never executes after a
    call submitted later."""

    def __init__(self):
        self._cv = threading.Condition()
        self._heap: list = []  # (seq, not_before, (meta, refs))
        self._next_seq = 0
        self._closed = False

    def put(self, meta, refs) -> int:
        import heapq

        with self._cv:
            seq = self._next_seq
            self._next_seq += 1
            heapq.heappush(self._heap, (seq, 0.0, (meta, refs)))
            self._cv.notify()
        return seq

    def put_replay(self, seq: int, meta, refs, delay: float):
        import heapq

        with self._cv:
            heapq.heappush(self._heap, (seq, time.time() + delay, (meta, refs)))
            self._cv.notify()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()

    def get(self):
        """Blocks for the lowest-seq item; honors its not-before time rather
        than skipping ahead (order beats latency here). None = closed."""
        import heapq

        with self._cv:
            while True:
                if self._closed:
                    return None
                if self._heap:
                    seq, not_before, item = self._heap[0]
                    now = time.time()
                    if not_before <= now:
                        heapq.heappop(self._heap)
                        return seq, item
                    self._cv.wait(timeout=not_before - now)
                else:
                    self._cv.wait()


def _parse_address(address) -> Tuple[str, int]:
    if isinstance(address, tuple):
        return address
    addr = address.replace("tcp://", "").replace("ray_tpu://", "")
    host, port = addr.rsplit(":", 1)
    return host, int(port)


class ClusterClient:
    def __init__(self, address, config: Optional[Config] = None):
        self.config = config or Config()
        # one named knob for every control-plane call deadline in here
        self._rpc_timeout = self.config.rpc_call_timeout_s
        host, port = _parse_address(address)
        self.worker_id = new_id("driver")
        self.node_id = "driver"
        self.store = MemoryStore()  # resolved values (inline or fetched)
        self._lock = threading.Lock()
        self._task_meta: Dict[str, dict] = {}  # task_id -> submitted meta (retries, lineage)
        self._ref_index: Dict[str, str] = {}  # object_id -> task_id (lineage)
        self._result_ready: Dict[str, dict] = {}  # task_id -> result payload meta
        self._actor_cache: Dict[str, dict] = {}
        self._actor_queues: Dict[str, Any] = {}
        self._daemon_conns: Dict[str, RpcClient] = {}
        self._shm_conns: Dict[str, Any] = {}  # node_id -> ShmClientStore|False
        self._reconstructing: set = set()  # producer task_ids being re-run
        # packaging memo: (kind, realpath) -> KV key (one zip + upload per
        # directory per driver; mutating the dir mid-run is not picked up,
        # matching the reference's upload-once semantics). kind matters:
        # the same tree zips with different layouts as working_dir vs
        # py_module.
        self._uploaded_rtenvs: Dict[tuple, str] = {}
        # ---- distributed reference counting (owner side) ----
        # Semantics from reference_count.cc (owned refs, task-duration arg
        # pins, lineage pinned while outputs live, BORROWS), not its
        # implementation: counting is owner-local; a task that stashes an
        # arg ref past its lifetime is reported as a borrower in its result
        # (worker.py _collect_borrows), and the owner holds a borrow pin per
        # (oid, borrower) until the borrower releases it or dies.
        self._refcounts: Dict[str, list] = {}  # oid -> [local, pinned]
        self._borrows: Dict[str, set] = {}  # oid -> {borrower worker_ids}
        # refs another client owns, pinned here only as args of tasks this
        # client submitted (a borrower forwarding a borrowed ref). Their
        # pins end without a free: only the owner frees an object, and the
        # task's executor reports its own borrow to that owner.
        self._foreign: set = set()
        # output ids of THIS client's in-flight ACTOR calls. Actor calls
        # bypass the GCS (direct client->daemon dispatch), so the GCS's
        # active_outputs can't know a producer exists; deps carrying
        # own_inflight=True tell its gate "pending, not dead" (reference
        # analog: the owner resolves args locally before scheduling in
        # normal_task_submitter.cc — here the gate is remote, so the
        # ownership knowledge travels with the spec)
        self._inflight_outputs: set = set()
        # pickled-function cache: cloudpickling a dynamic function costs
        # ~2ms, and doing it PER TASK capped driver submission at ~550/s
        # (profiled: 3.2s of a 7s 1500-task submit loop). The reference
        # exports a function definition once per cluster
        # (function_manager.py export) — same idea here: pickle once per
        # function object, ship the cached bytes in every spec. Closure-
        # captured ObjectRefs are remembered alongside so every task still
        # lists them as deps. id() keys are kept alive by the stored func
        # reference. FIFO-capped.
        self._func_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._FUNC_CACHE_MAX = 512
        # compiled-DAG state pushed by the GCS (dag_update): dag_id ->
        # {"state", "error"}; CompiledDAG.execute polls it so a dead
        # pipeline raises ChannelClosedError instead of parking forever
        self._dag_states: Dict[str, dict] = {}
        # --- overload control plane (client half) ---
        # last advisory throttle push from the GCS ("overload" channel);
        # replaced wholesale (atomic assignment) so readers never lock
        self._overload = {"overloaded": False, "retry_after": 0.0, "ts": 0.0}
        # admission-rejected tasks parked for a paced resubmission:
        # (not_before, meta), drained by the gc thread's 0.1s tick
        self._paced: List[tuple] = []
        # error-object publication queue: one shared publisher thread (see
        # _publish_error); entries are (refs, payload, deadline)
        self._err_pub_q: list = []
        self._err_pub_cv = threading.Condition()
        self._err_pub_thread: Optional[threading.Thread] = None
        # A borrow_released can arrive BEFORE its borrow_added: the add rides
        # the direct daemon reply while the release rides the GCS push
        # connection — different reader threads, no ordering. Early releases
        # park here as tombstones the late add consumes instead of pinning.
        self._early_borrow_releases: Dict[str, set] = {}
        self._task_pins: Dict[str, list] = {}  # task_id -> pinned oids
        self._task_outputs: Dict[str, set] = {}  # task_id -> live output oids
        self._task_out_ids: Dict[str, list] = {}  # task_id -> all output oids
        self._task_dep_ids: Dict[str, list] = {}  # task_id -> dep oids
        self._lineage_consumers: Dict[str, set] = {}  # dep oid -> consumer tids
        # SimpleQueue, not deque: producers include ObjectRef.__del__
        # (which may fire inside a cyclic-GC pass while THIS thread holds
        # self._lock, so the producer side must never lock) — SimpleQueue
        # .put is the documented reentrant-safe primitive for exactly
        # that context, and it gives the gc drain thread a real
        # happens-before edge instead of relying on GIL-atomic deque ops
        # (flagged by the race sanitizer, analysis/racer.py)
        self._gc_queue: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._gcs_host, self._gcs_port = host, port
        self._closed = False
        self._nodes: Dict[str, dict] = {}
        # workers embed a ClusterClient too; they register flagged so the
        # GCS excludes them from worker-log fanout (a worker printing
        # received logs would echo them back through its own log pump)
        self._is_worker_client = "RAY_TPU_WORKER_ID" in __import__("os").environ
        # Auto-reconnecting GCS session (reference: GCS FT — core workers
        # reconnect + resubscribe): _gcs_session re-registers and resubmits
        # unfinished tasks on every reconnect, so a GCS restart at any
        # point is survivable rather than fatal.
        self.gcs = RetryingRpcClient(
            host, port, name=self.worker_id, peer="gcs",
            on_session=self._gcs_session, auto_connect=False,
            config=self.config,
        )
        self.gcs.on_reconnect_timeout = self._on_gcs_reconnect_timeout
        self.gcs.subscribe("task_result", self._on_task_result)
        self.gcs.subscribe("stream_item", self._on_stream_item)
        self.gcs.subscribe("actor_update", self._on_actor_update)
        self.gcs.subscribe("nodes", self._on_nodes)
        self.gcs.subscribe("borrow_added", self._on_borrow_added)
        self.gcs.subscribe("borrow_released", self._on_borrow_released)
        self.gcs.subscribe("worker_logs", self._on_worker_logs)
        self.gcs.subscribe("overload", self._on_overload)
        self.gcs.subscribe("dag_update", self._on_dag_update)
        self.gcs.connect()
        self._put_rr = 0
        self._gc_thread = threading.Thread(
            target=self._gc_loop, daemon=True, name="driver-gc"
        )
        self._gc_thread.start()

    # ------------------------------------------------- reference counting

    def _register_ref(self, ref: ObjectRef) -> None:
        """Count a user-facing owned ref instance."""
        with self._lock:
            if ref._register(self._on_ref_del):
                self._refcounts.setdefault(ref.id, [0, 0])[0] += 1

    def _pin(self, oid: str, n: int = 1) -> None:
        """In-flight pin: arg of a submitted task / output of a pending
        task. Caller holds _lock."""
        self._refcounts.setdefault(oid, [0, 0])[1] += n

    def _unpin(self, oid: str) -> None:
        with self._lock:
            rc = self._refcounts.get(oid)
            if rc is None:
                return
            rc[1] -= 1
            free = rc[0] <= 0 and rc[1] <= 0
        if free:
            self._queue_free(oid)

    def _on_worker_logs(self, p: dict) -> None:
        """Worker stdout/stderr reaching the driver, reference-style
        '(pid=..., node=...)' prefixed (log_monitor.py's output format)."""
        if not self.config.log_to_driver:
            return
        prefix = f"(pid={p.get('pid')}, node={str(p.get('node_id'))[:12]})"
        for line in p.get("lines") or ():
            print(f"{prefix} {line}", flush=True)

    def _apply_borrows(self, p: dict) -> None:
        """Borrows reported in a task result: pin each (oid, borrower) pair
        BEFORE the task's arg pins release (same handler, so ordered)."""
        for b in p.get("borrows") or ():
            if b.get("owner") == self.worker_id:
                self._add_borrow(b["id"], p.get("borrow_worker"))

    def _add_borrow(self, oid: str, worker_id) -> None:
        with self._lock:
            early = self._early_borrow_releases.get(oid)
            if early is not None and worker_id in early:
                early.discard(worker_id)
                if not early:
                    del self._early_borrow_releases[oid]
                return  # release already arrived; never pin
            s = self._borrows.setdefault(oid, set())
            if worker_id in s:
                return
            s.add(worker_id)
            self._pin(oid)

    def _on_borrow_added(self, p: dict) -> None:
        self._add_borrow(p["object_id"], p.get("worker_id"))

    def _on_borrow_released(self, p: dict) -> None:
        oid = p["object_id"]
        with self._lock:
            s = self._borrows.get(oid)
            if s is None or p.get("worker_id") not in s:
                # raced ahead of the add: tombstone it (bounded — drop the
                # oldest entries past 10k; a leaked tombstone only costs a
                # transient borrow pin, freed when the borrower dies)
                if len(self._early_borrow_releases) > 10_000:
                    self._early_borrow_releases.pop(
                        next(iter(self._early_borrow_releases))
                    )
                self._early_borrow_releases.setdefault(oid, set()).add(
                    p.get("worker_id")
                )
                return
            s.discard(p.get("worker_id"))
            if not s:
                del self._borrows[oid]
        self._unpin(oid)

    def _on_ref_del(self, oid: str) -> None:
        # Runs from __del__, possibly inside a cyclic-GC pass triggered
        # while THIS thread already holds self._lock — so it must never
        # take it: SimpleQueue.put is reentrant-safe for destructor
        # context; the GC thread applies the decrement under the lock.
        if not self._closed:
            self._gc_queue.put(("decref", oid))

    def _queue_free(self, oid: str) -> None:
        self._gc_queue.put(("check", oid))

    def _release_task_deps(self, task_id: str) -> None:
        """Terminal task result: release its arg + output pins (idempotent —
        the pin list is popped exactly once). Actor calls additionally shed
        their lineage-consumer edges here: they are never reconstructed, so
        they must not pin their dep producers' specs past completion."""
        # pop under _lock: the gc thread's _maybe_drop_lineage pops this
        # table under the lock too (race sanitizer finding — the reader
        # thread popped bare)
        with self._lock:
            pins = self._task_pins.pop(task_id, None)
        for oid in pins or ():
            self._unpin(oid)
        if pins is not None:
            with self._lock:
                if task_id not in self._task_meta:
                    for d in self._task_dep_ids.pop(task_id, ()):
                        self._drop_consumer_edge(d, task_id)

    def _maybe_drop_lineage(self, tid: str) -> None:
        """Drop a task's spec when no live output remains AND no retained
        consumer lineage could still need its outputs reconstructed
        (transitive lineage pinning, reference: reference_count.cc keeping
        lineage while reconstructable refs exist). Cascades to producers
        whose last consumer was just dropped. Caller holds _lock."""
        if self._task_outputs.get(tid):
            return  # an output ref is still live
        out_ids = self._task_out_ids.get(tid, ())
        if any(self._lineage_consumers.get(o) for o in out_ids):
            return  # a consumer may reconstruct through these outputs
        self._task_meta.pop(tid, None)
        self._task_outputs.pop(tid, None)
        self._task_pins.pop(tid, None)
        for o in self._task_out_ids.pop(tid, ()):
            self._ref_index.pop(o, None)
        for d in self._task_dep_ids.pop(tid, ()):
            self._drop_consumer_edge(d, tid)

    def _drop_consumer_edge(self, dep_oid: str, tid: str) -> None:
        """Remove tid from dep_oid's consumer set; if it was the last
        consumer and the object itself is already freed, the dep's producer
        may now be droppable too (cascade). Caller holds _lock."""
        cons = self._lineage_consumers.get(dep_oid)
        if cons is None:
            return
        cons.discard(tid)
        if not cons:
            del self._lineage_consumers[dep_oid]
            if dep_oid not in self._refcounts:  # object already freed
                ptid = self._ref_index.get(dep_oid)
                if ptid is not None:
                    self._maybe_drop_lineage(ptid)

    def _gc_loop(self) -> None:
        """Batched auto-free (reference: the eviction pubsub that follows
        UpdateFinishedTaskReferences; batched here to amortize the RPC)."""
        while not self._closed:
            time.sleep(0.1)
            # paced admission retries (overload control plane): resubmit
            # every parked meta whose retry_after elapsed — runs here so
            # rejected tasks need no thread of their own
            due = []
            with self._lock:
                if self._paced:
                    now = time.time()
                    still = []
                    for nb, meta in self._paced:
                        (due if nb <= now else still).append((nb, meta))
                    self._paced = still
            for _nb, meta in due:
                try:
                    self._submit_async(meta)
                except Exception:  # noqa: BLE001 - reconnect plane owns it
                    pass
            batch = []
            while True:
                try:
                    batch.append(self._gc_queue.get_nowait())
                except queue_mod.Empty:
                    break
            if not batch:
                continue
            # failed submissions drain here too (single thread, bounded):
            # _fail_task_refs takes the lock and does blocking RPCs, so it
            # runs outside the refcount pass below
            fails = [p for k, p in batch if k == "fail_submit"]
            batch = [(k, p) for k, p in batch if k != "fail_submit"]
            for meta, msg in fails:
                try:
                    self._fail_task_refs(meta["task_id"], meta, msg)
                except Exception:  # noqa: BLE001
                    pass
            drop = []
            with self._lock:
                for kind, oid in batch:
                    rc = self._refcounts.get(oid)
                    if rc is None:
                        continue
                    if kind == "decref":
                        rc[0] -= 1
                    if rc[0] > 0 or rc[1] > 0:
                        continue  # still referenced / pinned
                    self._refcounts.pop(oid, None)
                    self._result_ready.pop(oid, None)
                    if oid in self._foreign:
                        self._foreign.discard(oid)
                        continue
                    drop.append(oid)
                    tid = self._ref_index.get(oid)
                    if tid is not None:
                        outs = self._task_outputs.get(tid)
                        if outs is not None:
                            outs.discard(oid)
                        self._maybe_drop_lineage(tid)
            if not drop:
                continue
            self.store.delete([ObjectRef(oid) for oid in drop])
            try:
                self.gcs.call("free_objects", {"object_ids": drop}, timeout=self._rpc_timeout)
            except Exception:  # noqa: BLE001
                pass

    # -------------------------------------------------- GCS reconnection

    def _gcs_session(self, gcs: RpcClient, first: bool):
        """(Re)establish the driver's GCS session on a fresh connection
        (runs inside RetryingRpcClient before the connection is published;
        subscriptions were already replayed). On reconnects, resubmit every
        unfinished normal task — at-least-once across a control-plane
        restart; the GCS dedupes duplicates."""
        timeout = self.config.rpc_call_timeout_s
        reply = gcs.call("register_driver", {
            "driver_id": self.worker_id,
            "worker": self._is_worker_client,
            "logs": bool(self.config.log_to_driver),
        }, timeout=timeout)
        with self._lock:
            self._nodes = reply["nodes"]
            if first:
                return
            unfinished = []
            for tid, meta in self._task_meta.items():
                if meta.get("actor_creation") or meta.get("actor_id"):
                    continue
                first_out = ObjectRef.for_task_output(
                    tid, 0, owner=self.worker_id
                )
                if not self.store.contains(first_out):
                    unfinished.append(dict(meta))
        for meta in unfinished:
            try:
                self._refresh_inflight_deps(meta)
                self._submit_blocking(gcs, meta, timeout)
            except Exception:
                pass

    def _on_gcs_reconnect_timeout(self):
        """The GCS stayed unreachable past the reconnect window: fail
        unfinished tasks' refs so gets raise instead of hanging forever
        (the submit callbacks deferred their failures to the reconnect
        plane). Reconnection itself keeps retrying — a GCS back later
        still restores the session for NEW work."""
        with self._lock:
            stranded = [
                dict(m) for tid, m in self._task_meta.items()
                if not (m.get("actor_creation") or m.get("actor_id"))
                and not self.store.contains(
                    ObjectRef.for_task_output(tid, 0, owner=self.worker_id)
                )
            ]
        for m in stranded:
            try:
                self._fail_task_refs(
                    m["task_id"], m,
                    "GCS unreachable past reconnect timeout",
                )
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------ overload control

    def _on_overload(self, p: dict) -> None:
        """GCS advisory throttle push (backpressure propagation): the
        cluster overload state derived from queue depth + daemon
        saturation. Pacing submitters consult it in _maybe_pace."""
        self._overload = {
            "overloaded": bool(p.get("overloaded")),
            "retry_after": float(p.get("retry_after") or 0.25),
            "ts": time.time(),
        }

    def overload_state(self) -> dict:
        """Snapshot of the last advisory overload push (tests/tooling)."""
        return dict(self._overload)

    def _maybe_pace(self) -> None:
        """Optional client-side pacing: while the GCS advertises
        overload AND this driver already has admission-rejected tasks
        parked for retry (i.e. it is demonstrably over its quota —
        pacing a driver that still has admission headroom would throttle
        it below the admitted rate), slow the submitter down by the
        advertised hint. Open-loop producers degrade to the admitted
        rate; throughput is sustained by the paced retries refilling
        freed slots. Bounded (<= 0.25s per submission) and only from
        user submit threads, never from rpc reader threads. Stale pushes
        (no re-broadcast within 5s — e.g. across a GCS restart) stop
        pacing on their own."""
        if not self.config.admission_pacing_enabled:
            return
        ov = self._overload
        if not (ov["overloaded"] and time.time() - ov["ts"] < 5.0):
            return
        with self._lock:
            over_quota = bool(self._paced)
        if over_quota:
            time.sleep(min(ov["retry_after"], 0.25))

    def _on_admission_reject(self, meta: dict, reply: dict) -> None:
        """A submit_task was refused by the GCS admission controller
        (typed, retryable — never a silent drop). With pacing enabled,
        park the meta for a delayed resubmission (budgeted by
        admission_pacing_max_s); otherwise (or once the budget is spent)
        the task's refs fail with ClusterOverloadedError, which ray.get
        raises to the caller. Runs on the rpc reader thread — no
        blocking work here."""
        retry_after = float(
            reply.get("retry_after") or self.config.admission_retry_after_s
        )
        now = time.time()
        self._overload = {
            "overloaded": True, "retry_after": retry_after, "ts": now,
        }
        deadline = meta.get("_adm_deadline")
        if deadline is None:
            deadline = now + self.config.admission_pacing_max_s
            meta["_adm_deadline"] = deadline
        if (
            self.config.admission_pacing_enabled
            and now + retry_after < deadline
        ):
            # capped exponential backoff per task: a large parked set
            # must not hammer the GCS with a reject storm every
            # retry_after window; slots freed by completions are
            # refilled by whichever parked tasks come due next
            tries = meta.get("_adm_tries", 0)
            meta["_adm_tries"] = tries + 1
            delay = retry_after * min(2 ** tries, 16)
            with self._lock:
                self._paced.append((now + delay, meta))
            return
        err = ClusterOverloadedError(
            f"task {meta['task_id'][:12]} rejected by the cluster "
            f"admission controller ({reply.get('error')}); retry after "
            f"{retry_after}s",
            retry_after_s=retry_after,
        )
        self._gc_queue.put(("fail_submit", (meta, err)))

    def _submit_blocking(self, gcs, meta: dict, timeout: float) -> dict:
        """Blocking submit_task that HONORS admission rejections: the
        reconnect-resubmit and lineage-repair paths must never drop a
        refused task on the floor — a rejection routes into the same
        pace-or-typed-fail machinery as the async path."""
        reply = gcs.call("submit_task", meta, timeout=timeout)
        if isinstance(reply, dict) and reply.get("overloaded"):
            self._on_admission_reject(meta, reply)
        else:
            meta.pop("_adm_deadline", None)
            meta.pop("_adm_tries", None)
        return reply

    # ----------------------------------------------------------- submission

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        # rpc-profiler operation spans (analysis/rpcflow.py): actor CALLS
        # only enqueue here — their frame is measured on the per-actor
        # dispatcher thread as "actor_call"
        p = _tracing.PROFILE
        if p is None or (spec.actor_id is not None
                         and not spec.actor_creation):
            return self._submit_task_inner(spec)
        with p.operation(
            "actor_create" if spec.actor_creation else "submit_task"
        ):
            return self._submit_task_inner(spec)

    def _submit_task_inner(self, spec: TaskSpec) -> List[ObjectRef]:
        if _metrics.ENABLED:
            _M_TASKS_SUBMITTED.inc_k(
                _K_SUBMIT_ACTOR if spec.actor_id is not None
                and not spec.actor_creation else _K_SUBMIT_TASK
            )
        refs = [
            ObjectRef.for_task_output(spec.task_id, i, owner=self.worker_id)
            for i in range(spec.num_returns)
        ]
        if spec.actor_id is not None and not spec.actor_creation:
            if spec.streaming:
                # actor-call results ride the per-actor request/response
                # channel, which has no mid-task push path; streamed actor
                # methods are local-mode-only for now
                raise NotImplementedError(
                    "num_returns='streaming' on actor methods is not "
                    "supported in cluster mode yet (plain streaming tasks "
                    "are)"
                )
            meta = self._make_meta(spec)
            with self._lock:
                self._inflight_outputs.update(r.id for r in refs)
            self._track_submission(spec.task_id, meta, refs)
            self._submit_actor_call_meta(spec.actor_id, meta, refs)
            return refs
        meta = self._make_meta(spec)
        if spec.actor_creation:
            self.gcs.call("register_actor", {
                "actor_id": spec.actor_id,
                "class_name": getattr(spec.func, "__name__", "Actor"),
                "max_restarts": spec.max_restarts,
                "name": spec.name,
            }, timeout=self._rpc_timeout)
        with self._lock:
            self._task_meta[spec.task_id] = meta
        self._track_submission(spec.task_id, meta, refs)
        if not spec.actor_creation:
            # advisory throttle (overload control plane): normal-task
            # submitters pace while the GCS advertises overload
            self._maybe_pace()
        self._submit_async(meta)
        return refs

    def _refresh_inflight_deps(self, meta: dict) -> None:
        """Recompute own_inflight vouchers against the CURRENT in-flight
        set at every (re)submission — the SINGLE source of vouchers (every
        GCS submit path runs through this: _submit_async, lineage repair's
        two direct submits, the reconnect resubmit). The stored meta is
        reused by retries and repair, possibly long after the vouched-for
        actor call completed — a stale voucher would make the GCS dep-gate
        park the consumer forever instead of declaring the dep lost.

        The voucher value is the submission TIMESTAMP: the GCS honors it
        as a lease (config own_inflight_lease_s) so a consumer whose owner
        never manages to publish the failed call's error object is
        eventually re-evaluated by a node-death sweep rather than parked
        forever."""
        with self._lock:
            inflight = self._inflight_outputs
            for d in meta.get("deps") or ():
                if d["id"] in inflight:
                    d["own_inflight"] = time.time()
                else:
                    d.pop("own_inflight", None)

    def _submit_async(self, meta: dict) -> None:
        """Async submit: the ack carries nothing the client uses on success
        (deps-lost outcomes also arrive as task_result pushes), and one
        blocking round trip per submission serialized bulk fan-outs. A
        SERVER-side failure means the task was never registered and no
        task_result will ever arrive — fail the refs (including publishing
        the error object so dependents waiting at the GCS dep gate unblock
        and raise instead of hanging)."""
        self._refresh_inflight_deps(meta)
        def _cb(fut, meta=meta):
            try:
                exc = fut.exception()
            except Exception:  # noqa: BLE001 - cancelled
                return
            if exc is None:
                reply = fut.result()
                if isinstance(reply, dict) and reply.get("overloaded"):
                    # typed admission rejection: pace-and-retry or fail
                    # the refs with ClusterOverloadedError — either way
                    # the submission terminally resolves
                    self._on_admission_reject(meta, reply)
                else:
                    # accepted: a stale pacing deadline must not
                    # insta-fail an unrelated rejection much later
                    meta.pop("_adm_deadline", None)
                    meta.pop("_adm_tries", None)
                return
            if isinstance(exc, ConnectionLost) and not (
                meta.get("actor_creation") or meta.get("actor_id")
            ):
                # connection loss on a NORMAL task is owned by the
                # reconnect loop, which resubmits every unfinished task —
                # failing the refs here would race it (error objects
                # published over outputs a successful resubmission is about
                # to produce). If the GCS never returns, the reconnect loop
                # fails these tasks itself on timeout. Actor submissions are
                # NOT resubmitted by that loop, so they fall through to the
                # failure drain below.
                return
            # genuine server-side rejection: route through the single
            # failure-drain thread (this callback fires on the gcs READER
            # thread where blocking RPCs are forbidden, and one thread per
            # failure would be a thread storm on bulk fan-out failures)
            self._gc_queue.put(("fail_submit", (meta,
                                                f"submission failed: {exc}")))

        self.gcs.call_async("submit_task", meta).add_done_callback(_cb)

    def _track_submission(self, task_id: str, meta: dict,
                          refs: List[ObjectRef]) -> None:
        """Refcount bookkeeping at submit: args pinned for the task's
        flight, outputs pinned until the result lands, lineage indexed."""
        pins = [d["id"] for d in meta.get("deps", ())] + [r.id for r in refs]
        with self._lock:
            self._ref_index.update({r.id: task_id for r in refs})
            self._task_outputs[task_id] = {r.id for r in refs}
            self._task_out_ids[task_id] = [r.id for r in refs]
            self._task_dep_ids[task_id] = [d["id"] for d in meta.get("deps", ())]
            self._task_pins[task_id] = pins
            for d in meta.get("deps", ()):
                self._lineage_consumers.setdefault(d["id"], set()).add(task_id)
            for oid in pins:
                self._pin(oid)
        for r in refs:
            self._register_ref(r)

    def _pickle_func(self, func):
        """Pickle a task function/class once and reuse the bytes (see
        _func_cache comment). Returns (bytes_or_None, closure_refs).

        Matches the reference's export-once semantics: changes to globals a
        dynamic function reads are frozen at first submission."""
        if func is None:
            return None, ()
        from ray_tpu_torch.core.object_ref import capture_refs

        key = id(func)
        with self._lock:
            hit = self._func_cache.get(key)
            if hit is not None and hit[0] is func:
                return hit[1], hit[2]
        captured: Dict[str, ObjectRef] = {}
        with capture_refs(lambda r: captured.setdefault(r.id, r)):
            data = serialization.dumps(func)
        refs = tuple(captured.values())
        with self._lock:
            self._func_cache[key] = (func, data, refs)
            while len(self._func_cache) > self._FUNC_CACHE_MAX:
                self._func_cache.popitem(last=False)
        return data, refs

    def _make_meta(self, spec: TaskSpec) -> dict:
        # Refs nested inside argument values are discovered during pickling
        # (ObjectRef construction hook fires for each __reduce__ round-trip
        # is not needed — dumps touches every ref's __reduce__, and the
        # worker-side loads reconstructs them under its own capture). Here
        # they are folded into deps so the owner pins them for the task's
        # flight and the GCS gates on their existence; marked nested=True so
        # the executing node skips prefetching them (the task may never
        # get() them). Reference: reference_count.cc AddNestedObjectIds.
        nested: Dict[str, ObjectRef] = {}
        top_level = {
            a.id for a in list(spec.args) + list(spec.kwargs.values())
            if isinstance(a, ObjectRef)
        }

        from ray_tpu_torch.core.object_ref import capture_refs

        def _saw(ref):
            if ref.id not in top_level:
                nested[ref.id] = ref

        func_b, func_refs = self._pickle_func(spec.func)
        for ref in func_refs:
            _saw(ref)  # closure-captured refs stay deps on EVERY submit
        with capture_refs(_saw):
            spec_bytes = serialization.dumps({
                "func_b": func_b,
                "args": spec.args,
                "kwargs": spec.kwargs,
                "method_name": spec.method_name,
            })
        deps = []
        # own_inflight vouchers are NOT stamped here: _refresh_inflight_deps
        # is the single source, run at every GCS submission (actor-call
        # metas never hit the gate, so they don't need vouchers at all)
        # _ref_index is mutated by the gc thread under _lock; reads take
        # it too (race sanitizer finding — a torn read here would stamp
        # a wrong producing task into the dep's lineage record)
        with self._lock:
            for ref in [a for a in list(spec.args) + list(spec.kwargs.values())
                        if isinstance(a, ObjectRef)] + list(nested.values()):
                if (ref.owner is not None and ref.owner != self.worker_id
                        and ref.id not in self._ref_index):
                    self._foreign.add(ref.id)
            for a in list(spec.args) + list(spec.kwargs.values()):
                if isinstance(a, ObjectRef):
                    deps.append({
                        "id": a.id,
                        # producing task, for owner-side lineage
                        # reconstruction
                        "task": a.task_id or self._ref_index.get(a.id),
                    })
            for ref in nested.values():
                deps.append({
                    "id": ref.id,
                    "task": ref.task_id or self._ref_index.get(ref.id),
                    "nested": True,
                })
        return {
            "task_id": spec.task_id,
            "name": spec.name,
            "runtime_env": self._process_runtime_env(spec.runtime_env),
            "class_key": spec.scheduling_class(),
            "resources": dict(spec.resources),
            "deps": deps,
            "spec_bytes": spec_bytes,
            "num_returns": spec.num_returns,
            "streaming": spec.streaming,
            "backpressure": spec.backpressure,
            "owner": self.worker_id,
            "actor_id": spec.actor_id,
            "actor_creation": spec.actor_creation,
            "max_concurrency": spec.max_concurrency,
            "retries_left": spec.retries_left,
            "strategy": {
                "kind": spec.strategy.kind,
                "node_id": spec.strategy.node_id,
                "soft": spec.strategy.soft,
                "placement_group_id": spec.strategy.placement_group_id,
                "bundle_index": spec.strategy.bundle_index,
                "labels_hard": spec.strategy.labels_hard,
                "labels_soft": spec.strategy.labels_soft,
            },
        }

    def _process_runtime_env(self, runtime_env) -> Optional[dict]:
        """Turn a validated runtime_env into its wire form: working_dir is
        zipped and stored ONCE in the GCS KV under its content hash
        (reference: runtime_env working_dir upload to GCS storage)."""
        if not runtime_env:
            return None
        from ray_tpu_torch.core import runtime_env as rtenv

        out = {}
        if runtime_env.get("env_vars"):
            out["env_vars"] = dict(runtime_env["env_vars"])
        wd = runtime_env.get("working_dir")
        if wd:
            import os as _os

            ck = ("wd", _os.path.realpath(wd))
            key = self._uploaded_rtenvs.get(ck)
            if key is None:
                key, data = rtenv.package_working_dir(wd)
                self.kv_put(key, data)
                self._uploaded_rtenvs[ck] = key
            out["working_dir_key"] = key
        mods = runtime_env.get("py_modules")
        if mods:
            import os as _os

            keys = []
            for m in mods:
                # cache key carries the packaging KIND: the same directory
                # zips with different layouts as working_dir vs py_module
                ck = ("pymod", _os.path.realpath(m))
                key = self._uploaded_rtenvs.get(ck)
                if key is None:
                    key, data = rtenv.package_py_module(m)
                    self.kv_put(key, data)
                    self._uploaded_rtenvs[ck] = key
                keys.append(key)
            out["py_modules_keys"] = keys
        if runtime_env.get("pip"):
            # wheels_dir must be reachable from the workers (same host or
            # shared storage — the reference makes the same assumption for
            # local py_modules/pip sources)
            out["pip"] = {
                "packages": list(runtime_env["pip"]["packages"]),
                "wheels_dir": runtime_env["pip"]["wheels_dir"],
            }
        return out or None

    # ------------------------------------------------------------ actor path

    def _submit_actor_call_meta(self, actor_id: str, meta: dict,
                                refs: List[ObjectRef]):
        """Ordered actor submission: one dispatcher thread per actor sends
        calls in submit order on one connection — frame order IS execution
        order at the actor (reference: actor_task_submitter.cc +
        actor_submit_queue.h sequence numbers). Responses resolve
        concurrently via future callbacks."""
        with self._lock:
            q = self._actor_queues.get(actor_id)
            if q is None:
                q = _ActorQueue()
                self._actor_queues[actor_id] = q
                t = threading.Thread(
                    target=self._actor_dispatch_loop,
                    args=(actor_id, q),
                    daemon=True,
                    name=f"actor-dispatch-{actor_id[:8]}",
                )
                t.start()
        q.put(meta, refs)

    def _actor_dispatch_loop(self, actor_id: str, q: _ActorQueue):
        # Calls pipeline freely while they target one daemon connection
        # (frame order = execution order there). Before switching to a NEW
        # node (restart/relocation) the loop drains all in-flight calls, so
        # a bounced call replayed at its original seq can never execute
        # after a later-seq call that raced onto the new node.
        inflight: set = set()
        flight_cv = threading.Condition()
        last_node: List[Optional[str]] = [None]
        # ordering guard state: highest seq handed to call_async, and
        # highest seq KNOWN to have executed (daemon answered with a real
        # execution outcome, not a routing bounce)
        max_sent: List[int] = [-1]
        max_execed: List[int] = [-1]

        def _done(seq):
            with flight_cv:
                inflight.discard(seq)
                flight_cv.notify_all()

        def _may_have_run(seq):
            # recorded BEFORE _done releases the in-flight slot: the
            # dispatcher's replay drain wakes on _done, so a later-recorded
            # max_execed could let a bounced call replay behind this one
            # (the exact inversion the guard exists to stop)
            with flight_cv:
                max_execed[0] = max(max_execed[0], seq)

        while True:
            got = q.get()
            if got is None:
                return
            seq, (meta, refs) = got
            # ride the wire so the daemon's invariant tracer can witness
            # per-caller execution order (analysis/invariants.py)
            meta["seq"] = seq

            def fail(err, refs=refs, meta=meta):
                for r in refs:
                    self.store.put(r, err, is_exception=True)
                self._finalize_actor_call(refs, err)
                self._release_task_deps(meta["task_id"])

            try:
                if seq <= max_sent[0]:
                    # REPLAY of a bounced call: later-seq calls may already
                    # be in flight (pipelining). Drain them first so their
                    # outcomes are known, then refuse to replay behind a
                    # later call that actually executed — sending seq k
                    # after seq k+1 ran on the new incarnation would break
                    # submission-order execution (the invariant sanitizer's
                    # actor-seq check). At-most-once semantics make failing
                    # the bounced call the correct outcome.
                    with flight_cv:
                        deadline = time.time() + 60
                        while inflight and time.time() < deadline:
                            flight_cv.wait(timeout=1.0)
                    if max_execed[0] > seq:
                        fail(ActorDiedError(
                            f"actor call (seq {seq}) bounced during a "
                            f"restart after a later call (seq "
                            f"{max_execed[0]}) already executed on the new "
                            "incarnation; replaying would reorder execution"
                        ))
                        continue
                info = self._actor_location(actor_id, wait=True, timeout=60)
                if info is None or info.get("state") == "DEAD":
                    fail(ActorDiedError(f"actor {actor_id} is dead"))
                    continue
                if info["node_id"] != last_node[0]:
                    with flight_cv:
                        deadline = time.time() + 60
                        while inflight and time.time() < deadline:
                            flight_cv.wait(timeout=1.0)
                    last_node[0] = info["node_id"]
                daemon = self._daemon(info["node_id"], info["addr"], info["port"])
                with flight_cv:
                    inflight.add(seq)
                    max_sent[0] = max(max_sent[0], seq)
                _p = _tracing.PROFILE
                if _p is None:
                    fut = daemon.call_async("actor_call", meta)
                else:
                    # the actor-call frame leaves HERE, not in submit_task
                    with _p.operation("actor_call"):
                        fut = daemon.call_async("actor_call", meta)
            except (ConnectionLost, OSError, Exception) as e:  # noqa: BLE001
                _done(seq)
                fail(ActorDiedError(f"actor call failed: {e!r}"))
                continue

            def on_done(f, seq=seq, meta=meta, refs=refs, actor_id=actor_id):
                try:
                    p = f.result()
                except (ConnectionLost, OSError) as e:
                    # the call left on the wire and may have run before its
                    # connection died: the replay guard counts it as run
                    _may_have_run(seq)
                    _done(seq)
                    # daemon died with the call possibly mid-execution:
                    # at-most-once — fail, never replay (reference: actor
                    # calls in flight at death get ActorDiedError)
                    err = ActorDiedError(f"actor node unreachable: {e}")
                    for r in refs:
                        self.store.put(r, err, is_exception=True)
                    self._finalize_actor_call(refs, err)
                    self._release_task_deps(meta["task_id"])
                    return
                except Exception as e:  # noqa: BLE001
                    _may_have_run(seq)
                    _done(seq)
                    err = TaskError(f"actor call failed: {e!r}")
                    for r in refs:
                        self.store.put(r, err, is_exception=True)
                    self._finalize_actor_call(refs, err)
                    self._release_task_deps(meta["task_id"])
                    return
                if p.get("status") != "ACTOR_UNREACHABLE":
                    # a real execution outcome (not a routing bounce):
                    # feeds the replay-ordering guard above
                    _may_have_run(seq)
                _done(seq)
                if p.get("status") == "ACTOR_UNREACHABLE" and \
                        self._maybe_replay_actor_call(actor_id, seq, meta, refs):
                    return
                self._apply_borrows(p)
                err = self._ingest_result(p, refs)
                self._finalize_actor_call(refs, err)
                self._release_task_deps(meta["task_id"])

            fut.add_done_callback(on_done)

    def _actor_location(self, actor_id, wait=False, timeout=30.0):
        deadline = time.time() + timeout
        while True:
            with self._lock:
                info = self._actor_cache.get(actor_id)
            if info and info.get("state") == "ALIVE" and info.get("node_id"):
                return info
            info = self.gcs.call("get_actor", {"actor_id": actor_id}, timeout=self._rpc_timeout)
            if info:
                with self._lock:
                    self._actor_cache[actor_id] = info
                if info.get("state") == "ALIVE" and info.get("addr"):
                    return info
                if info.get("state") == "DEAD":
                    return info
            if not wait or time.time() > deadline:
                return info
            time.sleep(0.05)

    def _on_actor_update(self, p):
        with self._lock:
            if p.get("state") == "DEAD":
                info = self._actor_cache.get(p["actor_id"])
                if info is not None:
                    info["state"] = "DEAD"
            else:
                # RESTARTING/ALIVE: the actor may come back on a different
                # node — drop the cache so the next call re-resolves
                self._actor_cache.pop(p["actor_id"], None)

    def _maybe_replay_actor_call(self, actor_id: str, seq: int, meta: dict,
                                 refs) -> bool:
        """Hold-and-replay during restart (reference: actor_task_submitter.cc
        queues calls while the actor is RESTARTING). Only routing misses —
        calls the daemon could not deliver to a worker — are replayed; they
        re-enter the queue at their original seq with a backoff so a
        restarting actor has time to surface in the GCS table."""
        n = meta.get("_replays", 0)
        if n >= 10:
            return False
        try:
            info = self.gcs.call("get_actor", {"actor_id": actor_id}, timeout=self._rpc_timeout)
        except Exception:  # noqa: BLE001
            return False
        if not info or info.get("state") == "DEAD":
            return False
        meta["_replays"] = n + 1
        with self._lock:
            self._actor_cache.pop(actor_id, None)
            q = self._actor_queues.get(actor_id)
        if q is None:
            return False
        q.put_replay(seq, meta, refs, delay=min(0.25 * (n + 1), 1.0))
        return True

    # ------------------------------------------------------------- results

    # --- streaming generators (protocol: core/generator.py; the consumer
    # half — ObjectRefGenerator calls these runtime hooks) ---

    def _on_stream_item(self, p: dict):
        """GCS push: a streaming task yielded an item. Small items arrive
        inline; big ones land as a __remote__ placeholder the normal get
        path fetches lazily. The store put wakes any parked generator."""
        ref = ObjectRef(p["object_id"], owner=self.worker_id)
        inline = p.get("inline")
        if inline is not None:
            rec = serialization.unpack(inline)
            self.store.put(ref, rec["v"], is_exception=rec["e"])
        else:
            self.store.put(
                ref, ("__remote__", p["node_id"]), is_exception=False
            )

    def stream_item_ready(self, ref: ObjectRef) -> bool:
        return self.store.contains(ref)

    def stream_locate(self, ref: ObjectRef) -> bool:
        """Was this stream item actually produced? (GCS directory check —
        authoritative even when the push announcement was lost.)"""
        try:
            loc = self.gcs.call("locate_object", {"object_id": ref.id}, timeout=self._rpc_timeout)
        except Exception:  # noqa: BLE001 - GCS mid-restart
            return False
        return bool(loc.get("nodes"))

    def stream_mark_remote(self, ref: ObjectRef) -> None:
        """Pull-through for a stream item whose push announcement was
        lost: a __remote__ placeholder makes get() fetch it by its GCS
        directory location (recorded server-side when the item was
        published, independent of the push)."""
        if not self.store.contains(ref):
            self.store.put(ref, ("__remote__", None), is_exception=False)

    def stream_read_end(self, ref: ObjectRef):
        """(value, is_exception) of the end marker, without raising task
        errors (they become the stream's final element)."""
        try:
            return self._get_one(ref, deadline=time.time() + 30.0), False
        except GetTimeoutError:
            raise
        except BaseException as e:  # noqa: BLE001 - the error IS the value
            return e, True

    def stream_wait_any(self, refs, timeout: float) -> None:
        self.store.wait(refs, 1, timeout)

    def stream_ack(self, task_id: str, consumed: int) -> None:
        try:
            self.gcs.call_async(
                "stream_ack", {"task_id": task_id, "consumed": consumed}
            )
        except Exception:  # noqa: BLE001 - ack loss only delays the window
            pass

    def _on_task_result(self, p: dict):
        task_id = p["task_id"]
        status = p.get("status")
        with self._lock:
            meta = self._task_meta.get(task_id)
        with self._lock:
            self._reconstructing.discard(task_id)
        if status in ("DEPS_LOST", "DEPS_UNAVAILABLE") and meta is not None:
            # lineage repair runs on its own thread (blocking GCS calls are
            # forbidden on this reader thread), then resubmits the consumer
            if meta.get("retries_left", 0) > 0:
                meta["retries_left"] -= 1
                lost = p.get("lost") or list(meta.get("deps") or ())
                threading.Thread(
                    target=self._repair_and_resubmit,
                    args=(meta, lost), daemon=True,
                    name=f"lineage-repair-{task_id[:8]}",
                ).start()
                return
            status = "NODE_DIED"  # budget exhausted: fall into fail path
        if status in ("NODE_DIED", "WORKER_DIED") and meta is not None:
            if meta.get("retries_left", 0) > 0:
                meta["retries_left"] -= 1
                try:
                    # MUST be async: this runs on the rpc reader thread, and
                    # a blocking call() would deadlock waiting for a response
                    # only this same thread can read
                    self._submit_async(meta)
                    return
                except Exception:
                    pass
            self._fail_task_refs(task_id, meta, p.get("error"))
            return
        refs = [
            ObjectRef.for_task_output(task_id, i, owner=self.worker_id)
            for i in range(meta.get("num_returns", 1) if meta else len(p.get("results", [])) or 1)
        ]
        self._apply_borrows(p)
        self._ingest_result(p, refs)
        self._release_task_deps(task_id)

    def _fail_task_refs(self, task_id: str, meta: dict, error) -> None:
        refs = [
            ObjectRef.for_task_output(task_id, i, owner=self.worker_id)
            for i in range(meta.get("num_returns", 1))
        ]
        # a pre-typed exception (e.g. ClusterOverloadedError) passes
        # through so ray.get raises the specific, retryable type
        err = (
            error if isinstance(error, BaseException)
            else TaskError(f"task failed after retries: {error}")
        )
        for r in refs:
            self.store.put(r, err, is_exception=True)
        # publish the error as the objects themselves so tasks waiting on
        # these outputs fail with it instead of hanging at the dependency
        # gate (reference: the owner stores the error object); enqueues to
        # the shared publisher thread, so safe from reader threads
        self._publish_error(refs, err)
        self._release_task_deps(task_id)

    def _repair_and_resubmit(self, meta: dict, lost_deps: List[dict]) -> None:
        """Owner-driven lineage repair (reference: object_recovery_manager.cc
        + lineage pinning): for each dep with no surviving copy, resubmit
        its producing task (deduped) or republish a locally-cached put()
        value; unrecoverable deps fail the consumer. Finally resubmits the
        consumer, which the GCS dep-gate holds until the args exist."""
        try:
            all_present = True
            for d in lost_deps:
                oid = d["id"]
                try:
                    loc = self.gcs.call("locate_object", {"object_id": oid}, timeout=self._rpc_timeout)
                except Exception:  # noqa: BLE001
                    loc = {}
                if loc.get("nodes"):
                    continue  # a copy survives; nothing to repair
                all_present = False
                # cheapest repair: republish a locally-cached value (inlined
                # small results, put() values) instead of recomputing
                entry = self.store.try_get(ObjectRef(oid))
                if entry is not None and not entry.is_exception and not (
                    isinstance(entry.value, tuple)
                    and len(entry.value) == 2
                    and entry.value[0] == "__remote__"
                ):
                    payload = serialization.pack({"e": False, "v": entry.value})
                    if self._republish(oid, payload):
                        continue
                # lineage: resubmit the producing task (deduped)
                ptid = d.get("task")
                with self._lock:
                    pmeta = self._task_meta.get(ptid) if ptid else None
                if pmeta is not None:
                    with self._lock:
                        if ptid in self._reconstructing:
                            continue  # another consumer already resubmitted
                        self._reconstructing.add(ptid)
                    try:
                        self._refresh_inflight_deps(pmeta)
                        self._submit_blocking(
                            self.gcs, pmeta, self._rpc_timeout
                        )
                    except Exception:
                        # leave the door open for a later repair attempt
                        with self._lock:
                            self._reconstructing.discard(ptid)
                        raise
                    continue
                self._fail_task_refs(
                    meta["task_id"], meta,
                    f"arg object {oid[:8]} lost and not reconstructable",
                )
                return
            if all_present and meta.get("_dep_refunds", 0) < 5:
                # every "lost" dep actually exists: this was a slow
                # transfer, not a failure — don't charge the retry budget
                meta["_dep_refunds"] = meta.get("_dep_refunds", 0) + 1
                meta["retries_left"] = meta.get("retries_left", 0) + 1
            self._refresh_inflight_deps(meta)
            self._submit_blocking(self.gcs, meta, self._rpc_timeout)
        except Exception as e:  # noqa: BLE001
            self._fail_task_refs(meta["task_id"], meta, f"lineage repair: {e!r}")

    def _publish_error(self, refs: List[ObjectRef], err: BaseException) -> None:
        """Queue an exception payload for publication into the cluster
        store under each ref's id, so dependents waiting on them unblock
        and raise. Non-blocking (safe from rpc reader/callback threads):
        ONE publisher thread drains the queue, retrying across re-picked
        nodes — consumers parked at the GCS gate on an own_inflight voucher
        have ONLY this publication to wake them, so best-effort isn't good
        enough, but a mass failure must also not spawn a thread per task.
        (Residual risk if no node accepts within an entry's window: those
        consumers stay parked until a node-death sweep sees the voucher's
        lease expire.)"""
        payload = serialization.pack({"e": True, "v": err})
        with self._err_pub_cv:
            self._err_pub_q.append(
                (list(refs), payload, time.time() + 15.0)
            )
            if self._err_pub_thread is None or not self._err_pub_thread.is_alive():
                self._err_pub_thread = threading.Thread(
                    target=self._err_pub_loop, daemon=True,
                    name="err-publish",
                )
                self._err_pub_thread.start()
            self._err_pub_cv.notify()

    def _err_pub_loop(self) -> None:
        while not self._closed:
            with self._err_pub_cv:
                while not self._err_pub_q and not self._closed:
                    self._err_pub_cv.wait(timeout=5.0)
                batch, self._err_pub_q = self._err_pub_q, []
            if not batch:
                continue
            node = self._pick_put_node()
            daemon = None
            if node is not None:
                try:
                    daemon = self._daemon(
                        node["node_id"], node["addr"], node["port"]
                    )
                except Exception:  # noqa: BLE001
                    daemon = None
            retry = []
            for refs, payload, deadline in batch:
                pending = []
                for r in refs:
                    try:
                        if daemon is None:
                            raise ConnectionLost("no put node")
                        daemon.call(
                            "put_object",
                            {"object_id": r.id, "payload": payload},
                            timeout=self._rpc_timeout,
                        )
                    except Exception:  # noqa: BLE001
                        pending.append(r)
                        daemon = None  # node bounced: re-pick next pass
                if pending and time.time() < deadline:
                    retry.append((pending, payload, deadline))
            if retry:
                time.sleep(0.5)
                with self._err_pub_cv:
                    self._err_pub_q = retry + self._err_pub_q

    def _finalize_actor_call(self, refs: List[ObjectRef],
                             err: Optional[BaseException] = None) -> None:
        """Close out an actor call's output refs: drop them from the
        in-flight set (the GCS dep-gate flag source), and on failure
        publish the error AS the objects so cluster-side consumers parked
        on them wake up and raise instead of waiting forever (the publish
        enqueues to the shared publisher thread — safe from the rpc
        reader/callback threads this runs on)."""
        with self._lock:
            for r in refs:
                self._inflight_outputs.discard(r.id)
        if err is not None:
            self._publish_error(list(refs), err)

    def _ingest_result(self, p: dict, refs: List[ObjectRef]):
        """Record a call's results locally; returns the error stored for
        failed calls (None on success) so callers can propagate it."""
        inline = p.get("inline", {})
        result_ids = {oid for oid, _ in p.get("results", [])}
        err = None
        for r in refs:
            if r.id in inline:
                rec = serialization.unpack(inline[r.id])
                self.store.put(r, rec["v"], is_exception=rec["e"])
            elif r.id in result_ids:
                # large result: remember location meta; fetched lazily on get
                with self._lock:
                    self._result_ready[r.id] = {"node_id": p["node_id"]}
                self.store.put(r, ("__remote__", p["node_id"]), is_exception=False)
            elif p.get("status") not in ("FINISHED", None):
                err_cls = (
                    ActorDiedError
                    if p.get("status") in ("ACTOR_DEAD", "ACTOR_UNREACHABLE")
                    else TaskError
                )
                err = err_cls(f"task failed: {p.get('error')}")
                self.store.put(r, err, is_exception=True)
        return err

    # --------------------------------------------------------------- objects

    def _local_shm(self, node_id: str):
        """Same-host shm attachment for a node, or None (segment names are
        node-unique, so attach succeeds only on the daemon's own host —
        reference: plasma client connecting to the local store only)."""
        with self._lock:
            cached = self._shm_conns.get(node_id)
            if cached is not None:
                return cached or None
            info = self._nodes.get(node_id) or {}
            name = info.get("shm_name")
        if not name:
            # node metadata not here yet: don't negative-cache — the nodes
            # broadcast may still be in flight
            return None
        try:
            from ray_tpu_torch.cluster.shm_store import ShmClientStore

            seg = ShmClientStore(name)
        except Exception:  # noqa: BLE001 - remote host / no native build
            seg = None
        with self._lock:
            self._shm_conns[node_id] = seg or False
        return seg

    def put(self, value: Any) -> ObjectRef:
        with _tracing.op_span("put"):
            return self._put_inner(value)

    def _put_inner(self, value: Any) -> ObjectRef:
        ref = ObjectRef(owner=self.worker_id)
        payload = serialization.pack({"e": False, "v": value})
        node = self._pick_put_node()
        if node is None:
            # no nodes yet: keep locally; remote workers can't fetch it, but
            # a clusterless driver can still get() it back
            self.store.put(ref, value)
            self._register_ref(ref)
            return ref
        daemon = self._daemon(node["node_id"], node["addr"], node["port"])
        seg = self._local_shm(node["node_id"])
        stored = False
        if seg is not None:
            stored = seg.put_with_make_room(ref.id, payload, daemon)
            if stored:
                daemon.call("note_object", {"object_id": ref.id},
                            timeout=self._rpc_timeout)
        if not stored:
            daemon.call("put_object",
                        {"object_id": ref.id, "payload": payload},
                        timeout=self._rpc_timeout)
        self.store.put(ref, value)  # local cache
        self._register_ref(ref)
        return ref

    def _republish(self, oid: str, payload: bytes) -> bool:
        """Put a lost object's cached value back on a live node for a
        repair. The owner's view can still list a node that is gone (an
        autoscaler just terminated it): a node that refuses, drops or
        times out the put is skipped for this repair and the next live
        node tried. False when no node took it."""
        tried: set = set()
        while True:
            node = self._pick_put_node(exclude=tried)
            if node is None:
                return False
            tried.add(node["node_id"])
            try:
                daemon = self._daemon(node["node_id"], node["addr"], node["port"])
                daemon.call("put_object", {"object_id": oid, "payload": payload},
                            timeout=self._rpc_timeout)
                return True
            except (OSError, RpcError):
                continue

    def _pick_put_node(self, exclude=()):
        with self._lock:
            alive = [
                dict(node_id=nid, **{k: n[k] for k in ("addr", "port")})
                for nid, n in self._nodes.items()
                if n.get("alive", True) and nid not in exclude
            ]
            if not alive:
                return None
            self._put_rr += 1
            return alive[self._put_rr % len(alive)]

    def _on_nodes(self, snapshot):
        with self._lock:
            self._nodes = snapshot

    def _daemon(self, node_id, addr, port) -> RpcClient:
        with self._lock:
            c = self._daemon_conns.get(node_id)
            if c is not None and not c._closed:
                return c
        c = RpcClient(addr, port, name=self.worker_id, peer=node_id)
        with self._lock:
            self._daemon_conns[node_id] = c
        return c

    def _fetch(self, ref: ObjectRef, timeout: float, allow_reconstruct: bool) -> Any:
        """Fetch a remote object payload via the directory; on total loss,
        resubmit the creating task once (lineage reconstruction, reference:
        object_recovery_manager.cc + lineage pinning in reference_count.cc)."""
        deadline = time.time() + timeout
        attempted_reconstruct = False
        while time.time() < deadline:
            loc = self.gcs.call("locate_object", {"object_id": ref.id}, timeout=self._rpc_timeout)
            for entry in loc.get("nodes", []):
                seg = self._local_shm(entry["node_id"])
                if seg is not None:
                    payload = seg.get_bytes(ref.id)
                    if payload is not None:
                        rec = serialization.unpack(payload)
                        self.store.put(ref, rec["v"], is_exception=rec["e"])
                        if rec["e"]:
                            raise rec["v"]
                        return rec["v"]
                daemon = self._daemon(entry["node_id"], entry["addr"], entry["port"])
                try:
                    payload = daemon.call(
                        "fetch_object", {"object_id": ref.id, "timeout": 5.0},
                        timeout=30.0,
                    )
                except (ConnectionLost, OSError):
                    continue
                if payload is not None:
                    rec = serialization.unpack(payload)
                    self.store.put(ref, rec["v"], is_exception=rec["e"])
                    if rec["e"]:
                        raise rec["v"]
                    return rec["v"]
            if not loc.get("nodes") and allow_reconstruct and not attempted_reconstruct:
                attempted_reconstruct = True
                with self._lock:
                    task_id = ref.task_id or self._ref_index.get(ref.id)
                    meta = self._task_meta.get(task_id) if task_id else None
                if meta is not None:
                    # result will arrive via the normal task_result push
                    self.store.delete([ref])
                    self._submit_blocking(self.gcs, meta, self._rpc_timeout)
                    return self._get_one(ref, deadline)
            time.sleep(0.05)
        raise ObjectLostError(f"object {ref.id[:8]} could not be retrieved")

    # ------------------------------------------------------------- data api

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        with self._lock:
            owned = ref.id in self._ref_index or ref.owner == self.worker_id
        while True:
            e = self.store.try_get(ref)
            if e is not None:
                if e.is_exception:
                    raise e.value if isinstance(e.value, BaseException) else TaskError(str(e.value))
                if (
                    isinstance(e.value, tuple)
                    and len(e.value) == 2
                    and e.value[0] == "__remote__"
                ):
                    remaining = 60.0 if deadline is None else max(0.1, deadline - time.time())
                    return self._fetch(ref, remaining, allow_reconstruct=True)
                return e.value
            if deadline is not None and time.time() >= deadline:
                raise GetTimeoutError(f"get timed out on {ref.id[:8]}")
            if not owned:
                # produced by another worker/driver: poll the directory
                loc = self.gcs.call("locate_object", {"object_id": ref.id}, timeout=self._rpc_timeout)
                if loc.get("nodes"):
                    remaining = 30.0 if deadline is None else max(0.1, deadline - time.time())
                    return self._fetch(ref, remaining, allow_reconstruct=False)
            try:
                self.store.get([ref], timeout=0.1)
            except GetTimeoutError:
                pass

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        with _tracing.op_span("get"):
            deadline = time.time() + timeout if timeout is not None else None
            return [self._get_one(ref, deadline) for ref in refs]

    def wait(self, refs, num_returns=1, timeout=None):
        """Owned refs resolve via task_result pushes into the local store
        (condition-variable wait, no polling); only refs owned elsewhere
        consult the GCS directory, at a coarse interval."""
        with _tracing.op_span("wait"):
            return self._wait_inner(refs, num_returns, timeout)

    def _wait_inner(self, refs, num_returns=1, timeout=None):
        deadline = time.time() + timeout if timeout is not None else None
        with self._lock:
            foreign = [
                r for r in refs
                if r.id not in self._ref_index and r.owner != self.worker_id
            ]
        foreign_ready: set = set()
        last_dir_poll = 0.0
        while True:
            ready = [
                r for r in refs
                if self.store.contains(r) or r.id in foreign_ready
            ]
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.time() >= deadline:
                break
            if foreign and time.time() - last_dir_poll > 0.25:
                last_dir_poll = time.time()
                for r in foreign:
                    if r.id in foreign_ready:
                        continue
                    loc = self.gcs.call("locate_object", {"object_id": r.id}, timeout=self._rpc_timeout)
                    if loc.get("nodes"):
                        foreign_ready.add(r.id)
                continue
            remaining = 0.2 if deadline is None else min(0.2, deadline - time.time())
            self.store.wait(refs, num_returns, timeout=max(0.05, remaining))
        ready_set = {r.id for r in ready[:num_returns]}
        return (
            [r for r in refs if r.id in ready_set],
            [r for r in refs if r.id not in ready_set],
        )

    def free(self, refs: List[ObjectRef]):
        self.store.delete(refs)
        self.gcs.call("free_objects", {"object_ids": [r.id for r in refs]}, timeout=self._rpc_timeout)

    # ------------------------------------------------------- compiled DAGs

    def _on_dag_update(self, p: dict) -> None:
        with self._lock:
            ent = self._dag_states.setdefault(p["dag_id"], {})
            ent["state"] = p.get("state")
            ent["error"] = p.get("error")

    # --- serve fast-path pair control plane (ray_tpu_torch/serve/fastpath.py):
    # registration-time only; steady-state requests ride the channels ---

    def serve_register(self, payload: dict) -> dict:
        return self.gcs.call("serve_register", payload,
                             timeout=self._rpc_timeout)

    def serve_teardown(self, pair_id: str) -> dict:
        return self.gcs.call("serve_teardown", {"pair_id": pair_id},
                             timeout=self._rpc_timeout)

    def node_alive(self, node_id: str) -> Optional[bool]:
        """Liveness of a node per this client's pushed snapshot (no RPC);
        None when the node is unknown. The fast-path router's parked
        reads probe this so a killed NODE (whose daemon can no longer
        poke its channels) still wakes the client."""
        with self._lock:
            n = self._nodes.get(node_id)
        return None if n is None else bool(n.get("alive", True))

    def node_suspicion(self, node_id: str) -> float:
        """Gray-failure suspicion score [0,1] of a node per this client's
        pushed snapshot (no RPC; 0.0 when unknown). The serve fast-path
        router folds this into its power-of-two choice so request share
        decays away from ALIVE-but-DEGRADED replicas before the GCS ever
        quarantines them."""
        with self._lock:
            n = self._nodes.get(node_id)
        if n is None:
            return 0.0
        if n.get("quarantined"):
            return 1.0
        try:
            return float(n.get("suspicion") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def dag_register(self, payload: dict) -> dict:
        return self.gcs.call("dag_register", payload, timeout=self._rpc_timeout)

    def dag_teardown(self, dag_id: str) -> dict:
        with self._lock:
            self._dag_states.pop(dag_id, None)
        return self.gcs.call("dag_teardown", {"dag_id": dag_id},
                             timeout=self._rpc_timeout)

    def dag_state(self, dag_id: str) -> dict:
        with self._lock:
            return dict(self._dag_states.get(dag_id) or {})

    # ---------------------------------------------------------------- misc

    def create_placement_group(self, pg_id, bundles, strategy, name=""):
        with _tracing.op_span("pg_create"):
            return self.gcs.call("create_placement_group", {
                "pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name,
            }, timeout=self._rpc_timeout)

    def remove_placement_group(self, pg_id):
        self.gcs.call("remove_placement_group", {"pg_id": pg_id}, timeout=self._rpc_timeout)

    def get_placement_group(self, pg_id):
        return self.gcs.call("get_placement_group", {"pg_id": pg_id}, timeout=self._rpc_timeout)

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        self.gcs.call("kill_actor", {"actor_id": actor_id}, timeout=self._rpc_timeout)
        with self._lock:
            info = self._actor_cache.get(actor_id)
            if info is not None:
                info["state"] = "DEAD"

    def cluster_resources(self) -> Dict[str, float]:
        return self.gcs.call("cluster_resources", timeout=self._rpc_timeout)

    def available_resources(self) -> Dict[str, float]:
        return self.gcs.call("available_resources", timeout=self._rpc_timeout)

    # ------------------------------------------------------------ state API

    def list_tasks(self, limit: int = 1000) -> List[dict]:
        return self.gcs.call("list_tasks", {"limit": limit}, timeout=self._rpc_timeout)

    def summarize_tasks(self) -> dict:
        """Full-history per-name/status counts from the GCS's incremental
        aggregates — exact at any task count, unlike listing events."""
        return self.gcs.call("summarize_tasks", {}, timeout=self._rpc_timeout)

    def list_actors(self) -> List[dict]:
        return self.gcs.call("list_actors", {}, timeout=self._rpc_timeout)

    def list_placement_groups(self) -> List[dict]:
        return self.gcs.call("list_placement_groups", {}, timeout=self._rpc_timeout)

    def list_objects(self, limit: int = 1000) -> List[dict]:
        return self.store.list_entries(limit)

    def summary(self) -> dict:
        return self.gcs.call("summary", {}, timeout=self._rpc_timeout)

    # ------------------------------------------------------------- kv store

    def kv_put(self, key: str, value):
        self.gcs.call("kv_put", {"key": key, "value": value}, timeout=self._rpc_timeout)

    def kv_get(self, key: str):
        return self.gcs.call("kv_get", {"key": key}, timeout=self._rpc_timeout)

    def kv_del(self, key: str):
        self.gcs.call("kv_del", {"key": key}, timeout=self._rpc_timeout)

    def kv_keys(self, prefix: str = ""):
        return self.gcs.call("kv_keys", {"prefix": prefix}, timeout=self._rpc_timeout)

    def nodes(self) -> List[dict]:
        raw = self.gcs.call("get_nodes", timeout=self._rpc_timeout)
        return [
            {"NodeID": nid, "Alive": n["alive"], "Resources": n["resources"],
             "Labels": n.get("labels", {}), "Stats": n.get("stats") or {},
             "Quarantined": bool(n.get("quarantined")),
             "Health": n.get("health", "OK"),
             "Suspicion": float(n.get("suspicion") or 0.0)}
            for nid, n in raw.items()
        ]

    def timeline(self) -> List[dict]:
        return self.gcs.call("list_tasks", timeout=self._rpc_timeout)

    def current_task_id(self):
        return None

    def current_actor_id(self):
        return None

    def shutdown(self):
        self._closed = True
        for q in self._actor_queues.values():
            q.close()
        for c in self._daemon_conns.values():
            c.close()
        self.gcs.close()
