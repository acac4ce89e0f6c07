"""Per-node daemon: worker pool + local object store + task execution.

Reference: the raylet (src/ray/raylet/) — main.cc/node_manager.cc wiring
WorkerPool (worker_pool.cc: PopWorker/StartWorkerProcess), the local object
store (object_manager/plasma/ — in-process here until the C++ shm store
lands), object transfer (object_manager.cc push/pull in chunks), and local
spilling (local_object_manager.cc).

Scheduling does NOT live here (centralized batched rounds in the GCS — see
cluster/__init__.py); the daemon executes `exec_task` pushes, which is the
lease-grant + dispatch half of the reference's
LocalTaskManager::DispatchScheduledTasksToWorkers.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.task_spec import new_id
from ray_tpu_torch.cluster import rpc as rpc_mod
from ray_tpu_torch.cluster.rpc import (
    ConnectionLost,
    RetryingRpcClient,
    RpcClient,
    RpcServer,
    log_rpc_failure,
)
from ray_tpu_torch.util import metrics as _metrics

#: Test-only regression switch (mirror of ``gcs.SEEDED_BUGS`` /
#: ``channel.SEEDED_BUGS``): known, FIXED concurrency bugs the race
#: sanitizer (analysis/racer.py) re-introduces to prove it still catches
#: them. Production code never populates this. Names:
#:
#: - ``"metrics-push-unlocked"``: re-introduces one of PR 6's 21
#:   node_daemon lock fixes — ``rpc_metrics_push`` appends to
#:   ``_worker_metrics`` WITHOUT ``_lock``, racing the heartbeat
#:   thread's drain (the exact rpc-loop/heartbeat pair the fix covered).
SEEDED_BUGS: set = set()

# --- observability (ray_tpu_torch.obs): daemon-side metrics, module-scope.
# Handler self-time carries an explicit ``node`` tag so the cluster
# aggregate keeps per-node attribution even in the embedded test topology
# where several daemons share one process registry.
_M_RPC_HANDLER = _metrics.Histogram(
    "ray_tpu_daemon_rpc_handler_s",
    "node-daemon rpc handler self-time per method",
    boundaries=(
        0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
        0.0025, 0.005, 0.01, 0.025, 0.1, 0.5, 2.0,
    ),
    tag_keys=("method", "node"),
)
_M_STORE_BYTES = _metrics.Gauge(
    "ray_tpu_object_store_bytes",
    "bytes resident in the node-local object store",
    tag_keys=("node",),
)
_M_STORE_SPILLED = _metrics.Gauge(
    "ray_tpu_object_store_spilled_objects",
    "objects spilled to disk by the node-local store",
    tag_keys=("node",),
)
_M_TASK_QUEUE = _metrics.Gauge(
    "ray_tpu_daemon_task_queue",
    "dispatched tasks waiting for a free worker on this node",
    tag_keys=("node",),
)
_M_IDLE_WORKERS = _metrics.Gauge(
    "ray_tpu_daemon_idle_workers",
    "idle pooled workers on this node",
    tag_keys=("node",),
)


class ObjectStore:
    """Node-local object store: packed payload bytes by object id, LRU
    spilling to disk when over budget (reference: plasma + local_object_manager
    spilling). Thread-safe; blocking get with timeout."""

    def __init__(self, capacity_bytes: int, spill_dir: str):
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._data: Dict[str, bytes] = {}
        self._spilled: Dict[str, str] = {}
        self._lru: deque = deque()
        self._size = 0

    def put(self, oid: str, payload: bytes) -> None:
        with self._cv:
            if oid in self._data or oid in self._spilled:
                return
            self._data[oid] = payload
            self._size += len(payload)
            self._lru.append(oid)
            self._maybe_spill()
            self._cv.notify_all()

    def _maybe_spill(self):
        while self._size > self.capacity and self._lru:
            victim = self._lru.popleft()
            payload = self._data.pop(victim, None)
            if payload is None:
                continue
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, victim)
            with open(path, "wb") as f:
                f.write(payload)
            self._spilled[victim] = path
            self._size -= len(payload)

    def get(self, oid: str, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while True:
                if oid in self._data:
                    try:
                        self._lru.remove(oid)
                    except ValueError:
                        pass
                    self._lru.append(oid)
                    return self._data[oid]
                if oid in self._spilled:
                    path = self._spilled[oid]
                    break
                if deadline is None or time.time() >= deadline:
                    return None
                self._cv.wait(timeout=min(0.1, max(0.0, deadline - time.time())))
        with open(path, "rb") as f:  # restore outside the lock
            payload = f.read()
        with self._cv:
            if oid in self._spilled:
                del self._spilled[oid]
                self._data[oid] = payload
                self._size += len(payload)
                self._lru.append(oid)
                self._maybe_spill()
            unlink = oid not in self._spilled  # may have re-spilled to same path
        if unlink:
            try:
                os.unlink(path)
            except OSError:
                pass
        return payload

    def object_size(self, oid: str) -> Optional[int]:
        with self._lock:
            payload = self._data.get(oid)
            if payload is not None:
                return len(payload)
            path = self._spilled.get(oid)
        if path is not None:
            try:
                return os.path.getsize(path)
            except OSError:
                return None
        return None

    def read_range(self, oid: str, offset: int, length: int) -> Optional[bytes]:
        with self._lock:
            payload = self._data.get(oid)
            if payload is not None:
                return payload[offset:offset + length]
            path = self._spilled.get(oid)
        if path is not None:
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    return f.read(length)
            except OSError:
                return None
        return None

    def contains(self, oid: str) -> bool:
        with self._lock:
            return oid in self._data or oid in self._spilled

    def object_ids(self) -> List[str]:
        with self._lock:
            return list(self._data) + list(self._spilled)

    def delete(self, oids: List[str]):
        with self._cv:
            for oid in oids:
                payload = self._data.pop(oid, None)
                if payload is not None:
                    self._size -= len(payload)
                    try:
                        self._lru.remove(oid)
                    except ValueError:
                        pass
                path = self._spilled.pop(oid, None)
                if path:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "objects": len(self._data) + len(self._spilled),
                "bytes_in_memory": self._size,
                "spilled": len(self._spilled),
            }


class _Worker:
    def __init__(self, worker_id: str, proc: subprocess.Popen):
        self.worker_id = worker_id
        self.proc = proc
        self.conn = None  # ServerConn once registered
        self.busy = False
        self.actor_id: Optional[str] = None
        self.current_task: Optional[dict] = None
        # compiled-DAG stages pinned to this worker: {(dag_id, stage)}
        self.dag_stages: set = set()
        # serve fast-path pairs attached to this worker's replica: {pair_id}
        self.serve_pairs: set = set()


class NodeDaemon:
    def __init__(
        self,
        gcs_addr,
        resources: Dict[str, float],
        node_id: Optional[str] = None,
        config: Optional[Config] = None,
        host: str = "127.0.0.1",
        labels: Optional[Dict[str, str]] = None,
    ):
        self.config = config or Config()
        self.node_id = node_id or new_id("node")
        # process-unique incarnation stamp: lets the GCS distinguish a
        # reconnect of THIS daemon (keep the resource row as-is) from a
        # fresh daemon re-using the node id (old incarnation's tasks and
        # capacity holds must be swept first)
        self.instance = new_id("inst")
        self.resources = dict(resources)
        self.host = host
        spill_root = self.config.object_spilling_dir or os.path.join(
            self.config.session_dir_root, "spill", self.node_id
        )
        # The C++ shm segment is the node's data plane (reference: plasma
        # runs inside the raylet); the dict store remains as a fallback when
        # the native build is unavailable.
        self.store: Any
        try:
            from ray_tpu_torch.cluster.shm_store import ShmNodeStore

            self.store = ShmNodeStore(
                self.config.object_store_memory_bytes, spill_root,
                # a prefix of the port's own: a reference cluster in the same
                # process with the same node ids must not reach this segment
                name=f"/rtt_{self.node_id[-12:]}_{os.getpid()}",
            )
            self.shm_name: Optional[str] = self.store.shm_name
        except Exception:  # noqa: BLE001 - no toolchain / shm mount
            traceback.print_exc()
            self.store = ObjectStore(
                self.config.object_store_memory_bytes, spill_root
            )
            self.shm_name = None

        self._lock = threading.Lock()
        # per-method handler-metric series keys for THIS node, built once
        # (per-call tag-dict builds cost more than the observation)
        self._m_handler_keys: Dict[str, tuple] = {}
        self.workers: Dict[str, _Worker] = {}
        self._idle: deque = deque()
        self._task_queue: deque = deque()  # tasks waiting for a worker
        # --- compiled-DAG state (ray_tpu_torch/dag): per-dag pinned stages and
        # the channel files living on this node. chan_dir is advertised in
        # register_node so same-host drivers map channels directly.
        self.chan_dir = os.path.join(
            self.config.session_dir_root, "dagchan", self.node_id
        )
        os.makedirs(self.chan_dir, exist_ok=True)
        self._dags: Dict[str, dict] = {}  # dag_id -> {stages, keys}
        # serve fast-path pairs homed on this node (ray_tpu_torch/serve/fastpath):
        # pair_id -> {worker_id, actor_id, keys, paths}; channels live in
        # _chan_index/_chan_paths like dag edges, so the relay fallback
        # (rpc_dag_push/rpc_dag_pull) and the death sweep cover them too
        self._serve_pairs: Dict[str, dict] = {}
        self._chan_paths: Dict[str, str] = {}  # channel key -> local path
        self._chan_index: Dict[str, Any] = {}  # key -> Channel this daemon holds
        self._dag_pending: deque = deque()  # stage specs awaiting a worker
        self._actor_tasks: Dict[str, dict] = {}  # task_id -> meta (actor rpc futures)
        self._pending_rpc: Dict[str, Any] = {}  # task_id -> asyncio future (actor calls)
        self._peer_clients: Dict[str, RpcClient] = {}
        self._bundles: Dict[str, dict] = {}
        # chunked-pull state: per-peer concurrency caps, same-object dedupe,
        # and a transfer counter (observable in tests/metrics)
        self._pull_sems: Dict[str, threading.Semaphore] = {}
        self._inflight_pulls: Dict[str, threading.Event] = {}
        self._chunks_pulled = 0
        # borrows held by local workers: worker_id -> {oid: owner_id}; a
        # dying worker's borrows are released on its behalf (reference:
        # reference_count.cc removes borrower entries on worker death)
        self._worker_borrows: Dict[str, Dict[str, str]] = {}
        # metric delta snapshots pushed by local workers (rpc_metrics_push),
        # folded into this node's next heartbeat export; guarded by _lock
        # (appended on the rpc loop, drained by the heartbeat thread).
        # _metrics_seq stamps each metrics-carrying beat so the GCS can
        # dedupe retry-plane resends of the same frame (heartbeat is in
        # RETRYABLE); a beat that FAILS requeues its delta here — the
        # deltas are stateful (each increment handed out exactly once by
        # snapshot_delta), so dropping one would undercount forever.
        self._worker_metrics: List[dict] = []
        self._metrics_seq = 0

        self.server = RpcServer(
            self._handle, host=host, port=0,
            on_disconnect=self._on_worker_disconnect, name=f"daemon-{self.node_id[:8]}",
        )
        self.port = self.server.start()

        self._stopped = False  # before any thread that reads it starts
        # fixed prefetch pool: dep-gated tasks queue here and a small set of
        # fetcher threads pulls their args (a thread PER task meant a burst
        # of 10k dep-bearing dispatches was 10k threads)
        self._prefetch_queue: "deque" = deque()
        self._prefetch_cv = threading.Condition()
        self._prefetch_threads = [
            threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name=f"daemon-prefetch-{i}",
            )
            for i in range(4)
        ]
        for t in self._prefetch_threads:
            t.start()
        self._gcs_addr = gcs_addr
        self._labels = dict(labels or {})
        self._nodes_snapshot: Dict[str, dict] = {}
        # Auto-reconnecting GCS session (reference: raylet reconnect +
        # resubscribe after GCS fault-tolerant restart): registration and
        # resync live in _gcs_session, replayed on every reconnect, so a
        # GCS restart is survivable at any point in the daemon's life.
        # Published on self BEFORE connect(): a task pushed the instant
        # register_node lands may hit handlers (e.g. _spawn_worker ->
        # self.gcs.host) while connect() is still on the stack.
        self.gcs = RetryingRpcClient(
            gcs_addr[0], gcs_addr[1], name=self.node_id, peer="gcs",
            on_session=self._gcs_session, auto_connect=False,
            config=self.config,
        )
        self.gcs.subscribe("exec_task", self._on_exec_task)
        self.gcs.subscribe("exec_tasks", self._on_exec_tasks)
        self.gcs.subscribe("cancel_task", self._on_cancel_task)
        self.gcs.subscribe("probe", self._on_probe)
        self.gcs.subscribe("kill_actor", self._on_kill_actor)
        self.gcs.subscribe(
            "free_objects", lambda p: self.store.delete(p["object_ids"])
        )
        self.gcs.subscribe("return_bundle", self._on_return_bundle)
        self.gcs.subscribe("dag_teardown", self._on_dag_teardown)
        self.gcs.subscribe("serve_teardown", self._on_serve_teardown)
        self.gcs.subscribe("nodes", self._on_nodes_update)
        self.gcs.connect()
        self._beat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="daemon-beat"
        )
        self._beat_thread.start()

    # ------------------------------------------------- GCS (re)connection

    def _gcs_session(self, gcs: RpcClient, first: bool):
        """(Re)establish this node's GCS session on a fresh connection:
        register, then on reconnects re-sync hosted actors and stored
        objects into the rebuilt tables (snapshot + O(delta) recovery on
        the GCS side)."""
        if self._stopped:
            # stop() raced a reconnect: a stopping daemon must not
            # resurrect itself (it would re-register as alive with its
            # store contents, then silently heartbeat-timeout again)
            raise ConnectionLost("daemon stopping")
        timeout = self.config.rpc_call_timeout_s
        reply = gcs.call("register_node", {
            "node_id": self.node_id, "addr": self.host, "port": self.port,
            "resources": self.resources, "labels": self._labels,
            "shm_name": self.shm_name, "instance": self.instance,
            "chan_dir": self.chan_dir,
        }, timeout=timeout)
        assert reply["ok"]
        if not first:
            with self._lock:
                actor_ids = [
                    w.actor_id for w in self.workers.values() if w.actor_id
                ]
            gcs.call("node_sync", {
                "node_id": self.node_id,
                "actor_ids": actor_ids,
                "object_ids": self.store.object_ids(),
            }, timeout=timeout)

    # ------------------------------------------------------------ worker pool

    def _spawn_worker(self) -> _Worker:
        worker_id = new_id("worker")
        env = dict(os.environ)
        env["RAY_TPU_DAEMON_PORT"] = str(self.port)
        env["RAY_TPU_DAEMON_HOST"] = self.host
        env["RAY_TPU_WORKER_ID"] = worker_id
        env["RAY_TPU_NODE_ID"] = self.node_id
        env["RAY_TPU_GCS_ADDR"] = f"{self.gcs.host}:{self.gcs.port}"
        # piped stdout would otherwise block-buffer user prints, stranding
        # them until process exit instead of streaming to the driver
        env["PYTHONUNBUFFERED"] = "1"
        if self.shm_name:
            env["RAY_TPU_SHM_NAME"] = self.shm_name
        env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        # Workers are fresh interpreters (never forked from this process,
        # which may have opened CUDA) and touch the card only when user
        # code does.
        stream_logs = self.config.log_to_driver
        # bufsize=0: the log pump select()s on the fd; a BufferedReader
        # would pull several lines into userspace per readline and leave
        # the rest invisible to select until the worker next prints
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.cluster.worker"],
            env=env,
            stdout=subprocess.PIPE if stream_logs else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if stream_logs else None,
            bufsize=0 if stream_logs else -1,
        )
        w = _Worker(worker_id, proc)
        with self._lock:
            self.workers[worker_id] = w
        if stream_logs:
            # tail the worker's merged stdout/stderr and forward to the GCS,
            # which fans lines out to drivers (reference:
            # python/ray/_private/log_monitor.py tailing worker log files)
            threading.Thread(
                target=self._log_pump, args=(w,), daemon=True,
                name=f"daemon-logpump-{worker_id[:8]}",
            ).start()
        return w

    def _log_pump(self, w: "_Worker"):
        import select

        batch: List[str] = []

        def flush():
            nonlocal batch
            if batch:
                # attribute the lines to the driver whose task is (or was
                # just) running here, so other drivers' consoles don't
                # receive them (reference: per-job log routing)
                t = w.current_task
                owner = (t or {}).get("owner")
                try:
                    self.gcs.call_async("worker_logs", {
                        "node_id": self.node_id,
                        "worker_id": w.worker_id,
                        "pid": w.proc.pid,
                        "owner": owner,
                        "lines": batch,
                    })
                except Exception:  # noqa: BLE001 - gcs reconnecting
                    pass
                batch = []

        pipe = w.proc.stdout
        fd = pipe.fileno()
        os.set_blocking(fd, False)
        carry = b""
        try:
            while not self._stopped:
                # select-with-timeout so a quiet pipe still flushes the tail
                # of a batch; reads are 64KB chunks with userspace line
                # splitting (bufsize=0 + readline would cost one syscall per
                # BYTE of worker output)
                ready, _, _ = select.select([pipe], [], [], 0.2)
                if not ready:
                    flush()
                    continue
                try:
                    chunk = os.read(fd, 65536)
                except BlockingIOError:
                    continue
                if not chunk:
                    break  # EOF: worker exited
                carry += chunk
                *lines, carry = carry.split(b"\n")
                for raw in lines:
                    batch.append(raw.decode(errors="replace"))
                if len(batch) >= 100:
                    flush()
        except (ValueError, OSError):
            pass  # pipe closed with the worker
        finally:
            if carry:
                batch.append(carry.decode(errors="replace"))
            flush()

    def _on_worker_disconnect(self, conn):
        worker_id = conn.meta.get("worker_id")
        if not worker_id:
            return
        with self._lock:
            w = self.workers.pop(worker_id, None)
            try:
                self._idle.remove(worker_id)
            except ValueError:
                pass
        # release the dead worker's borrows on its behalf, else the owners
        # defer frees forever
        for oid, owner in self._worker_borrows.pop(worker_id, {}).items():
            try:
                self.gcs.call_async("borrow_released", {
                    "object_id": oid, "owner": owner,
                    "worker_id": worker_id,
                })
            except Exception:  # noqa: BLE001
                pass
        if w and w.dag_stages:
            # a pinned compiled-DAG worker died mid-iteration: flag every
            # channel of its DAGs on this node CLOSED|ERROR (parked
            # readers/writers wake with ChannelClosedError, never hang)
            # and report up — the GCS pushes dag_update to the owner
            self._on_dag_worker_died(w)
        if w and w.serve_pairs:
            # same sweep for serve fast-path pairs: clients' parked reads
            # raise ChannelClosedError and the router reroutes in-flight
            # requests to surviving replicas
            self._on_serve_worker_died(w)
        if w and w.current_task:
            # worker crashed mid-task -> report failure (reference:
            # NodeManager worker death handling -> task failure)
            t = w.current_task
            self._report_done(t, status="WORKER_DIED",
                             error=f"worker {worker_id} died (exit {w.proc.poll()})")
        if w and w.actor_id:
            # resolve every in-flight actor call on this worker, else the
            # drivers' actor_call rpcs hang forever (pop under the lock —
            # _report_done re-acquires it, so it runs after)
            with self._lock:
                stranded = [
                    t for t in list(self._actor_tasks.values())
                    if t.get("actor_id") == w.actor_id
                ]
                for t in stranded:
                    self._actor_tasks.pop(t["task_id"], None)
            for t in stranded:
                self._report_done(
                    t, status="ACTOR_DEAD",
                    error=f"actor worker died (exit {w.proc.poll()})",
                )
            try:
                # async: this handler runs on the daemon's event loop (the
                # server's on_disconnect hook) — a blocking GCS round trip
                # here would stall all daemon rpc handling
                self.gcs.call_async("actor_died", {
                    "actor_id": w.actor_id,
                    "cause": f"worker process died (exit {w.proc.poll()})",
                }).add_done_callback(log_rpc_failure)
            except Exception:
                pass

    # ------------------------------------------------------------------ rpc

    def _handle(self, method, params, conn):
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            raise ValueError(f"unknown daemon method {method}")
        if not _metrics.ENABLED:
            return fn(params or {}, conn)
        t0 = time.perf_counter()
        try:
            return fn(params or {}, conn)
        finally:
            k = self._m_handler_keys.get(method)
            if k is None:
                k = self._m_handler_keys[method] = \
                    _M_RPC_HANDLER.series_key(
                        {"method": method, "node": self.node_id})
            _M_RPC_HANDLER.observe_k(k, time.perf_counter() - t0)

    def rpc_worker_ready(self, p, conn):
        worker_id = p["worker_id"]
        conn.meta["worker_id"] = worker_id
        with self._lock:
            w = self.workers.get(worker_id)
            if w is None:
                w = _Worker(worker_id, proc=None)
                self.workers[worker_id] = w
            w.conn = conn
            self._idle.append(worker_id)
        self._pump_dag_stages()
        self._pump()
        return {"ok": True, "node_id": self.node_id}

    def rpc_task_finished(self, p, conn):
        """Worker -> daemon: results arrive either already sealed in shm
        (result_shm: [(oid, size)]) or as packed payload bytes (fallback)."""
        for oid, payload in p.get("result_payloads", {}).items():
            self.store.put(oid, payload)
            if rpc_mod.TRACE is not None:
                rpc_mod.TRACE.apply("obj_put", oid=oid, node=self.node_id)
        if p.get("result_shm") and hasattr(self.store, "note"):
            for oid, _size in p["result_shm"]:
                self.store.note(oid)
                if rpc_mod.TRACE is not None:
                    rpc_mod.TRACE.apply("obj_put", oid=oid, node=self.node_id)
        worker_id = conn.meta.get("worker_id")
        if p.get("borrows") and worker_id:
            held = self._worker_borrows.setdefault(worker_id, {})
            for b in p["borrows"]:
                held[b["id"]] = b["owner"]
        # actor calls are tracked by task id (several can be in flight on one
        # worker); pool tasks by the worker's current_task slot
        with self._lock:
            t = self._actor_tasks.pop(p["task_id"], None)
            w = self.workers.get(worker_id)
            if w is not None and t is None and w.current_task is not None \
                    and w.current_task["task_id"] == p["task_id"]:
                t = w.current_task
            if w is not None and t is not None and w.current_task is t:
                w.current_task = None
            if w is not None and w.actor_id is None and w.current_task is None:
                w.busy = False
                self._idle.append(worker_id)
        if t is not None:
            results = [
                (oid, len(pl)) for oid, pl in p.get("result_payloads", {}).items()
            ] + [tuple(r) for r in p.get("result_shm", [])]
            self._report_done(
                t, status=p.get("status", "FINISHED"), error=p.get("error"),
                results=results,
                start=p.get("start"), end=p.get("end"),
                borrows=p.get("borrows"), borrow_worker=worker_id,
            )
        self._pump()
        return {"ok": True}

    def rpc_stream_item(self, p, conn):
        """Worker -> daemon: a streaming task yielded an item. Store the
        payload (shm items were already sealed by the worker), then relay
        the announcement to the GCS, which records the location and pushes
        it to the owner. Small payloads ride inline all the way to the
        driver (reference: small-return inlining)."""
        payload = p.get("payload")
        if payload is not None:
            self.store.put(p["object_id"], payload)
        elif hasattr(self.store, "note"):
            self.store.note(p["object_id"])
        if rpc_mod.TRACE is not None:
            rpc_mod.TRACE.apply(
                "obj_put", oid=p["object_id"], node=self.node_id
            )
        inline = None
        if (
            payload is not None
            and len(payload) <= self.config.max_direct_call_object_size
        ):
            inline = payload
        try:
            self.gcs.call_async("stream_item", {
                "task_id": p["task_id"],
                "object_id": p["object_id"],
                "node_id": self.node_id,
                "inline": inline,
            }).add_done_callback(log_rpc_failure)
        except Exception:
            traceback.print_exc()
        return {"ok": True}

    def rpc_stream_ack(self, p, conn):
        """GCS -> daemon: forward a consumer ack to the worker running the
        streaming task so its backpressure window widens."""
        tid = p["task_id"]
        w = None
        with self._lock:
            for ww in self.workers.values():
                ct = ww.current_task
                if ct is not None and ct.get("task_id") == tid:
                    w = ww
                    break
        if w is not None and w.conn is not None:
            self.server.call_soon(
                lambda c=w.conn: asyncio.ensure_future(
                    c.push("stream_ack", {
                        "task_id": tid, "consumed": int(p["consumed"]),
                    })
                )
            )
        return {"ok": True}

    def rpc_get_object(self, p, conn):
        """Workers/drivers resolve objects through the daemon: local store
        hit, else locate via GCS directory + pull from the peer daemon
        (reference: pull_manager.cc / ObjectManager chunked pull). Runs on
        the thread pool — blocking here would stall the daemon's event loop
        (and with it task_finished handling: a same-node producer could then
        never publish the object being waited on)."""
        return self.server.loop.run_in_executor(
            None,
            lambda: self._get_object_bytes(p["object_id"], timeout=p.get("timeout", 30.0)),
        )

    def rpc_fetch_object(self, p, conn):
        """Peer daemons / drivers fetch a locally-stored object whole (small
        objects; big ones go through object_info + fetch_chunk)."""
        timeout = p.get("timeout", 0.0)
        if timeout <= 0:
            return self.store.get(p["object_id"], timeout=0.0)
        return self.server.loop.run_in_executor(
            None, lambda: self.store.get(p["object_id"], timeout=timeout)
        )

    def rpc_object_info(self, p, conn):
        """Size probe ahead of a pull: lets the puller pick whole-frame vs
        chunked (reference: object directory size metadata consulted by
        pull_manager.cc before requesting pushes)."""
        return {"size": self.store.object_size(p["object_id"])}

    def rpc_fetch_chunk(self, p, conn):
        """One bounded piece of an object (reference: object_manager.cc
        serves objects in object_buffer_pool chunks over gRPC). Off the
        event loop: read_range may touch spilled files on disk. Each reply
        frame is ~chunk-sized, so a 2GB object never occupies the peer's
        event loop or one giant pickle frame."""
        return self.server.loop.run_in_executor(
            None,
            lambda: self.store.read_range(
                p["object_id"], int(p["offset"]), int(p["length"])
            ),
        )

    def rpc_borrow_released(self, p, conn):
        """Worker notify: its last local reference to a borrowed object is
        gone. Relay to the GCS, which routes it to the owner."""
        worker_id = p.get("worker_id") or conn.meta.get("worker_id")
        held = self._worker_borrows.get(worker_id or "", {})
        held.pop(p["object_id"], None)
        try:
            self.gcs.call_async("borrow_released", {
                "object_id": p["object_id"], "owner": p.get("owner"),
                "worker_id": worker_id,
            })
        except Exception:  # noqa: BLE001
            pass
        return {"ok": True}

    def rpc_make_room(self, p, conn):
        """Attached writer (worker/driver) hit StoreFullError: spill LRU
        objects so its retry can fit (reference: create_request_queue.cc
        retrying creates after eviction/spill)."""
        if hasattr(self.store, "make_room"):
            freed = self.store.make_room(int(p["nbytes"]))
            return {"ok": True, "freed": freed}
        return {"ok": False, "freed": 0}

    def rpc_note_object(self, p, conn):
        """Attached writer sealed an object directly in shm: register it and
        publish its location."""
        if hasattr(self.store, "note"):
            self.store.note(p["object_id"])
        if rpc_mod.TRACE is not None:
            rpc_mod.TRACE.apply(
                "obj_put", oid=p["object_id"], node=self.node_id
            )
        try:
            # async: rpc handlers run on the event loop; the location
            # publish must not block it on a GCS round trip
            self.gcs.call_async("add_object_location", {
                "object_id": p["object_id"], "node_id": self.node_id,
            }).add_done_callback(log_rpc_failure)
        except Exception:
            pass
        return {"ok": True}

    def rpc_put_object(self, p, conn):
        self.store.put(p["object_id"], p["payload"])
        if rpc_mod.TRACE is not None:
            rpc_mod.TRACE.apply(
                "obj_put", oid=p["object_id"], node=self.node_id
            )
        try:
            self.gcs.call_async("add_object_location", {
                "object_id": p["object_id"], "node_id": self.node_id,
            }).add_done_callback(log_rpc_failure)
        except Exception:
            pass
        return {"ok": True}

    def rpc_actor_call(self, p, conn):
        """Driver -> daemon: run an actor method, await completion (the rpc
        response carries the result metadata; payloads go through the store)."""
        fut = self.server.loop.create_future()
        with self._lock:
            self._pending_rpc[p["task_id"]] = fut
        self._dispatch_actor_task(p)
        return fut

    def rpc_metrics_push(self, p, conn):
        """Worker -> daemon (notify): a worker process's metric registry
        delta; queued here and folded into the node's next heartbeat
        export (workers have no GCS connection of their own)."""
        if "metrics-push-unlocked" in SEEDED_BUGS:
            # SEEDED BUG (test-only; see SEEDED_BUGS above): the append
            # lands outside _lock, racing the heartbeat thread's drain —
            # the re-introduced PR 6 fix the race sanitizer must catch.
            self._worker_metrics.append(p["delta"])  # ray-lint: disable=cross-thread-field-write
            return
        with self._lock:
            self._worker_metrics.append(p["delta"])

    def rpc_stats(self, p, conn):
        with self._lock:
            return {
                "node_id": self.node_id,
                "workers": len(self.workers),
                "idle": len(self._idle),
                "queued": len(self._task_queue),
                "store": self.store.stats(),
            }

    # --------------------------------------------------------- task dispatch

    def _on_exec_tasks(self, ts: List[dict]):
        """Batched dispatch frame: per-task isolation — one bad task (e.g.
        a worker-spawn OSError) must not strand the rest of the batch in
        the GCS running table."""
        for t in ts:
            try:
                self._on_exec_task(t)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                try:
                    self._report_done(
                        t, status="WORKER_DIED",
                        error="daemon failed to accept dispatch",
                    )
                except Exception:  # noqa: BLE001
                    traceback.print_exc()

    def _on_exec_task(self, t: dict):
        # nested deps (refs inside arg values) are pinned/gated but NOT
        # prefetched — the task may never get() them, and a worker that does
        # resolves them through the normal pull path on demand
        missing = [
            d["id"] for d in t.get("deps") or ()
            if not d.get("nested") and not self.store.contains(d["id"])
        ]
        if missing:
            # pull args into the local store FIRST; the task reaches a
            # worker only with args local, so workers never block holding
            # their slot (reference: local_task_manager.cc dispatches only
            # when DependencyManager reports args local)
            with self._prefetch_cv:
                self._prefetch_queue.append((t, missing))
                self._prefetch_cv.notify()
            return
        with self._lock:
            self._task_queue.append(t)
        self._pump()

    def _prefetch_loop(self):
        while True:
            with self._prefetch_cv:
                while not self._prefetch_queue and not self._stopped:
                    self._prefetch_cv.wait(timeout=1.0)
                if self._stopped:
                    return
                t, missing = self._prefetch_queue.popleft()
            self._prefetch_then_queue(t, missing)

    def _prefetch_then_queue(self, t: dict, missing: List[str]):
        for oid in missing:
            if self._stopped:
                return
            if not self._ensure_local(
                oid, timeout=self.config.object_fetch_timeout_s
            ):
                self._report_done(
                    t, status="DEPS_UNAVAILABLE",
                    error=f"arg object {oid[:8]} unavailable on "
                          f"{self.node_id}",
                    lost=[d for d in t.get("deps") or ()
                          if d["id"] == oid],
                )
                return
        if self._stopped:
            return
        with self._lock:
            self._task_queue.append(t)
        self._pump()

    def _pump(self):
        """Match queued tasks to idle workers; spawn when the pool is short
        (reference: WorkerPool::PopWorker + StartWorkerProcess prestart)."""
        while True:
            with self._lock:
                if not self._task_queue:
                    return
                if self._idle:
                    worker_id = self._idle.popleft()
                    w = self.workers.get(worker_id)
                    if w is None or w.conn is None:
                        continue
                    t = self._task_queue.popleft()
                    w.busy = True
                    w.current_task = t
                    if t.get("actor_creation"):
                        w.actor_id = t.get("actor_id")
                    conn = w.conn
                else:
                    limit = self.config.num_workers_soft_limit or max(
                        int(self.resources.get("CPU", 4)) + 2, 4
                    )
                    if len(self.workers) < limit + sum(
                        1 for w in self.workers.values() if w.actor_id
                    ):
                        spawn = True
                    else:
                        spawn = False
                    t = None
            if t is None:
                if spawn:
                    self._spawn_worker()
                return
            self.server.call_soon(
                lambda c=conn, task=t: asyncio.ensure_future(c.push("run_task", task))
            )

    def _on_cancel_task(self, p: dict):
        """GCS push: a speculative race for this task was decided elsewhere
        (or the copy here lost) — stop burning capacity on it. Queued: the
        task is silently dropped (the GCS already released this node's
        hold and treats the execution as cancelled). Running: the worker is
        killed — on a gray node it is likely wedged, and in-process task
        preemption doesn't exist; the resulting WORKER_DIED report is
        dropped by the GCS's loser filter."""
        tid = p.get("task_id")
        with self._prefetch_cv:
            for item in list(self._prefetch_queue):
                if item[0].get("task_id") == tid:
                    self._prefetch_queue.remove(item)
                    return
        victim = None
        with self._lock:
            for t in list(self._task_queue):
                if t.get("task_id") == tid:
                    self._task_queue.remove(t)
                    return
            for w in self.workers.values():
                t = w.current_task
                if (
                    t is not None and t.get("task_id") == tid
                    and not w.actor_id
                ):
                    victim = w
                    break
        if victim is not None:
            try:
                victim.proc.kill()
            except Exception:  # noqa: BLE001 - already exiting
                pass

    def _on_probe(self, p: dict):
        """GCS push while this node is quarantined: run a tiny probe
        execution off-thread and report how long it took. The chaos exec
        hook is consulted so an injected gray node answers slowly — and a
        wedged (factor=inf) one never answers — probes must experience
        what real tasks experience, or recovery verification would lie.
        Off-thread because a slow probe must not stall the push loop."""
        def run():
            t0 = time.time()
            ch = rpc_mod.CHAOS
            if ch is not None:
                factor = ch.on_exec(self.node_id, "__probe__")
                if factor == float("inf"):
                    return  # wedged: quarantine stays sticky
                if factor > 1.0:
                    # emulate a 50ms-equivalent task under the slow factor
                    time.sleep(min((factor - 1.0) * 0.05, 600.0))
            try:
                self.gcs.call_async("probe_result", {
                    "node_id": self.node_id,
                    "probe_id": p.get("probe_id"),
                    "sent_at": p.get("sent_at"),
                    "elapsed": time.time() - t0,
                })
            except Exception:  # noqa: BLE001 - daemon may be shutting down
                pass

        threading.Thread(
            target=run, daemon=True, name=f"probe-{self.node_id[:8]}"
        ).start()

    def _dispatch_actor_task(self, t: dict):
        aid = t["actor_id"]
        with self._lock:
            w = next(
                (w for w in self.workers.values() if w.actor_id == aid), None
            )
        if w is None or w.conn is None:
            with self._lock:
                fut = self._pending_rpc.pop(t["task_id"], None)
            if fut is not None:
                self.server.call_soon(
                    lambda: fut.set_result({
                        # routing miss (actor moved/restarting) — the client
                        # re-resolves the location and replays the call
                        "status": "ACTOR_UNREACHABLE", "task_id": t["task_id"],
                        "node_id": self.node_id, "results": [], "inline": {},
                        "error": f"actor {aid} not on node {self.node_id}",
                    }) if not fut.done() else None
                )
            return
        with self._lock:
            self._actor_tasks[t["task_id"]] = t
        if rpc_mod.TRACE is not None:
            # the call reached a hosted worker: it WILL execute (serially,
            # in arrival order) — the unit the per-caller seq-monotonicity
            # invariant is defined over. Bounced calls (no worker) never
            # get here.
            rpc_mod.TRACE.apply(
                "actor_exec", actor=aid, seq=t.get("seq"),
                owner=t.get("owner"), task=t["task_id"],
                worker=w.worker_id, node=self.node_id,
            )
        self.server.call_soon(
            lambda c=w.conn, task=t: asyncio.ensure_future(c.push("run_task", task))
        )

    def _report_done(self, t: dict, status: str, error=None, results=None,
                     start=None, end=None, lost=None, borrows=None,
                     borrow_worker=None):
        task_id = t["task_id"]
        with self._lock:
            fut = self._pending_rpc.pop(task_id, None)
        payload = {
            "lost": lost or [],
            "task_id": task_id,
            "node_id": self.node_id,
            "status": status,
            "error": error,
            "results": results or [],
            "name": t.get("name"),
            "actor_id": t.get("actor_id"),
            "actor_creation": t.get("actor_creation", False),
            "owner_conn": t.get("owner_conn"),
            "start": start,
            "end": end,
            "borrows": borrows or [],
            "borrow_worker": borrow_worker,
        }
        if borrows and fut is not None:
            # actor-call results bypass the GCS; register the borrows there
            # explicitly so node-death cleanup still covers them
            try:
                self.gcs.call_async("register_borrows", {
                    "node_id": self.node_id, "worker_id": borrow_worker,
                    "borrows": borrows,
                })
            except Exception:  # noqa: BLE001
                pass
        # inline small results so the driver skips the fetch round trip
        inline = {}
        budget = self.config.max_direct_call_object_size
        for oid, size in payload["results"]:
            if size <= budget:
                data = self.store.get(oid, timeout=0.1)
                if data is not None:
                    inline[oid] = data
        payload["inline"] = inline
        if fut is not None:  # actor call: answer the driver rpc directly
            self.server.call_soon(
                lambda: fut.set_result(payload) if not fut.done() else None
            )
            with self._lock:
                self._actor_tasks.pop(task_id, None)
            # actor results bypass task_done's batched directory add (the
            # future above answers the driver directly), so the daemon
            # publishes their locations itself — in ONE batched frame, on
            # the async path (_report_done runs on the event loop here)
            from ray_tpu_torch.cluster import gcs as gcs_mod

            oids = [oid for oid, _ in payload["results"]]
            if "per-object-location-loop" in gcs_mod.SEEDED_BUGS:
                # SEEDED BUG (test-only; see gcs.SEEDED_BUGS): the
                # pre-batching N+1 — one add_object_location frame per
                # result. rpc-in-loop must flag it statically and the rpc
                # profiler must catch the budget breach dynamically.
                for oid in oids:
                    try:
                        self.gcs.call_async("add_object_location", {  # ray-lint: disable=rpc-in-loop
                            "object_id": oid, "node_id": self.node_id,
                        }).add_done_callback(log_rpc_failure)
                    except Exception:
                        pass
                return
            if oids:
                try:
                    self.gcs.call_async("add_object_location", {
                        "object_ids": oids, "node_id": self.node_id,
                    }).add_done_callback(log_rpc_failure)
                except Exception:
                    pass
            return
        try:
            # async: this runs on the daemon's event loop for pool tasks —
            # a blocking call would stall ALL daemon rpc handling for a GCS
            # round trip per completed task (measured: it capped end-to-end
            # cluster throughput at ~140 tasks/s). Remote failures surface
            # via the future's callback, not silently vanish.
            self.gcs.call_async("task_done", payload).add_done_callback(
                log_rpc_failure
            )
        except Exception:
            traceback.print_exc()

    # ------------------------------------------------------------- transfers

    def _get_object_bytes(self, oid: str, timeout: float) -> Optional[bytes]:
        if self._ensure_local(oid, timeout):
            return self.store.get(oid, timeout=1.0)
        return None

    def _ensure_local(self, oid: str, timeout: float) -> bool:
        """Make the object resident in the local store (pulling from a peer
        if needed) without materializing an extra host copy — chunked pulls
        stream straight into a pre-allocated shm buffer."""
        if self.store.contains(oid):
            return True
        deadline = time.time() + timeout
        while time.time() < deadline and not self._stopped:
            # same-object dedupe: one puller does the transfer, the rest wait
            with self._lock:
                ev = self._inflight_pulls.get(oid)
                if ev is None:
                    ev = threading.Event()
                    self._inflight_pulls[oid] = ev
                    i_pull = True
                else:
                    i_pull = False
            if not i_pull:
                ev.wait(timeout=max(0.0, deadline - time.time()))
                if self.store.contains(oid):
                    return True
                continue  # puller failed; take over on the next lap
            try:
                try:
                    loc = self.gcs.call(
                        "locate_object", {"object_id": oid},
                        timeout=self.config.rpc_call_timeout_s,
                    )
                except Exception:
                    return False
                for entry in loc.get("nodes", []):
                    if entry["node_id"] == self.node_id:
                        continue
                    peer = self._peer(
                        entry["node_id"], entry["addr"], entry["port"]
                    )
                    if peer is None:
                        continue
                    if self._pull_from_peer(
                        peer, entry["node_id"], oid, deadline
                    ):
                        if rpc_mod.TRACE is not None:
                            rpc_mod.TRACE.apply(
                                "obj_put", oid=oid, node=self.node_id,
                                pulled=True,
                            )
                        try:
                            self.gcs.call("add_object_location", {
                                "object_id": oid, "node_id": self.node_id,
                            }, timeout=self.config.rpc_call_timeout_s)
                        except Exception:
                            pass
                        return True
            finally:
                with self._lock:
                    self._inflight_pulls.pop(oid, None)
                ev.set()
            # object may be produced by an in-flight task: wait for local
            if self.store.get(oid, timeout=0.2) is not None:
                return True
        return self.store.contains(oid)

    def _pull_from_peer(self, peer: RpcClient, peer_node_id: str,
                        oid: str, deadline: float) -> bool:
        chunk_bytes = self.config.object_transfer_chunk_bytes
        try:
            info = peer.call("object_info", {"object_id": oid}, timeout=10.0)
        except Exception:
            return False
        size = (info or {}).get("size")
        if size is None:
            return False
        if size <= chunk_bytes:
            try:
                payload = peer.call(
                    "fetch_object", {"object_id": oid, "timeout": 5.0},
                    timeout=30.0,
                )
            except Exception:
                return False
            if payload is None:
                return False
            self.store.put(oid, payload)
            return True
        return self._pull_chunked(
            peer, peer_node_id, oid, size, chunk_bytes, deadline
        )

    def _pull_chunked(self, peer: RpcClient, peer_node_id: str, oid: str,
                      size: int, chunk_bytes: int, deadline: float) -> bool:
        """Stream a big object in chunk_bytes pieces with a bounded pipeline
        window, at most object_pull_max_concurrent big pulls per peer
        (reference: pull_manager.cc + object_buffer_pool.cc). The peer's
        event loop only ever sees chunk-sized frames, so its small-RPC
        latency stays bounded during the transfer."""
        with self._lock:
            sem = self._pull_sems.get(peer_node_id)
            if sem is None:
                sem = threading.Semaphore(
                    max(int(self.config.object_pull_max_concurrent), 1)
                )
                self._pull_sems[peer_node_id] = sem
        with sem:
            buf = None
            if hasattr(self.store, "begin_streaming_put"):
                buf = self.store.begin_streaming_put(oid, size)
            assemble = bytearray(size) if buf is None else None
            dst = buf if buf is not None else memoryview(assemble)
            window = max(int(self.config.object_pull_window), 1)
            offsets = list(range(0, size, chunk_bytes))
            inflight: Dict[int, Any] = {}  # offset -> future
            # A big healthy transfer may legitimately outlive the caller's
            # fetch deadline; grant a bandwidth-floor allowance (10MB/s)
            # beyond it so only genuinely stalled pulls abort, and cap every
            # chunk wait so one dead peer never wedges the pull thread.
            xfer_deadline = max(deadline, time.time()) + size / (10 << 20)
            try:
                oi = 0
                while oi < len(offsets) or inflight:
                    while oi < len(offsets) and len(inflight) < window:
                        off = offsets[oi]
                        inflight[off] = peer.call_async(
                            "fetch_chunk",
                            {"object_id": oid, "offset": off,
                             "length": min(chunk_bytes, size - off)},
                        )
                        oi += 1
                    # drain the oldest outstanding chunk (send order is
                    # frame order at the peer, so oldest completes first)
                    wait = min(30.0, xfer_deadline - time.time())
                    if wait <= 0:
                        raise TimeoutError(f"pull of {oid[:8]} overran deadline")
                    off = next(iter(inflight))
                    data = inflight.pop(off).result(timeout=wait)
                    want = min(chunk_bytes, size - off)
                    if data is None or len(data) != want:
                        # vanished at the peer, or a short read (truncated
                        # spill file): sealing would register a corrupt
                        # replica that then propagates to every puller
                        raise LookupError(
                            f"chunk at {off}: got "
                            f"{0 if data is None else len(data)}/{want} bytes"
                        )
                    dst[off:off + len(data)] = data
                    self._chunks_pulled += 1
                if buf is not None:
                    self.store.commit_streaming_put(oid)
                else:
                    # hand the bytearray over as-is: stores treat payloads
                    # as read-only buffers, and bytes(assemble) would double
                    # transient memory exactly when the node is pressured
                    self.store.put(oid, assemble)
                return True
            except Exception:
                if buf is not None:
                    try:
                        self.store.abort_streaming_put(oid)
                    except Exception:
                        pass
                return False

    def _peer(self, node_id, addr, port) -> Optional[RpcClient]:
        with self._lock:
            c = self._peer_clients.get(node_id)
            if c is not None and not c._closed:
                return c
        try:
            c = RpcClient(addr, port, name=self.node_id, peer=node_id)
        except OSError:
            return None
        with self._lock:
            self._peer_clients[node_id] = c
        return c

    # ----------------------------------------------------------------- misc

    def _on_kill_actor(self, p):
        aid = p["actor_id"]
        with self._lock:
            w = next((w for w in self.workers.values() if w.actor_id == aid), None)
        if w is not None and w.proc is not None:
            try:
                w.proc.terminate()
            except OSError:
                pass

    # --- compiled-DAG stages + channels (ray_tpu_torch/dag; reference: Ray
    # Compiled Graphs — the daemon pins one worker per stage, owns the
    # writable end of channels deposited by remote writers, and relays
    # cross-node frames over dag_push/dag_pull) ---

    def _dag_ent(self, dag_id: str) -> dict:
        with self._lock:
            return self._dags.setdefault(
                dag_id, {"stages": {}, "keys": set()}
            )

    def rpc_dag_start_stage(self, p, conn):
        """Driver -> daemon: pin a worker and start a compiled-DAG stage's
        exec loop. Pre-creates daemon-owned deposit channels (in-edges
        whose writer is remote), then pushes the static loop spec to a
        dedicated worker; resolves once the worker reports dag_stage_ready."""
        from ray_tpu_torch.dag.channel import Channel

        if self._stopped:
            return {"ok": False, "error": "daemon stopping"}
        dag_id, stage, spec = p["dag_id"], p["stage"], p["spec"]
        ent = self._dag_ent(dag_id)
        for c in p.get("own_channels") or ():
            # the (possibly blocking) shm create runs unlocked; the index
            # insert re-checks under the lock
            made = None
            with self._lock:  # the teardown pops the index under it
                have = c["key"] in self._chan_index
            if not have:
                made = Channel.create(
                    c["path"], int(p.get("capacity") or 65536), c["key"]
                )
            with self._lock:
                cur = (
                    self._chan_index.setdefault(c["key"], made)
                    if made is not None else None
                )
                ent["keys"].add(c["key"])
                self._chan_paths[c["key"]] = c["path"]
            if made is not None and cur is not made:
                # lost the race to a concurrent open of the same key:
                # drop OUR mapping only (close() would set the shared
                # CLOSED flag and kill the winner's channel)
                made.detach()
        with self._lock:
            for e in list(spec.get("in_edges") or ()) + [
                e for e in spec.get("out_edges") or () if not e.get("remote")
            ]:
                ent["keys"].add(e["key"])
                self._chan_paths[e["key"]] = e["path"]
        aid = p.get("actor_id")
        fut = self.server.loop.create_future()
        with self._lock:
            self._pending_rpc[f"dagstage-{dag_id}-{stage}"] = fut
        if aid:
            # actor-bound stage: the loop runs on the worker already
            # hosting the actor (actors stay where they live)
            with self._lock:
                w = next(
                    (w for w in self.workers.values() if w.actor_id == aid),
                    None,
                )
            if w is None or w.conn is None:
                with self._lock:
                    self._pending_rpc.pop(f"dagstage-{dag_id}-{stage}", None)
                return {"ok": False,
                        "error": f"actor {aid} not hosted on {self.node_id}"}
            self._dispatch_dag_stage(w, dag_id, stage, spec)
            return fut
        with self._lock:
            w = None
            while self._idle:
                w = self.workers.get(self._idle.popleft())
                if w is not None and w.conn is not None:
                    break
                w = None
            if w is not None:
                w.busy = True
        if w is not None:
            self._dispatch_dag_stage(w, dag_id, stage, spec)
        else:
            # no ready worker: park the spec; rpc_worker_ready drains it
            self._dag_pending.append((dag_id, stage, spec))
            self._spawn_worker()
        return fut

    def _pump_dag_stages(self):
        """Hand parked dag stages to ready workers (called on worker_ready
        — dag stages outrank the task queue: each one was explicitly
        provisioned a pinned worker)."""
        while True:
            with self._lock:
                if not self._dag_pending:
                    return
                w = None
                while self._idle:
                    w = self.workers.get(self._idle.popleft())
                    if w is not None and w.conn is not None:
                        break
                    w = None
                if w is None:
                    return
                w.busy = True
                dag_id, stage, spec = self._dag_pending.popleft()
            self._dispatch_dag_stage(w, dag_id, stage, spec)

    def _dispatch_dag_stage(self, w: "_Worker", dag_id: str, stage: int,
                            spec: dict):
        w.dag_stages.add((dag_id, stage))
        self._dag_ent(dag_id)["stages"][stage] = w.worker_id
        self.server.call_soon(
            lambda c=w.conn, s=spec: asyncio.ensure_future(
                c.push("dag_loop", s)
            )
        )

    def rpc_dag_stage_ready(self, p, conn):
        """Worker notify: the exec loop is up, out-channels created."""
        with self._lock:
            fut = self._pending_rpc.pop(
                f"dagstage-{p['dag_id']}-{p['stage']}", None
            )
        if fut is not None:
            self.server.call_soon(
                lambda: fut.set_result({"ok": True})
                if not fut.done() else None
            )
        return {"ok": True}

    def rpc_dag_stage_exit(self, p, conn):
        """Worker notify: its exec loop finished (teardown or upstream
        close) — release the worker pin back to the pool."""
        worker_id = conn.meta.get("worker_id")
        with self._lock:
            w = self.workers.get(worker_id)
            if w is not None:
                w.dag_stages.discard((p["dag_id"], p["stage"]))
                if (
                    not w.dag_stages and w.actor_id is None
                    and w.current_task is None and w.busy
                ):
                    w.busy = False
                    self._idle.append(worker_id)
        ent = self._dags.get(p["dag_id"])
        if ent is not None:
            ent["stages"].pop(p["stage"], None)
        self._pump()
        return {"ok": True}

    def rpc_dag_push(self, p, conn):
        """Cross-node edge deposit: a remote writer (worker or driver)
        hands a frame to the channel this daemon owns. Blocking (channel
        backpressure) — runs off the event loop."""
        with self._lock:  # the teardown pops the index under it
            ch = self._chan_index.get(p["key"])
        if ch is None:
            return {"ok": False,
                    "error": f"no channel {p['key']} on {self.node_id}"}
        if p.get("close"):
            ch.close(error=bool(p.get("error")))
            return {"ok": True}
        payload = p.get("payload")
        return self.server.loop.run_in_executor(
            None, lambda: self._dag_deposit(ch, payload)
        )

    @staticmethod
    def _dag_deposit(ch, payload) -> dict:
        try:
            ch.write(payload, timeout=60.0)
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 - surface to the pusher
            return {"ok": False, "error": repr(e)}

    def rpc_dag_pull(self, p, conn):
        """Remote-driver read of an output edge: the daemon attaches the
        channel's read end locally and consumes on the driver's behalf
        (the ack word needs a same-host writable mapping)."""
        timeout = float(p.get("timeout") or 30.0)
        return self.server.loop.run_in_executor(
            None, lambda: self._dag_pull_frame(p["key"], timeout)
        )

    def _dag_pull_frame(self, key: str, timeout: float) -> dict:
        from ray_tpu_torch.dag.channel import (
            Channel,
            ChannelClosedError,
            ChannelTimeoutError,
        )

        with self._lock:
            ch = self._chan_index.get(key)
            path = self._chan_paths.get(key)
        if ch is None:
            if path is None:
                return {"ok": False, "closed": True}
            try:
                opened = Channel.open_wait(path, key, timeout=timeout)
            except (ChannelClosedError, ChannelTimeoutError):
                return {"ok": False, "closed": False}
            with self._lock:
                ch = self._chan_index.setdefault(key, opened)
            if ch is not opened:
                opened.detach()  # racer won; drop our duplicate mapping
        try:
            seq, payload = ch.read(timeout=timeout)
            return {"ok": True, "seq": seq, "payload": payload}
        except ChannelClosedError:
            return {"ok": False, "closed": True}
        except Exception:  # noqa: BLE001 - timeout or torn mapping
            return {"ok": False, "closed": False}

    def rpc_dag_spans(self, p, conn):
        """Worker notify: a batch of per-iteration (start, end) spans from
        a stage's exec loop; relayed to the GCS task-event log so
        `ray_tpu_torch timeline` shows per-stage occupancy of the hot loop."""
        try:
            self.gcs.call_async("dag_spans", {
                "dag_id": p["dag_id"], "stage": p["stage"],
                "name": p.get("name"), "base": p.get("base") or 0,
                "node_id": self.node_id, "spans": p.get("spans") or [],
            }).add_done_callback(log_rpc_failure)
        except Exception:  # noqa: BLE001 - gcs reconnecting
            pass
        return {"ok": True}

    def _on_dag_worker_died(self, w: "_Worker"):
        from ray_tpu_torch.dag import channel as _chan

        for dag_id, stage in list(w.dag_stages):
            ent = self._dags.get(dag_id)
            if ent is not None:
                ent["stages"].pop(stage, None)
                for key in ent["keys"]:
                    path = self._chan_paths.get(key)
                    if path:
                        _chan.poke_error(path)
            # died before reporting ready: fail the driver's pending
            # dag_start_stage instead of letting it ride out its timeout
            with self._lock:
                fut = self._pending_rpc.pop(
                    f"dagstage-{dag_id}-{stage}", None
                )
            if fut is not None:
                self.server.call_soon(
                    lambda f=fut, s=stage: f.set_result({
                        "ok": False,
                        "error": f"stage {s} worker died before ready",
                    }) if not f.done() else None
                )
            try:
                self.gcs.call_async("dag_worker_died", {
                    "dag_id": dag_id, "stage": stage,
                    "error": f"dag stage {stage} worker {w.worker_id} died "
                             f"on {self.node_id} (exit {w.proc.poll() if w.proc else '?'})",
                }).add_done_callback(log_rpc_failure)
            except Exception:  # noqa: BLE001 - gcs reconnecting
                pass

    def _on_dag_teardown(self, p):
        """GCS push: release the DAG's channels and worker pins on this
        node. Idempotent — a second teardown finds nothing."""
        from ray_tpu_torch.dag.channel import Channel

        dag_id = p["dag_id"]
        with self._lock:
            ent = self._dags.pop(dag_id, None)
        if ent is None:
            return
        with self._lock:
            stage_workers = [
                self.workers.get(wid) for wid in set(ent["stages"].values())
            ]
        for w in stage_workers:
            if w is not None and w.conn is not None:
                self.server.call_soon(
                    lambda c=w.conn: asyncio.ensure_future(
                        c.push("dag_stop", {"dag_id": dag_id})
                    )
                )
        for key in ent["keys"]:
            with self._lock:
                ch = self._chan_index.pop(key, None)
                path = self._chan_paths.pop(key, None)
            if ch is not None:
                try:
                    ch.close()
                    ch.detach()
                except Exception:  # noqa: BLE001
                    pass
            elif path:
                # close in place so a still-draining end wakes up
                try:
                    c = Channel.open_wait(path, key, timeout=0.01)
                    c.close()
                    c.detach()
                except Exception:  # noqa: BLE001
                    pass
            if path:
                Channel.unlink(path)

    # --- serve fast-path pairs (ray_tpu_torch/serve/fastpath.py): the daemon
    # creates each pair's request/response channel files under its
    # chan_dir, registers them for the relay fallback AND its worker-death
    # sweep, and hands the pair to the worker hosting the replica actor ---

    def rpc_serve_attach(self, p, conn):
        """Client -> daemon: build one fast-path pair against the replica
        actor hosted here. Creates both channels, registers the death
        poke, pushes the attach spec to the replica's worker, and defers
        the reply until the worker reports serve_replica_ready — so a
        successful return means the request plane is LIVE."""
        from ray_tpu_torch.dag.channel import Channel

        if self._stopped:
            return {"ok": False, "error": "daemon stopping"}
        pair_id, aid = p["pair_id"], p["actor_id"]
        cap = int(p.get("capacity") or 65536)
        with self._lock:
            existing = self._serve_pairs.get(pair_id)
        if existing is not None:
            # idempotent re-attach (retry-plane resend of the same call)
            req_path, resp_path = existing["paths"]
            return {"ok": True, "req_path": req_path,
                    "resp_path": resp_path}
        with self._lock:
            w = next(
                (w for w in self.workers.values() if w.actor_id == aid),
                None,
            )
        if w is None or w.conn is None:
            # the actor moved/died between the GCS resolve and this call:
            # the client refreshes membership and re-routes
            return {"ok": False, "retry": True,
                    "error": f"actor {aid} not hosted on {self.node_id}"}
        keys = (f"{pair_id}-rq", f"{pair_id}-rs")
        paths = tuple(f"{self.chan_dir}/{k}.chan" for k in keys)
        for key, path in zip(keys, paths):
            made = None
            with self._lock:  # the pair's close pops the index under it
                have = key in self._chan_index
            if not have:
                made = Channel.create(path, cap, key)
            with self._lock:
                cur = (self._chan_index.setdefault(key, made)
                       if made is not None else None)
                self._chan_paths[key] = path
            if made is not None and cur is not made:
                made.detach()  # racer won: drop OUR mapping only
        fut = self.server.loop.create_future()
        with self._lock:
            self._pending_rpc[f"servepair-{pair_id}"] = fut
            self._serve_pairs[pair_id] = {
                "pair_id": pair_id,
                "worker_id": w.worker_id,
                "actor_id": aid,
                "keys": keys,
                "paths": paths,
            }
            w.serve_pairs.add(pair_id)
        spec = {
            "pair_id": pair_id,
            "actor_id": aid,
            "req_path": paths[0],
            "resp_path": paths[1],
            "batch_max": self.config.serve_fastpath_batch_max,
            "target_latency_s": self.config.serve_fastpath_target_latency_s,
        }
        self.server.call_soon(
            lambda c=w.conn, s=spec: asyncio.ensure_future(
                c.push("serve_attach", s)
            )
        )
        return fut

    def rpc_serve_replica_ready(self, p, conn):
        """Worker notify: the replica loop attached the pair's channels
        (or failed to) — resolves the client's pending serve_attach."""
        pair_id = p["pair_id"]
        with self._lock:
            fut = self._pending_rpc.pop(f"servepair-{pair_id}", None)
            sp = self._serve_pairs.get(pair_id)
        if fut is None:
            return {"ok": True}
        if p.get("ok", True) and sp is not None:
            reply = {"ok": True, "req_path": sp["paths"][0],
                     "resp_path": sp["paths"][1]}
        else:
            reply = {"ok": False, "retry": True,
                     "error": p.get("error") or "replica attach failed"}
        self.server.call_soon(
            lambda: fut.set_result(reply) if not fut.done() else None
        )
        return {"ok": True}

    def _close_serve_pair(self, sp: dict) -> None:
        """Close + unlink one pair's channels (wakes both ends)."""
        from ray_tpu_torch.dag.channel import Channel

        for key, path in zip(sp["keys"], sp["paths"]):
            with self._lock:
                ch = self._chan_index.pop(key, None)
                self._chan_paths.pop(key, None)
            if ch is not None:
                try:
                    ch.close()
                    ch.detach()
                except Exception:  # noqa: BLE001
                    pass
            Channel.unlink(path)

    def _on_serve_teardown(self, p):
        """GCS push (client teardown or owner-disconnect sweep): release
        the pair's channels on this node. Idempotent."""
        with self._lock:
            sp = self._serve_pairs.pop(p["pair_id"], None)
            if sp is not None:
                w = self.workers.get(sp["worker_id"])
                if w is not None:
                    w.serve_pairs.discard(p["pair_id"])
        if sp is not None:
            self._close_serve_pair(sp)

    def _on_serve_worker_died(self, w: "_Worker"):
        """A worker hosting fast-path replicas died: flag every pair
        channel CLOSED|ERROR so parked clients wake with
        ChannelClosedError and reroute — the serve half of the dag death
        sweep. Entries stay until teardown so the files still unlink."""
        from ray_tpu_torch.dag import channel as _chan

        with self._lock:
            pairs = [self._serve_pairs.get(pid)
                     for pid in list(w.serve_pairs)]
            futs = [self._pending_rpc.pop(f"servepair-{pid}", None)
                    for pid in list(w.serve_pairs)]
        for sp in pairs:
            if sp is None:
                continue
            for path in sp["paths"]:
                _chan.poke_error(path)
        for fut in futs:
            if fut is not None:
                self.server.call_soon(
                    lambda f=fut: f.set_result({
                        "ok": False, "retry": True,
                        "error": "replica worker died before ready",
                    }) if not f.done() else None
                )

    # --- 2PC bundle protocol, GCS-initiated (reference:
    # placement_group_resource_manager.cc Prepare/Commit/ReturnBundle;
    # resource authority stays in the GCS view — daemons record the
    # reservation mapping, the analog of minting CPU_group_<pgid>) ---

    def rpc_prepare_bundle(self, p, conn):
        ok = not self._stopped
        if rpc_mod.TRACE is not None:
            rpc_mod.TRACE.apply(
                "pg_prepare", pg=p["pg_id"], bundle=p["bundle_index"],
                node=self.node_id, ok=ok,
            )
        if not ok:
            return {"ok": False, "error": "daemon stopping"}
        key = f"{p['pg_id']}:{p['bundle_index']}"
        with self._lock:
            self._bundles[key] = {**p, "state": "PREPARED"}
        return {"ok": True}

    def rpc_commit_bundle(self, p, conn):
        # the whole check-then-commit is one critical section: a
        # return_bundle push (client dispatch thread) racing this handler
        # (server loop) could otherwise pop the entry between the get and
        # the state write — the commit would "succeed" into an orphaned
        # row the GCS believes returned (cross-thread-field-write checker)
        key = f"{p['pg_id']}:{p['bundle_index']}"
        with self._lock:
            ent = self._bundles.get(key)
            ok = not (ent is None or self._stopped)
            if rpc_mod.TRACE is not None:
                # transition=False marks an idempotent re-commit (a chaos-
                # duplicated frame): legal, and the invariant checker must
                # not read it as a double-commit
                rpc_mod.TRACE.apply(
                    "pg_commit", pg=p["pg_id"], bundle=p["bundle_index"],
                    node=self.node_id, ok=ok,
                    transition=ok and ent.get("state") != "COMMITTED",
                )
            if not ok:
                # commit without a surviving prepare (daemon restarted
                # between phases): refuse so the GCS returns the bundle
                # and re-packs
                return {"ok": False, "error": "no prepared bundle"}
            ent["state"] = "COMMITTED"
        return {"ok": True}

    def _on_return_bundle(self, p):
        """GCS aborts/releases a 2PC bundle reservation (failed prepare
        round, PG removal, gang reset after a member node death)."""
        with self._lock:
            popped = self._bundles.pop(
                f"{p['pg_id']}:{p['bundle_index']}", None
            )
        if popped is not None and rpc_mod.TRACE is not None:
            rpc_mod.TRACE.apply(
                "pg_return", pg=p["pg_id"], bundle=p["bundle_index"],
                node=self.node_id,
            )

    def _on_nodes_update(self, snapshot):
        self._nodes_snapshot = snapshot

    def _heartbeat_loop(self):
        period = self.config.health_check_period_ms / 1000.0
        beats = 0
        while not self._stopped:
            payload = {"node_id": self.node_id}
            # one locked snapshot per beat feeds the load signal, the
            # gauges below, and _sample_stats — the racer
            # (analysis/racer.py) flagged the previous lock-free len()
            # reads racing the rpc loop's locked mutations of
            # _task_queue/_idle/workers
            with self._lock:
                n_queued = len(self._task_queue)
                n_idle = len(self._idle)
                n_workers = len(self.workers)
            if beats % 5 == 0:  # physical stats every ~5th beat (psutil
                payload["stats"] = self._sample_stats(n_workers)  # calls are
            beats += 1                                  # cheap but not free
            # backpressure signal (overload control plane): task-queue
            # depth + worker saturation fold into the GCS's cluster
            # overload derivation every beat
            payload["load"] = {
                "queued": n_queued,
                "idle": n_idle,
                "workers": n_workers,
            }
            if _metrics.ENABLED:
                # metric export rides the beat: this process's registry
                # delta + any deltas local workers pushed since last time.
                # Deltas partition the totals, so several in-process
                # daemons (embedded test topology) exporting one shared
                # registry never double-count (see util/metrics.py).
                st = self.store.stats()
                _M_STORE_BYTES.set(
                    st.get("bytes_in_memory", 0), {"node": self.node_id}
                )
                _M_STORE_SPILLED.set(
                    st.get("spilled", 0), {"node": self.node_id}
                )
                _M_TASK_QUEUE.set(n_queued, {"node": self.node_id})
                _M_IDLE_WORKERS.set(n_idle, {"node": self.node_id})
                delta = _metrics.snapshot_delta()
                pushed = self._drain_worker_metrics()
                for d in pushed:
                    _metrics.merge_deltas(delta, d)
                if delta:
                    self._metrics_seq += 1
                    payload["metrics"] = delta
                    payload["metrics_seq"] = self._metrics_seq
            try:
                self.gcs.call("heartbeat", payload, timeout=5.0)
            except Exception:
                # the beat is lost but its DELTA must not be: requeue it
                # for the next beat (at-least-once; the seq stamp dedupes
                # exact resends server-side, and the only double-count
                # window left is apply-then-lost-response)
                delta = payload.get("metrics")
                if delta:
                    with self._lock:
                        self._worker_metrics.append(delta)
            time.sleep(period)

    def _drain_worker_metrics(self) -> List[dict]:
        """Swap out the queued worker metric deltas (heartbeat thread).
        The lock pairs with rpc_metrics_push's append on the rpc loop —
        the field/thread pair the race sanitizer's seeded
        ``metrics-push-unlocked`` probe exercises."""
        with self._lock:
            pushed, self._worker_metrics = self._worker_metrics, []
        return pushed

    def _sample_stats(self, n_workers: int) -> dict:
        """Per-node physical stats riding the heartbeat (reference:
        dashboard/modules/reporter/reporter_agent.py sampling psutil into
        the GCS for the node views). ``n_workers`` is the heartbeat's
        locked snapshot — reading ``self.workers`` here would race the
        rpc loop."""
        try:
            import psutil
        except ImportError:
            return {}
        out: dict = {"sampled_at": time.time()}
        # each field sampled independently: one unavailable metric (e.g. no
        # os.getloadavg on some platforms) must not blank the rest
        for key, fn in (
            ("cpu_percent", lambda: psutil.cpu_percent(interval=None)),
            ("mem_used", lambda: int(psutil.virtual_memory().used)),
            ("mem_total", lambda: int(psutil.virtual_memory().total)),
            ("load_avg", os.getloadavg),
            ("disk_percent", lambda: psutil.disk_usage("/").percent),
            ("workers", lambda: n_workers),
            ("store_bytes",
             lambda: self.store.stats().get("bytes_in_memory", 0)),
        ):
            try:
                out[key] = fn()
            except Exception:  # noqa: BLE001 - stats must never kill the beat
                pass
        return out

    def shutdown(self):
        self._stopped = True
        with self._prefetch_cv:
            self._prefetch_cv.notify_all()
        with self._lock:
            workers = list(self.workers.values())
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except OSError:
                    pass
        self.server.stop()
        self.gcs.close()
        if hasattr(self.store, "close"):
            try:
                self.store.close()
            except Exception:
                pass


def main():  # pragma: no cover - exercised as a subprocess
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs-host", required=True)
    ap.add_argument("--gcs-port", type=int, required=True)
    ap.add_argument("--resources", required=True, help="JSON resource map")
    ap.add_argument("--node-id", default=None)
    args = ap.parse_args()
    daemon = NodeDaemon(
        (args.gcs_host, args.gcs_port),
        json.loads(args.resources),
        node_id=args.node_id,
    )
    print(f"daemon {daemon.node_id} on port {daemon.port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        daemon.shutdown()


if __name__ == "__main__":
    main()
