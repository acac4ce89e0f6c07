"""Worker process: executes tasks and hosts actors for one node daemon.

Reference: the worker side of src/ray/core_worker/core_worker.cc
(ExecuteTask / the task execution callback into Python, _raylet.pyx
execute_task) plus python/ray/_private/worker.py's main loop. One process
runs one task at a time; a worker that creates an actor stays bound to it
for the actor's lifetime (reference: dedicated actor workers).

Object resolution goes through the daemon (rpc get_object), which pulls
from peers via the GCS directory when the object is remote.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.object_ref import ObjectRef, capture_refs
from ray_tpu_torch.cluster.rpc import RpcClient

_actor_instances = {}
_actor_concurrency = {}
_actor_aio = {}  # actor_id -> ActorEventLoop for async (coroutine) actors
_shm = None  # ShmClientStore when the daemon exposes a segment

# streaming-generator backpressure (reference: _raylet.pyx streaming
# generators): consumer acks arrive as daemon pushes; the producing
# thread parks here when produced - acked >= the window
_stream_acks: dict = {}
_stream_cv = threading.Condition()


def _on_stream_ack(p: dict):
    with _stream_cv:
        tid = p["task_id"]
        # only update REGISTERED streams: a straggler ack arriving after
        # the producer finished must not re-insert the entry (a slow leak
        # in long-lived pooled/actor workers)
        if tid in _stream_acks:
            _stream_acks[tid] = max(_stream_acks[tid], int(p["consumed"]))
            _stream_cv.notify_all()


def _drain_stream(client: RpcClient, t: dict, gen) -> int:
    """Producer loop for a streaming task: publish each yielded item as
    produced (shm seal + announcement, or payload in the announcement),
    parking when the backpressure window fills. Returns the item count —
    the task's declared return, which doubles as the end-of-stream
    marker (protocol: core/generator.py)."""
    task_id = t["task_id"]
    bp = int(t.get("backpressure") or 0)
    if bp > 0:
        with _stream_cv:
            _stream_acks.setdefault(task_id, 0)
    n = 0
    try:
        for item in gen:
            oid = ObjectRef.for_task_output(task_id, n + 1).id
            data = _pack_value(item)
            msg = {"task_id": task_id, "object_id": oid, "size": len(data)}
            if not (
                _shm is not None
                and _shm.put_with_make_room(oid, data, client)
            ):
                msg["payload"] = data
            client.call("stream_item", msg, timeout=60.0)
            n += 1
            if bp > 0:
                with _stream_cv:
                    while n - _stream_acks.get(task_id, 0) >= bp:
                        _stream_cv.wait(timeout=0.5)
    finally:
        with _stream_cv:
            _stream_acks.pop(task_id, None)
    return n


# ---- borrower accounting (reference: reference_count.cc AddBorrowedObject) --
# Every ObjectRef deserialized out of task args is counted here. A ref still
# alive when its task finishes (stashed in actor state / a global) makes this
# worker a BORROWER: the daemon/GCS relay that to the owner, which defers
# auto-free until the borrow is released (the ref's count here hits zero) or
# this worker dies.
_borrowed: dict = {}  # oid -> {"count": int, "reported": bool, "owner": str}
_borrow_lock = threading.Lock()
_daemon_client: RpcClient = None  # set in main()


def _on_borrow_ref(ref: ObjectRef):
    """Capture hook: a ref was deserialized from task args on this thread."""
    if ref.owner is None:
        return  # unroutable: no owner to defer the free
    with _borrow_lock:
        ent = _borrowed.setdefault(
            ref.id, {"count": 0, "reported": False, "owner": ref.owner}
        )
        ent["count"] += 1
    ref._register(_on_borrow_del)


def _on_borrow_del(oid: str):
    with _borrow_lock:
        ent = _borrowed.get(oid)
        if ent is None:
            return
        ent["count"] -= 1
        if ent["count"] > 0:
            return
        del _borrowed[oid]
        reported = ent["reported"]
    if reported and _daemon_client is not None:
        try:
            _daemon_client.notify("borrow_released", {
                "object_id": oid, "owner": ent["owner"],
                "worker_id": os.environ.get("RAY_TPU_WORKER_ID"),
            })
        except Exception:  # noqa: BLE001 - daemon gone; it cleans up for us
            pass


def _collect_borrows(task_refs: list) -> list:
    """Called after the task's own references are dropped: any arg ref still
    counted is stashed beyond the task — report it (once) as borrowed."""
    out = []
    with _borrow_lock:
        for oid in task_refs:
            ent = _borrowed.get(oid)
            if ent is None or ent["count"] <= 0 or ent["reported"]:
                continue
            ent["reported"] = True
            out.append({"id": oid, "owner": ent["owner"]})
    return out


def _attach_shm():
    global _shm
    name = os.environ.get("RAY_TPU_SHM_NAME")
    if not name:
        return
    try:
        from ray_tpu_torch.cluster.shm_store import ShmClientStore

        _shm = ShmClientStore(name)
    except Exception:  # noqa: BLE001 - fall back to the daemon RPC path
        _shm = None


def _resolve(client: RpcClient, obj, pins=None):
    """Arg resolution: same-node shm hit is a zero-copy mapped read
    (reference: plasma client Get -> mmap view); miss falls back to the
    daemon, which pulls from peers. When `pins` is given the shm object
    stays pinned (appended for post-task release) and numpy buffers
    deserialize as views into the segment; without it the payload is
    copied — actor tasks use the copy path because actor state outlives
    the task and must not dangle into an evictable segment."""
    if isinstance(obj, ObjectRef):
        payload = None
        if _shm is not None:
            if pins is not None:
                view = _shm.get_view(obj.id)
                if view is not None:
                    pins.append(obj.id)
                    payload = view
            else:
                payload = _shm.get_bytes(obj.id)
        if payload is None:
            payload = client.call(
                "get_object", {"object_id": obj.id, "timeout": 60.0}, timeout=90.0
            )
        if payload is None:
            raise RuntimeError(f"object {obj.id[:8]} unavailable")
        rec = serialization.unpack(payload)
        if rec["e"]:
            raise rec["v"] if isinstance(rec["v"], BaseException) else RuntimeError(str(rec["v"]))
        return rec["v"]
    return obj


def _pack_value(value, is_exception=False) -> bytes:
    return serialization.pack({"e": is_exception, "v": value})


from ray_tpu_torch.core import runtime_env as _rtenv_mod  # noqa: E402


def _resolve_runtime_env(rtenv):
    """Materialize a wire-form runtime_env: fetch + extract the working
    dir and py_modules (content-hash cached), build the pip target dir
    from the local wheels directory. Returns (env_vars, cwd, py_paths)."""
    if not rtenv:
        return None, None, None
    from ray_tpu_torch.core import api as _api

    rt = _api._runtime
    cwd = None
    key = rtenv.get("working_dir_key")
    if key:
        data = rt.kv_get(key)
        if data is None:
            raise RuntimeError(f"runtime_env working_dir {key} missing from KV")
        cwd = _rtenv_mod.ensure_working_dir(
            key, data, rt.config.session_dir_root
        )
    py_paths = []
    for mkey in rtenv.get("py_modules_keys") or ():
        data = rt.kv_get(mkey)
        if data is None:
            raise RuntimeError(f"runtime_env py_module {mkey} missing from KV")
        py_paths.append(_rtenv_mod.ensure_working_dir(
            mkey, data, rt.config.session_dir_root
        ))
    if rtenv.get("pip"):
        py_paths.append(_rtenv_mod.ensure_pip_env(
            rtenv["pip"], rt.config.session_dir_root
        ))
    return rtenv.get("env_vars"), cwd, py_paths or None


# deserialized-function cache (driver side pickles each function once; the
# worker shouldn't re-unpickle it per task either). Functions whose bytes
# deserialize ObjectRefs (closure-captured refs) are NOT cached: each
# execution must re-materialize them under capture_refs so borrow tracking
# keeps seeing them. Keyed by the pickle bytes; bounded FIFO.
_func_cache: dict = {}
_FUNC_CACHE_MAX = 256


def _load_func(func_b: bytes, saw_ref) -> object:
    hit = _func_cache.get(func_b)
    if hit is not None:
        return hit
    refs_seen: list = []

    def probe(r):
        refs_seen.append(r)
        saw_ref(r)

    from ray_tpu_torch.core.object_ref import capture_refs as _cap

    with _cap(probe):
        fn = serialization.loads(func_b)
    if not refs_seen:
        if len(_func_cache) >= _FUNC_CACHE_MAX:
            _func_cache.pop(next(iter(_func_cache)))
        _func_cache[func_b] = fn
    return fn


def _finish_value(client, t, value, num_returns, aio):
    """Streaming tasks drain their generator (items published as
    produced; the count becomes the declared return); everything else
    keeps the plain num_returns contract."""
    if t.get("streaming"):
        if hasattr(value, "__anext__"):
            if aio is None:
                raise TypeError(
                    "async generator returned outside an async actor"
                )
            from ray_tpu_torch.core.async_actor import agen_to_iter

            value = agen_to_iter(value, aio)
        if not hasattr(value, "__next__"):
            raise TypeError(
                "num_returns='streaming' requires a generator function; "
                f"got {type(value)}"
            )
        return [_drain_stream(client, t, value)]
    return [value] if num_returns == 1 else list(value)


def _chaos_exec_stall(t: dict, start: float) -> None:
    """Chaos ``slow`` hook (gray-failure injection): stretch this task's
    apparent execution time by the schedule's factor. The stall happens
    BEFORE the result report, so an inf-factor task is indistinguishable
    from a wedged worker — the node keeps heartbeating, the task never
    finishes. Zero overhead when no schedule is installed (one module
    global check, same contract as the RPC hooks)."""
    from ray_tpu_torch.cluster import rpc as rpc_mod

    ch = rpc_mod.CHAOS
    if ch is None:
        return
    factor = ch.on_exec(
        os.environ.get("RAY_TPU_NODE_ID", "*"), t.get("name")
    )
    if factor <= 1.0:
        return
    if factor == float("inf"):
        while True:  # wedged forever; only process death ends it
            time.sleep(1.0)
    # multiplicative over real elapsed time, with a small floor so a gray
    # node is visibly slow even on sub-millisecond tasks
    elapsed = max(time.time() - start, 0.02)
    time.sleep(min(elapsed * (factor - 1.0), 600.0))


def _execute(client: RpcClient, t: dict):
    task_id = t["task_id"]
    start = time.time()
    num_returns = t.get("num_returns", 1)
    out_ids = [
        ObjectRef.for_task_output(task_id, i).id for i in range(num_returns)
    ]
    # actor method calls derive output ids the same way on the driver side
    pins = []
    task_arg_refs: list = []  # oids of refs deserialized for THIS task
    try:
        # capture every ref that materializes while unpacking args (top-level
        # and nested, including refs inside fetched values) — candidates for
        # borrow reporting if user code stashes them past the task
        def _saw_ref(r):
            if r.owner is not None:
                task_arg_refs.append(r.id)
            _on_borrow_ref(r)

        with capture_refs(_saw_ref):
            spec = serialization.loads(t["spec_bytes"])
            if spec.get("func_b") is not None:
                # function shipped as separately-cached bytes (the driver
                # pickles each function once, not per task); loaded inside
                # capture_refs so closure-captured refs are seen too
                spec["func"] = _load_func(spec["func_b"], _saw_ref)
            else:
                spec.setdefault("func", None)
            is_actor_task = bool(t.get("actor_creation") or t.get("actor_id"))
            arg_pins = None if is_actor_task else pins
            args = tuple(_resolve(client, a, arg_pins) for a in spec["args"])
            kwargs = {
                k: _resolve(client, v, arg_pins)
                for k, v in spec["kwargs"].items()
            }
        env_vars, env_cwd, env_paths = _resolve_runtime_env(
            t.get("runtime_env")
        )
        if t.get("actor_creation"):
            # keep=True: the dedicated actor worker owns this env for the
            # actor's lifetime (reference: per-runtime-env worker pools)
            with _rtenv_mod.applied(env_vars, env_cwd, keep=True,
                                    py_paths=env_paths):
                cls = spec["func"]
                _actor_instances[t["actor_id"]] = cls(*args, **kwargs)
            _actor_concurrency[t["actor_id"]] = int(t.get("max_concurrency", 1))
            # async actor: all its methods run on one dedicated event loop
            # (reference: python/ray/actor.py async actors); the dispatch
            # pool threads below act as concurrency slots that bridge into
            # the loop and carry the blocking result RPC
            from ray_tpu_torch.core.async_actor import ActorEventLoop, class_is_async

            if class_is_async(cls):
                _actor_aio[t["actor_id"]] = ActorEventLoop(
                    name=f"actor-{t['actor_id'][:8]}-aio"
                )
            values = [t["actor_id"]]
        elif t.get("actor_id"):
            inst = _actor_instances.get(t["actor_id"])
            if inst is None:
                raise RuntimeError(f"actor {t['actor_id']} not hosted here")
            method = getattr(inst, spec["method_name"])
            aio = _actor_aio.get(t["actor_id"])
            if aio is not None:
                value = aio.call(method, args, kwargs)
            else:
                # serialize against a compiled-DAG stage bound to this
                # actor, if any (the dag thread invokes methods directly)
                lk = _actor_dag_locks.get(t["actor_id"])
                if lk is not None:
                    with lk:
                        value = method(*args, **kwargs)
                else:
                    value = method(*args, **kwargs)
            values = _finish_value(client, t, value, num_returns, aio)
        else:
            with _rtenv_mod.applied(env_vars, env_cwd, py_paths=env_paths):
                value = spec["func"](*args, **kwargs)
                values = _finish_value(client, t, value, num_returns, None)
        if len(values) != num_returns:
            raise ValueError(
                f"task returned {len(values)} values, expected {num_returns}"
            )
        packed = [(oid, _pack_value(v)) for oid, v in zip(out_ids, values)]
        status, error = "FINISHED", None
        # drop the task's own references so only genuinely stashed arg refs
        # (actor state, globals) survive into the borrow check below
        del spec, args, kwargs, values
    except BaseException as e:  # noqa: BLE001 - worker must survive user errors
        tb = traceback.format_exc()
        from ray_tpu_torch.core.exceptions import TaskError

        err = TaskError(f"task {t.get('name') or task_id} failed: {e!r}", tb)
        packed = [(oid, _pack_value(err, is_exception=True)) for oid in out_ids]
        status, error = "FAILED", f"{e!r}"
        # the frame still binds whatever the try block reached; clear so
        # arg refs aren't miscounted as stashed below
        spec = args = kwargs = values = None
    _chaos_exec_stall(t, start)
    borrows = _collect_borrows(task_arg_refs) if task_arg_refs else []
    # Results go straight into shm (create+seal, zero daemon copies); the
    # RPC carries only (oid, size). Fallback: bytes in the RPC frame.
    try:
        payloads, shm_results = {}, []
        for oid, data in packed:
            if _shm is not None and _shm.put_with_make_room(oid, data, client):
                shm_results.append((oid, len(data)))
            else:
                payloads[oid] = data
        # Fire-and-forget: profiling showed the worker blocked ~20ms per
        # task awaiting this ack on a loaded single-core host — 10x the
        # task's actual CPU cost. TCP keeps the frame ordered and reliable
        # on a live connection; if the connection dies instead, on_close
        # exits this worker and the daemon resolves the task as
        # WORKER_DIED — the same recovery the blocking path had. The
        # exception: tasks that REPORT BORROWS keep the blocking ack, so
        # the borrow registry is in place before this worker's pins drop.
        payload = {
            "task_id": task_id,
            "status": status,
            "error": error,
            "result_payloads": payloads,
            "result_shm": shm_results,
            "borrows": borrows,
            "start": start,
            "end": time.time(),
        }
        if borrows:
            client.call("task_finished", payload, timeout=120.0)
        else:
            client.notify("task_finished", payload)
    finally:
        # leaked pins would make the objects permanently unevictable
        for oid in pins:
            try:
                _shm.release(oid)
            except Exception:  # noqa: BLE001
                pass


# ---- compiled-DAG exec-loop mode (reference: Ray Compiled Graphs — the
# pinned worker loop in python/ray/dag/compiled_dag_node.py's executors).
# A worker that receives a `dag_loop` push runs the stage's static loop on
# a dedicated thread: read every input channel, run the bound function (or
# the hosted actor's method), write the output channel(s) — no control
# plane on the hot path, until `dag_stop`/channel close/teardown.

_dag_stops: dict = {}  # (dag_id, stage) -> threading.Event
# sync (non-asyncio) actors with a DAG stage bound run that stage's method
# on the dag thread CONCURRENTLY with normal method calls on the task
# thread(s); this per-actor mutex serializes the two planes so actor state
# never sees torn updates (async actors already serialize via their loop)
_actor_dag_locks: dict = {}  # actor_id -> threading.RLock


def _on_dag_stop(p: dict):
    for (dag_id, stage), ev in list(_dag_stops.items()):
        if dag_id == p["dag_id"]:
            ev.set()


def _dag_loop(client: RpcClient, spec: dict):
    from ray_tpu_torch.cluster.rpc import RpcClient as _Rpc
    from ray_tpu_torch.dag.channel import (
        Channel,
        ChannelClosedError,
        ChannelTimeoutError,
    )
    from ray_tpu_torch.dag.compiled import _EdgeArg, _RemoteEdgeWriter

    dag_id, stage = spec["dag_id"], spec["stage"]
    stop = threading.Event()
    _dag_stops[(dag_id, stage)] = stop
    outs: list = []
    ins: list = []
    remote_clients: dict = {}
    error_exit = False
    spans: list = []  # (start, end) per iteration, for the timeline
    flushed = 0

    def flush_spans(final=False):
        nonlocal spans, flushed
        if spans and (final or len(spans) >= 128):
            try:
                client.notify("dag_spans", {
                    "dag_id": dag_id, "stage": stage,
                    "name": spec.get("name"), "base": flushed,
                    "spans": spans,
                })
            except Exception:  # noqa: BLE001 - daemon racing teardown
                pass
            flushed += len(spans)
            spans = []

    try:
        # out channels FIRST (downstream readers poll for the files), then
        # tell the daemon the stage is up, then block on upstream
        for e in spec["out_edges"]:
            if e.get("remote"):
                # cross-node edge: frames ride the daemon transfer path
                ck = (e["addr"], e["port"])
                c = remote_clients.get(ck)
                if c is None:
                    c = _Rpc(e["addr"], e["port"],
                             name=os.environ.get("RAY_TPU_WORKER_ID"),
                             peer=e.get("node_id") or "daemon")
                    remote_clients[ck] = c
                outs.append(_RemoteEdgeWriter(c, e["key"]))
            else:
                outs.append(
                    Channel.create(e["path"], spec["capacity"], e["key"])
                )
        client.notify("dag_stage_ready", {"dag_id": dag_id, "stage": stage})
        ins = [
            Channel.open_wait(e["path"], e["key"], timeout=60.0,
                              should_stop=stop.is_set)
            for e in spec["in_edges"]
        ]
        aio = None
        actor_lk = None
        if spec.get("actor_id"):
            inst = _actor_instances.get(spec["actor_id"])
            if inst is None:
                raise RuntimeError(
                    f"actor {spec['actor_id']} not hosted on this worker"
                )
            fn = getattr(inst, spec["method_name"])
            aio = _actor_aio.get(spec["actor_id"])
            if aio is None:
                actor_lk = _actor_dag_locks.setdefault(
                    spec["actor_id"], threading.RLock()
                )
        else:
            fn = serialization.loads(spec["func_b"])
        args_t, kwargs_t = serialization.loads(spec["args_template"])

        def _subst(a, vals):
            return vals[a.index] if isinstance(a, _EdgeArg) else a

        while not stop.is_set():
            raws: list = []
            recs: list = []
            try:
                for ch in ins:
                    while True:
                        try:
                            _seq, data = ch.read(
                                timeout=0.5, should_stop=stop.is_set
                            )
                            break
                        except ChannelTimeoutError:
                            if stop.is_set():
                                raise ChannelClosedError("stage stopping") \
                                    from None
                    raws.append(data)
                    recs.append(serialization.unpack(data))
            except ChannelClosedError:
                error_exit = any(
                    getattr(ch, "errored", False) for ch in ins
                )
                break
            t0 = time.time()
            err_i = next((i for i, r in enumerate(recs) if r["e"]), None)
            if err_i is not None:
                # an upstream stage failed this iteration: forward its
                # error frame unchanged instead of computing on garbage
                out_payload = raws[err_i]
            else:
                try:
                    vals = [r["v"] for r in recs]
                    args = tuple(_subst(a, vals) for a in args_t)
                    kwargs = {k: _subst(v, vals)
                              for k, v in kwargs_t.items()}
                    if aio is not None:
                        value = aio.call(fn, args, kwargs)
                    elif actor_lk is not None:
                        with actor_lk:
                            value = fn(*args, **kwargs)
                    else:
                        value = fn(*args, **kwargs)
                    out_payload = _pack_value(value)
                except BaseException as e:  # noqa: BLE001 - becomes the frame
                    from ray_tpu_torch.core.exceptions import TaskError

                    out_payload = _pack_value(
                        TaskError(
                            f"dag stage {spec.get('name')} failed: {e!r}",
                            traceback.format_exc(),
                        ),
                        is_exception=True,
                    )
            try:
                for ch in outs:
                    ch.write(out_payload, timeout=None,
                             should_stop=stop.is_set)
            except ChannelClosedError:
                break
            spans.append((t0, time.time()))
            flush_spans()
    except BaseException:  # noqa: BLE001 - loop must never kill the worker
        traceback.print_exc()
        error_exit = True
    finally:
        for ch in outs:
            try:
                ch.close(error=error_exit)
            except Exception:  # noqa: BLE001
                pass
        for ch in list(ins) + list(outs):
            try:
                ch.detach()
            except Exception:  # noqa: BLE001
                pass
        flush_spans(final=True)
        _dag_stops.pop((dag_id, stage), None)
        try:
            client.notify("dag_stage_exit", {
                "dag_id": dag_id, "stage": stage,
            })
        except Exception:  # noqa: BLE001 - daemon already gone
            pass
        for c in remote_clients.values():
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass


def _metrics_push_loop(client: RpcClient):
    """Periodic worker -> daemon metric export (ray_tpu_torch.obs): the worker's
    registry delta rides a fire-and-forget ``metrics_push``; the daemon
    folds it into the node's next GCS heartbeat. Ends with the
    connection."""
    from ray_tpu_torch.core import config as _config
    from ray_tpu_torch.util import metrics as _m

    period = _config.GLOBAL_CONFIG.metrics_report_interval_ms / 1000.0
    while True:
        time.sleep(period)
        if not _m.ENABLED:
            continue
        delta = _m.snapshot_delta()
        if not delta:
            continue
        try:
            client.notify("metrics_push", {"delta": delta})
        except Exception:  # noqa: BLE001 - daemon gone; worker exits soon
            return


def _on_dag_loop(client: RpcClient):
    def handler(spec: dict):
        threading.Thread(
            target=_dag_loop, args=(client, spec), daemon=True,
            name=f"dag-{spec['dag_id'][-8:]}-s{spec['stage']}",
        ).start()

    return handler


# ---- serve fast-path replica loops (ray_tpu_torch/serve/fastpath.py): one
# ReplicaFastPath per hosted replica actor drains the request channels the
# daemon attaches via `serve_attach` pushes — no control plane per request.
_serve_fp: dict = {}  # actor_id -> ReplicaFastPath
_serve_fp_lock = threading.Lock()


def _serve_attach(client: RpcClient, p: dict):
    aid = p["actor_id"]
    # the attach may race the actor's creation task: wait for the instance
    deadline = time.time() + 30.0
    inst = _actor_instances.get(aid)
    while inst is None and time.time() < deadline:
        time.sleep(0.01)
        inst = _actor_instances.get(aid)
    try:
        if inst is None:
            raise RuntimeError(f"actor {aid} never materialized here")
        from ray_tpu_torch.serve.fastpath import ReplicaFastPath

        with _serve_fp_lock:
            fp = _serve_fp.get(aid)
            if fp is None:
                fp = _serve_fp[aid] = ReplicaFastPath(
                    inst, aio=_actor_aio.get(aid),
                    batch_max=int(p.get("batch_max") or 64),
                    target_latency_s=float(
                        p.get("target_latency_s") or 0.02
                    ),
                )
        fp.attach(p["pair_id"], p["req_path"], p["resp_path"])
    except BaseException as e:  # noqa: BLE001 - reported to the daemon
        try:
            client.notify("serve_replica_ready", {
                "pair_id": p["pair_id"], "ok": False, "error": repr(e),
            })
        except Exception:  # noqa: BLE001 - daemon already gone
            pass
        return
    try:
        client.notify("serve_replica_ready", {
            "pair_id": p["pair_id"], "ok": True,
        })
    except Exception:  # noqa: BLE001 - daemon already gone
        pass


def _on_serve_attach(client: RpcClient):
    def handler(p: dict):
        threading.Thread(
            target=_serve_attach, args=(client, p), daemon=True,
            name=f"serve-fp-attach-{p['pair_id'][-8:]}",
        ).start()

    return handler


def main():  # pragma: no cover - runs as a subprocess
    global _daemon_client
    host = os.environ["RAY_TPU_DAEMON_HOST"]
    port = int(os.environ["RAY_TPU_DAEMON_PORT"])
    worker_id = os.environ["RAY_TPU_WORKER_ID"]
    try:
        client = RpcClient(
            host, port, timeout=120.0,
            name=worker_id, peer=os.environ.get("RAY_TPU_NODE_ID", "daemon"),
        )
    except OSError:
        # daemon already gone (cluster tearing down while we spawned):
        # exit quietly instead of spraying a traceback
        return
    _daemon_client = client
    _attach_shm()
    tasks: "queue.Queue[dict]" = queue.Queue()
    client.subscribe("run_task", tasks.put)
    client.subscribe("stream_ack", _on_stream_ack)
    client.subscribe("dag_loop", _on_dag_loop(client))
    client.subscribe("dag_stop", _on_dag_stop)
    client.subscribe("serve_attach", _on_serve_attach(client))
    client.on_close = lambda: os._exit(0)  # daemon gone -> exit
    # Install the cluster runtime NOW (env RAY_TPU_GCS_ADDR -> ClusterClient)
    # rather than relying on lazy auto-init: threaded-actor methods run on
    # pool threads, where auto-init is forbidden.
    import ray_tpu_torch

    ray_tpu_torch.init(ignore_reinit_error=True)
    client.call("worker_ready", {"worker_id": worker_id}, timeout=30.0)
    threading.Thread(
        target=_metrics_push_loop, args=(client,), daemon=True,
        name="worker-metrics-push",
    ).start()
    # Threaded-actor pool (reference: max_concurrency>1): methods of an actor
    # created with max_concurrency>1 may overlap/block on each other.
    from concurrent.futures import ThreadPoolExecutor

    def _pooled(t):
        # Inline-path semantics: an unreported failure (e.g. daemon RPC loss)
        # kills the worker so the daemon resolves the task as WORKER_DIED —
        # never leave the driver hanging on an unobserved Future.
        try:
            _execute(client, t)
        except BaseException:
            traceback.print_exc()
            os._exit(1)

    profiler = None
    n_profiled = 0
    if os.environ.get("RAY_TPU_WORKER_PROFILE"):
        import cProfile

        import time as _t
        profiler = cProfile.Profile(_t.process_time)  # CPU, not wall

    pool = None
    while True:
        t = tasks.get()
        mc = _actor_concurrency.get(t.get("actor_id") or "", 1)
        if mc > 1 and not t.get("actor_creation"):
            if pool is None:
                # sized to the actor's declared concurrency (one actor per
                # worker process, so one pool)
                pool = ThreadPoolExecutor(max_workers=mc)
            pool.submit(_pooled, t)
        elif profiler is not None:
            profiler.enable()
            _execute(client, t)
            profiler.disable()
            n_profiled += 1
            if n_profiled % 100 == 0:  # workers die via os._exit: no atexit
                profiler.dump_stats(
                    f"{os.environ['RAY_TPU_WORKER_PROFILE']}"
                    f".{os.getpid()}"
                )
        else:
            _execute(client, t)


if __name__ == "__main__":
    main()
