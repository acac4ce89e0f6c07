"""Dependency-free RPC: length-prefixed pickle frames over asyncio TCP.

Fills the role of the reference's gRPC layer (src/ray/rpc/grpc_server.h,
grpc_client.h, retryable_grpc_client.cc) for the host-side control plane.
The environment has no grpcio; the control plane is low-rate (the data plane
moves bytes in chunks over the same framing), so asyncio + pickle is enough.

Frame: 8-byte little-endian length + pickle payload.
Request: {"id": n, "method": str, "params": obj}
Response: {"id": n, "result": obj} | {"id": n, "error": (type_name, str, tb)}
Push (server->client, no id): {"push": channel, "data": obj}

Fault injection: every hook point below is guarded by a single
``if CHAOS is not None`` check on a module global set by
``ray_tpu.chaos.install`` — zero overhead when injection is disabled.

Retry/reconnect: ``RpcClient`` is one TCP connection and stays that way
(its owner sees ``ConnectionLost``); :class:`RetryingRpcClient` layers
transparent reconnection with capped exponential backoff + full jitter,
per-call deadlines, an idempotent-method retry table, and subscription
replay on reconnect (reference: retryable_grpc_client.cc) — daemons and
drivers ride it for their GCS connection, so a GCS restart is survivable
instead of fatal.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import random
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.util import metrics as _metrics

_LEN = struct.Struct("<Q")

# --- observability (ray_tpu.obs): client-side rpc metrics + retry-plane
# counters. Constructed at module scope (one registry entry per process);
# every observation site is gated on the single _metrics.ENABLED global.
_M_CALL_LATENCY = _metrics.Histogram(
    "ray_tpu_rpc_client_call_s",
    "blocking rpc round-trip latency per method (client-side)",
    tag_keys=("method",),
)
_M_CLIENT_PENDING = _metrics.Gauge(
    "ray_tpu_rpc_client_pending",
    "in-flight request futures on one rpc client connection",
    tag_keys=("peer",),
)
_M_RECONNECTS = _metrics.Counter(
    "ray_tpu_rpc_reconnects_total",
    "successful RetryingRpcClient reconnections",
    tag_keys=("peer",),
)
_M_RESENDS = _metrics.Counter(
    "ray_tpu_rpc_resends_total",
    "ack-watchdog resends of unanswered retryable call_asyncs",
    tag_keys=("peer",),
)
_M_BLACKHOLES = _metrics.Counter(
    "ray_tpu_rpc_blackhole_resets_total",
    "connections reset after consecutive unanswered attempt windows",
    tag_keys=("peer",),
)
# per-method/per-peer series keys, computed once (the per-call tag-dict
# build + sort costs more than the observation itself on hot rpc paths)
_CALL_LATENCY_KEYS: Dict[str, tuple] = {}
MAX_FRAME = 1 << 31

# Active fault plane, or None. Set ONLY by ray_tpu.chaos.install/uninstall;
# every hook below costs one global load + identity check when disabled.
CHAOS = None

# Active protocol tracer, or None. Set ONLY by
# ray_tpu.analysis.invariants.install/uninstall — same zero-overhead
# pattern as CHAOS: one global load + identity check per frame when
# disabled. When installed, every client send and server recv is recorded
# with a Lamport clock (requests carry it as a top-level "_lc" frame key,
# beside "id"/"method", so payloads are untouched), and the GCS/daemon
# apply hooks record state mutations to the same trace for the offline
# invariant checker.
TRACE = None


class RpcError(Exception):
    pass


class RpcTimeout(RpcError):
    """A call exceeded its deadline (no response; the request may or may
    not have executed). Distinct from remote errors so retry layers can
    tell 'no answer' from 'answered with failure'."""


def log_rpc_failure(fut):
    """Done-callback for fire-and-forget call_async uses: a server-side
    exception set on an unread future would otherwise vanish silently."""
    try:
        exc = fut.exception()
    except Exception:  # noqa: BLE001 - cancelled
        return
    if exc is not None:
        import sys

        print(f"[ray_tpu] async rpc failed: {exc!r}", file=sys.stderr)


class ConnectionLost(RpcError):
    pass


def flight_dump(reason: str) -> None:
    """Best-effort black-box dump on a crash surface: when the active
    tracer is the always-on flight recorder (ray_tpu.obs), write its ring
    to artifacts/ (rate-limited). Never raises — a failing dump must not
    compound the crash being recorded."""
    t = TRACE
    if t is not None and getattr(t, "is_flight_recorder", False):
        try:
            t.maybe_dump(reason)
        except Exception:  # noqa: BLE001 - crash path stays quiet
            pass


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    data = await reader.readexactly(n)
    return pickle.loads(data)


def frame_bytes(obj: Any) -> bytes:
    data = pickle.dumps(obj, protocol=5)
    return _LEN.pack(len(data)) + data


async def write_frame(writer: asyncio.StreamWriter, obj: Any):
    writer.write(frame_bytes(obj))
    await writer.drain()


class ServerConn:
    """One accepted connection; supports push."""

    _next_id = 0

    def __init__(self, reader, writer, loop, server_name: str = "rpc"):
        self.reader = reader
        self.writer = writer
        self.loop = loop
        ServerConn._next_id += 1
        self.conn_id = ServerConn._next_id
        self.server_name = server_name
        self.meta: Dict[str, Any] = {}  # handler scratch (e.g. node_id)
        self._wlock = asyncio.Lock()
        self.closed = False

    def peer_label(self) -> str:
        """Chaos endpoint label for the remote side: its registered
        node/driver identity once known, else a connection ordinal."""
        return (
            self.meta.get("node_id")
            or self.meta.get("driver_id")
            or self.meta.get("worker_id")
            or f"conn{self.conn_id}"
        )

    async def _chaos_send(self, channel: Optional[str]) -> Tuple[bool, bool]:
        """(deliver, duplicate) for an outbound frame under the active
        fault plane. Caller already checked CHAOS is not None."""
        act = CHAOS.on_server_send(self.server_name, self.peer_label(), channel)
        if act is None:
            return True, False
        if act.kind in ("drop", "partition"):
            return False, False
        if act.kind == "reset":
            try:
                self.writer.transport.abort()
            except Exception:  # noqa: BLE001
                pass
            self.closed = True
            return False, False
        if act.kind == "delay":
            await asyncio.sleep(act.delay_s)
            return True, False
        return True, act.kind == "duplicate"

    async def push(self, channel: str, data: Any):
        if self.closed:
            return
        if TRACE is not None:
            TRACE.on_push(self.server_name, self.peer_label(), channel)
        twice = False
        if CHAOS is not None:
            deliver, twice = await self._chaos_send(channel)
            if not deliver:
                return
        try:
            async with self._wlock:
                await write_frame(self.writer, {"push": channel, "data": data})
                if twice:
                    await write_frame(
                        self.writer, {"push": channel, "data": data}
                    )
        except (ConnectionError, asyncio.IncompleteReadError, RuntimeError):
            self.closed = True

    async def respond(self, msg: dict):
        if CHAOS is not None:
            deliver, _ = await self._chaos_send("response")
            if not deliver:
                return
        try:
            async with self._wlock:
                await write_frame(self.writer, msg)
        except (ConnectionError, RuntimeError):
            self.closed = True


class RpcServer:
    """Asyncio TCP server running in its own thread.

    handler(method, params, conn) -> result (sync or async); raising maps to
    an error response. on_disconnect(conn) fires when a client drops — the
    hook health-checking builds on (reference: gcs_health_check_manager.cc
    polls; we get edge-triggered close + periodic heartbeats).
    """

    def __init__(
        self,
        handler: Callable,
        host: str = "127.0.0.1",
        port: int = 0,
        on_disconnect: Optional[Callable] = None,
        name: str = "rpc",
    ):
        self.handler = handler
        self.on_disconnect = on_disconnect
        self.host = host
        self.port = port
        self.name = name
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-server", daemon=True
        )
        self.conns: Dict[int, ServerConn] = {}
        self._server = None

    def start(self) -> int:
        self._thread.start()
        timeout = _config.GLOBAL_CONFIG.rpc_server_start_timeout_s
        if not self._started.wait(timeout=timeout):
            raise RpcError("server failed to start")
        return self.port

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self._serve())
        try:
            self.loop.run_forever()
        finally:
            self.loop.close()

    async def _serve(self):
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()

    async def _on_client(self, reader, writer):
        conn = ServerConn(reader, writer, self.loop, server_name=self.name)
        self.conns[conn.conn_id] = conn
        try:
            while True:
                msg = await read_frame(reader)
                if TRACE is not None:
                    TRACE.on_recv(
                        conn.peer_label(), self.name, msg.get("method"),
                        msg.pop("_lc", None),
                    )
                if CHAOS is not None:
                    if not await self._chaos_recv(conn, msg):
                        continue
                asyncio.ensure_future(self._dispatch(conn, msg))
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            pickle.UnpicklingError,
            EOFError,
        ):
            pass
        finally:
            conn.closed = True
            self.conns.pop(conn.conn_id, None)
            if self.on_disconnect:
                try:
                    res = self.on_disconnect(conn)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    traceback.print_exc()
            try:
                writer.close()
            except Exception:
                pass

    async def _chaos_recv(self, conn: ServerConn, msg: dict) -> bool:
        """True when the inbound frame should be dispatched. Caller already
        checked CHAOS is not None."""
        act = CHAOS.on_server_recv(
            conn.peer_label(), self.name, msg.get("method")
        )
        if act is None:
            return True
        if act.kind in ("drop", "partition"):
            return False
        if act.kind == "delay":
            await asyncio.sleep(act.delay_s)
            return True
        if act.kind == "duplicate":
            asyncio.ensure_future(self._dispatch(conn, dict(msg)))
            return True
        if act.kind == "reset":
            try:
                conn.writer.transport.abort()
            except Exception:  # noqa: BLE001
                pass
            return False
        return True

    async def _dispatch(self, conn: ServerConn, msg: dict):
        mid = msg.get("id")
        try:
            result = self.handler(msg["method"], msg.get("params"), conn)
            if asyncio.iscoroutine(result) or isinstance(result, asyncio.Future):
                result = await result
            if mid is not None:
                await conn.respond({"id": mid, "result": result})
        except Exception as e:
            if mid is not None:
                await conn.respond(
                    {"id": mid, "error": (type(e).__name__, str(e), traceback.format_exc())}
                )
            else:
                # a fire-and-forget handler crashed: nobody hears the
                # error response that doesn't exist — leave a black box
                traceback.print_exc()
                flight_dump(f"handler-crash-{self.name}")

    def broadcast(self, channel: str, data: Any, filter_fn=None):
        """Thread-safe push to all (or filtered) connections."""

        def _do():
            for conn in list(self.conns.values()):
                if filter_fn is None or filter_fn(conn):
                    asyncio.ensure_future(conn.push(channel, data))

        try:
            self.loop.call_soon_threadsafe(_do)
        except RuntimeError:  # loop closed during shutdown
            pass

    def call_soon(self, fn, *args):
        try:
            self.loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:  # loop closed during shutdown
            pass

    def send_push(self, conn: ServerConn, channel: str, data: Any):
        """Thread-safe single-connection push. Every GCS-originated push
        funnels through here (or broadcast) — the seam the virtual
        runtime's in-process server overrides to turn pushes into
        schedulable events (see ray_tpu/cluster/runtime.py)."""
        self.call_soon(
            lambda: asyncio.ensure_future(conn.push(channel, data))
        )

    def stop(self):
        def _stop():
            if self._server:
                self._server.close()
            # abort every client socket: peers detect the shutdown
            # edge-triggered (a stopped loop alone sends no FIN, leaving
            # clients blocked in recv forever — no reconnect would ever
            # fire). abort() sends RST immediately, no flush cycle needed.
            for conn in list(self.conns.values()):
                try:
                    conn.writer.transport.abort()
                except Exception:
                    try:
                        conn.writer.close()
                    except Exception:
                        pass
            # one extra loop tick so the aborts are processed before stop
            self.loop.call_later(0.05, self.loop.stop)

        try:
            self.loop.call_soon_threadsafe(_stop)
            self._thread.join(
                timeout=_config.GLOBAL_CONFIG.rpc_server_stop_timeout_s
            )
        except Exception:
            pass


class RpcClient:
    """Synchronous client facade over a background asyncio connection.

    call() blocks the calling thread; subscriptions deliver on a dedicated
    dispatch thread (so callbacks may themselves call()). This class is ONE
    TCP connection: when it drops, every pending call fails with
    ConnectionLost and the instance is dead. Owners that must survive peer
    restarts wrap it in RetryingRpcClient (reference:
    retryable_grpc_client.cc), which reconnects with backoff and replays
    subscriptions.

    ``name``/``peer`` are chaos endpoint labels (see ray_tpu.chaos).
    """

    def __init__(self, host: str, port: int, timeout: Optional[float] = None,
                 name: str = "client", peer: str = "server",
                 send_timeout: Optional[float] = None):
        from concurrent.futures import Future

        cfg = _config.GLOBAL_CONFIG
        self.host = host
        self.port = port
        self.timeout = timeout if timeout is not None else cfg.rpc_call_timeout_s
        self.send_timeout = (
            send_timeout if send_timeout is not None else cfg.rpc_send_timeout_s
        )
        self.name = name
        self.peer = peer
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._pending: Dict[int, "Future"] = {}
        self._subs: Dict[str, Callable] = {}
        self._sock = socket.create_connection((host, port), timeout=self.timeout)
        self._sock.settimeout(None)
        # per-direction send-slice deadline: SO_SNDTIMEO bounds each send()
        # syscall without touching recv (settimeout would); _send_bytes
        # enforces the full-frame send_timeout across slices
        slice_s = max(min(1.0, self.send_timeout), 0.05)
        self._sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", int(slice_s), int((slice_s % 1.0) * 1e6)),
        )
        self._send_lock = threading.Lock()
        self._m_pending_key = _M_CLIENT_PENDING.series_key({"peer": peer})
        self._closed = False
        self.on_close: Optional[Callable] = None
        self._reader_thread = threading.Thread(
            target=self._read_loop, daemon=True, name="rpc-client-reader"
        )
        self._reader_thread.start()

    def _read_loop(self):
        buf = b""
        sock = self._sock
        try:
            while not self._closed:
                while len(buf) < _LEN.size:
                    chunk = sock.recv(1 << 20)
                    if not chunk:
                        raise ConnectionLost("server closed")
                    buf += chunk
                (n,) = _LEN.unpack(buf[: _LEN.size])
                buf = buf[_LEN.size :]
                while len(buf) < n:
                    chunk = sock.recv(1 << 20)
                    if not chunk:
                        raise ConnectionLost("server closed")
                    buf += chunk
                msg = pickle.loads(buf[:n])
                buf = buf[n:]
                self._handle(msg)
        except (ConnectionLost, ConnectionError, OSError):
            pass
        finally:
            # fail all pending calls: _closed is published in the same
            # critical section as the sweep and call_async checks it
            # under _id_lock, so an insert lands either in this
            # snapshot (failed here) or after it (raises ConnectionLost
            # at the caller) — never in the stranded gap between
            with self._id_lock:
                self._closed = True
                stranded = list(self._pending.items())
                self._pending.clear()
            for mid, fut in stranded:
                if not fut.done():
                    fut.set_exception(ConnectionLost("connection lost"))
            if self.on_close:
                try:
                    self.on_close()
                except Exception:
                    pass

    def _handle(self, msg: dict):
        if "push" in msg:
            cb = self._subs.get(msg["push"])
            if cb:
                try:
                    cb(msg["data"])
                except Exception:
                    traceback.print_exc()
            return
        mid = msg.get("id")
        with self._id_lock:
            fut = self._pending.pop(mid, None)
            npending = len(self._pending)
        if fut is not None and _metrics.ENABLED:
            # keep the gauge honest on the way DOWN too, or an idle
            # connection reports its burst high-water mark forever
            _M_CLIENT_PENDING.set_k(self._m_pending_key, npending)
        if fut is not None and not fut.done():
            if "error" in msg:
                etype, estr, tb = msg["error"]
                if etype == "ConnectionLost":
                    fut.set_exception(ConnectionLost(estr))
                else:
                    fut.set_exception(
                        RpcError(f"{etype}: {estr}\n--- remote traceback ---\n{tb}")
                    )
            else:
                fut.set_result(msg["result"])

    def subscribe(self, channel: str, callback: Callable):
        self._subs[channel] = callback

    def _send_bytes(self, data: bytes):
        """Bounded send (caller holds _send_lock). sendall on a blocking
        socket has NO deadline: one peer that stops draining its receive
        buffer would wedge every caller forever behind the send lock.
        Chunked sends under SO_SNDTIMEO slices enforce ``send_timeout``
        per frame; on expiry the socket is torn down (a half-written frame
        corrupts the stream) and ConnectionLost raised."""
        deadline = time.monotonic() + self.send_timeout
        view = memoryview(data)
        sock = self._sock
        while view:
            if time.monotonic() >= deadline:
                self._teardown()
                raise ConnectionLost(
                    f"send to {self.peer} stalled for {self.send_timeout}s"
                )
            try:
                n = sock.send(view[: 1 << 20])
            except (BlockingIOError, InterruptedError):
                continue  # SNDTIMEO slice expired with no buffer space
            except OSError as e:
                raise ConnectionLost(str(e))
            view = view[n:]

    def _teardown(self):
        """Kill the socket so the reader thread unblocks and fails every
        pending call (the connection is no longer usable)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def call_async(self, method: str, params: Any = None):
        """Send a request and return a concurrent.futures.Future for its
        result. Send order on one client is frame order at the server — the
        ordered-submission primitive actor call pipelines rely on
        (reference: actor_submit_queue.h sequence numbers)."""
        from concurrent.futures import Future

        fut: Future = Future()
        # closed-check + insert are one critical section (_id_lock doubles
        # as the pending-table lock): the reader thread's teardown sweep
        # snapshots-and-fails _pending, so a future inserted between its
        # snapshot and a bare closed-check would never be failed and the
        # caller would hang out its full timeout (race found by the
        # happens-before sanitizer, analysis/racer.py)
        with self._id_lock:
            if self._closed:
                raise ConnectionLost("client closed")
            self._next_id += 1
            mid = self._next_id
            self._pending[mid] = fut
            npending = len(self._pending)
        if _metrics.ENABLED:
            _M_CLIENT_PENDING.set_k(self._m_pending_key, npending)
        msg = {"id": mid, "method": method, "params": params}
        t = TRACE
        if t is not None:
            msg["_lc"] = t.on_send(self.name, self.peer, method)
        data = frame_bytes(msg)
        if t is not None:
            # richer optional hook (rpc profiler): frame size + send kind
            # aren't in on_send's signature, and widening it would break
            # every installed tracer
            osb = getattr(t, "on_send_bytes", None)
            if osb is not None:
                osb(method, len(data), "call")
        if CHAOS is not None:
            act = CHAOS.on_client_send(self.name, self.peer, method)
            if act is not None:
                if act.kind in ("drop", "partition"):
                    return fut  # frame never leaves; the caller's deadline fires
                if act.kind == "delay":
                    time.sleep(act.delay_s)
                elif act.kind == "duplicate":
                    data = data + data
                elif act.kind == "reset":
                    self._teardown()
                    with self._id_lock:
                        self._pending.pop(mid, None)
                    raise ConnectionLost("chaos: injected connection reset")
        try:
            with self._send_lock:
                self._send_bytes(data)
        except (OSError, ConnectionLost) as e:
            with self._id_lock:
                self._pending.pop(mid, None)
            if isinstance(e, ConnectionLost):
                raise
            raise ConnectionLost(str(e))
        return fut

    def call(self, method: str, params: Any = None, timeout: Optional[float] = None):
        t0 = time.perf_counter() if _metrics.ENABLED else 0.0
        fut = self.call_async(method, params)
        from concurrent.futures import TimeoutError as FutTimeout

        try:
            result = fut.result(timeout=timeout or self.timeout)
            if _metrics.ENABLED:
                k = _CALL_LATENCY_KEYS.get(method)
                if k is None:
                    k = _CALL_LATENCY_KEYS[method] = \
                        _M_CALL_LATENCY.series_key({"method": method})
                _M_CALL_LATENCY.observe_k(k, time.perf_counter() - t0)
            return result
        except FutTimeout:
            # drop the orphaned future so _pending doesn't leak (a late
            # response finds no entry and is ignored)
            with self._id_lock:
                for mid, f in list(self._pending.items()):
                    if f is fut:
                        self._pending.pop(mid, None)
                        break
            raise RpcTimeout(f"rpc {method} timed out")

    def notify(self, method: str, params: Any = None):
        """Fire-and-forget (no response expected)."""
        if self._closed:
            raise ConnectionLost("client closed")
        msg = {"method": method, "params": params}
        t = TRACE
        if t is not None:
            msg["_lc"] = t.on_send(self.name, self.peer, method)
        data = frame_bytes(msg)
        if t is not None:
            osb = getattr(t, "on_send_bytes", None)
            if osb is not None:
                osb(method, len(data), "notify")
        if CHAOS is not None:
            act = CHAOS.on_client_send(self.name, self.peer, method)
            if act is not None:
                if act.kind in ("drop", "partition"):
                    return
                if act.kind == "delay":
                    time.sleep(act.delay_s)
                elif act.kind == "duplicate":
                    data = data + data
                elif act.kind == "reset":
                    self._teardown()
                    raise ConnectionLost("chaos: injected connection reset")
        with self._send_lock:
            self._send_bytes(data)

    def close(self):
        # _id_lock serializes the flag flip with call_async's
        # closed-check-and-insert and with the reader's teardown sweep
        # (race sanitizer finding: two unsynchronized writers on the
        # shutdown flag)
        with self._id_lock:
            self._closed = True
        self._teardown()


class RetryingRpcClient:
    """Reconnecting, retrying facade over RpcClient (reference:
    retryable_grpc_client.cc: transparent retry with exponential backoff,
    bounded by per-call deadlines, for methods marked idempotent).

    - Reconnects forever with capped exponential backoff + full jitter;
      after ``reconnect_timeout_s`` of continuous outage it fires
      ``on_reconnect_timeout`` ONCE (owners fail stranded work) but keeps
      dialing, so a peer back after minutes still restores the session.
    - ``on_session(raw, first)`` runs on every (re)connect before the
      connection is published: registration + state resync live there.
    - Subscriptions are replayed onto every new connection, exactly once
      per channel (dict semantics — no stacked callbacks).
    - ``call`` retries methods in RETRYABLE across connection losses (and
      lost frames, via per-attempt sub-deadlines) until the call deadline;
      non-retryable methods fail fast with ConnectionLost.
    - ``call_async``/``notify`` during an outage park retryable sends in a
      queue drained on reconnect — callers on event-loop threads are never
      blocked by a dead peer.
    """

    # Methods safe to re-send after an ambiguous failure: reads, absolute
    # state writes (register/sync/location/kv), and reports the server
    # dedupes (submit_task, task_done). Actor CALLS are absent by design:
    # they are at-most-once (actor_submit_queue handles replay).
    RETRYABLE = frozenset({
        "register_node", "node_sync", "register_driver", "heartbeat",
        "get_nodes", "locate_object", "add_object_location", "object_info",
        "kv_put", "kv_get", "kv_del", "kv_keys", "get_actor", "list_actors",
        "list_tasks", "summarize_tasks", "list_placement_groups",
        "get_placement_group", "list_events", "cluster_resources",
        "available_resources", "summary", "autoscaler_state", "stats",
        "submit_task", "task_done", "actor_died", "register_borrows",
        "borrow_released", "free_objects", "stream_item", "stream_ack",
        "worker_logs", "register_actor", "metrics",
        # PG ops are dedupe-guarded server-side (duplicate create returns
        # the current state; remove/kill are idempotent pops)
        "create_placement_group", "remove_placement_group", "kill_actor",
        # serve fast-path pair plane: register overwrites the same pair_id
        # idempotently, teardown is an idempotent pop
        "serve_register", "serve_teardown",
    })

    def __init__(self, host: str, port: int, timeout: Optional[float] = None,
                 name: str = "client", peer: str = "server",
                 on_session: Optional[Callable] = None,
                 reconnect_timeout_s: Optional[float] = None,
                 auto_connect: bool = True, config=None):
        # owners with a per-instance Config pass it; GLOBAL_CONFIG is the
        # fallback for bare construction
        cfg = config if config is not None else _config.GLOBAL_CONFIG
        self.host = host
        self.port = port
        self.timeout = timeout if timeout is not None else cfg.rpc_call_timeout_s
        self.name = name
        self.peer = peer
        self.on_session = on_session
        self.on_reconnect_timeout: Optional[Callable] = None
        self._reconnect_timeout_s = (
            reconnect_timeout_s
            if reconnect_timeout_s is not None
            else cfg.gcs_reconnect_timeout_s
        )
        self._base_backoff = cfg.rpc_retry_base_backoff_s
        self._max_backoff = cfg.rpc_retry_max_backoff_s
        self._attempt_timeout = cfg.rpc_retry_attempt_timeout_s
        self._subs: Dict[str, Callable] = {}
        self._cv = threading.Condition()
        self._raw: Optional[RpcClient] = None
        self._closed = False
        self._reconnecting = False
        self._connected_once = False
        # (method, params, Future|None) parked while disconnected
        self._queued: List[tuple] = []
        # ack watchdog for retryable call_async sends: a silently lost
        # frame (chaos drop, kernel buffer torn down mid-outage) would
        # otherwise strand the future forever. Exhausted resends FAIL the
        # future with RpcTimeout. _watch_due keeps healthy-path ticks O(1).
        self._watch: List[list] = []
        self._watch_due = float("inf")
        self._watch_thread: Optional[threading.Thread] = None
        if auto_connect:
            self.connect()

    # ------------------------------------------------------- connection

    def connect(self):
        """First dial; raises on failure (constructor parity with
        RpcClient — a peer that was never there is the caller's error)."""
        raw = self._dial(first=True)
        self._connected_once = True
        self._publish(raw)
        return self

    def _dial(self, first: bool) -> RpcClient:
        raw = RpcClient(
            self.host, self.port, timeout=self.timeout,
            name=self.name, peer=self.peer,
        )
        try:
            for ch, cb in self._subs.items():
                raw.subscribe(ch, cb)
            raw.on_close = lambda r=raw: self._on_raw_close(r)
            if self.on_session is not None:
                self.on_session(raw, first)
        except BaseException:
            raw.close()
            raise
        return raw

    def _publish(self, raw: RpcClient):
        with self._cv:
            self._raw = raw
            queued, self._queued = self._queued, []
            self._cv.notify_all()
        for method, params, fut in queued:
            self._send_queued(raw, method, params, fut)
        if raw._closed:
            # died between session setup and publication: the on_close hook
            # already fired (and was ignored — raw wasn't current yet)
            self._on_raw_close(raw)

    def _on_raw_close(self, raw: RpcClient):
        with self._cv:
            if self._closed or self._raw is not raw:
                return
            self._raw = None
            if self._reconnecting:
                return
            self._reconnecting = True
        threading.Thread(
            target=self._reconnect_loop, daemon=True,
            name=f"rpc-reconnect-{self.peer}",
        ).start()

    def _reconnect_loop(self):
        start = time.monotonic()
        attempt = 0
        timed_out = False
        try:
            while not self._closed:
                # full jitter: uniform over [0, min(cap, base * 2^attempt)];
                # exponent clamped — an unbounded 2**attempt overflows
                # float conversion after ~1024 attempts and would kill this
                # thread, permanently disabling reconnection
                time.sleep(random.uniform(
                    0.0,
                    min(
                        self._max_backoff,
                        self._base_backoff * (2 ** min(attempt, 30)),
                    ),
                ))
                attempt += 1
                if not timed_out and (
                    time.monotonic() - start > self._reconnect_timeout_s
                ):
                    # one-shot: owners fail stranded work, we keep dialing
                    timed_out = True
                    self._fail_queued(ConnectionLost(
                        f"{self.peer} unreachable past reconnect timeout"
                    ))
                    if self.on_reconnect_timeout is not None:
                        try:
                            self.on_reconnect_timeout()
                        except Exception:
                            traceback.print_exc()
                try:
                    raw = self._dial(first=False)
                except Exception:  # noqa: BLE001 - peer still down
                    continue
                with self._cv:
                    self._reconnecting = False
                if _metrics.ENABLED:
                    _M_RECONNECTS.inc(tags={"peer": self.peer})
                self._publish(raw)
                return
        finally:
            with self._cv:
                if self._reconnecting:
                    self._reconnecting = False

    def _fail_queued(self, exc: Exception):
        """Fail everything parked on the reconnect plane: the outage queue
        AND ack-watched sends (their last attempt died with the old conn —
        nothing else will complete them if the peer stays gone)."""
        with self._cv:
            queued, self._queued = self._queued, []
            watched, self._watch = self._watch, []
            self._watch_due = float("inf")
        for _method, _params, fut in queued:
            if fut is not None and not fut.done():
                fut.set_exception(exc)
        for ent in watched:
            if not ent[0].done():
                ent[0].set_exception(exc)

    def _send_queued(self, raw: RpcClient, method, params, fut):
        try:
            inner = raw.call_async(method, params)
        except Exception:  # noqa: BLE001 - raced another outage: the
            return  # entry stays ack-watched; the watchdog resends
        if fut is not None:
            self._chain(inner, fut)

    # ------------------------------------------------------------- calls

    def _wait_connected(self, deadline: float, retryable: bool,
                        method: str) -> RpcClient:
        with self._cv:
            while self._raw is None and not self._closed:
                if not retryable:
                    raise ConnectionLost(f"{self.peer} disconnected")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RpcTimeout(
                        f"rpc {method} timed out waiting for reconnect"
                    )
                self._cv.wait(timeout=min(remaining, 0.5))
            if self._closed:
                raise ConnectionLost("client closed")
            return self._raw

    def call(self, method: str, params: Any = None,
             timeout: Optional[float] = None):
        total = timeout if timeout is not None else self.timeout
        deadline = time.monotonic() + total
        retryable = method in self.RETRYABLE
        stale_raw = None
        stale_timeouts = 0
        while True:
            raw = self._wait_connected(deadline, retryable, method)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RpcTimeout(f"rpc {method} timed out")
            # retryable calls probe in sub-deadline attempts so a single
            # lost frame costs one attempt window, not the whole budget
            attempt = (
                min(remaining, self._attempt_timeout) if retryable else remaining
            )
            try:
                return raw.call(method, params, timeout=max(attempt, 0.05))
            except ConnectionLost:
                if not retryable or self._closed:
                    raise
                if time.monotonic() >= deadline:
                    raise RpcTimeout(f"rpc {method} timed out")
            except RpcTimeout:
                if not retryable or self._closed:
                    raise
                if time.monotonic() >= deadline:
                    raise RpcTimeout(f"rpc {method} timed out")
                # two consecutive unanswered attempt windows on ONE conn:
                # suspected blackhole (half-open socket) — reset it so the
                # next attempt rides a fresh connection
                stale_timeouts = stale_timeouts + 1 if raw is stale_raw else 1
                stale_raw = raw
                if stale_timeouts >= 2:
                    with self._cv:
                        current = self._raw is raw
                    if current:
                        if _metrics.ENABLED:
                            _M_BLACKHOLES.inc(tags={"peer": self.peer})
                        raw._teardown()
                    stale_timeouts = 0

    def call_async(self, method: str, params: Any = None):
        """Future-returning send. During an outage, retryable methods park
        in the reconnect queue (the future resolves after replay) instead
        of blocking or raising — safe from event-loop threads. Retryable
        sends are also ack-watched: no response within the attempt window
        triggers a resend (the retry table guarantees dedupe safety), so a
        silently lost frame cannot strand the future."""
        from concurrent.futures import Future

        retryable = method in self.RETRYABLE
        with self._cv:
            if self._closed:
                raise ConnectionLost("client closed")
            raw = self._raw
            if raw is None:
                if not retryable:
                    raise ConnectionLost(f"{self.peer} disconnected")
                fut: Future = Future()
                self._queued.append((method, params, fut))
                self._watch_send(fut, method, params)
                return fut
        try:
            inner = raw.call_async(method, params)
        except ConnectionLost:
            if not retryable or self._closed:
                raise
            with self._cv:
                fut = Future()
                self._queued.append((method, params, fut))
            self._watch_send(fut, method, params)
            return fut
        if retryable:
            # decouple the caller's future from the wire attempt so the
            # watchdog can complete it from a resend instead
            fut = Future()
            self._chain(inner, fut)
            self._watch_send(fut, method, params, sent_on=raw)
            return fut
        return inner

    @staticmethod
    def _chain(inner, fut):
        """First terminal inner attempt wins; later ones are ignored.
        ConnectionLost from a watched attempt is NOT propagated — the
        watchdog/reconnect queue owns the retry (the final failure arrives
        via _fail_queued or resend exhaustion)."""
        def _copy(f, fut=fut):
            if fut.done():
                return
            try:
                exc = f.exception()
            except Exception:  # noqa: BLE001 - cancelled
                return
            if isinstance(exc, ConnectionLost):
                return  # a retry attempt will complete (or fail) fut later
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(f.result())
        inner.add_done_callback(_copy)

    def _watch_send(self, fut, method, params, sent_on=None):
        # entry: [fut, method, params, resend_at, resends_left,
        #         last_raw, unanswered_windows_on_last_raw]
        due = time.monotonic() + self._attempt_timeout
        with self._cv:
            self._watch.append([fut, method, params, due, 3, sent_on, 0])
            if due < self._watch_due:
                self._watch_due = due
            if self._watch_thread is None or not self._watch_thread.is_alive():
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, daemon=True,
                    name=f"rpc-ack-watch-{self.peer}",
                )
                self._watch_thread.start()

    def _watch_loop(self):
        while not self._closed:
            time.sleep(min(self._attempt_timeout / 4.0, 1.0))
            now = time.monotonic()
            resend = []
            expired = []
            suspect = set()
            with self._cv:
                if now < self._watch_due:
                    # nothing can be due yet: keep the healthy-path tick
                    # O(1) — entries are only scanned near their window
                    continue
                keep = []
                next_due = float("inf")
                for ent in self._watch:
                    fut, method, params, resend_at, left, last_raw, misses = ent
                    if fut.done():
                        continue
                    if now >= resend_at:
                        if left <= 0:
                            # out of resends: FAIL the future — a caller
                            # (e.g. _submit_async's error drain) must hear
                            # about the loss, not wait forever
                            expired.append((fut, method))
                            continue
                        raw = self._raw
                        ent[3] = now + self._attempt_timeout
                        if raw is None:
                            # mid-outage: the reconnect queue will replay;
                            # just push the next check out
                            pass
                        elif raw is last_raw:
                            ent[6] = misses + 1
                            if ent[6] >= 2:
                                # two unanswered windows on one conn: treat
                                # it as a blackhole (half-open socket, peer
                                # wedged) and reset it — the reconnect path
                                # takes over (reference: grpc keepalive ->
                                # channel reset in retryable_grpc_client)
                                suspect.add(raw)
                                ent[6] = 0
                            else:
                                ent[4] = left - 1
                                resend.append((raw, fut, method, params))
                        else:
                            ent[4] = left - 1
                            ent[5] = raw
                            ent[6] = 0
                            resend.append((raw, fut, method, params))
                    next_due = min(next_due, ent[3])
                    keep.append(ent)
                self._watch = keep
                self._watch_due = next_due
                if not keep:
                    self._watch_thread = None
                    return
            for fut, method in expired:
                if not fut.done():
                    fut.set_exception(RpcTimeout(
                        f"rpc {method} unacknowledged after resends"
                    ))
            if _metrics.ENABLED and resend:
                _M_RESENDS.inc(len(resend), tags={"peer": self.peer})
            for raw, fut, method, params in resend:
                try:
                    self._chain(raw.call_async(method, params), fut)
                except Exception:  # noqa: BLE001 - raced an outage
                    pass
            if _metrics.ENABLED and suspect:
                _M_BLACKHOLES.inc(len(suspect), tags={"peer": self.peer})
            for raw in suspect:
                raw._teardown()

    def notify(self, method: str, params: Any = None):
        with self._cv:
            if self._closed:
                raise ConnectionLost("client closed")
            raw = self._raw
            if raw is None:
                if method not in self.RETRYABLE:
                    raise ConnectionLost(f"{self.peer} disconnected")
                self._queued.append((method, params, None))
                return
        try:
            raw.notify(method, params)
        except ConnectionLost:
            if method not in self.RETRYABLE or self._closed:
                raise
            with self._cv:
                self._queued.append((method, params, None))

    # -------------------------------------------------- subs & lifecycle

    def subscribe(self, channel: str, callback: Callable):
        """Register a push callback; replayed onto every reconnection."""
        self._subs[channel] = callback
        with self._cv:
            raw = self._raw
        if raw is not None:
            raw.subscribe(channel, callback)

    @property
    def connected(self) -> bool:
        with self._cv:
            return self._raw is not None and not self._raw._closed

    def close(self):
        with self._cv:
            self._closed = True
            raw, self._raw = self._raw, None
            self._cv.notify_all()
        self._fail_queued(ConnectionLost("client closed"))
        if raw is not None:
            raw.close()


# Env-driven activation: workers and daemons spawned as subprocesses
# inherit RAY_TPU_CHAOS_SPEC and join the same fault plane (one-time at
# import; steady-state cost stays the single CHAOS check).
if os.environ.get("RAY_TPU_CHAOS_SPEC"):  # pragma: no cover - env-driven
    def _install_chaos_from_env():
        from ray_tpu_torch import chaos as _chaos

        _chaos.install_from_env()

    _install_chaos_from_env()

# Same one-time activation for the protocol tracer: subprocesses started
# with RAY_TPU_TRACE_FILE append to the shared JSONL trace.
if os.environ.get("RAY_TPU_TRACE_FILE"):  # pragma: no cover - env-driven
    def _install_trace_from_env():
        from ray_tpu_torch.analysis import invariants as _inv

        _inv.install_from_env()

    _install_trace_from_env()

# Always-on flight recorder (ray_tpu.obs): when no file tracer claimed the
# hook, install the bounded in-memory ring as the default TRACE so every
# process keeps a dumpable black box of its recent protocol events. A
# later invariants.install() displaces it for the session and
# invariants.uninstall() restores it.
if TRACE is None and _config.GLOBAL_CONFIG.flight_recorder_enabled:
    def _install_flight_recorder():
        from ray_tpu_torch.obs.flightrec import install_default

        install_default()

    _install_flight_recorder()
