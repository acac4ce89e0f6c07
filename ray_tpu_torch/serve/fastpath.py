"""Serve fast path: a zero-RPC request plane on compiled-graph channels.

The task-layer serve path dispatches every request through the
driver -> GCS -> daemon -> worker RPC chain (~tens of ms of control plane
per call on this class of box); the compiled-graph channel path moves the
same handoff in ~a millisecond with zero GCS RPCs (BENCH_dag_r01). This
module rebuilds the replica hot path on that machinery: a deployment
marked ``fast_path=True`` gets, per (client handle/proxy, replica) pair,
one REQUEST channel and one RESPONSE channel out of
:mod:`ray_tpu_torch.dag.channel` — registered through the control plane ONCE
(GCS ``serve_register`` resolves the replica's node and records the pair
for sweep-on-disconnect; the replica daemon's ``serve_attach`` creates the
channel files, registers them for its death sweep, and defers its reply
until the replica worker attached) — after which steady-state
request -> response involves ZERO GCS RPCs. Cross-node pairs ride the
existing daemon relay fallback (``dag_push``/``dag_pull``).

Topology per pair (every channel is strictly SPSC; the "MPSC" request
plane is the *set* of pairs a replica drains with
:meth:`Channel.try_read`):

    client writer --req channel--> replica loop (drain -> batcher)
    client reader <--resp channel-- replica loop (responses, rid-tagged)

Frames are COALESCED: one channel frame carries a LIST of requests (or
responses). Submitting threads enqueue and return immediately; one
flusher per pair packs everything queued into the next frame as soon as
the channel's ack word frees it (the seqlock alternation stays 1-deep —
pipelining comes from frame width, not depth, so the checked SPSC
protocol is untouched). Under closed-loop load this turns N blocked
writers into one in-flight frame of N requests; at light load a frame is
a single request and the path is pure latency.

The replica side (:class:`ReplicaFastPath`, one per hosted replica actor,
running inside the worker process) drains its request channels into a
CONTINUOUS batcher: :class:`~ray_tpu_torch.serve.batching.AdaptiveBatchSizer`
sizes dispatch groups from the live request stream (target-latency /
EMA(service time)); ``@serve.batch``-decorated handlers are called
VECTORIZED with the whole group (the rendezvous wrapper is bypassed —
the group *is* the batch), other handlers execute concurrently on the
replica's pool. Backpressure is the channel ack word: a client can have
exactly one unconsumed frame per pair, so an overloaded replica pushes
queueing back into the callers instead of accumulating unbounded state.

Failure contract: a replica worker (or node) dying flips the pair's
channels CLOSED|ERROR via the daemon's existing death sweep; the client
router reroutes that pair's in-flight requests to surviving replicas and
delivers each response exactly once (responses are request-id tagged and
de-duplicated; execution is at-least-once across a mid-request death,
delivery is exactly-once). Routing is power-of-two-choices on locally
observed in-flight counts; membership refresh runs on a BACKGROUND thread
(``serve_fastpath_refresh_s``) so the request path never blocks on the
controller. Teardown is idempotent; a vanished client's pairs are swept
by the GCS on driver disconnect.

Observability (ray_tpu_torch.obs): per-deployment end-to-end latency histogram
``ray_tpu_serve_request_seconds`` (client side), batch-size histogram and
queue-depth gauge (replica side) — all accumulated in plain attributes
and flushed on a 64-observation cadence like the dag channel
accumulators, never on the handoff window itself.
"""

from __future__ import annotations

import inspect
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.core.task_spec import new_id
from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

_M_REQ_SECONDS = _metrics.Histogram(
    "ray_tpu_serve_request_seconds",
    "serve fast-path end-to-end request latency (client side)",
    boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 10.0),
    tag_keys=("deployment",),
)
_M_BATCH_SIZE = _metrics.Histogram(
    "ray_tpu_serve_batch_size",
    "serve fast-path continuous-batcher dispatch group size (replica side)",
    boundaries=(1, 2, 4, 8, 16, 32, 64, 128),
    tag_keys=("deployment",),
)
_M_QUEUE_DEPTH = _metrics.Gauge(
    "ray_tpu_serve_queue_depth",
    "serve fast-path pending+executing requests on one replica loop",
    tag_keys=("deployment",),
)
_M_SHED = _metrics.Counter(
    "ray_tpu_serve_shed_total",
    "requests shed by the replica drain loop because their deadline "
    "expired before a handler ran (each resolves the submitter with "
    "DeadlineExceededError exactly once)",
    tag_keys=("deployment",),
)
_M_REJECTED = _metrics.Counter(
    "ray_tpu_serve_rejected_total",
    "requests failed fast by the router because every replica pair was "
    "saturated (serve_fastpath_max_inflight)",
    tag_keys=("deployment",),
)
_FLUSH_EVERY = 64

#: Test-only regression switch (mirror of ``gcs.SEEDED_BUGS`` /
#: ``node_daemon.SEEDED_BUGS``): known concurrency-bug shapes the race
#: sanitizer (analysis/racer.py) re-introduces to prove it still catches
#: them. Production code never populates this. Names:
#:
#: - ``"stats-lock-alias"``: ``_bump`` remakes ``_stats_lock`` per call
#:   (the alias/``__reduce__``-reconstruction laundering shape that bit
#:   the reference once) — every caller then holds a DIFFERENT lock object while the
#:   ``self._stats_lock`` attribute text the static lock-propagation
#:   rule credits is unchanged. Provably invisible to the static pass;
#:   the dynamic vector-clock stage must catch it.
SEEDED_BUGS: set = set()

#: live routers, for serve.shutdown() to sweep (weak: a dropped handle's
#: router must not be kept alive by this registry)
_ROUTERS: "weakref.WeakSet" = weakref.WeakSet()


def shutdown_all() -> None:
    """Tear down every live router's pairs (serve.shutdown hook)."""
    for r in list(_ROUTERS):
        try:
            r.shutdown()
        except Exception:  # noqa: BLE001 - best-effort sweep
            pass


def _keys_for(pair_id: str) -> Tuple[str, str]:
    return f"{pair_id}-rq", f"{pair_id}-rs"


# ============================================================ client side


class _Waiter:
    __slots__ = ("rid", "req", "ev", "value", "is_err", "done",
                 "pair", "retries", "t0")

    def __init__(self, rid: str, req: tuple):
        self.rid = rid
        # (rid, method, args, kwargs, deadline) — repacked per frame;
        # deadline is absolute wall-clock (time.time()) or None, carried
        # IN the coalesced frame so the replica drain loop can shed
        # expired requests before a handler ever runs
        self.req = req
        self.ev = threading.Event()
        self.value: Any = None
        self.is_err = False
        self.done = False
        self.pair: Optional["_Pair"] = None
        self.retries = 0
        self.t0 = time.monotonic()

    def finish(self, value: Any, is_err: bool) -> None:
        # first completion wins: a duplicate/late response must never
        # overwrite a delivered result (exactly-once delivery)
        if self.done:
            return
        self.value = value
        self.is_err = is_err
        self.done = True
        self.ev.set()


class FastPathResponse:
    """Future-like response (the fast-path analog of DeploymentResponse).
    Reroute-on-replica-death happens inside the router; callers just wait."""

    def __init__(self, waiter: _Waiter):
        self._w = waiter

    def result(self, timeout: Optional[float] = None):
        if not self._w.ev.wait(timeout):
            raise GetTimeoutError(
                f"serve fast-path request {self._w.rid[:12]} timed out"
            )
        if self._w.is_err:
            v = self._w.value
            raise v if isinstance(v, BaseException) else RuntimeError(str(v))
        return self._w.value


class _Pair:
    """Client end of one (handle, replica) request plane."""

    __slots__ = ("pair_id", "actor_id", "node_id", "req", "resp", "qlock",
                 "outbox", "flushing", "dead", "inflight", "reader",
                 "reader_done")

    def __init__(self, pair_id: str, actor_id: str, node_id: str, req, resp):
        self.pair_id = pair_id
        self.actor_id = actor_id
        self.node_id = node_id
        self.req = req    # writer end
        self.resp = resp  # reader end
        # frame coalescing: submitters enqueue waiters here and return;
        # exactly one thread at a time is the flusher (SPSC writer)
        self.qlock = threading.Lock()
        self.outbox: List["_Waiter"] = []
        self.flushing = False
        self.dead = False
        self.inflight = 0
        self.reader: Optional[threading.Thread] = None
        # set by the reader under the router's lock as it exits: from then
        # on the pair's stranded requests are swept by whoever fails it
        self.reader_done = False


class FastPathRouter:
    """Client-side router: pairs per replica, pow-2 routing, reroute on
    death, exactly-once response delivery. One per (app, deployment) per
    handle tree (method handles share their parent's router)."""

    MAX_REROUTES = 5

    def __init__(self, deployment_name: str, app_name: str,
                 fetch_membership: Callable[[], Tuple[List[str], int]],
                 force_remote: bool = False):
        from ray_tpu_torch.core import api as _api

        self._rt = _api._get_runtime()
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._fetch = fetch_membership
        self._force_remote = force_remote
        self._cap = int(self._rt.config.serve_fastpath_channel_bytes)
        self._refresh_s = float(self._rt.config.serve_fastpath_refresh_s)
        # saturation bound (overload control): with every live pair at
        # >= this many in-flight requests, submit fails FAST with a
        # typed ClusterOverloadedError instead of queueing behind the
        # backlog; 0 = unbounded
        self._max_inflight = int(
            getattr(self._rt.config, "serve_fastpath_max_inflight", 0)
        )
        self._lock = threading.Lock()
        # per-replica pair-build locks: one replica still STARTING must
        # not head-of-line block pair builds to healthy replicas (the
        # build path can wait up to ~30s on retry hints)
        self._reg_locks: Dict[str, threading.Lock] = {}
        self._pairs: Dict[str, _Pair] = {}   # actor_id -> pair
        self._waiters: Dict[str, _Waiter] = {}
        self._actor_ids: List[str] = []
        self._dead: Set[str] = set()
        self._rng = random.Random()
        self._closed = False
        self._refresher: Optional[threading.Thread] = None
        # counters are GATES (chaos soaks exit 1 on duplicates>0): plain
        # dict += from N reader/submitter threads loses updates, so every
        # bump goes through _bump's lock
        self._stats_lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0, "rerouted": 0,
                      "duplicates": 0, "failed": 0, "rejected": 0,
                      "shed": 0}
        self._m_key = _M_REQ_SECONDS.series_key(
            {"deployment": deployment_name})
        self._m_rej_key = _M_REJECTED.series_key(
            {"deployment": deployment_name})
        self._m_lat: List[float] = []
        _ROUTERS.add(self)

    # ------------------------------------------------------------ metrics

    def _bump(self, key: str, n: int = 1) -> None:
        if "stats-lock-alias" in SEEDED_BUGS:
            # SEEDED BUG (test-only; see SEEDED_BUGS above): the lock is
            # remade per call, so each caller serializes on its OWN
            # object — the `self._stats_lock` the static pass credits
            # no longer names one identity. Dynamically a race; the
            # pragma keeps the (correct) static claim on file.
            self._stats_lock = lk = threading.Lock()
            with lk:
                self.stats[key] = self.stats.get(key, 0) + n  # ray-lint: disable=cross-thread-field-write
            return
        with self._stats_lock:
            self.stats[key] += n

    def _observe_latency(self, seconds: float) -> None:
        # accumulate then flush in blocks (dag-channel accumulator shape,
        # but MULTIPLE reader threads feed this list, so the swap happens
        # under the stats lock); the registry work stays off the window
        # between a response read and its waiter wake
        if not _metrics.ENABLED:
            return
        block = None
        with self._stats_lock:
            self._m_lat.append(seconds)
            if len(self._m_lat) >= _FLUSH_EVERY:
                block, self._m_lat = self._m_lat, []
        if block:
            for v in block:
                _M_REQ_SECONDS.observe_k(self._m_key, v)

    # --------------------------------------------------------- membership

    def refresh_now(self) -> None:
        try:
            ids, _version = self._fetch()
        except Exception:  # noqa: BLE001 - controller mid-restart
            return
        with self._lock:
            self._actor_ids = [a for a in ids if a not in self._dead]
            # a replaced replica never reuses its actor id: once membership
            # stops reporting a dead id, forget it (bounds the set); prune
            # its pair-build lock with it
            self._dead &= set(ids)
            for aid in list(self._reg_locks):
                if aid not in ids and aid not in self._pairs:
                    del self._reg_locks[aid]

    def _refresh_loop(self) -> None:
        while not self._closed:
            time.sleep(self._refresh_s)
            if self._closed:
                return
            self.refresh_now()

    def _ensure_refresher(self) -> None:
        if self._refresher is None or not self._refresher.is_alive():
            self._refresher = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name=f"serve-fp-refresh-{self.deployment_name}",
            )
            self._refresher.start()

    # ------------------------------------------------------------ routing

    def _pick(self, exclude: Set[str]) -> Tuple[Optional[str], Optional[str]]:
        """Power-of-two-choices on locally observed per-pair in-flight
        counts (reference: pow_2_scheduler.py), over live membership.
        Returns (actor_id, reason): reason is None on a pick, "empty"
        when membership is empty/excluded, "saturated" when every live
        pair is at the serve_fastpath_max_inflight bound (the caller
        fails FAST with a typed error instead of queueing)."""
        with self._lock:
            ids = [a for a in self._actor_ids
                   if a not in exclude and a not in self._dead]
            if not ids:
                return None, "empty"
            if self._max_inflight > 0:
                open_ids = [
                    a for a in ids
                    if (self._pairs.get(a) is None
                        or self._pairs[a].inflight < self._max_inflight)
                ]
                if not open_ids:
                    return None, "saturated"
                ids = open_ids
            if len(ids) == 1:
                return ids[0], None
            a, b = self._rng.sample(ids, 2)
            pa, pb = self._pairs.get(a), self._pairs.get(b)
            la = pa.inflight if pa is not None else 0
            lb = pb.inflight if pb is not None else 0
        # health-weighted pow-2 (gray-failure defense): scale each
        # candidate's observed load by its node's suspicion from the
        # pushed node snapshot (a local dict read — the request path
        # stays RPC-free). A replica on an ALIVE-but-DEGRADED node loses
        # ties immediately and loses outright as suspicion grows, so its
        # request share decays long before the GCS quarantines it.
        sa = self._node_suspicion(pa.node_id) if pa is not None else 0.0
        sb = self._node_suspicion(pb.node_id) if pb is not None else 0.0
        wa = (la + 1.0) * (1.0 + 4.0 * sa)
        wb = (lb + 1.0) * (1.0 + 4.0 * sb)
        return (a if wa <= wb else b), None

    def _ensure_pair(self, actor_id: str) -> _Pair:
        """Get or build the channel pair for one replica. The build is the
        ONLY control-plane traffic on this plane: one GCS serve_register
        (placement + sweep registration) + one daemon serve_attach
        (channels created, replica attached, deferred until ready)."""
        with self._lock:
            p = self._pairs.get(actor_id)
            reg_lock = self._reg_locks.setdefault(actor_id,
                                                  threading.Lock())
        if p is not None and not p.dead:
            return p
        with reg_lock:
            with self._lock:
                p = self._pairs.get(actor_id)
            if p is not None and not p.dead:
                return p
            pair_id = new_id("svp")
            # creation may still be in flight (actor STARTING, or it just
            # relocated): honor the retry hint briefly, like dag_register
            deadline = time.monotonic() + 30.0
            while True:
                info = self._rt.serve_register({
                    "pair_id": pair_id,
                    "actor_id": actor_id,
                    "owner": self._rt.worker_id,
                })
                if (info or {}).get("ok"):
                    break
                if not (info or {}).get("retry") or \
                        time.monotonic() > deadline:
                    raise ChannelClosedError(
                        f"serve pair register refused for replica "
                        f"{actor_id[:12]}: {(info or {}).get('error')}"
                    )
                time.sleep(0.1)
            daemon = self._rt._daemon(
                info["node_id"], info["addr"], info["port"]
            )
            r = daemon.call("serve_attach", {
                "pair_id": pair_id,
                "actor_id": actor_id,
                "capacity": self._cap,
            }, timeout=30.0)
            if not (r or {}).get("ok"):
                try:
                    self._rt.serve_teardown(pair_id)
                except Exception:  # noqa: BLE001 - GCS sweeps it later
                    pass
                raise ChannelClosedError(
                    f"serve pair attach refused on {info['node_id']}: "
                    f"{(r or {}).get('error')}"
                )
            rq_key, rs_key = _keys_for(pair_id)
            from ray_tpu_torch.dag.compiled import (
                _RemoteEdgeReader,
                _RemoteEdgeWriter,
                _addr_is_local,
            )

            local = (not self._force_remote and info.get("chan_dir")
                     and _addr_is_local(info["addr"]))
            if local:
                req = Channel.open_wait(r["req_path"], rq_key, timeout=10.0)
                resp = Channel.open_wait(r["resp_path"], rs_key, timeout=10.0)
                # polite waits: a parked serve end shares its host with
                # the whole request plane — yield the core early instead
                # of hot-spinning through the peer's compute time
                req.spin_hot = 50
                resp.spin_hot = 50
            else:
                req = _RemoteEdgeWriter(daemon, rq_key)
                resp = _RemoteEdgeReader(daemon, rs_key)
            pair = _Pair(pair_id, actor_id, info["node_id"], req, resp)
            pair.reader = threading.Thread(
                target=self._read_loop, args=(pair,), daemon=True,
                name=f"serve-fp-read-{pair_id[-8:]}",
            )
            with self._lock:
                self._pairs[actor_id] = pair
            pair.reader.start()
            return pair

    # ------------------------------------------------------------- submit

    def submit(self, method: Optional[str], args, kwargs,
               deadline_s: Optional[float] = None) -> FastPathResponse:
        # hot path: explicit guard, not op_span() (see dag execute)
        p = _tracing.PROFILE
        if p is None:
            return self._submit_inner(method, args, kwargs, deadline_s)
        frame = p.op_begin("serve_request")
        try:
            return self._submit_inner(method, args, kwargs, deadline_s)
        finally:
            p.op_end(frame)

    def _submit_inner(self, method: Optional[str], args, kwargs,
                      deadline_s: Optional[float] = None) -> FastPathResponse:
        if self._closed:
            raise RuntimeError("serve fast-path router is shut down")
        self._ensure_refresher()
        rid = new_id("req")
        # absolute wall-clock deadline rides the coalesced frame: the
        # replica drain loop sheds requests already past it before a
        # handler runs (same-host clocks; the relay fallback assumes
        # synced clocks, like any cross-node deadline). `is not None`:
        # a caller-computed remaining budget of 0.0 means ALREADY
        # expired (shed on arrival), not "no deadline"
        deadline = (
            time.time() + deadline_s if deadline_s is not None else None
        )
        w = _Waiter(rid, (rid, method, args, kwargs, deadline))
        self._bump("submitted")
        self._submit_waiter(w, set())
        return FastPathResponse(w)

    def _reject_saturated(self, w: _Waiter) -> None:
        """Every live pair is at its in-flight bound: fail FAST with a
        typed retryable error — queueing behind the backlog would just
        convert overload into timeouts."""
        from ray_tpu_torch.core.exceptions import ClusterOverloadedError

        self._bump("rejected")
        if _metrics.ENABLED:
            _M_REJECTED.inc_k(self._m_rej_key)
        w.finish(ClusterOverloadedError(
            f"every replica of {self.deployment_name} is saturated "
            f"(>= {self._max_inflight} in flight per pair)"
        ), is_err=True)

    def _submit_waiter(self, w: _Waiter, exclude: Set[str]) -> None:
        last_err: Optional[BaseException] = None
        for attempt in range(self.MAX_REROUTES + 3):
            if self._closed:
                break
            actor_id, why = self._pick(exclude)
            if actor_id is None and why != "saturated":
                # stale/empty membership (all replicas excluded or a
                # rescale in flight): forced refresh is the failure-path
                # RPC, never the steady-state one
                self.refresh_now()
                actor_id, why = self._pick(exclude)
            if why == "saturated":
                self._reject_saturated(w)
                return
            if actor_id is None:
                time.sleep(min(0.1 * (attempt + 1), 0.5))
                exclude = set()
                continue
            try:
                pair = self._ensure_pair(actor_id)
            except Exception as e:  # noqa: BLE001 - replica came down
                last_err = e
                exclude = exclude | {actor_id}
                with self._lock:
                    self._dead.add(actor_id)
                continue
            with self._lock:
                self._waiters[w.rid] = w
                w.pair = pair
                pair.inflight += 1
            # frame coalescing: enqueue and (maybe) become the pair's
            # flusher. A submitter whose pair already has a flusher
            # returns IMMEDIATELY — its request rides the next frame.
            self._enqueue(pair, w)
            return
        self._bump("failed")
        from ray_tpu_torch.core.exceptions import ActorDiedError

        w.finish(ActorDiedError(
            f"serve fast-path request could not reach any replica of "
            f"{self.deployment_name}: {last_err!r}"
        ), is_err=True)

    def _enqueue(self, pair: _Pair, w: _Waiter) -> None:
        with pair.qlock:
            if not pair.dead:
                pair.outbox.append(w)
                if pair.flushing:
                    return
                pair.flushing = True
                run_flush = True
            else:
                run_flush = False
        if not run_flush:
            # the pair died between pick and enqueue: if _fail_pair's
            # sweep missed this waiter (registered after the sweep ran),
            # reroute it ourselves — exactly one of the two paths wins
            self._reroute_if_mine(w, pair, "pair died before enqueue")
            return
        self._flush_pair(pair)

    def _flush_pair(self, pair: _Pair) -> None:
        """THE writer of this pair's request channel (one thread at a
        time): packs everything queued into one list-frame per channel
        slot. Exits only when the outbox is drained (checked under qlock,
        so a racing enqueue either lands in this frame or re-arms a new
        flusher)."""
        while True:
            with pair.qlock:
                batch, pair.outbox = pair.outbox, []
                if not batch or pair.dead:
                    pair.flushing = False
                    if not batch:
                        return
            if pair.dead:
                # the death sweep may have run before these were queued:
                # claim-and-reroute each one that is still ours
                for w in batch:
                    self._reroute_if_mine(w, pair, "pair died while queued")
                self._detach_req(pair)
                return
            payload = serialization.dumps([w.req for w in batch])
            try:
                pair.req.write(
                    payload, timeout=30.0,
                    should_stop=lambda: pair.dead or self._closed,
                )
            except (ChannelClosedError, ChannelTimeoutError,
                    TypeError, ValueError, OSError) as e:
                # TypeError/ValueError/OSError: the mapping was torn (a
                # racing teardown detached an end mid-wait) — same
                # meaning as a closed channel, and it must not escape
                # into an unrelated handle.remote() caller
                with pair.qlock:
                    pair.flushing = False
                self._fail_pair(pair, repr(e))
                self._detach_req(pair)
                return

    @staticmethod
    def _detach_req(pair: _Pair) -> None:
        """Detach the request end once no flusher can be inside write():
        called by the exiting flusher itself, or by the reader when the
        pair is dead and no flusher is active (pair.dead blocks new
        flushers from arming, so the not-flushing state is final)."""
        with pair.qlock:
            if pair.flushing:
                return  # the active flusher owns the detach on its way out
        try:
            pair.req.detach()
        except Exception:  # noqa: BLE001 - already detached
            pass

    # ----------------------------------------------------------- responses

    def _complete(self, rid: str, value: Any, is_err: bool) -> None:
        with self._lock:
            w = self._waiters.pop(rid, None)
            if w is not None and w.pair is not None:
                w.pair.inflight -= 1
        if w is None:
            # response for an unknown/already-delivered request id: count
            # it (chaos gates assert this stays 0) and drop it
            self._bump("duplicates")
            return
        w.finish(value, is_err)
        if is_err:
            from ray_tpu_torch.core.exceptions import DeadlineExceededError

            if isinstance(value, DeadlineExceededError):
                # replica-side deadline shed, delivered as a typed
                # outcome — tracked so exactly-once accounting over
                # ok+shed+failed is assertable from the router alone
                self._bump("shed")
        self._bump("completed")
        self._observe_latency(time.monotonic() - w.t0)

    def _read_loop(self, pair: _Pair) -> None:
        last_probe = [0.0]

        def probe() -> bool:
            if pair.dead or self._closed:
                return True
            now = time.monotonic()
            if now - last_probe[0] < 0.2:
                return False
            last_probe[0] = now
            # node-death wake: a killed NODE can't poke its channels, but
            # the GCS "nodes" push already reached this client — a local
            # dict read, zero RPCs
            alive = self._node_alive(pair.node_id)
            return alive is False

        try:
            while not pair.dead and not self._closed:
                try:
                    _seq, data = pair.resp.read(
                        timeout=10.0, should_stop=probe
                    )
                except ChannelTimeoutError:
                    continue
                except ChannelClosedError as e:
                    self._fail_pair(pair, repr(e))
                    return
                try:
                    responses = serialization.loads(data)
                except Exception:  # noqa: BLE001 - torn/alien frame
                    continue
                for rid, is_err, value in responses:
                    self._complete(rid, value, is_err)
        finally:
            # this thread owns the RESPONSE end (detaching it anywhere
            # else would tear it out from under this parked read); the
            # REQUEST end belongs to whichever flusher may still be
            # inside write() — _detach_req hands it over safely
            try:
                pair.resp.detach()
            except Exception:  # noqa: BLE001
                pass
            self._detach_req(pair)
            # a pair another thread failed while this one was reading:
            # every response the replica wrote has been read above, so
            # what is still registered here is rerouted now
            with self._lock:
                pair.reader_done = True
                dead = pair.dead
            if dead and not self._closed:
                self._fail_pair(pair, "pair failed while its reader read")

    def _node_alive(self, node_id: str) -> Optional[bool]:
        alive = getattr(self._rt, "node_alive", None)
        if alive is None:
            return None
        return alive(node_id)

    def _node_suspicion(self, node_id: str) -> float:
        susp = getattr(self._rt, "node_suspicion", None)
        if susp is None or node_id is None:
            return 0.0
        try:
            return float(susp(node_id) or 0.0)
        except Exception:  # noqa: BLE001 - routing must never raise here
            return 0.0

    # ------------------------------------------------------------- failure

    def _fail_pair(self, pair: _Pair, reason: str) -> None:
        """A pair's replica/channel died: retire the pair, then reroute its
        in-flight requests to surviving replicas. Each rerouted request is
        re-registered under its SAME request id, so its response — wherever
        it comes from — still delivers exactly once."""
        with self._lock:
            first = not pair.dead
            pair.dead = True
            if first:
                self._dead.add(pair.actor_id)
                if self._pairs.get(pair.actor_id) is pair:
                    del self._pairs[pair.actor_id]
            # A replica's responses may still sit in the response channel
            # (a killed replica's last frame, committed before it died):
            # while the pair's reader runs, it reads them first and fails
            # the pair again on its way out, which reroutes what is left.
            # Rerouting them here, ahead of that read, ran each such
            # request twice and delivered it twice.
            stranded = []
            if (pair.reader is None or pair.reader_done
                    or pair.reader is threading.current_thread()):
                stranded = [w for w in self._waiters.values()
                            if w.pair is pair and not w.done]
            for w in stranded:
                self._waiters.pop(w.rid, None)
                w.pair = None
        if first:
            try:
                self._rt.serve_teardown(pair.pair_id)
            except Exception:  # noqa: BLE001 - GCS sweeps on disconnect
                pass
        # channel ends are NOT detached here: the pair's reader thread is
        # (or may be) parked inside resp.read, and detaching under it
        # tears the mapping out of a live poll — the reader notices
        # pair.dead via its should_stop probe and detaches both ends on
        # its own way out
        from ray_tpu_torch.core.exceptions import ActorDiedError

        for w in stranded:
            self._reroute(w, pair.actor_id, reason)

    def _reroute(self, w: _Waiter, dead_actor: str, reason: str) -> None:
        """Resubmit a de-registered waiter (bounded), keeping its request
        id so its eventual response still delivers exactly once."""
        from ray_tpu_torch.core.exceptions import ActorDiedError

        w.retries += 1
        if w.retries > self.MAX_REROUTES:
            self._bump("failed")
            w.finish(ActorDiedError(
                f"serve request {w.rid[:12]} exhausted reroutes "
                f"({reason})"
            ), is_err=True)
            return
        self._bump("rerouted")
        self._submit_waiter(w, {dead_actor})

    def _reroute_if_mine(self, w: _Waiter, pair: _Pair,
                         reason: str) -> None:
        """Reroute w ONLY if it is still registered against this pair —
        the atomic claim that keeps an enqueue racing _fail_pair's sweep
        from resubmitting one request twice (a duplicate execution AND a
        duplicate delivery candidate)."""
        with self._lock:
            cur = self._waiters.get(w.rid)
            if cur is not w or w.pair is not pair:
                return  # the sweep (or a racing path) already owns it
            del self._waiters[w.rid]
            pair.inflight -= 1
            w.pair = None
        self._reroute(w, pair.actor_id, reason)

    # ------------------------------------------------------------ teardown

    def shutdown(self) -> None:
        """Idempotent: retire every pair (GCS teardown + local detach) and
        fail any still-waiting requests."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            pairs = list(self._pairs.values())
            self._pairs.clear()
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for pair in pairs:
            pair.dead = True  # readers wake via their probe and detach
            try:
                self._rt.serve_teardown(pair.pair_id)
            except Exception:  # noqa: BLE001
                pass
        from ray_tpu_torch.core.exceptions import ActorDiedError

        for w in waiters:
            w.finish(ActorDiedError("serve fast path shut down"),
                     is_err=True)
        with self._stats_lock:
            block, self._m_lat = self._m_lat, []
        if block and _metrics.ENABLED:
            for v in block:
                _M_REQ_SECONDS.observe_k(self._m_key, v)


# =========================================================== replica side


class _Req:
    __slots__ = ("rpair", "rid", "method", "args", "kwargs", "deadline",
                 "t")

    def __init__(self, rpair, rid, method, args, kwargs, deadline=None):
        self.rpair = rpair
        self.rid = rid
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.deadline = deadline  # absolute time.time() or None
        self.t = time.monotonic()


class _RPair:
    """Replica end of one pair: request reader + response writer."""

    __slots__ = ("pair_id", "req", "resp", "qlock", "outbox", "flushing",
                 "dead")

    def __init__(self, pair_id: str, req: Channel, resp: Channel):
        self.pair_id = pair_id
        self.req = req
        self.resp = resp
        # response coalescing (mirror of the client's request outbox):
        # pool threads enqueue finished responses; one flusher at a time
        # packs them into list-frames on the SPSC response channel
        self.qlock = threading.Lock()
        self.outbox: List[tuple] = []
        self.flushing = False
        self.dead = False


class ReplicaFastPath:
    """The replica-side loop: drain request channels -> continuous batcher
    -> execute -> write rid-tagged responses. One instance per hosted
    replica actor, running on a dedicated thread in the worker process.
    New pairs attach dynamically (one client handle/proxy each)."""

    def __init__(self, instance, aio=None, batch_max: int = 64,
                 target_latency_s: float = 0.02):
        from ray_tpu_torch.serve.batching import AdaptiveBatchSizer

        self._inst = instance  # the hosted ServeReplica
        self._aio = aio
        self._sizer = AdaptiveBatchSizer(target_latency_s, batch_max)
        self._max_inflight = max(batch_max * 4, 8)
        # execution-concurrency bound = the deployment's declared
        # max_ongoing_requests (the replica's sync pool is sized by it):
        # while this many items are dispatched-but-unfinished, new
        # groups HOLD in _pending — which is where the deadline check
        # lives, so at overload expired requests shed instead of
        # stacking invisibly inside the executor's queue
        self._max_exec = int(getattr(
            getattr(instance, "_sync_pool", None), "_max_workers", 32
        ) or 32)
        self._pairs: Dict[str, _RPair] = {}
        self._pairs_lock = threading.Lock()
        self._pending: "deque[_Req]" = deque()
        self._exec_lock = threading.Lock()  # _inflight + EMA feedback
        self._inflight = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        ident = getattr(instance, "_identity", None)
        dep = str(ident[1]) if ident else "unknown"
        self._m_batch_key = _M_BATCH_SIZE.series_key({"deployment": dep})
        self._m_depth_key = _M_QUEUE_DEPTH.series_key({"deployment": dep})
        self._m_shed_key = _M_SHED.series_key({"deployment": dep})
        self._m_batches: List[int] = []
        # deadline sheds on this replica (single-writer: the loop thread)
        self._shed = 0

    # ----------------------------------------------------------- lifecycle

    def attach(self, pair_id: str, req_path: str, resp_path: str) -> None:
        """Open this pair's channels (created by the daemon) and join the
        drain loop; idempotent per pair_id."""
        with self._pairs_lock:
            if pair_id in self._pairs:
                return
        rq_key, rs_key = _keys_for(pair_id)
        req = Channel.open_wait(req_path, rq_key, timeout=30.0)
        resp = Channel.open_wait(resp_path, rs_key, timeout=30.0)
        req.spin_hot = 50   # polite waits: see the client-side note
        resp.spin_hot = 50
        with self._pairs_lock:
            self._pairs[pair_id] = _RPair(pair_id, req, resp)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="serve-fp-replica",
                )
                self._thread.start()

    def stop(self) -> None:
        self._stop = True

    def _drop_pair(self, rpair: _RPair) -> None:
        rpair.dead = True
        with self._pairs_lock:
            self._pairs.pop(rpair.pair_id, None)
        for ch in (rpair.req, rpair.resp):
            try:
                ch.detach()
            except Exception:  # noqa: BLE001
                pass

    # ---------------------------------------------------------- drain loop

    def _loop(self) -> None:
        idle = 0
        since_flush = 0
        while not self._stop:
            progressed = self._drain()
            dispatched = self._maybe_dispatch()
            flushed = self._flush_responses()
            if progressed or dispatched or flushed:
                idle = 0
            else:
                idle += 1
                # adaptive park (channel _park shape): stay hot briefly —
                # same-host handoff is microseconds — then yield the core
                if idle < 50:
                    time.sleep(0)
                else:
                    time.sleep(0.0002 if idle < 2000 else 0.002)
            since_flush += 1
            if since_flush >= 512:
                since_flush = 0
                self._flush_metrics()

    def _drain(self) -> bool:
        """One round-robin pass over the request channels; every available
        frame moves into the pending queue (and its ack frees the client's
        next write — backpressure lives in the channel, not here)."""
        with self._pairs_lock:
            rpairs = list(self._pairs.values())
        progressed = False
        for rp in rpairs:
            if self._inflight + len(self._pending) >= self._max_inflight:
                break
            try:
                frame = rp.req.try_read()
            except ChannelClosedError:
                self._drop_pair(rp)  # teardown/client gone: retire quietly
                continue
            if frame is None:
                continue
            _seq, data = frame
            try:
                reqs = serialization.loads(data)
            except Exception:  # noqa: BLE001 - alien frame: nothing to ack
                continue
            for rid, method, args, kwargs, deadline in reqs:
                self._pending.append(
                    _Req(rp, rid, method, args, kwargs, deadline)
                )
            progressed = True
        # exported for the autoscaling stats push (replica.py reads it on
        # its side thread; single-writer plain attribute)
        self._inst._fp_ongoing = self._inflight + len(self._pending)
        return progressed

    def _shed_expired_front(self) -> int:
        """Shed queued requests (FIFO front) whose deadline already
        passed: each gets a typed DeadlineExceededError response instead
        of a handler run. Runs even while the executor is saturated —
        that IS the overload case shedding exists for."""
        now = time.time()
        n = 0
        while self._pending:
            it = self._pending[0]
            if it.deadline is None or now <= it.deadline:
                break
            self._pending.popleft()
            self._shed_one(it, now)
            n += 1
        return n

    def _shed_one(self, it: _Req, now: float) -> None:
        from ray_tpu_torch.core.exceptions import DeadlineExceededError

        self._shed += 1
        if _metrics.ENABLED:
            _M_SHED.inc_k(self._m_shed_key)
        self._respond(it.rpair, it.rid, DeadlineExceededError(
            f"request {it.rid[:12]} shed: deadline expired "
            f"{now - it.deadline:.3f}s before a handler ran"
        ), True)

    def _maybe_dispatch(self) -> bool:
        if not self._pending:
            return False
        shed_front = self._shed_expired_front()
        if not self._pending:
            return bool(shed_front)
        if self._inflight >= self._max_exec:
            # the deployment's declared concurrency bound
            # (max_ongoing_requests) is in use: HOLD new groups here —
            # excess work waits where the deadline check can shed it,
            # and the channel ack word pushes further queueing back
            # into the callers
            return bool(shed_front)
        target = self._sizer.target()
        # vLLM-shaped continuous batching: an IDLE executor dispatches
        # whatever is pending immediately (no artificial window — the
        # batch for the next dispatch accumulates naturally while this
        # one executes); only a BUSY executor holds a partial group, and
        # never past the wait budget
        if self._inflight and len(self._pending) < target:
            oldest_age = time.monotonic() - self._pending[0].t
            if oldest_age < self._sizer.wait_budget():
                return bool(shed_front)
        # deadline check again at pop time (a group assembled from a
        # deep queue can contain newly-expired items past the front)
        want = min(target, len(self._pending))
        now = time.time()
        group: List[_Req] = []
        while self._pending and len(group) < want:
            it = self._pending.popleft()
            if it.deadline is not None and now > it.deadline:
                self._shed_one(it, now)
            else:
                group.append(it)
        if not group:
            return True  # only sheds this pass; retry next iteration
        with self._exec_lock:
            self._inflight += len(group)
        if _metrics.ENABLED:
            self._m_batches.append(len(group))
        # group by target method: a vectorizable (@serve.batch) handler
        # gets ONE call with the whole sub-group — continuous batching —
        # while plain handlers overlap on the replica's pool
        by_method: Dict[Optional[str], List[_Req]] = {}
        for it in group:
            by_method.setdefault(it.method, []).append(it)
        pool = self._inst._sync_pool
        ema = self._sizer._ema_item_s
        for method, items in by_method.items():
            fn = self._resolve(method)
            if getattr(fn, "_rt_is_batched", False):
                # ALWAYS the vectorized path, even for a group of one:
                # routing singles through the wrapper would rendezvous in
                # its thread batcher, and that coalescing window would
                # feed the sizer a service-time EMA inflated by the wait
                # itself — locking the target at 1 forever
                pool.submit(self._run_batched, fn, items)
            elif (ema is not None and ema < 0.0005
                  and not inspect.iscoroutinefunction(fn)):
                # measured-fast sync handler: run the group inline on the
                # loop thread — per-item pool handoff would cost more
                # than the work (a surprise slow call just trains the EMA
                # back onto the pool path)
                for it in items:
                    self._run_one(fn, it)
            else:
                for it in items:
                    pool.submit(self._run_one, fn, it)
        return True

    def _flush_metrics(self) -> None:
        if not _metrics.ENABLED:
            return
        if self._m_batches:
            block, self._m_batches = self._m_batches, []
            for b in block:
                _M_BATCH_SIZE.observe_k(self._m_batch_key, b)
        _M_QUEUE_DEPTH.set_k(
            self._m_depth_key, self._inflight + len(self._pending)
        )

    # ----------------------------------------------------------- execution

    def _resolve(self, method: Optional[str]):
        c = self._inst._callable
        if self._inst._is_function:
            return c
        return getattr(c, method or "__call__")

    def _run_one(self, fn, it: _Req) -> None:
        t0 = time.monotonic()
        try:
            if inspect.iscoroutinefunction(fn) and self._aio is not None:
                value = self._aio.call(fn, it.args, it.kwargs)
            else:
                value = fn(*it.args, **it.kwargs)
            is_err = False
        except BaseException as e:  # noqa: BLE001 - becomes the response
            value, is_err = self._as_error(it, e)
        self._respond(it.rpair, it.rid, value, is_err)
        self._finish_exec(1, time.monotonic() - t0)

    def _run_batched(self, fn, items: List[_Req]) -> None:
        """Vectorized dispatch for @serve.batch handlers: the adaptive
        group IS the batch — the underlying list->list function is called
        directly, bypassing the thread-rendezvous wrapper (whose window
        would add a second coalescing delay on top of the batcher's)."""
        t0 = time.monotonic()
        inner = inspect.unwrap(fn)
        try:
            vals = [it.args[0] if it.args else None for it in items]
            if self._inst._is_function:
                outs = inner(vals)
            else:
                outs = inner(self._inst._callable, vals)
            if not isinstance(outs, (list, tuple)) or \
                    len(outs) != len(items):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(items)} results; got {type(outs)}"
                )
            for it, v in zip(items, outs):
                self._respond(it.rpair, it.rid, v, False)
        except BaseException as e:  # noqa: BLE001 - fan the error out
            for it in items:
                value, is_err = self._as_error(it, e)
                self._respond(it.rpair, it.rid, value, is_err)
        self._finish_exec(len(items), time.monotonic() - t0)

    @staticmethod
    def _as_error(it: _Req, e: BaseException):
        import traceback

        from ray_tpu_torch.core.exceptions import TaskError

        return TaskError(
            f"serve request {it.rid[:12]} failed: {e!r}",
            traceback.format_exc(),
        ), True

    def _finish_exec(self, n: int, elapsed: float) -> None:
        with self._exec_lock:
            self._inflight -= n
            self._sizer.record(n, elapsed)

    def _respond(self, rpair: _RPair, rid: str, value: Any,
                 is_err: bool) -> None:
        """Queue one response. Writing happens in the drain loop's
        NON-BLOCKING flush pass (_flush_responses): a response writer that
        blocked on the client's ack word here would stall whichever
        thread finished the request — including the drain loop itself on
        the inline path, which would stop ALL request intake while one
        client reader slept (measured as a ~4x frame-cycle inflation)."""
        if rpair.dead:
            return
        with rpair.qlock:
            rpair.outbox.append((rid, is_err, value))

    def _flush_responses(self) -> bool:
        """One non-blocking pass: for every pair with queued responses,
        attempt a zero-deadline write of ALL of them as one frame. A
        client that has not consumed the previous frame keeps its batch
        queued (and growing — later flushes ship a wider frame); nothing
        here ever parks the loop."""
        with self._pairs_lock:
            rpairs = list(self._pairs.values())
        progressed = False
        for rp in rpairs:
            if not rp.outbox:
                continue
            with rp.qlock:
                batch, rp.outbox = rp.outbox, []
            if not batch:
                continue
            try:
                payload = serialization.dumps(batch)
            except Exception as e:  # noqa: BLE001 - unpicklable result
                from ray_tpu_torch.core.exceptions import TaskError

                payload = serialization.dumps([
                    (r, True, TaskError(f"unserializable response: {e!r}"))
                    for r, _e, _v in batch
                ])
            try:
                rp.resp.write(payload, timeout=0)
                progressed = True
            except ChannelTimeoutError:
                # client still consuming the previous frame: requeue AT
                # THE FRONT so response order per pair stays stable
                with rp.qlock:
                    rp.outbox = batch + rp.outbox
            except ChannelClosedError:
                # client went away (teardown/driver death): the pair is
                # done — the daemon/GCS sweeps already own cleanup
                self._drop_pair(rp)
        return progressed
