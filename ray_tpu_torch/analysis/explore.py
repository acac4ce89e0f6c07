"""Deterministic control-plane model checker (interleaving exploration).

The invariant tracer verifies the protocol invariants on interleavings
that *happen* to occur in live runs and chaos soaks. This module
*searches* the interleaving space instead, in the style of Loom/Shuttle:
the real :class:`~ray_tpu_torch.cluster.gcs.GcsServer` handler object is
instantiated behind a **virtual runtime** (see ``cluster/runtime.py``) —
no sockets, no threads, a step-counted clock — together with N simulated
daemon/driver peers. Every pending RPC delivery, push delivery, task
execution, scheduler round, connection drop, and 2PC finalizer is a
*step* on a controlled queue; a **schedule** is the sequence of steps
chosen at each decision point. The explorer then:

- enumerates schedules with a bounded-depth DFS, pruned
  persistent-set/sleep-set style: an unchosen alternative is only
  branched on when it *conflicts* (shares an entity footprint — task id,
  node id, pg id, actor id, object id, or the global scheduler) with a
  step that ran before its own turn in the current schedule — adjacent
  independent steps commute, so one of the two orders suffices;
- samples seeded-random schedules beyond the DFS bound (same-seed runs
  are byte-identical);
- pipes every explored schedule through the :class:`ProtocolTracer` +
  ``check_trace`` invariants (exactly-once, capacity conservation, PG
  2PC legality, exec-seq monotonicity, borrow/object lifecycle), plus
  handler crashes and per-scenario postconditions;
- shrinks any violating schedule to a minimal reproducer (greedy
  truncation + delta-debugging over step labels) and writes it to a
  replay file that ``python -m ray_tpu_torch.analysis --replay <file>``
  re-executes deterministically.

The scenario library covers the known-hard corners: node kill +
reconnect with instance stamps, watchdog resend races, PG prepare/commit
vs node death (the 2PC fault hook is an interleave point, so death can
land *between* the phases), dag register vs driver disconnect, and actor
kill/creation/replay races. ``gcs.SEEDED_BUGS`` re-introduces known,
fixed bugs so the harness can prove it still finds and shrinks them.

Honesty notes: the conflict relation is an over-approximation by entity
footprint (scheduler rounds conflict with everything), so pruning is
sound with respect to it but the footprint annotations themselves are
hand-written per step kind; the simulated peers implement the *fixed*
daemon/driver protocol (same trace events as the real ones), so the
object under test is the GCS handler protocol, not daemon internals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time as _time
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis.invariants import (
    InvariantChecker,
    ProtocolTracer,
    Violation,
)

#: schedule entry meaning "resume the step paused at an interleave point"
CONTINUE = "::continue"

#: conflict wildcard: a step with this key conflicts with every step
GLOBAL_KEY = "*"


# ---------------------------------------------------------------- tracing


class BufTracer(ProtocolTracer):
    """In-memory ProtocolTracer: same Lamport clocking and event shapes,
    but records land in a list instead of a JSONL file (10k+ schedules
    per exploration must not pay a file open/flush each)."""

    def __init__(self):  # noqa: D107 - deliberately no super().__init__
        self.path = None
        self._lock = threading.Lock()
        self._clock = 0
        self._pid = os.getpid()
        self.closed = False
        self.records: List[Dict[str, Any]] = []

    def _emit(self, rec: Dict[str, Any]) -> int:
        with self._lock:
            self._clock += 1
            rec["c"] = self._clock
            rec["pid"] = self._pid
            if not self.closed:
                self.records.append(rec)
            return self._clock

    def close(self) -> None:
        with self._lock:
            self.closed = True


def interleaving_coverage(
    events: Sequence[Dict[str, Any]], dst: str = "gcs"
) -> Set[Tuple[str, str]]:
    """Distinct ordered adjacent handler pairs observed at ``dst`` in a
    protocol trace: the coverage language the explorer and
    ``scripts/chaos_soak.py`` share — a soak that never produced the
    ordering (m1, m2) never tested it, regardless of fault count."""
    methods = [
        str(ev.get("m"))
        for ev in events
        if ev.get("t") == "recv" and ev.get("dst") == dst and ev.get("m")
    ]
    return set(zip(methods, methods[1:]))


# ------------------------------------------------------------ world parts


class ScheduleDiverged(Exception):
    """A replayed schedule named a step that is not enabled — the
    schedule does not belong to this scenario/seed (or a shrink candidate
    removed a step its suffix depended on)."""


class VirtualClock:
    def __init__(self, start: float = 1_000_000.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class Step:
    label: str
    fn: Callable[[], None]
    keys: FrozenSet[str]
    #: label that must have executed before this step becomes enabled
    #: (models per-connection FIFO, e.g. actor-call submission order)
    after: Optional[str] = None


class VirtualConn:
    """Stand-in for rpc.ServerConn: identity + handler scratch meta.
    Conn ids are WORLD-local (not process-global like ServerConn's):
    step labels embed them, and labels must be byte-identical across
    re-executions for replay/shrinking to work."""

    def __init__(self, peer: "SimPeer"):
        world = peer.world
        world._next_conn_id += 1
        self.conn_id = world._next_conn_id
        self.meta: Dict[str, Any] = {}
        self.closed = False
        self.peer = peer

    def peer_label(self) -> str:
        return (
            self.meta.get("node_id")
            or self.meta.get("driver_id")
            or f"conn{self.conn_id}"
        )


class _VirtualFuture:
    """Minimal concurrent-future look-alike for the virtual 2PC client
    (resolved synchronously; ``result(timeout)`` never blocks)."""

    def __init__(self, value=None, exc=None):
        self._value = value
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return self._value

    def done(self) -> bool:
        return True


class VirtualLoop:
    """The ``server.loop`` surface the GCS touches:
    ``run_in_executor(None, fn)`` becomes a schedulable step."""

    def __init__(self, world: "World"):
        self.world = world

    def run_in_executor(self, _executor, fn):
        from concurrent.futures import Future

        fut: Future = Future()

        def run():
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 - surfaced as a finding
                fut.set_result(None)
                self.world.crash("gcs-blocking", e)

        self.world.enqueue("gcs:blocking", run, keys={GLOBAL_KEY})
        return fut


class VirtualServer:
    """RpcServer stand-in the GCS drives through the runtime seam: pushes
    and broadcasts become schedulable delivery steps (or synchronous
    record-only deliveries for inert channels)."""

    def __init__(self, world: "World", handler, on_disconnect, name: str):
        self.world = world
        self.handler = handler
        self.on_disconnect = on_disconnect
        self.name = name
        self.conns: Dict[int, VirtualConn] = {}
        self.loop = VirtualLoop(world)

    def start(self) -> int:
        return 0

    def stop(self) -> None:
        pass

    def send_push(self, conn: VirtualConn, channel: str, data: Any) -> None:
        self.world.deliver_push(conn, channel, data)

    def broadcast(self, channel: str, data: Any, filter_fn=None) -> None:
        for conn in list(self.conns.values()):
            if filter_fn is None or filter_fn(conn):
                self.world.deliver_push(conn, channel, data)

    def call_soon(self, fn, *args) -> None:
        fn(*args)


class VirtualRuntime:
    """cluster/runtime.py seam implementation backed by a World."""

    threaded = False

    def __init__(self, world: "World"):
        self.world = world

    def now(self) -> float:
        return self.world.clock.now()

    def make_server(self, handler, host, port, on_disconnect, name):
        server = VirtualServer(self.world, handler, on_disconnect, name)
        self.world.server = server
        return server

    def make_daemon_client(self, addr, port, node_id):
        d = self.world.daemons.get(node_id)
        return None if d is None else d.client

    def spawn(self, name: str, fn) -> None:
        self.world.enqueue(f"gcs:spawn:{name}", fn, keys={GLOBAL_KEY})

    def kick(self, gcs) -> None:
        self.world.kick()


# ---------------------------------------------------------------- chooser


class Chooser:
    """Drives every scheduling decision of one world execution.

    - ``prefix``: labels to follow first (DFS branch / replay / shrink);
    - after the prefix: uniform-random picks under ``rng`` if given, else
      the deterministic default (the oldest enabled step — program
      order);
    - ``stop_after``: end the run when the prefix is exhausted instead of
      running the default tail (shrinking + minimal replays).
    """

    def __init__(self, prefix: Sequence[str] = (), rng=None,
                 stop_after: bool = False):
        self.prefix = list(prefix)
        self.rng = rng
        self.stop_after = stop_after
        self.i = 0

    def choose(self, options: Tuple[str, ...],
               at_interleave: bool) -> Optional[str]:
        if self.i < len(self.prefix):
            c = self.prefix[self.i]
            if c not in options:
                raise ScheduleDiverged(
                    f"schedule step {self.i} wants {c!r}; enabled: "
                    f"{list(options)}"
                )
        else:
            if self.stop_after:
                # truncated run: finish a paused step, stop the loop
                return CONTINUE if at_interleave else None
            if self.rng is not None:
                c = options[self.rng.randrange(len(options))]
            else:
                c = options[0]
        self.i += 1
        return c


# ------------------------------------------------------------------ world


class World:
    """One fresh control-plane universe: the real GcsServer under a
    virtual runtime + simulated peers + the step queue."""

    def __init__(self, chooser: Chooser, tracer: BufTracer,
                 step_limit: int = 600):
        self.chooser = chooser
        self.tracer = tracer
        self.step_limit = step_limit
        self.clock = VirtualClock()
        self.steps: List[Step] = []
        self.executed: Set[str] = set()  # labels, for `after` gating
        self.schedule: List[str] = []  # chosen label at every choice point
        self.options_at: List[Tuple[str, ...]] = []
        self.keys_of: Dict[str, FrozenSet[str]] = {}
        self._label_counts: Dict[str, int] = {}
        self._next_conn_id = 10_000
        self._sched_pending = False
        self.crashes: List[str] = []
        self.server: Optional[VirtualServer] = None
        self.gcs = None
        self.daemons: Dict[str, "SimDaemon"] = {}
        self.drivers: Dict[str, "SimDriver"] = {}
        self.stopped_early = False

    # -------------------------------------------------------- lifecycle

    def build_gcs(self, config_overrides: Optional[dict] = None,
                  device: str = "cuda") -> None:
        """The GCS under test, its rounds on `device`: every ``sched`` step
        is one synchronous K1 round (the plain K1 on "cpu"); "cuda" without
        a card raises, it never falls back to the CPU."""
        from ray_tpu_torch.core.config import Config
        from ray_tpu_torch.cluster.gcs import GcsServer

        overrides = {
            "task_events_spill": False,
            "scheduling_policy": "torch_cuda",
            "scheduler_device": device,
            # even the explorer's tiny rounds go to K1, not the NumPy twin
            "jax_policy_min_cells": 0,
            # synchronous rounds: a round's decision lands in its own step
            "jax_policy_pipeline_depth": 0,
        }
        overrides.update(config_overrides or {})
        self.gcs = GcsServer(
            config=Config(overrides), runtime=VirtualRuntime(self)
        )
        # the 2PC gap between prepare and commit is an interleave point:
        # node deaths and rival handlers can land between the phases
        self.gcs._pg_fault_hook = lambda pg_id: self.interleave()

    def close(self) -> None:
        if self.gcs is not None:
            try:
                self.gcs.shutdown()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
            # the world and its GCS form reference cycles (interleave
            # hooks): free the policy's device view now, not at the next
            # cyclic collection, across hundreds of worlds
            self.gcs.policy.close()
            self.gcs = None

    # ------------------------------------------------------------ queue

    def enqueue(self, base_label: str, fn: Callable[[], None],
                keys: Sequence[str], after: Optional[str] = None) -> str:
        n = self._label_counts.get(base_label, 0)
        self._label_counts[base_label] = n + 1
        label = base_label if n == 0 else f"{base_label}#{n}"
        self.steps.append(Step(label, fn, frozenset(keys), after))
        self.keys_of[label] = frozenset(keys)
        return label

    def kick(self) -> None:
        if not self._sched_pending:
            self._sched_pending = True
            self.enqueue("sched", self._run_sched, keys={GLOBAL_KEY})

    def _run_sched(self) -> None:
        self._sched_pending = False
        self.gcs._schedule_round()

    def crash(self, where: str, exc: Exception) -> None:
        self.crashes.append(f"{where}: {type(exc).__name__}: {exc}")

    def deliver_push(self, conn: VirtualConn, channel: str,
                     data: Any) -> None:
        peer = conn.peer
        if peer is None:
            return
        if channel in peer.sync_channels:
            # record-only reaction: no GCS state effect, so making it a
            # step would only inflate the schedule space
            peer.on_push(channel, data)
            return
        if channel not in peer.reactive_channels:
            return
        def deliver(p=peer, ch=channel, d=data):
            self.tracer.on_push("gcs", p.name, ch)
            p.on_push(ch, d)
        self.enqueue(
            f"push:{channel}->{peer.name}", deliver,
            keys=peer.push_keys(channel, data),
        )

    def rpc(self, peer: "SimPeer", method: str, params: dict,
            keys: Sequence[str], base_label: Optional[str] = None,
            after: Optional[str] = None,
            conn: Optional[VirtualConn] = None) -> str:
        """Enqueue a peer->GCS RPC delivery step (send is traced when the
        frame 'leaves' = step creation; recv + dispatch at execution)."""
        use_conn = conn or peer.conn

        def fire():
            lc = self.tracer.on_send(peer.name, "gcs", method)
            self.tracer.on_recv(peer.name, "gcs", method, lc)
            try:
                res = self.gcs._handle(method, params, use_conn)
            except Exception as e:  # noqa: BLE001 - a crash IS a finding
                self.crash(f"rpc_{method}", e)
                return
            peer.on_response(method, params, res)

        return self.enqueue(
            base_label or f"rpc:{method}:{peer.name}", fire,
            keys=keys, after=after,
        )

    # -------------------------------------------------------- execution

    def _enabled(self) -> List[Step]:
        return [
            s for s in self.steps
            if s.after is None or s.after in self.executed
        ]

    def run(self) -> None:
        while self.steps:
            if len(self.schedule) >= self.step_limit:
                self.crashes.append(
                    f"step budget exceeded ({self.step_limit}): the "
                    "scenario does not quiesce"
                )
                return
            enabled = self._enabled()
            if not enabled:
                self.crashes.append(
                    "deadlock: pending steps exist but none are enabled "
                    f"({[s.label for s in self.steps]})"
                )
                return
            options = tuple(s.label for s in enabled)
            chosen = self.chooser.choose(options, at_interleave=False)
            if chosen is None:
                self.stopped_early = True
                return
            self._fire(chosen, options)

    def interleave(self) -> None:
        """Choice point inside a running step (the PG 2PC phase gap):
        zero or more enabled steps may run before the step resumes."""
        while True:
            enabled = self._enabled()
            options = (CONTINUE,) + tuple(s.label for s in enabled)
            chosen = self.chooser.choose(options, at_interleave=True)
            if chosen is None or chosen == CONTINUE:
                self.schedule.append(CONTINUE)
                self.options_at.append(options)
                return
            self._fire(chosen, options)

    def _fire(self, label: str, options: Tuple[str, ...]) -> None:
        self.schedule.append(label)
        self.options_at.append(options)
        for i, s in enumerate(self.steps):
            if s.label == label:
                step = self.steps.pop(i)
                break
        else:  # pragma: no cover - choose() only offers pending labels
            raise ScheduleDiverged(f"step {label!r} vanished")
        self.executed.add(label)
        self.clock.advance(0.001)
        step.fn()


# ------------------------------------------------------------- sim peers


class SimPeer:
    #: push channels delivered as schedulable steps
    reactive_channels: FrozenSet[str] = frozenset()
    #: push channels recorded synchronously (no GCS state effect)
    sync_channels: FrozenSet[str] = frozenset()

    def __init__(self, world: World, name: str):
        self.world = world
        self.name = name
        self.conn = VirtualConn(self)
        world.server.conns[self.conn.conn_id] = self.conn
        self.pushed: List[Tuple[str, Any]] = []
        self.responses: List[Tuple[str, Any]] = []

    def new_conn(self) -> VirtualConn:
        self.conn = VirtualConn(self)
        self.world.server.conns[self.conn.conn_id] = self.conn
        return self.conn

    def on_push(self, channel: str, data: Any) -> None:
        self.pushed.append((channel, data))

    def on_response(self, method: str, params: dict, res: Any) -> None:
        self.responses.append((method, res))

    def push_keys(self, channel: str, data: Any) -> Set[str]:
        return {GLOBAL_KEY}


class _SimDaemonClient:
    """The GCS's request/response client to a simulated daemon (2PC
    prepare/commit, stream acks): dispatches synchronously — the 2PC
    *phase gap* is the interleave point, not the individual ack."""

    def __init__(self, daemon: "SimDaemon"):
        self.daemon = daemon

    @property
    def _closed(self) -> bool:
        return not self.daemon.alive

    def call_async(self, method: str, params: dict):
        try:
            return _VirtualFuture(self.daemon.handle_rpc(method, params))
        except Exception as e:  # noqa: BLE001 - mirrors a remote error
            return _VirtualFuture(exc=e)

    def notify(self, method: str, params: dict) -> None:
        self.daemon.handle_rpc(method, params)

    def close(self) -> None:
        pass


class SimDaemon(SimPeer):
    """Protocol-faithful daemon peer: registers with an instance stamp,
    executes dispatched tasks (obj_put trace + task_done report), mirrors
    the 2PC bundle table with the same pg_prepare/pg_commit/pg_return
    trace events the real node_daemon emits, and hosts actor execs."""

    reactive_channels = frozenset(
        {"exec_tasks", "return_bundle", "kill_actor", "free_objects",
         "dag_teardown"}
    )
    sync_channels = frozenset({"nodes"})

    def __init__(self, world: World, node_id: str, cpus: float = 2.0,
                 resend_reports: bool = False):
        super().__init__(world, node_id)
        self.node_id = node_id
        self.cpus = cpus
        self.alive = False
        self.instance = 0
        self.resend_reports = resend_reports
        self._bundles: Dict[str, dict] = {}
        self.store: Set[str] = set()
        self.ran: List[str] = []
        self.exec_seq: Dict[str, int] = {}  # actor -> last executed seq
        self.worker_id = f"{node_id}-w1"
        self.client = _SimDaemonClient(self)
        world.daemons[node_id] = self

    # ------------------------------------------------------- step seeds

    def step_register(self, new_instance: bool = False,
                      new_conn: bool = False) -> str:
        self.instance += 1
        inst = f"{self.node_id}-i{self.instance}"
        if new_conn or new_instance:
            self.new_conn()
        conn = self.conn

        def also():
            self.alive = True
            if new_instance:
                # a fresh daemon process: the old incarnation's store,
                # bundles, and in-flight work are gone
                self.store.clear()
                self._bundles.clear()
        payload = {
            "node_id": self.node_id, "addr": "127.0.0.1",
            "port": 20000, "resources": {"CPU": self.cpus},
            "instance": inst, "labels": {},
        }
        label = self.world.rpc(
            self, "register_node", payload, keys={GLOBAL_KEY},
            base_label=f"reg:{self.node_id}/i{self.instance}", conn=conn,
        )
        # run the local bookkeeping with the registration delivery
        step = next(s for s in self.world.steps if s.label == label)
        orig = step.fn

        def fn():
            also()
            orig()
        step.fn = fn
        return label

    def step_drop_conn(self, conn: Optional[VirtualConn] = None) -> str:
        """The (possibly stale) server-side disconnect of one of this
        daemon's connections."""
        target = conn or self.conn

        def fire():
            target.closed = True
            self.world.server.conns.pop(target.conn_id, None)
            try:
                self.world.gcs._on_disconnect(target)
            except Exception as e:  # noqa: BLE001
                self.world.crash("on_disconnect", e)
        return self.world.enqueue(
            f"drop-conn:{self.node_id}/c{target.conn_id}", fire,
            keys={GLOBAL_KEY},
        )

    def step_kill(self) -> str:
        """Daemon process death: local liveness off + its connection
        drops (the edge-triggered death path)."""
        conn = self.conn

        def fire():
            self.alive = False
            conn.closed = True
            self.world.server.conns.pop(conn.conn_id, None)
            try:
                self.world.gcs._on_disconnect(conn)
            except Exception as e:  # noqa: BLE001
                self.world.crash("on_disconnect", e)
        return self.world.enqueue(
            f"kill:{self.node_id}", fire, keys={GLOBAL_KEY}
        )

    # ----------------------------------------------------- push effects

    def push_keys(self, channel: str, data: Any) -> Set[str]:
        if channel == "exec_tasks":
            return {f"node:{self.node_id}", *(
                f"task:{t['task_id']}" for t in data
            )}
        if channel == "return_bundle":
            return {f"node:{self.node_id}", f"pg:{data['pg_id']}"}
        return {GLOBAL_KEY}

    def on_push(self, channel: str, data: Any) -> None:
        super().on_push(channel, data)
        if channel == "exec_tasks":
            inst = self.instance
            for t in data:
                self.world.enqueue(
                    f"run:{t['task_id']}@{self.node_id}",
                    lambda t=t, i=inst: self._run_task(t, i),
                    keys={f"task:{t['task_id']}", f"node:{self.node_id}"},
                )
        elif channel == "return_bundle":
            key = f"{data['pg_id']}:{data['bundle_index']}"
            if self._bundles.pop(key, None) is not None:
                self.world.tracer.apply(
                    "pg_return", pg=data["pg_id"],
                    bundle=data["bundle_index"], node=self.node_id,
                )
        elif channel == "free_objects":
            self.store -= set(data["object_ids"])

    def _run_task(self, t: dict, instance: int) -> None:
        if not self.alive or instance != self.instance:
            return  # the incarnation that was asked to run this is gone
        from ray_tpu_torch.core.object_ref import ObjectRef

        tid = t["task_id"]
        self.ran.append(tid)
        results = []
        for i in range(int(t.get("num_returns", 1) or 1)):
            oid = ObjectRef.for_task_output(tid, i).id
            self.store.add(oid)
            self.world.tracer.apply("obj_put", oid=oid, node=self.node_id)
            results.append((oid, 8))
        payload = {
            "task_id": tid, "node_id": self.node_id, "status": "FINISHED",
            "results": results, "name": t.get("name") or "sim",
            "start": self.world.clock.now(),
            "end": self.world.clock.now(),
        }
        if t.get("actor_creation"):
            payload["actor_creation"] = True
            payload["actor_id"] = t.get("actor_id")
        keys = {
            f"task:{tid}", f"cap:{self.node_id}",
            *(f"obj:{oid}" for oid, _ in results),
        }
        if t.get("actor_creation"):
            keys.add(GLOBAL_KEY)  # actor table + hold retag ripple wider
        sends = 2 if self.resend_reports else 1
        for _ in range(sends):
            self.world.rpc(
                self, "task_done", payload, keys=keys,
                base_label=f"done:{tid}@{self.node_id}",
            )

    # --------------------------------------------- gcs-initiated rpcs

    def handle_rpc(self, method: str, params: dict):
        if not self.alive:
            raise ConnectionError(f"daemon {self.node_id} is down")
        if method == "prepare_bundle":
            self.world.tracer.apply(
                "pg_prepare", pg=params["pg_id"],
                bundle=params["bundle_index"], node=self.node_id, ok=True,
            )
            key = f"{params['pg_id']}:{params['bundle_index']}"
            self._bundles[key] = {**params, "state": "PREPARED"}
            return {"ok": True}
        if method == "commit_bundle":
            key = f"{params['pg_id']}:{params['bundle_index']}"
            ent = self._bundles.get(key)
            ok = ent is not None
            self.world.tracer.apply(
                "pg_commit", pg=params["pg_id"],
                bundle=params["bundle_index"], node=self.node_id, ok=ok,
                transition=ok and ent.get("state") != "COMMITTED",
            )
            if not ok:
                return {"ok": False, "error": "no prepared bundle"}
            ent["state"] = "COMMITTED"
            return {"ok": True}
        if method == "stream_ack":
            return {"ok": True}
        raise ValueError(f"sim daemon has no rpc {method}")

    # ------------------------------------------------------ actor execs

    def exec_actor_call(self, owner: str, actor: str, seq: int) -> None:
        self.exec_seq[actor] = seq
        self.world.tracer.apply(
            "actor_exec", owner=owner, actor=actor,
            worker=self.worker_id, seq=seq,
        )

    def step_worker_restart(self, actor: str) -> str:
        """The worker hosting ``actor`` dies and restarts. Calls still
        pending at the restart execute on the NEW incarnation
        (exec_actor_call reads ``worker_id`` live) — the fixed client
        protocol's replay semantics: a fresh worker key restarts the
        per-worker seq ordering the invariant checker tracks."""

        def fire():
            n = int(self.worker_id.rsplit("w", 1)[1]) + 1
            self.worker_id = f"{self.node_id}-w{n}"
        return self.world.enqueue(
            f"wrestart:{self.node_id}", fire,
            keys={f"actor:{actor}", f"node:{self.node_id}"},
        )


class SimDriver(SimPeer):
    sync_channels = frozenset(
        {"task_result", "nodes", "actor_update", "dag_update",
         "borrow_added", "borrow_released", "stream_item"}
    )

    def __init__(self, world: World, driver_id: str):
        super().__init__(world, driver_id)
        self.driver_id = driver_id
        self.results: Dict[str, Any] = {}

    def on_push(self, channel: str, data: Any) -> None:
        super().on_push(channel, data)
        if channel == "task_result":
            self.results[data.get("task_id")] = data.get("status")

    def step_register(self) -> str:
        return self.world.rpc(
            self, "register_driver", {"driver_id": self.driver_id},
            keys={GLOBAL_KEY}, base_label=f"reg-driver:{self.driver_id}",
        )

    def task_meta(self, task_id: str, cpus: float = 1.0,
                  **extra) -> dict:
        meta = {
            "task_id": task_id, "name": task_id,
            "class_key": ("sim", (("CPU", float(cpus)),)),
            "resources": {"CPU": float(cpus)},
            "owner": self.driver_id, "num_returns": 1,
        }
        meta.update(extra)
        return meta

    def step_submit(self, meta: dict) -> str:
        # submissions conflict with each other (and scheduler rounds)
        # through the intake queue's order — under scarce capacity,
        # which of two tasks dispatches first is semantically different
        return self.world.rpc(
            self, "submit_task", meta,
            keys={f"task:{meta['task_id']}", "sched-queue"},
            base_label=f"sub:{meta['task_id']}",
        )

    def step_free(self, oids: List[str], tag: str) -> str:
        return self.world.rpc(
            self, "free_objects", {"object_ids": oids},
            keys={f"obj:{o}" for o in oids}, base_label=f"free:{tag}",
        )

    def step_disconnect(self) -> str:
        conn = self.conn

        def fire():
            conn.closed = True
            self.world.server.conns.pop(conn.conn_id, None)
            try:
                self.world.gcs._on_disconnect(conn)
            except Exception as e:  # noqa: BLE001
                self.world.crash("on_disconnect", e)
        return self.world.enqueue(
            f"disc:{self.driver_id}", fire, keys={GLOBAL_KEY}
        )


# -------------------------------------------------------------- scenarios


@dataclasses.dataclass
class Scenario:
    name: str
    description: str
    build: Callable[[World], None]
    #: quiescence-only assertions returning violation strings
    postcheck: Optional[Callable[[World], List[str]]] = None


def _no_leaked_holds(world: World) -> List[str]:
    """A lifetime hold is LEAKED when its owner can no longer release
    it: an actor-hold whose actor is DEAD/unknown, a dag-hold whose dag
    is unregistered. ALIVE actors and live dags legally hold capacity."""
    out = []
    for key in world.gcs.running:
        if key.startswith("actor-hold-"):
            a = world.gcs.actors.get(key[len("actor-hold-"):])
            if a is None or a.get("state") == "DEAD":
                out.append(f"hold {key} leaked at quiescence "
                           f"(actor state: {a and a.get('state')})")
        elif key.startswith("dag-hold-"):
            dag_id = key[len("dag-hold-"):].rsplit("-", 1)[0]
            if dag_id not in world.gcs.dags:
                out.append(f"hold {key} leaked at quiescence "
                           "(dag unregistered)")
    return out


def _build_node_reconnect(world: World) -> None:
    d0 = SimDaemon(world, "d0", cpus=2.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    first_conn = d0.conn
    d0.step_register()
    drv.step_submit(drv.task_meta("t1", cpus=2.0))
    d0.step_register(new_instance=True)  # restart with a fresh stamp
    d0.step_drop_conn(first_conn)  # the old conn's disconnect lands late
    drv.step_submit(drv.task_meta("t2", cpus=2.0))
    drv.step_submit(drv.task_meta("t3", cpus=2.0))


def _post_node_reconnect(world: World) -> List[str]:
    out = _no_leaked_holds(world)
    d0 = world.daemons["d0"]
    n = world.gcs.nodes.get("d0")
    if d0.alive and n is not None and not n.get("alive") and \
            n.get("conn_id") == d0.conn.conn_id:
        out.append(
            "node d0 marked dead while its latest registration's "
            "connection is still open (a stale conn's disconnect killed "
            "the re-registered node)"
        )
    return out


def _build_watchdog_resend(world: World) -> None:
    from ray_tpu_torch.core.object_ref import ObjectRef

    d0 = SimDaemon(world, "d0", cpus=2.0, resend_reports=True)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    drv.step_submit(drv.task_meta("t1"))
    drv.step_submit(drv.task_meta("t1"))  # duplicate submission
    drv.step_submit(drv.task_meta("t2"))
    oid = ObjectRef.for_task_output("t1", 0).id
    drv.step_free([oid], tag="t1-out")


def _post_watchdog_resend(world: World) -> List[str]:
    # NOTE: a duplicate submission MAY legally re-execute after the
    # first execution completed (lineage reconstruction re-runs finished
    # producers); the real contract — never two dispatches outstanding
    # at once — is the exactly-once trace invariant, checked per run
    return _no_leaked_holds(world)


def _build_pg_vs_death(world: World) -> None:
    d0 = SimDaemon(world, "d0", cpus=1.0)
    d1 = SimDaemon(world, "d1", cpus=1.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    d1.step_register()
    world.rpc(
        drv, "create_placement_group",
        {"pg_id": "p1", "bundles": [{"CPU": 1.0}, {"CPU": 1.0}],
         "strategy": "PACK"},
        keys={GLOBAL_KEY}, base_label="pg:create:p1",
    )
    d1.step_kill()
    world.rpc(
        drv, "remove_placement_group", {"pg_id": "p1"},
        keys={GLOBAL_KEY}, base_label="pg:remove:p1",
    )


def _build_dag_vs_disconnect(world: World) -> None:
    d0 = SimDaemon(world, "d0", cpus=2.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    world.rpc(
        drv, "dag_register",
        {"dag_id": "g1", "owner": "drv0",
         "stages": [
             {"stage": 0, "resources": {"CPU": 1.0}},
             {"stage": 1, "resources": {"CPU": 1.0}},
         ]},
        keys={GLOBAL_KEY}, base_label="dag:reg:g1",
    )
    world.rpc(
        drv, "dag_teardown", {"dag_id": "g1"},
        keys={GLOBAL_KEY}, base_label="dag:teardown:g1",
    )
    drv.step_disconnect()


def _build_actor_kill_vs_create(world: World) -> None:
    d0 = SimDaemon(world, "d0", cpus=2.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    reg = world.rpc(
        drv, "register_actor",
        {"actor_id": "a1", "class_name": "Sim", "max_restarts": 0},
        keys={"actor:a1"}, base_label="actor:reg:a1",
    )
    sub = drv.step_submit(drv.task_meta(
        "c1", cpus=1.0, actor_creation=True, actor_id="a1",
    ))
    # kill/died causally follow the registration (a handle — and a
    # hosted worker — exist only after it); any later interleaving is
    # fair game
    world.rpc(
        drv, "kill_actor", {"actor_id": "a1"},
        keys={"actor:a1", GLOBAL_KEY}, base_label="actor:kill:a1",
        after=reg,
    )
    world.rpc(
        d0, "actor_died", {"actor_id": "a1", "cause": "worker died"},
        keys={"actor:a1", GLOBAL_KEY}, base_label="actor:died:a1",
        after=sub,
    )


def _build_actor_kill_vs_release(world: World) -> None:
    """Hunt for a soak transient: a ``[capacity]`` actor-hold
    release-node-mismatch ("release of 'actor-hold-a1' on dX but the
    allocation lives on dY"). The window under test is the death of the
    hold's HOME NODE between the creation's dispatch debit and the
    kill/died release credit: a restartable actor re-creates on the
    surviving daemon, so the hold's home flips mid-race and every release
    path (kill_actor, actor_died, node sweep) must credit where the
    allocation LIVES, never where it first landed.

    Clean sweep recorded 2026-08-07: 1400 DFS + 800 sampled schedules,
    0 violations (capacity conservation, exactly-once, no leaked holds),
    40 handler-pair orderings covered — the soak's transient did not
    reproduce under this model; if it resurfaces in a soak, replay its
    trace against this scenario's postcheck first."""
    d0 = SimDaemon(world, "d0", cpus=1.0)
    d1 = SimDaemon(world, "d1", cpus=1.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    d1.step_register()
    reg = world.rpc(
        drv, "register_actor",
        {"actor_id": "a1", "class_name": "Sim", "max_restarts": 1},
        keys={"actor:a1"}, base_label="actor:reg:a1",
    )
    sub = drv.step_submit(drv.task_meta(
        "c1", cpus=1.0, actor_creation=True, actor_id="a1",
    ))
    # the home-node kill can land before dispatch, between debit and
    # task_done's actor-hold retag, or after the hold settled — the
    # restart then re-places the actor on d1
    d0.step_kill()
    world.rpc(
        drv, "kill_actor", {"actor_id": "a1"},
        keys={"actor:a1", GLOBAL_KEY}, base_label="actor:kill:a1",
        after=reg,
    )
    # a (possibly stale) died report from the SURVIVING daemon: after a
    # restart relocated the actor, this is the release path whose node
    # attribution the mismatch message complained about
    world.rpc(
        d1, "actor_died", {"actor_id": "a1", "cause": "worker died"},
        keys={"actor:a1", GLOBAL_KEY}, base_label="actor:died:a1",
        after=sub,
    )


def _build_actor_replay(world: World) -> None:
    d0 = SimDaemon(world, "d0", cpus=2.0)
    drv = SimDriver(world, "drv0")
    drv.step_register()
    d0.step_register()
    # per-connection FIFO: seq 2's delivery is gated on seq 1's (the
    # client's ordered-submission pipeline); the worker restart replays
    # only calls the dead incarnation had not executed
    l1 = world.enqueue(
        "acall:a1/s1", lambda: d0.exec_actor_call("drv0", "a1", 1),
        keys={"actor:a1"},
    )
    world.enqueue(
        "acall:a1/s2", lambda: d0.exec_actor_call("drv0", "a1", 2),
        keys={"actor:a1"}, after=l1,
    )
    d0.step_worker_restart("a1")


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in [
        Scenario(
            "node-reconnect-instance",
            "daemon restart with a fresh instance stamp racing task "
            "dispatch/completion and the old connection's late disconnect",
            _build_node_reconnect, _post_node_reconnect,
        ),
        Scenario(
            "watchdog-resend",
            "duplicated task submission + watchdog-resent task_done "
            "reports racing dispatch and an owner free",
            _build_watchdog_resend, _post_watchdog_resend,
        ),
        Scenario(
            "pg-2pc-vs-node-death",
            "placement-group 2PC prepare/commit with a member node dying "
            "at every point, including between the phases, and a "
            "concurrent remove",
            _build_pg_vs_death, _no_leaked_holds,
        ),
        Scenario(
            "dag-register-vs-driver-disconnect",
            "compiled-dag registration racing its owner's disconnect "
            "sweep and an explicit teardown",
            _build_dag_vs_disconnect, _no_leaked_holds,
        ),
        Scenario(
            "actor-kill-vs-create",
            "actor creation in flight racing ray.kill and a daemon "
            "actor_died report (lifetime-hold conservation)",
            _build_actor_kill_vs_create, _no_leaked_holds,
        ),
        Scenario(
            "actor-kill-vs-release",
            "restartable actor whose home node dies between the creation "
            "dispatch debit and the kill/died release credit: the hold "
            "relocates with the restart, hunting the soak's "
            "release-node-mismatch transient",
            _build_actor_kill_vs_release, _no_leaked_holds,
        ),
        Scenario(
            "actor-replay",
            "ordered actor calls with a worker restart replaying "
            "in-flight calls on the new incarnation",
            _build_actor_replay, None,
        ),
    ]
}


# ---------------------------------------------------------------- results


@dataclasses.dataclass
class WorldResult:
    scenario: str
    schedule: List[str]
    options_at: List[Tuple[str, ...]]
    keys_of: Dict[str, FrozenSet[str]]
    violations: List[Violation]
    events: List[Dict[str, Any]]
    quiesced: bool

    @property
    def violation_kinds(self) -> Set[str]:
        return {v.kind for v in self.violations}

    def schedule_log(self) -> str:
        return " | ".join(self.schedule)


def run_world(scenario: Scenario, chooser: Chooser,
              seeded_bugs: Sequence[str] = (),
              step_limit: int = 600,
              device: str = "cuda") -> WorldResult:
    """Execute one schedule of ``scenario`` from a fresh world; returns
    the schedule actually taken plus every violation (invariants over the
    trace, handler crashes, unmet postconditions)."""
    from ray_tpu_torch.cluster import gcs as gcs_mod
    from ray_tpu_torch.cluster import rpc as rpc_mod

    prev_trace = rpc_mod.TRACE
    prev_bugs = set(gcs_mod.SEEDED_BUGS)
    tracer = BufTracer()
    rpc_mod.TRACE = tracer
    gcs_mod.SEEDED_BUGS.clear()
    gcs_mod.SEEDED_BUGS.update(seeded_bugs)
    world = World(chooser, tracer, step_limit=step_limit)
    try:
        world.build_gcs(device=device)
        scenario.build(world)
        world.run()
        violations = InvariantChecker().run(list(tracer.records))
        clock = tracer._clock
        for c in world.crashes:
            violations.append(Violation("crash", c, clock))
        quiesced = not world.steps and not world.stopped_early
        if quiesced and scenario.postcheck is not None:
            for msg in scenario.postcheck(world):
                violations.append(Violation("postcheck", msg, clock))
        return WorldResult(
            scenario=scenario.name,
            schedule=list(world.schedule),
            options_at=list(world.options_at),
            keys_of=dict(world.keys_of),
            violations=violations,
            events=list(tracer.records),
            quiesced=quiesced,
        )
    finally:
        world.close()
        rpc_mod.TRACE = prev_trace
        gcs_mod.SEEDED_BUGS.clear()
        gcs_mod.SEEDED_BUGS.update(prev_bugs)


@dataclasses.dataclass
class ExploreResult:
    scenario: str
    schedules_run: int
    dfs_schedules: int
    sampled_schedules: int
    branches_pruned: int
    branches_queued: int
    coverage: Set[Tuple[str, str]]
    elapsed_s: float
    violating: Optional[WorldResult] = None
    shrunk: Optional[List[str]] = None
    shrunk_violations: Optional[List[Violation]] = None
    shrunk_stop_after: bool = True

    @property
    def found(self) -> bool:
        return self.violating is not None

    def summary(self) -> str:
        head = (
            f"{self.scenario}: {self.schedules_run} schedules "
            f"({self.dfs_schedules} dfs + {self.sampled_schedules} "
            f"sampled), {self.branches_pruned} branches pruned, "
            f"{len(self.coverage)} handler-pair orderings, "
            f"{self.elapsed_s:.2f}s"
        )
        if not self.found:
            return head + " — no violations"
        kinds = sorted({v.kind for v in self.violating.violations})
        n = len(self.shrunk or self.violating.schedule)
        return head + f" — VIOLATION {kinds}, shrunk to {n} steps"


# ----------------------------------------------------- generic engine
#
# The DFS + conflict-pruning + shrink machinery below is deliberately
# generic over a duck-typed *run result* (needs: ``schedule``,
# ``options_at``, ``keys_of``, ``violations`` with ``.kind``,
# ``violation_kinds``) so other model checkers — analysis/memmodel.py's
# word-level channel checker — reuse the exact same engine instead of
# re-implementing (and diverging on) persistent-set pruning and
# delta-debug shrinking. ``explore()``/``shrink_schedule()`` are the
# GCS-scenario instantiations.


def _conflicts(a: FrozenSet[str], b: FrozenSet[str]) -> bool:
    return GLOBAL_KEY in a or GLOBAL_KEY in b or bool(a & b)


def _backtrack_alternatives(
    res, start: int, max_depth: Optional[int],
    conflicts: Callable[[FrozenSet[str], FrozenSet[str]], bool] = _conflicts,
    process_of: Optional[Callable[[str], str]] = None,
) -> List[Tuple[int, str]]:
    """(position, alternative) pairs worth branching on, persistent-set
    style: an unchosen enabled step is explored at position i only when
    something that ran in [i, its own turn) conflicts with it.

    With ``process_of`` (worlds whose steps are *per-process program
    counters*, e.g. memmodel's actor ops), the Flanagan–Godefroid
    refinement also branches an alternative whose own op commutes but
    whose process has a LATER op conflicting with something that ran in
    between — without it, a benign leading op (a load of an untouched
    word) shields its process's entire remaining schedule from DFS."""
    out: List[Tuple[int, str]] = []
    sched = res.schedule
    limit = len(sched) if max_depth is None else min(len(sched), max_depth)
    pos_of = {label: i for i, label in enumerate(sched)}
    later_union: List[Dict[str, FrozenSet[str]]] = []
    if process_of is not None:
        # later_union[x][P]: union of key footprints of P's steps after
        # position x — one backwards sweep, queried per (between, proc)
        acc: Dict[str, FrozenSet[str]] = {}
        rev: List[Dict[str, FrozenSet[str]]] = []
        for label in reversed(sched):
            rev.append(dict(acc))
            if label != CONTINUE:
                p = process_of(label)
                acc[p] = acc.get(p, frozenset()) | \
                    res.keys_of.get(label, frozenset({GLOBAL_KEY}))
        later_union = list(reversed(rev))
    for i in range(start, limit):
        chosen = sched[i]
        for alt in res.options_at[i]:
            if alt == chosen or alt == CONTINUE:
                continue
            akeys = res.keys_of.get(alt, frozenset({GLOBAL_KEY}))
            j = pos_of.get(alt)
            if j is None:
                out.append((i, alt))  # never ran (truncation): explore
                continue
            aproc = process_of(alt) if process_of is not None else None
            branch = False
            for x_i in range(i, j):
                x = sched[x_i]
                if x == CONTINUE:
                    continue
                xkeys = res.keys_of.get(x, frozenset({GLOBAL_KEY}))
                if conflicts(akeys, xkeys):
                    branch = True
                    break
                if aproc is not None and \
                        process_of(x) != aproc and conflicts(
                            xkeys, later_union[x_i].get(aproc, frozenset())
                        ):
                    branch = True
                    break
            if branch:
                out.append((i, alt))
    return out


@dataclasses.dataclass
class EngineStats:
    """What the generic DFS+sampling engine hands back to its caller."""

    violating: Optional[Any]
    dfs_runs: int
    sampled_runs: int
    pruned: int
    queued: int


def dfs_explore(
    run_fn: Callable[[Chooser], Any],
    *,
    max_schedules: int,
    max_depth: Optional[int],
    samples: int,
    seed: int,
    wall_cap_s: Optional[float] = None,
    conflicts: Callable[[FrozenSet[str], FrozenSet[str]], bool] = _conflicts,
    process_of: Optional[Callable[[str], str]] = None,
    on_result: Optional[Callable[[Any], None]] = None,
) -> EngineStats:
    """Generic exploration loop: bounded-depth DFS with persistent-set
    pruning over ``run_fn``'s schedules, then seeded-random sampling.
    ``run_fn(chooser)`` executes ONE schedule from a fresh world and
    returns the duck-typed run result; it may raise ScheduleDiverged.
    Stops at the first violating result."""
    import random

    t0 = _time.monotonic()
    frontier: List[Tuple[str, ...]] = [()]
    seen: Set[Tuple[str, ...]] = {()}
    dfs_runs = 0
    sampled_runs = 0
    pruned = 0
    queued = 0
    violating = None

    def out_of_wall() -> bool:
        return (
            wall_cap_s is not None and _time.monotonic() - t0 > wall_cap_s
        )

    def out_of_budget() -> bool:
        # max_schedules bounds the DFS half; the sampling half has its
        # own ``samples`` budget (a DFS that fills its budget must not
        # starve the random pass — the two find different bugs)
        return out_of_wall() or dfs_runs >= max_schedules

    while frontier and not out_of_budget() and violating is None:
        prefix = frontier.pop()
        try:
            res = run_fn(Chooser(prefix))
        except ScheduleDiverged:  # pragma: no cover - determinism guard
            continue
        dfs_runs += 1
        if on_result is not None:
            on_result(res)
        if res.violations:
            violating = res
            break
        alts = _backtrack_alternatives(res, len(prefix), max_depth,
                                       conflicts=conflicts,
                                       process_of=process_of)
        total_alts = 0
        for i, alt in reversed(alts):
            total_alts += 1
            new_prefix = tuple(res.schedule[:i]) + (alt,)
            if new_prefix in seen:
                continue
            seen.add(new_prefix)
            frontier.append(new_prefix)
            queued += 1
        # pruning accounting: enabled-but-not-branched alternatives
        limit = (
            len(res.schedule) if max_depth is None
            else min(len(res.schedule), max_depth)
        )
        enabled_alts = sum(
            len([o for o in res.options_at[i]
                 if o not in (res.schedule[i], CONTINUE)])
            for i in range(len(prefix), limit)
        )
        pruned += max(0, enabled_alts - total_alts)

    rng_base = random.Random(seed)
    while (
        violating is None and sampled_runs < samples and not out_of_wall()
    ):
        rng = random.Random(rng_base.getrandbits(64))
        try:
            res = run_fn(Chooser(rng=rng))
        except ScheduleDiverged:  # pragma: no cover
            continue
        sampled_runs += 1
        if on_result is not None:
            on_result(res)
        if res.violations:
            violating = res

    return EngineStats(
        violating=violating,
        dfs_runs=dfs_runs,
        sampled_runs=sampled_runs,
        pruned=pruned,
        queued=queued,
    )


def shrink_generic(
    run_fn: Callable[[Chooser], Any],
    schedule: List[str],
    target_kinds: Set[str],
    stop_after: bool,
    max_attempts: int = 400,
    chooser_factory: Optional[
        Callable[[Sequence[str], bool], Chooser]
    ] = None,
    blocks_of: Optional[Callable[[List[str]], List[Tuple[int, int]]]] = None,
) -> Tuple[List[str], List[Violation]]:
    """Minimize a violating schedule: greedy prefix truncation, then
    single-step delta removal — plus, when ``blocks_of`` is given,
    contiguous-block removal (a world whose step labels carry per-actor
    op counters renumbers every later label when one op is dropped, so
    only whole blocks — e.g. a spin-wait iteration — can go; pair with a
    counter-insensitive ``chooser_factory``). Every candidate is
    re-executed from scratch via ``run_fn``; a candidate survives only
    if it still produces a violation of one of the original kinds."""
    if chooser_factory is None:
        chooser_factory = lambda prefix, stop: Chooser(  # noqa: E731
            prefix, stop_after=stop
        )

    def still_bad(cand: List[str]) -> Optional[List[Violation]]:
        try:
            r = run_fn(chooser_factory(cand, stop_after))
        except ScheduleDiverged:
            return None
        if r.violation_kinds & target_kinds:
            return r.violations
        return None

    attempts = 0
    current = list(schedule)
    best_viol = still_bad(current)
    if best_viol is None:  # pragma: no cover - caller passes a violator
        return current, []
    if stop_after:
        # truncate: shortest prefix that still violates
        lo, hi = 0, len(current)
        while lo < hi and attempts < max_attempts:
            mid = (lo + hi) // 2
            attempts += 1
            v = still_bad(current[:mid])
            if v is not None:
                hi = mid
                best_viol = v
            else:
                lo = mid + 1
        current = current[:hi]
    changed = True
    while changed and attempts < max_attempts:
        changed = False
        if blocks_of is not None:
            # contiguous-block removals first (largest wins fastest)
            for s, e in sorted(blocks_of(current),
                               key=lambda b: b[0] - b[1]):
                if attempts >= max_attempts:
                    break
                cand = current[:s] + current[e:]
                attempts += 1
                v = still_bad(cand)
                if v is not None:
                    current = cand
                    best_viol = v
                    changed = True
                    break
            if changed:
                continue
        # downward single-step removals: dropping index i leaves the
        # positions below it valid, so one pass is index-stable
        i = len(current) - 1
        while i >= 0 and attempts < max_attempts:
            cand = current[:i] + current[i + 1:]
            attempts += 1
            v = still_bad(cand)
            if v is not None:
                current = cand
                best_viol = v
                changed = True
            i -= 1
    return current, best_viol


def shrink_schedule(
    scenario: Scenario, schedule: List[str], target_kinds: Set[str],
    seeded_bugs: Sequence[str], stop_after: bool,
    max_attempts: int = 400,
    device: str = "cuda",
) -> Tuple[List[str], List[Violation]]:
    """GCS-scenario instantiation of :func:`shrink_generic`."""
    return shrink_generic(
        lambda chooser: run_world(scenario, chooser,
                                  seeded_bugs=seeded_bugs, device=device),
        schedule, target_kinds, stop_after, max_attempts=max_attempts,
    )


def explore(
    scenario: Scenario,
    max_schedules: int = 500,
    max_depth: Optional[int] = 30,
    samples: int = 100,
    seed: int = 0,
    seeded_bugs: Sequence[str] = (),
    wall_cap_s: Optional[float] = None,
    shrink: bool = True,
    step_limit: int = 600,
    device: str = "cuda",
) -> ExploreResult:
    """DFS + random-sampling exploration of one scenario (via the
    generic :func:`dfs_explore` engine). Stops at the first violating
    schedule (shrinking it), or when the schedule budget / wall cap
    runs out."""
    t0 = _time.monotonic()
    coverage: Set[Tuple[str, str]] = set()

    stats = dfs_explore(
        lambda chooser: run_world(
            scenario, chooser, seeded_bugs=seeded_bugs,
            step_limit=step_limit, device=device,
        ),
        max_schedules=max_schedules,
        max_depth=max_depth,
        samples=samples,
        seed=seed,
        wall_cap_s=wall_cap_s,
        on_result=lambda res: coverage.update(
            interleaving_coverage(res.events)
        ),
    )
    violating = stats.violating

    result = ExploreResult(
        scenario=scenario.name,
        schedules_run=stats.dfs_runs + stats.sampled_runs,
        dfs_schedules=stats.dfs_runs,
        sampled_schedules=stats.sampled_runs,
        branches_pruned=stats.pruned,
        branches_queued=stats.queued,
        coverage=coverage,
        elapsed_s=_time.monotonic() - t0,
        violating=violating,
    )
    if violating is not None and shrink:
        kinds = violating.violation_kinds
        # postcheck violations only exist at quiescence: shrink those
        # with the default tail instead of truncation
        stop_after = "postcheck" not in kinds
        shrunk, viol = shrink_schedule(
            scenario, violating.schedule, kinds, seeded_bugs, stop_after,
            device=device,
        )
        result.shrunk = shrunk
        result.shrunk_violations = viol
        result.shrunk_stop_after = stop_after
    return result


def explore_all(
    names: Optional[Sequence[str]] = None, device: str = "cuda", **kw
) -> Dict[str, ExploreResult]:
    out: Dict[str, ExploreResult] = {}
    for name in names or sorted(SCENARIOS):
        out[name] = explore(SCENARIOS[name], device=device, **kw)
    return out


# ----------------------------------------------------------------- replay


def write_replay(path: str, result: ExploreResult,
                 seeded_bugs: Sequence[str] = ()) -> None:
    assert result.violating is not None, "nothing to replay"
    schedule = result.shrunk or result.violating.schedule
    viols = (
        result.shrunk_violations
        if result.shrunk is not None
        else result.violating.violations
    )
    with open(path, "w", encoding="utf-8") as f:
        json.dump({
            "scenario": result.scenario,
            "seeded_bugs": sorted(seeded_bugs),
            "stop_after": result.shrunk_stop_after,
            "schedule": schedule,
            "violation_kinds": sorted({v.kind for v in (viols or [])}),
            "violations": [v.format() for v in (viols or [])],
        }, f, indent=2)
        f.write("\n")


def replay(path: str, device: str = "cuda") -> WorldResult:
    """Re-execute a recorded counterexample deterministically."""
    with open(path, "r", encoding="utf-8") as f:
        rec = json.load(f)
    scenario = SCENARIOS.get(rec["scenario"])
    if scenario is None:
        raise ValueError(f"unknown scenario {rec['scenario']!r}")
    return run_world(
        scenario,
        Chooser(rec["schedule"], stop_after=rec.get("stop_after", True)),
        seeded_bugs=rec.get("seeded_bugs", ()),
        device=device,
    )
