"""Happens-before protocol tracing + offline invariant checking.

The dynamic cross-check of the static protocol model in
:mod:`ray_tpu.analysis.protocol` — the same relationship the runtime
lock-order sanitizer has to the static lock graph. A
:class:`ProtocolTracer` installed via :func:`install` records control-
plane events (frame sends/recvs from hook points in ``cluster/rpc.py``
plus application-level *apply* events from the GCS/daemon/client) to a
JSONL trace, each stamped with a Lamport clock. :func:`check_trace`
replays a trace offline and verifies the protocol invariants the
retry/replay machinery of the reconnecting control plane must preserve:

- **exactly-once**: a ``task_done`` report mutates GCS state at most once
  per (task, execution) — watchdog resends and chaos-duplicated frames
  must be absorbed by the dedupe paths;
- **capacity conservation**: per node, outstanding dispatched demand
  (tasks + staged PG bundles) never exceeds the node total and never goes
  negative — releases match allocations (cf. Narayanan et al.,
  "Heterogeneity-Aware Cluster Scheduling Policies": every guarantee
  presumes the capacity ledger never drifts);
- **PG 2PC legality**: per (node, pg, bundle), commit transitions only
  out of a prepared state; returns/aborts are idempotent;
- **actor ordering**: per (caller, actor, hosting worker) executed
  sequence numbers are strictly increasing;
- **borrow conservation**: borrow releases never exceed registrations
  per (object, worker); optionally, terminal outstanding count is zero;
- **admission conservation** (overload control plane): the GCS's
  ``admit``/``admit_exit`` events — emitted at every queue enter/exit —
  balance per task (an exit without an admit is a ledger bug), and in
  ``strict_terminal`` mode every admitted task must have terminally
  resolved (result, typed failure, or hand-back) by the end of the
  trace: admission control may REJECT loudly, but never drop silently;
- **object lifecycle**: an object location is only ever recorded after a
  store put on that node, and never re-surfaces after a free without an
  intervening re-creation (created -> sealed/put -> located -> freed);
- **channel alternation** (compiled DAGs): per edge, frame seqs written
  by the single writer are gap-free (+1 each), every read consumes the
  next unread seq, and no seq is read before it was written — the shm
  seqlock's write/ack alternation, checked offline. Channel events carry
  their happens-before through the channel header's clock words (see
  ray_tpu/dag/channel.py), since those frames never cross the RPC layer.

Activation mirrors ``ray_tpu.chaos``: a single module-global hook
(``rpc.TRACE``) checked with ``is None`` on the hot path — zero overhead
when no tracer is installed — plus ``RAY_TPU_TRACE_FILE`` env activation
so spawned subprocesses can join the same trace file (append-mode, one
JSON line per event; in-process daemons/GCS/driver are what the
invariants need, so tests normally trace only the test process).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

ENV_TRACE = "RAY_TPU_TRACE_FILE"

#: rpc methods whose apply semantics the invariant checker models; the
#: static protocol dump must know every one of them (see
#: test_dump_protocol_roundtrips_method_table) so the two halves cannot
#: drift apart silently.
METHOD_TABLE: Dict[str, str] = {
    "submit_task": "exactly-once (GCS running-table dedupe)",
    "task_done": "exactly-once + capacity release + object location",
    "register_node": "capacity ledger reset semantics",
    "node_sync": "object location resync",
    "add_object_location": "object lifecycle (located)",
    "free_objects": "object lifecycle (freed)",
    "prepare_bundle": "PG 2PC prepare",
    "commit_bundle": "PG 2PC commit",
    "create_placement_group": "PG capacity stage",
    "remove_placement_group": "PG capacity release",
    "actor_call": "per-caller actor seq monotonicity",
    "register_borrows": "borrow conservation (register)",
    "borrow_released": "borrow conservation (release)",
    "kill_actor": "actor lifetime-hold release",
    "actor_died": "actor lifetime-hold release",
    "stream_item": "object lifecycle (located)",
    # overload control plane: admission enter/exit events pair at every
    # queue transition (admission conservation — every admitted task
    # terminally resolves), drain marks a node unschedulable while its
    # running tasks bleed off
    "drain_node": "node unschedulable marking (graceful drain)",
    # gray-failure defense plane: quarantine is the reversible drain-mask
    # twin (probe-verified recovery instead of terminate); probe results
    # drive the QUARANTINED -> PROBATION exit. Speculative executions ride
    # the dispatch/release ledger under per-copy keys (task~sN) with
    # exactly-one winning task_done apply and cancel-conservation on the
    # losers (see _on_dispatch/_on_spec_cancel/_on_spec_promote)
    "quarantine_node": "reversible node quarantine mask (gray defense)",
    "probe_result": "quarantine recovery probing (gray defense)",
    # compiled DAGs (ray_tpu/dag): stage capacity holds follow the same
    # dispatch/release ledger as tasks; channel frames follow the per-edge
    # seq-alternation invariant (chan_write/chan_read apply events emitted
    # by the exec loops, clocks carried through the shm header)
    "dag_register": "dag stage capacity holds (dispatch)",
    "dag_teardown": "dag stage capacity release + channel teardown",
    "dag_worker_died": "dag broken propagation + stage-hold release",
    "dag_start_stage": "stage worker pinning",
    "dag_push": "channel frame deposit (chan seq alternation)",
    "dag_pull": "channel frame consume (chan seq alternation)",
    # serve fast path (ray_tpu/serve/fastpath.py): pair registration is
    # the plane's only control traffic; request/response frames ride the
    # same per-channel seq-alternation invariant as dag edges
    "serve_register": "fast-path pair registration (placement + sweep)",
    "serve_teardown": "fast-path pair release + channel teardown",
    "serve_attach": "pair channel creation + replica worker attach",
    "serve_replica_ready": "replica loop attach acknowledgement",
}

_EPS = 1e-4


def _jsonable(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class ProtocolTracer:
    """Append-only JSONL event recorder with a Lamport clock.

    One instance per process; every event costs one lock + one buffered
    line write, paid ONLY while installed (the rpc layer guards each hook
    behind ``if TRACE is not None``). The clock is process-global and
    merged from incoming frame clocks (``_lc``), so multi-process traces
    interleave causally; in the single-process test topology (GCS +
    daemons in-process, workers as subprocesses whose frames are clocked
    at the receiving daemon) the clock is a total order consistent with
    program order under the GCS/daemon locks.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._clock = 0
        self._pid = os.getpid()
        self._f = open(path, "a", encoding="utf-8")
        self.closed = False

    def _emit(self, rec: Dict[str, Any]) -> int:
        with self._lock:
            self._clock += 1
            rec["c"] = self._clock
            rec["pid"] = self._pid
            if not self.closed:
                self._f.write(json.dumps(rec, default=_jsonable) + "\n")
                self._f.flush()
            return self._clock

    # ------------------------------------------------------- rpc hooks

    def on_send(self, src: str, dst: str, method: Optional[str]) -> int:
        """Client-side frame send; the returned clock rides the frame as
        ``_lc`` so the receiving process can merge it."""
        return self._emit({"t": "send", "src": src, "dst": dst, "m": method})

    def on_recv(self, src: str, dst: str, method: Optional[str],
                remote_clock: Optional[int]) -> None:
        with self._lock:
            if remote_clock is not None and remote_clock > self._clock:
                self._clock = remote_clock
        self._emit({"t": "recv", "src": src, "dst": dst, "m": method})

    def on_push(self, src: str, dst: str, channel: Optional[str]) -> None:
        self._emit({"t": "push", "src": src, "dst": dst, "ch": channel})

    # ---------------------------------------------------- apply events

    def apply(self, kind: str, **fields: Any) -> int:
        """Application-level state mutation (GCS/daemon/client hooks).
        Returns the event's Lamport clock — shm channels stamp it into
        their header so the peer process can merge it (frames there never
        cross the RPC layer, where ``_lc`` would normally carry it)."""
        rec: Dict[str, Any] = {"t": "apply", "k": kind}
        rec.update(fields)
        return self._emit(rec)

    def merge_clock(self, remote_clock: Optional[int]) -> None:
        """Fold a peer clock received out-of-band (e.g. a channel header
        word) into this process's clock, preserving happens-before."""
        if not remote_clock:
            return
        with self._lock:
            if remote_clock > self._clock:
                self._clock = int(remote_clock)

    def close(self) -> None:
        with self._lock:
            self.closed = True
            try:
                self._f.close()
            except OSError:
                pass


# ------------------------------------------------------------ activation

# Flight recorder displaced by install() (ray_tpu.obs installs a bounded
# in-memory ring as the default rpc.TRACE): uninstall() puts it back so
# the always-on black box survives opt-in tracing sessions.
_displaced = None


def install(path: str) -> ProtocolTracer:
    """Make a fresh tracer writing to ``path`` the process-wide trace
    plane (``cluster/rpc.py`` hooks + every apply-event site)."""
    global _displaced
    from ray_tpu_torch.cluster import rpc as _rpc

    tracer = ProtocolTracer(path)
    prev = _rpc.TRACE
    if prev is not None and getattr(prev, "is_flight_recorder", False):
        _displaced = prev
    _rpc.TRACE = tracer
    return tracer


def uninstall() -> None:
    global _displaced
    from ray_tpu_torch.cluster import rpc as _rpc

    tracer = _rpc.TRACE
    if tracer is not None and getattr(tracer, "is_flight_recorder", False):
        return  # nothing opt-in is installed; keep the recorder running
    _rpc.TRACE, _displaced = _displaced, None
    if tracer is not None:
        tracer.close()


def active() -> Optional[ProtocolTracer]:
    from ray_tpu_torch.cluster import rpc as _rpc

    return _rpc.TRACE


def install_from_env() -> Optional[ProtocolTracer]:
    path = os.environ.get(ENV_TRACE)
    if not path:
        return None
    return install(path)


# -------------------------------------------------------------- checking


@dataclasses.dataclass
class Violation:
    kind: str
    message: str
    clock: int

    def format(self) -> str:
        return f"[{self.kind}] c={self.clock}: {self.message}"


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace, totally ordered by (clock, pid, file order).
    Tolerates a torn final line (a killed process mid-write)."""
    events: List[Tuple[int, int, int, Dict]] = []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a killed writer
            events.append((int(ev.get("c", 0)), int(ev.get("pid", 0)), i, ev))
    events.sort(key=lambda t: (t[0], t[1], t[2]))
    return [ev for _c, _p, _i, ev in events]


class InvariantChecker:
    """Replays a trace's apply events against the protocol invariants."""

    def __init__(self):
        self.violations: List[Violation] = []
        # capacity model
        self.node_total: Dict[str, Dict[str, float]] = {}
        self.node_alive: Dict[str, bool] = {}
        # node -> {ledger_key: resources}; keys are task ids, actor-hold
        # ids, or ("pg", pg_id, bundle_index) tuples
        self.ledger: Dict[str, Dict[Any, Dict[str, float]]] = {}
        self.wiped: set = set()  # ledger keys erased by node death/reset
        # exactly-once: task -> node of the outstanding dispatch
        self.outstanding: Dict[str, str] = {}
        # straggler speculation: task -> {spec ledger key -> node} of
        # outstanding speculative copies. Every copy must end as the
        # winner (task_done from its node), a spec_cancel loser, a
        # spec_promote (new primary), or a node_dead wipe — anything
        # left at a strict_terminal check leaked a capacity hold
        self.spec_out: Dict[str, Dict[str, str]] = {}
        # PG 2PC daemon-side state per (node, pg, bundle)
        self.pg2pc: Dict[Tuple, str] = {}
        # actor ordering: (owner, actor, worker) -> last seq
        self.actor_seq: Dict[Tuple, int] = {}
        # borrows: outstanding (oid, worker) registrations
        self.borrows: set = set()
        # admission conservation: task -> net admit count (enter - exit);
        # a duplicate submission legally sits at 2 until intake dedupes
        self.admitted: Dict[str, int] = {}
        # object lifecycle: oid -> {"nodes": set, "freed": clock|None,
        #                           "put_after_free": bool}
        self.objects: Dict[str, Dict[str, Any]] = {}
        # compiled-DAG channels: key -> {"w": last written seq,
        # "r": last read seq, "reads_seen"/"writes_seen": bool}. The
        # cross-side checks (write overrun, read-before-write) arm only
        # once BOTH sides are witnessed on the edge — a topology where
        # only one end traces (e.g. the driver with worker subprocesses
        # lacking RAY_TPU_TRACE_FILE) must not self-flag; the same-side
        # seq-continuity checks always hold.
        self.channels: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------ helpers

    def _bad(self, kind: str, clock: int, msg: str) -> None:
        self.violations.append(Violation(kind, msg, clock))

    @staticmethod
    def _res(v: Any) -> Dict[str, float]:
        return {str(k): float(x) for k, x in (v or {}).items()}

    def _alloc(self, clock: int, node: str, key: Any,
               res: Dict[str, float]) -> None:
        led = self.ledger.setdefault(node, {})
        if key in led:
            self._bad("capacity", clock,
                      f"allocation key {key!r} on {node} allocated twice "
                      "without release")
            return
        led[key] = res
        self.wiped.discard(key)
        total = self.node_total.get(node)
        if total is None:
            return
        sums: Dict[str, float] = {}
        for r in led.values():
            for name, amt in r.items():
                sums[name] = sums.get(name, 0.0) + amt
        for name, amt in sums.items():
            if amt > total.get(name, 0.0) + _EPS:
                self._bad("capacity", clock,
                          f"node {node} oversubscribed on {name}: "
                          f"{amt:.3f} outstanding > {total.get(name, 0.0):.3f} "
                          f"total (alloc {key!r})")

    def _release(self, clock: int, key: Any, node: Optional[str]) -> None:
        # a LIVE ledger entry always wins over a stale wiped marker: an
        # actor-hold wiped by one node's death can be re-created on a new
        # node (restart) and must release normally there
        for n, led in self.ledger.items():
            if key in led:
                if node is not None and n != node:
                    self._bad("capacity", clock,
                              f"release of {key!r} on {node} but the "
                              f"allocation lives on {n}")
                del led[key]
                self.wiped.discard(key)
                return
        if key in self.wiped:
            self.wiped.discard(key)
            return  # released after its node died: the wipe already covered it
        self._bad("capacity", clock,
                  f"release of {key!r} with no outstanding allocation "
                  "(double-release or conservation drift)")

    def _wipe_node(self, node: str) -> None:
        for key in list(self.ledger.get(node, {})):
            self.wiped.add(key)
        self.ledger[node] = {}
        for task, n in list(self.outstanding.items()):
            if n == node:
                del self.outstanding[task]
        # speculative copies hosted on the dead node die with it (their
        # ledger entries were wiped above; no cancel/release follows)
        for task, m in list(self.spec_out.items()):
            for k in [k for k, n in m.items() if n == node]:
                del m[k]
            if not m:
                del self.spec_out[task]

    # -------------------------------------------------------------- apply

    def run(self, events: List[Dict[str, Any]],
            strict_terminal: bool = False) -> List[Violation]:
        for ev in events:
            if ev.get("t") != "apply":
                continue
            handler = getattr(self, "_on_" + ev.get("k", ""), None)
            if handler is not None:
                handler(ev)
        if strict_terminal:
            clock = events[-1].get("c", 0) if events else 0
            for oid_worker in sorted(self.borrows):
                self._bad("borrow", clock,
                          f"borrow {oid_worker!r} never released "
                          "(terminal count nonzero)")
            for task in sorted(self.admitted):
                self._bad("admission", clock,
                          f"task {task} admitted but never terminally "
                          "resolved (admission conservation: a silent "
                          "drop or a stranded queue entry)")
            for task in sorted(self.spec_out):
                self._bad("speculation", clock,
                          f"speculative copies of {task} never resolved "
                          "(no win, cancel, promote, or node wipe): "
                          f"{sorted(self.spec_out[task])}")
        return self.violations

    def _on_node(self, ev: Dict) -> None:
        node = ev["node"]
        if ev.get("revived") or node not in self.node_total:
            # fresh row or revival after death: availability reset, so the
            # ledger resets with it
            self._wipe_node(node)
            self.node_total[node] = self._res(ev.get("resources"))
        # live connection bounce (revived=False on a known node): the GCS
        # keeps the row as-is, so the ledger keeps its entries
        self.node_alive[node] = True

    def _on_node_dead(self, ev: Dict) -> None:
        node = ev["node"]
        self.node_alive[node] = False
        self._wipe_node(node)

    def _on_dispatch(self, ev: Dict) -> None:
        task, node = ev["task"], ev["node"]
        if ev.get("speculative"):
            # straggler speculation: a concurrent SECOND execution of the
            # same task is legal — under its OWN ledger key (task~sN), so
            # capacity conservation still pairs per execution — but only
            # while the primary dispatch is outstanding
            key = ev.get("key") or f"{task}~s?"
            if task not in self.outstanding:
                self._bad("speculation", ev["c"],
                          f"speculative copy {key!r} launched with no "
                          "outstanding primary dispatch")
            if not self.node_alive.get(node, False):
                self._bad("capacity", ev["c"],
                          f"speculative copy {key!r} dispatched to "
                          f"dead/unknown node {node}")
            self.spec_out.setdefault(task, {})[key] = node
            self._alloc(ev["c"], node, key, self._res(ev.get("res")))
            return
        if task in self.outstanding:
            self._bad("exactly-once", ev["c"],
                      f"task {task} dispatched to {node} while an earlier "
                      f"dispatch to {self.outstanding[task]} is still "
                      "outstanding")
        self.outstanding[task] = node
        if not self.node_alive.get(node, False):
            self._bad("capacity", ev["c"],
                      f"task {task} dispatched to dead/unknown node {node}")
        # PG-riding tasks debit their bundle, not the node: ledger entry is
        # empty but still keyed so the release pairs up
        self._alloc(ev["c"], node, task,
                    {} if ev.get("pg") else self._res(ev.get("res")))

    def _on_task_done(self, ev: Dict) -> None:
        task = ev["task"]
        if task not in self.outstanding:
            self._bad("exactly-once", ev["c"],
                      f"task_done for {task} applied with no outstanding "
                      "dispatch — a resend/duplicate escaped the dedupe")
            return
        del self.outstanding[task]
        # a speculative copy on the REPORTING node is the winner: its
        # ledger entry releases through the normal release event; every
        # other copy must follow with a spec_cancel (checked terminal)
        m = self.spec_out.get(task)
        if m:
            for k in [k for k, n in m.items() if n == ev.get("node")]:
                del m[k]
            if not m:
                del self.spec_out[task]

    def _on_spec_cancel(self, ev: Dict) -> None:
        """A losing execution of a speculated task was cancelled. The
        capacity release rides a paired ``release`` event under the same
        ledger key; here we retire the speculation bookkeeping —
        cancel-conservation: each copy cancels at most once."""
        task, key = ev["task"], ev.get("key")
        if key == task:
            return  # the PRIMARY lost to a copy: outstanding already
            # resolved by the winning task_done apply
        m = self.spec_out.get(task)
        if m is None or key not in m:
            self._bad("speculation", ev["c"],
                      f"spec_cancel for {key!r} with no outstanding "
                      "speculative copy (double-cancel or phantom)")
            return
        del m[key]
        if not m:
            del self.spec_out[task]

    def _on_spec_promote(self, ev: Dict) -> None:
        """The primary's node died with a speculative copy surviving: the
        copy becomes the primary (its ledger key carries over — the
        eventual release pairs against it)."""
        task, node, key = ev["task"], ev["node"], ev.get("key")
        m = self.spec_out.get(task)
        if m is None or key not in m:
            self._bad("speculation", ev["c"],
                      f"spec_promote of {key!r} which is not an "
                      "outstanding speculative copy")
        else:
            del m[key]
            if not m:
                del self.spec_out[task]
        if task in self.outstanding:
            self._bad("speculation", ev["c"],
                      f"spec_promote of {task} while a primary dispatch "
                      "is still outstanding (promotion without a wipe)")
        self.outstanding[task] = node

    def _on_node_quarantine(self, ev: Dict) -> None:
        pass  # informational; capacity semantics ride release events

    def _on_task_done_dup(self, ev: Dict) -> None:
        pass  # informational: a dedup that worked

    def _on_retag(self, ev: Dict) -> None:
        old, new = ev["old"], ev["new"]
        for led in self.ledger.values():
            if old in led:
                led[new] = led.pop(old)
                # the hold key may carry a stale wiped marker from a
                # PREVIOUS incarnation's node death (actor restarts reuse
                # actor-hold-<id>); the fresh entry supersedes it
                self.wiped.discard(new)
                return
        if old in self.wiped:
            self.wiped.discard(old)
            self.wiped.add(new)

    def _on_release(self, ev: Dict) -> None:
        self._release(ev["c"], ev["key"], ev.get("node"))

    def _on_pg_stage(self, ev: Dict) -> None:
        pg = ev["pg"]
        for led in self.ledger.values():
            for key in led:
                if isinstance(key, (tuple, list)) and len(key) == 3 \
                        and key[0] == "pg" and key[1] == pg:
                    self._bad("pg-2pc", ev["c"],
                              f"pg {pg} staged while bundle allocation "
                              f"{key!r} is still outstanding")
        for i, (node, bundle) in enumerate(
            zip(ev.get("nodes") or (), ev.get("bundles") or ())
        ):
            self._alloc(ev["c"], node, ("pg", pg, i), self._res(bundle))

    def _on_pg_reapply(self, ev: Dict) -> None:
        # snapshot-restored bundle re-applied as its node re-registered;
        # ordinal-keyed (bundle indices are not in the snapshot tuple)
        node, pg = ev["node"], ev["pg"]
        n = sum(
            1 for led in self.ledger.values() for key in led
            if isinstance(key, (tuple, list)) and key[0] == "pg"
            and key[1] == pg
        )
        self._alloc(ev["c"], node, ("pg", pg, f"reapply-{n}"),
                    self._res(ev.get("res")))

    def _on_pg_release(self, ev: Dict) -> None:
        pg = ev["pg"]
        for led in self.ledger.values():
            for key in list(led):
                if isinstance(key, (tuple, list)) and len(key) == 3 \
                        and key[0] == "pg" and key[1] == pg:
                    del led[key]
        for key in list(self.wiped):
            if isinstance(key, (tuple, list)) and key and key[0] == "pg" \
                    and key[1] == pg:
                self.wiped.discard(key)

    def _on_pg_created(self, ev: Dict) -> None:
        pass  # allocations persist for the PG's lifetime — nothing to move

    def _on_pg_prepare(self, ev: Dict) -> None:
        if ev.get("ok"):
            self.pg2pc[(ev["node"], ev["pg"], ev["bundle"])] = "PREPARED"

    def _on_pg_commit(self, ev: Dict) -> None:
        key = (ev["node"], ev["pg"], ev["bundle"])
        if not ev.get("ok"):
            return  # refused commit (no surviving prepare): legal outcome
        if not ev.get("transition", True):
            return  # idempotent re-commit of an already-committed bundle
        if self.pg2pc.get(key) != "PREPARED":
            self._bad("pg-2pc", ev["c"],
                      f"bundle {key!r} committed from state "
                      f"{self.pg2pc.get(key, 'IDLE')!r} (commit without "
                      "prepare / commit after abort)")
        self.pg2pc[key] = "COMMITTED"

    def _on_pg_return(self, ev: Dict) -> None:
        self.pg2pc.pop((ev["node"], ev["pg"], ev["bundle"]), None)

    def _on_actor_exec(self, ev: Dict) -> None:
        seq = ev.get("seq")
        if seq is None:
            return
        key = (ev.get("owner"), ev["actor"], ev.get("worker"))
        last = self.actor_seq.get(key)
        if last is not None and int(seq) <= last:
            self._bad("actor-seq", ev["c"],
                      f"actor {ev['actor']} executed seq {seq} after seq "
                      f"{last} for the same caller on the same worker "
                      "(submission-order execution broken)")
        else:
            self.actor_seq[key] = int(seq)

    # --- admission conservation (overload control plane) ---

    def _on_admit(self, ev: Dict) -> None:
        t = ev["task"]
        self.admitted[t] = self.admitted.get(t, 0) + 1

    def _on_admit_exit(self, ev: Dict) -> None:
        t = ev["task"]
        n = self.admitted.get(t, 0) - 1
        if n < 0:
            self._bad("admission", ev["c"],
                      f"task {t} exited the admission ledger without a "
                      "matching admit (exit-without-admit)")
            self.admitted.pop(t, None)
        elif n == 0:
            self.admitted.pop(t, None)
        else:
            self.admitted[t] = n

    def _on_admit_reject(self, ev: Dict) -> None:
        pass  # typed rejection: terminal by construction, never admitted

    def _on_node_drain(self, ev: Dict) -> None:
        pass  # informational; capacity semantics ride release events

    def _on_borrow_reg(self, ev: Dict) -> None:
        self.borrows.add((ev["oid"], ev.get("worker")))

    def _on_borrow_rel(self, ev: Dict) -> None:
        key = (ev["oid"], ev.get("worker"))
        if key not in self.borrows:
            self._bad("borrow", ev["c"],
                      f"borrow release for {key!r} without a registration "
                      "(releases exceed registers)")
            return
        self.borrows.discard(key)

    def _on_obj_put(self, ev: Dict) -> None:
        o = self.objects.setdefault(
            ev["oid"], {"nodes": set(), "freed": None}
        )
        o["nodes"].add(ev.get("node"))
        if o["freed"] is not None:
            o["freed"] = None  # legal re-creation (retry / reconstruction)

    def _on_obj_loc(self, ev: Dict) -> None:
        oid, node = ev["oid"], ev.get("node")
        o = self.objects.get(oid)
        if o is None or node not in o["nodes"]:
            self._bad("object-lifecycle", ev["c"],
                      f"location of {oid[:12]} on {node} recorded without "
                      "a store put on that node")
            return
        if o["freed"] is not None:
            self._bad("object-lifecycle", ev["c"],
                      f"location of {oid[:12]} on {node} re-surfaced after "
                      "free with no re-creation (ghost directory entry)")

    def _on_obj_free(self, ev: Dict) -> None:
        o = self.objects.get(ev["oid"])
        if o is not None:
            o["freed"] = ev["c"]

    # --- compiled-DAG channel alternation (ray_tpu/dag/channel.py) ---

    def _chan(self, key: str) -> Dict[str, Any]:
        return self.channels.setdefault(
            key, {"w": 0, "r": 0, "reads_seen": False, "writes_seen": False}
        )

    def _on_chan_write(self, ev: Dict) -> None:
        st = self._chan(ev["chan"])
        seq = int(ev["seq"])
        st["writes_seen"] = True
        if seq != st["w"] + 1:
            self._bad("channel", ev["c"],
                      f"channel {ev['chan']}: write seq {seq} after seq "
                      f"{st['w']} (gap or duplicate — single-writer seq "
                      "must advance by exactly 1)")
        elif st["reads_seen"] and st["r"] != st["w"]:
            self._bad("channel", ev["c"],
                      f"channel {ev['chan']}: write seq {seq} before frame "
                      f"{st['r'] + 1} was consumed (writer overran the "
                      "reader ack — backpressure broken)")
        st["w"] = max(st["w"], seq)

    def _on_chan_read(self, ev: Dict) -> None:
        st = self._chan(ev["chan"])
        seq = int(ev["seq"])
        st["reads_seen"] = True
        if st["writes_seen"] and seq > st["w"]:
            self._bad("channel", ev["c"],
                      f"channel {ev['chan']}: read seq {seq} before it was "
                      f"written (last write {st['w']}) — read-before-write")
        elif seq != st["r"] + 1:
            self._bad("channel", ev["c"],
                      f"channel {ev['chan']}: read seq {seq} after seq "
                      f"{st['r']} (skipped or re-read a frame)")
        st["r"] = max(st["r"], seq)


def check_trace(path: str, strict_terminal: bool = False) -> List[Violation]:
    """Replay the JSONL trace at ``path`` and return every invariant
    violation (empty list = the run was protocol-clean)."""
    return InvariantChecker().run(read_trace(path), strict_terminal)
