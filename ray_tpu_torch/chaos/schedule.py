"""Deterministic fault schedules for the control plane.

A ``FaultSchedule`` is a seeded set of rules consulted from hook points in
``cluster/rpc.py`` (client send, server recv, server send) and from
``step()`` hooks in the test harnesses (process kills). Every decision is a
pure function of ``(seed, rule, stream, frame_index)`` — no shared RNG
state — so two runs with the same seed make identical decisions for the
nth frame of any given stream regardless of thread interleaving, and the
recorded fault trace (sorted per stream) is byte-identical across runs.

Endpoints are named: servers carry their ``name`` ("gcs", "daemon-..."),
clients carry ``name``/``peer`` labels (a daemon's node id, a driver's
worker id). Rules match endpoints with fnmatch globs, so
``reset(src="driver*", dst="gcs")`` targets every driver's GCS connection
and ``partition(src="node-3", dst="gcs")`` is a one-way partition.

Only the stdlib is used here, and nothing from ``ray_tpu.cluster`` is
imported at module level: the RPC layer guards every hook behind a single
``if CHAOS is not None`` check, so this module stays importable (and the
hot path stays zero-overhead) whether or not injection is active.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

#: hook names, for reference: client_send | server_recv | server_send |
#: step | exec (worker-side task-execution hook, see ``slow``)
HOOKS = ("client_send", "server_recv", "server_send", "step", "exec")

#: fault kinds a rule can inject
KINDS = ("drop", "delay", "duplicate", "reset", "partition", "kill", "slow")

# Process-level kill-target registry: harnesses (Cluster.add_node, soak
# scripts) register targets HERE unconditionally, so a schedule installed
# after cluster construction still finds them. Per-schedule registrations
# (FaultSchedule.register_kill) shadow these.
_KILL_TARGETS: Dict[str, Callable[[], None]] = {}


def register_kill(target: str, fn: Callable[[], None]) -> None:
    _KILL_TARGETS[target] = fn


def unregister_kill(target: str, fn: Optional[Callable] = None) -> None:
    """Remove a kill target. Pass the callable you registered to make the
    removal owner-safe: a second harness re-registering the same name must
    not have its live entry deleted by the first harness's teardown."""
    if fn is None or _KILL_TARGETS.get(target) is fn:
        _KILL_TARGETS.pop(target, None)


@dataclasses.dataclass
class Rule:
    """One fault rule. Fires on frames matching (hook, src, dst, method)
    when the trigger condition holds:

    - ``at``: exactly the ``at``-th matching frame of the stream
    - ``frm``/``until``: every frame with ``frm <= n < until`` (partitions)
    - ``p``: each frame independently with probability ``p``, decided by a
      seeded hash of the stream key and frame index (deterministic)
    """

    kind: str
    src: str = "*"
    dst: str = "*"
    method: Optional[str] = None  # None matches every method/channel
    hook: Optional[str] = None  # None matches every hook point
    p: float = 0.0
    at: Optional[int] = None
    frm: int = 0
    until: Optional[int] = None
    delay_s: float = 0.05
    target: Optional[str] = None  # kill rules: registered kill-target name
    # slow rules: execution-time multiplier injected at the worker exec
    # hook (1.0 = no-op; float("inf") wedges the task forever — the
    # gray-failure "alive but never finishes" mode)
    factor: float = 1.0

    def matches(self, hook: str, src: str, dst: str,
                method: Optional[str]) -> bool:
        # exec consults pair exclusively with slow rules: a generic
        # hook=None rule (e.g. drop(p=...)) must not fire on — or shadow —
        # the worker execution stream, and vice versa
        if (hook == "exec") != (self.kind == "slow"):
            return False
        if self.hook is not None and self.hook != hook:
            return False
        if self.method is not None and self.method != method:
            return False
        return fnmatch.fnmatchcase(src, self.src) and fnmatch.fnmatchcase(
            dst, self.dst
        )

    def fires(self, seed: int, rule_idx: int, key: Tuple, n: int) -> bool:
        if self.at is not None:
            return n == self.at
        if self.kind == "partition" or self.until is not None or self.frm:
            return n >= self.frm and (self.until is None or n < self.until)
        if self.p > 0.0:
            return _chance(seed, rule_idx, key, n) < self.p
        return False

    def to_spec(self) -> Dict:
        out = {"kind": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name != "kind" and v != f.default:
                out[f.name] = v
        return out


def _chance(seed: int, rule_idx: int, key: Tuple, n: int) -> float:
    """Uniform [0,1) drawn purely from identity — the determinism core."""
    h = hashlib.blake2b(
        repr((seed, rule_idx, key, n)).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


# ------------------------------------------------------- rule constructors


def drop(src: str = "*", dst: str = "*", p: float = 0.0,
         at: Optional[int] = None, method: Optional[str] = None,
         hook: Optional[str] = None) -> Rule:
    """Silently discard a frame (request, response, or push)."""
    return Rule("drop", src=src, dst=dst, p=p, at=at, method=method, hook=hook)


def delay(src: str = "*", dst: str = "*", p: float = 0.0,
          at: Optional[int] = None, delay_s: float = 0.05,
          method: Optional[str] = None, hook: Optional[str] = None) -> Rule:
    """Stall a frame for ``delay_s`` before letting it through."""
    return Rule("delay", src=src, dst=dst, p=p, at=at, delay_s=delay_s,
                method=method, hook=hook)


def duplicate(src: str = "*", dst: str = "*", p: float = 0.0,
              at: Optional[int] = None, method: Optional[str] = None,
              hook: Optional[str] = None) -> Rule:
    """Deliver a frame twice (tests at-least-once / dedupe paths)."""
    return Rule("duplicate", src=src, dst=dst, p=p, at=at, method=method,
                hook=hook)


def reset(src: str = "*", dst: str = "*", p: float = 0.0,
          at: Optional[int] = None, method: Optional[str] = None,
          hook: Optional[str] = None) -> Rule:
    """Tear the connection down mid-stream (RST-style)."""
    return Rule("reset", src=src, dst=dst, p=p, at=at, method=method,
                hook=hook)


def partition(src: str, dst: str, frm: int = 0,
              until: Optional[int] = None) -> Rule:
    """One-way partition: drop every src->dst frame with index in
    [frm, until). ``until=None`` partitions forever."""
    return Rule("partition", src=src, dst=dst, frm=frm, until=until)


def kill_at(label: str, at: int, target: str) -> Rule:
    """Kill the registered ``target`` process on the ``at``-th ``step()``
    consult carrying ``label`` (see FaultSchedule.register_kill)."""
    return Rule("kill", src=label, hook="step", at=at, target=target)


def kill(label: str = "*", p: float = 0.0, target: Optional[str] = None) -> Rule:
    return Rule("kill", src=label, hook="step", p=p, target=target)


def slow(node: str = "*", factor: float = 10.0, p: float = 1.0,
         method: Optional[str] = None, frm: int = 0,
         until: Optional[int] = None) -> Rule:
    """Gray failure: multiply task execution time on matching nodes by
    ``factor`` (consulted at the worker ``exec`` hook; ``method`` matches
    the task's function name). ``factor=float("inf")`` wedges the task
    forever — the node stays ALIVE on heartbeats while never finishing.
    Default ``p=1.0``: a gray node is slow on *every* task, not
    probabilistically."""
    return Rule("slow", src=node, hook="exec", p=p, method=method,
                frm=frm, until=until, factor=factor)


# ------------------------------------------------------------ the schedule


class FaultSchedule:
    """Seeded, deterministic fault-injection plane.

    Install with ``ray_tpu.chaos.install(schedule)``; the RPC layer then
    consults it at each hook point. Decisions and the recorded trace are
    deterministic per stream (see module docstring)."""

    def __init__(self, seed: int = 0, rules: Optional[List[Rule]] = None):
        self.seed = int(seed)
        self.rules = list(rules or ())
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, int] = {}  # stream key -> frames seen
        self._records: List[Tuple] = []  # (hook, src, dst, n, method, kind)
        self._kill_targets: Dict[str, Callable[[], None]] = {}
        self.consults = 0  # total hook consults (observability/tests)

    # ------------------------------------------------------------- hooks

    def on_client_send(self, src: str, dst: str,
                       method: Optional[str]) -> Optional[Rule]:
        return self._consult("client_send", src, dst, method)

    def on_server_recv(self, src: str, dst: str,
                       method: Optional[str]) -> Optional[Rule]:
        return self._consult("server_recv", src, dst, method)

    def on_server_send(self, src: str, dst: str,
                       channel: Optional[str]) -> Optional[Rule]:
        return self._consult("server_send", src, dst, channel)

    def on_exec(self, node: str, method: Optional[str]) -> float:
        """Worker-side task-execution hook: returns the execution-delay
        factor for this task (1.0 = run at full speed). Consulted once per
        task execution; the frame counter advances per (node, method)
        stream, so decisions stay deterministic per stream like every
        other hook. The first matching slow rule wins."""
        rule = self._consult("exec", node, "*", method)
        if rule is not None and rule.kind == "slow":
            return float(rule.factor)
        return 1.0

    def step(self, label: str) -> Optional[Rule]:
        """Process-level hook (test harness loops): consults kill rules.
        A fired rule with a registered ``target`` (on this schedule, or in
        the process-level registry) runs its kill callback on a fresh
        thread (kills are slow; the calling loop must not stall)."""
        rule = self._consult("step", label, "*", None)
        if rule is not None and rule.kind == "kill" and rule.target:
            fn = self._kill_targets.get(rule.target) or _KILL_TARGETS.get(
                rule.target
            )
            if fn is not None:
                threading.Thread(
                    target=fn, daemon=True, name=f"chaos-kill-{rule.target}"
                ).start()
        return rule

    def _consult(self, hook: str, src: str, dst: str,
                 method: Optional[str]) -> Optional[Rule]:
        key = (hook, src, dst, method)
        with self._lock:
            self.consults += 1
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
        for i, rule in enumerate(self.rules):
            if not rule.matches(hook, src, dst, method):
                continue
            if rule.fires(self.seed, i, key, n):
                with self._lock:
                    self._records.append(
                        (hook, src, dst, n, method or "", rule.kind)
                    )
                return rule
        return None

    # ----------------------------------------------------- kills & trace

    def register_kill(self, target: str, fn: Callable[[], None]) -> None:
        """Name a killable process; ``kill``/``kill_at`` rules reference it
        by ``target``."""
        self._kill_targets[target] = fn

    def trace(self) -> List[Tuple]:
        """Fired faults, sorted per stream: deterministic for a fixed seed
        whenever each stream sees the same frames in the same order."""
        with self._lock:
            return sorted(self._records)

    def trace_text(self) -> str:
        """The trace as bytes-comparable text (one fault per line)."""
        return "\n".join(
            f"{hook} {src}->{dst} #{n} {method} {kind}"
            for hook, src, dst, n, method, kind in self.trace()
        )

    # -------------------------------------------------------------- spec

    def to_spec(self) -> Dict:
        return {"seed": self.seed, "rules": [r.to_spec() for r in self.rules]}

    @classmethod
    def from_spec(cls, spec: Dict) -> "FaultSchedule":
        """Inverse of to_spec; the RAY_TPU_CHAOS_SPEC env payload format."""
        rules = []
        for r in spec.get("rules", ()):
            r = dict(r)
            kind = r.pop("kind")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            rules.append(Rule(kind, **r))
        return cls(seed=int(spec.get("seed", 0)), rules=rules)
