"""Exhaustive word-level model checker for the compiled-DAG seqlock channel.

The GCS explorer machine-checks the control plane; this module gives the
*data plane* — the single-writer/single-reader seqlock shm channel in
``ray_tpu_torch/dag/channel.py`` that every compiled-graph iteration rides —
the same treatment, one abstraction level down: individual header-word
loads/stores and payload copies are the scheduling alphabet, not RPC
deliveries.

Dynamic half. The channel protocol runs as *actor op generators*
(writer, reader, the MultiOutput dual-channel writer with a second
reader, the daemon death-sweep poker, a graceful closer) over a
:class:`VirtualMem` — a virtual channel memory whose every word op is a
step on a controlled schedule. The payload memcpy is deliberately
non-atomic (two chunk micro-ops), so torn frames are representable; each
end tracks its own mapped size, so grow-in-place ``ftruncate``+remap
races are representable; a *kill* step can preempt the writer at any op
(crash consistency: the reader must then see the old intact frame or
``CLOSED|ERROR`` — never a torn or stale-seq frame), after which the
poker models the daemon's death sweep. Schedules are enumerated by the
exact engine ``explore.py`` uses — bounded-depth DFS with
persistent-set conflict pruning (read/write-aware here: two loads of the
same word commute), seeded-random sampling beyond the bound, and
delta-debug shrinking of any violation to a minimal replay file that
``python -m ray_tpu_torch.analysis --replay`` re-executes deterministically.

Static half (what keeps the model honest). The checked model is only as
good as its correspondence to the real code, so
:func:`verify_op_sequences` AST-extracts the op sequences of
``Channel.write`` / ``Channel.read`` / ``Channel.close`` /
``poke_error`` from ``dag/channel.py`` — every ``self._get/_put`` /
``mem.load/store`` / payload / grow / remap call, in source order, with
loop/optional structure — and matches them against
:data:`DECLARED_SEQUENCES`, the same table the actor generators
implement. The companion lint checkers (``chan-raw-header-access``,
``chan-publication-order`` in ``analysis/checkers.py``) enforce that no
code outside the :class:`~ray_tpu_torch.dag.channel.ChannelMem` ops layer
touches header words at all, and that payload stores precede the
``version``/``ack`` publication. Same load-bearing pattern as the
invariant checker's METHOD_TABLE round-trip against ``--dump-protocol``.

``ray_tpu_torch.dag.channel.SEEDED_BUGS`` re-introduces known protocol bugs
(``version-before-payload``, ``skip-remap-reread``) so the harness can
prove it still finds and shrinks them — the regression teeth.

Honesty notes: the model abstracts payload bytes to two seq-stamped
chunks (enough to represent torn/stale reads, not byte contents) and
lengths to small "units"; the adaptive spin/sleep wait collapses to a
single *park* step woken by stores to the watched words (timeouts are
explicit one-shot steps), so real-time behavior — how long a stall
lasts — is out of scope; only event orderings are checked.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import textwrap
import time as _time
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from ray_tpu_torch.analysis.core import chan_word_of
from ray_tpu_torch.analysis.explore import (
    GLOBAL_KEY,
    Chooser,
    ScheduleDiverged,
    dfs_explore,
    shrink_generic,
)
from ray_tpu_torch.analysis.invariants import Violation

#: (channel.SEEDED_BUGS name, scenario that exhibits it) — the ONE table
#: the CI teeth (lint_gate --memmodel), bench.py's detection-cost trail,
#: and the regression tests all iterate; a bug added to
#: channel.SEEDED_BUGS without a row here is invisible to all three
#: (explore_channel accepts unknown names without error).
SEEDED_BUG_SCENARIOS: Tuple[Tuple[str, str], ...] = (
    ("version-before-payload", "spsc-alternation"),
    ("skip-remap-reread", "late-attach-grow"),
)

KNOWN_SEEDED_BUGS = tuple(b for b, _ in SEEDED_BUG_SCENARIOS)

#: header words the model schedules over, in channel.HEADER_LAYOUT
#: order (verify_op_sequences() cross-checks; duplicated here so the
#: model is readable without the runtime tree in scope). ``closed`` and
#: ``error`` are write-once blind-store words.
WORD_NAMES = (
    "magic", "closed", "error", "version", "ack", "len", "wclock",
    "rclock", "capacity", "cpid", "apid",
)


# ------------------------------------------------------ declared model
#
# One entry per op: (kind, target, flags) where kind ∈ {load, store,
# grow, remap}, target is a header word name / "payload" / "", and flags
# is "" (unconditional), "loop" (inside the spin-wait loop — runs ≥ once
# per wakeup), or "opt" (branch-dependent: grow path, tracer installed).
# These tables are BOTH what the actor generators below implement AND
# what verify_op_sequences() matches against the AST of the real
# dag/channel.py — edit one side and the round-trip gate fails.

WRITE_SEQ: Tuple[Tuple[str, str, str], ...] = (
    ("load", "error", "loop"),
    ("load", "closed", "loop"),
    ("load", "version", "loop"),
    ("load", "ack", "loop"),
    ("load", "capacity", ""),
    ("grow", "", "opt"),
    ("store", "capacity", "opt"),
    ("store", "payload", ""),
    ("store", "len", ""),
    ("load", "rclock", "opt"),
    ("store", "wclock", "opt"),
    ("store", "version", ""),
)

# NOTE the load order in the wait loop: ``closed`` strictly before
# ``version``/``ack``. The writer publishes its last commit before
# closing, so closed==1 here implies the version load already sees every
# committed frame; the reversed order (the original code) let a racing
# graceful close drop a committed final frame — found by this checker.
READ_SEQ: Tuple[Tuple[str, str, str], ...] = (
    ("load", "error", "loop"),
    ("load", "closed", "loop"),
    ("load", "ack", "loop"),
    ("load", "version", "loop"),
    ("load", "len", ""),
    ("remap", "", "opt"),
    ("load", "payload", ""),
    ("load", "wclock", "opt"),
    ("store", "rclock", "opt"),
    ("store", "ack", ""),
)

# Blind one-shot stores, NO load: a load-OR-store close() racing
# poke_error() loses whichever bit the slower store did not carry —
# found by this checker (close-vs-poke scenario), fixed by splitting
# the flag word and forbidding the read-modify-write. ``error`` lands
# BEFORE ``closed``: a peer waking between the stores must already see
# the fatal bit rather than drain a death-close like a graceful one.
CLOSE_SEQ: Tuple[Tuple[str, str, str], ...] = (
    ("store", "error", "opt"),
    ("store", "closed", ""),
)

POKE_SEQ: Tuple[Tuple[str, str, str], ...] = (
    ("store", "error", ""),
    ("store", "closed", ""),
)

DECLARED_SEQUENCES: Dict[str, Tuple[Tuple[str, str, str], ...]] = {
    "write": WRITE_SEQ,
    "read": READ_SEQ,
    "close": CLOSE_SEQ,
    "poke_error": POKE_SEQ,
}


# ------------------------------------------------------- virtual memory


class VirtualMem:
    """One channel's virtual shared memory: the header words, the
    payload as two seq-stamped chunks (a non-atomic memcpy), the backing
    file size, and each attached end's mapped size. Lengths are abstract
    *units* (capacity 2 = a frame of len ≤ 2 fits without growing)."""

    def __init__(self, name: str, capacity: int):
        from ray_tpu_torch.dag.channel import MAGIC

        self.name = name
        self.words: Dict[str, int] = {w: 0 for w in WORD_NAMES}
        self.words["magic"] = MAGIC
        self.words["capacity"] = capacity
        self.chunks: List[int] = [0, 0]  # seq that last wrote each half
        self.file_units = capacity
        self.mapped: Dict[str, int] = {}  # actor -> units mapped
        self.epoch: Dict[str, int] = {w: 0 for w in WORD_NAMES}

    def attach(self, actor: str) -> None:
        self.mapped.setdefault(actor, self.words["capacity"])


# ------------------------------------------------------------- actors
#
# Generators yield op tuples (kind, chan, a, b) and receive the op's
# result (loads: the value; park: "woken"/"timeout"). They implement
# DECLARED_SEQUENCES — the payload entry expands to the two chunk
# micro-ops, the spin-wait loop to a park step — and gate on the same
# SEEDED_BUGS names as the real channel code.


def _write_one(world: "ChannelWorld", chan: str, name: str, need: int,
               bugs: FrozenSet[str]):
    """One Channel.write() on ``chan``; returns "ok" / "closed" /
    "timeout" (timeout = zero-commit: nothing of this frame hit shared
    memory, the CompiledDAG.execute rewind precondition)."""
    while True:
        err = yield ("load", chan, "error", None)
        closed = yield ("load", chan, "closed", None)
        if err or closed:
            return "closed"
        version = yield ("load", chan, "version", None)
        ack = yield ("load", chan, "ack", None)
        if ack == version:
            break
        r = yield ("park", chan, ("error", "closed", "ack"), None)
        if r == "timeout":
            return "timeout"
    seq = version + 1
    cap = yield ("load", chan, "capacity", None)
    if need > cap:
        new_cap = max(need, 2 * cap)
        yield ("grow", chan, new_cap, None)
        yield ("store", chan, "capacity", new_cap)
    world.declare_frame(chan, seq, need)
    if "version-before-payload" in bugs:
        # SEEDED BUG mirror of channel.write's gated early publication
        yield ("store", chan, "version", seq)
    yield ("store_chunk", chan, 0, (seq, need))
    yield ("store_chunk", chan, 1, (seq, need))
    yield ("store", chan, "len", need)
    yield ("store", chan, "version", seq)
    return "ok"


def _close_one(chan: str, error: bool = False):
    if error:
        yield ("store", chan, "error", 1)
    yield ("store", chan, "closed", 1)


def _writer(world: "ChannelWorld", name: str, chans: Sequence[str],
            frames: Sequence[int], bugs: FrozenSet[str],
            close_after: bool = True, rewind_on_timeout: bool = False):
    """Stage writer: commits each frame to every channel in ``chans`` in
    order (one channel = plain SPSC; two = the MultiOutput dual-channel
    / partial-input-commit shape), then closes gracefully."""
    fi = 0
    while fi < len(frames):
        for chan in chans:
            r = yield from _write_one(world, chan, name, frames[fi], bugs)
            if r == "closed":
                world.outcome(name, ("closed", fi))
                return
            if r == "timeout":
                world.outcome(name, ("timeout", fi))
                if not rewind_on_timeout:
                    return
                # zero-commit rewind: retry the SAME frame/seq later
                break
        else:
            world.outcome(name, ("committed", fi + 1))
            fi += 1
    if close_after:
        for chan in chans:
            yield from _close_one(chan)
    world.outcome(name, ("done", fi))


def _reader(world: "ChannelWorld", name: str, chan: str,
            bugs: FrozenSet[str]):
    """Driver/stage reader: consumes frames until the channel reports
    CLOSED (drained) or ERROR, recording everything it observed."""
    got: List[int] = []
    while True:
        while True:
            err = yield ("load", chan, "error", None)
            if err:
                world.outcome(name, ("error-closed", tuple(got)))
                return
            closed = yield ("load", chan, "closed", None)
            ack = yield ("load", chan, "ack", None)
            version = yield ("load", chan, "version", None)
            if version > ack:
                break
            if closed:
                world.outcome(name, ("closed-drained", tuple(got)))
                return
            r = yield ("park", chan, ("error", "closed", "version"), None)
            if r == "timeout":
                world.outcome(name, ("timeout", tuple(got)))
                return
        seq = version
        need = yield ("load", chan, "len", None)
        world.check_len(chan, name, seq, need)
        if "skip-remap-reread" not in bugs:
            if need > world.mem(chan).mapped[name]:
                yield ("remap", chan, None, None)
        yield ("load_chunk", chan, 0, (seq, need))
        yield ("load_chunk", chan, 1, (seq, need))
        world.check_seq(chan, name, seq, got)
        yield ("store", chan, "ack", seq)
        got.append(seq)


def _poker(chans: Sequence[str]):
    """The daemon's death sweep: flag every channel of the dead worker's
    DAG CLOSED|ERROR (channel.poke_error per channel)."""
    for chan in chans:
        yield from _close_one(chan, error=True)


def _closer(chans: Sequence[str]):
    """Graceful driver teardown: CLOSED without ERROR (stages drain)."""
    for chan in chans:
        yield from _close_one(chan)


# -------------------------------------------------------------- world


@dataclasses.dataclass
class _Actor:
    name: str
    gen: Any
    pending: Optional[tuple] = None
    label: str = ""
    ops: int = 0
    parked: Optional[Tuple[str, Tuple[str, ...]]] = None  # (chan, words)
    done: bool = False
    killed: bool = False
    #: (chan, word) -> store epoch at this actor's last load of it; a
    #: park is a no-op (stays runnable) when a watched word moved since
    #: the actor's last look — otherwise a store landing between the
    #: spin-loop's reads and the park step would be missed and the actor
    #: would sleep forever on a condition that already holds
    seen_epochs: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class _ExtraStep:
    label: str
    fire: Callable[[], None]
    enabled: Callable[[], bool]
    keys: FrozenSet


class ChannelWorld:
    """One execution of a channel scenario under a controlled schedule:
    the actors' pending ops (plus kill/timeout steps) are the step set;
    every store enforces the word-level invariants; every completed read
    is checked for torn/stale frames."""

    def __init__(self, chooser: Chooser, bugs: Sequence[str] = (),
                 step_limit: int = 300):
        self.chooser = chooser
        self.bugs = frozenset(bugs)
        self.step_limit = step_limit
        self.mems: Dict[str, VirtualMem] = {}
        self.actors: Dict[str, _Actor] = {}
        self.extra: List[_ExtraStep] = []
        self.schedule: List[str] = []
        self.options_at: List[Tuple[str, ...]] = []
        self.keys_of: Dict[str, FrozenSet] = {}
        self.violations: List[Violation] = []
        self.outcomes: Dict[str, List[tuple]] = {}
        self.frame_lens: Dict[Tuple[str, int], int] = {}
        #: version-ordering pairs: (behind, ahead) — chan `behind` may
        #: never commit past chan `ahead` (MultiOutput branch order)
        self.order_pairs: List[Tuple[str, str]] = []
        self.crash_point: Optional[str] = None
        self.stopped_early = False

    # ------------------------------------------------------------ build

    def add_channel(self, name: str, capacity: int) -> None:
        self.mems[name] = VirtualMem(name, capacity)

    def mem(self, chan: str) -> VirtualMem:
        return self.mems[chan]

    def add_actor(self, name: str, gen) -> None:
        a = _Actor(name, gen)
        self.actors[name] = a
        for m in self.mems.values():
            m.attach(name)
        self._advance(a, first=True)

    def add_kill(self, victim: str, spawn_poker_on: Sequence[str]) -> None:
        """A schedulable kill of ``victim`` at ANY of its op positions
        (keys=GLOBAL so the DFS branches it everywhere), followed by the
        daemon death-sweep poker over ``spawn_poker_on``."""

        def fire():
            a = self.actors[victim]
            a.gen.close()
            a.done = True
            a.killed = True
            a.parked = None
            self.crash_point = a.label or "start"
            self.outcome(victim, ("killed-at", a.label))
            self.add_actor("poker", _poker(tuple(spawn_poker_on)))

        self.extra.append(_ExtraStep(
            label=f"kill:{victim}", fire=fire,
            enabled=lambda: not self.actors[victim].done,
            keys=frozenset({GLOBAL_KEY}),
        ))

    def add_timeout(self, target: str) -> None:
        """One-shot deadline expiry for ``target``: wakes its park with
        "timeout" (the ChannelTimeoutError path)."""
        step = _ExtraStep(
            label=f"timeout:{target}", fire=lambda: None,
            enabled=lambda: self.actors[target].parked is not None,
            keys=frozenset({GLOBAL_KEY}),
        )

        def fire(step=step):
            self.extra.remove(step)
            self._wake(self.actors[target], "timeout")

        step.fire = fire
        self.extra.append(step)

    # ------------------------------------------------------- bookkeeping

    def outcome(self, name: str, what: tuple) -> None:
        self.outcomes.setdefault(name, []).append(what)

    def declare_frame(self, chan: str, seq: int, need: int) -> None:
        self.frame_lens[(chan, seq)] = need

    def violate(self, kind: str, msg: str) -> None:
        self.violations.append(Violation(kind, msg, len(self.schedule)))

    def check_len(self, chan: str, reader: str, seq: int,
                  need: int) -> None:
        # checked at the len LOAD (the earliest observable point of a
        # header tear) so violating replays shrink to the minimum prefix
        declared = self.frame_lens.get((chan, seq))
        if declared is not None and declared != need:
            self.violate(
                "torn-frame",
                f"{reader} read seq {seq} on {chan} with len {need}, "
                f"writer declared {declared} (header tear)",
            )

    def check_seq(self, chan: str, reader: str, seq: int,
                  got: List[int]) -> None:
        last = got[-1] if got else 0
        if seq != last + 1:
            self.violate(
                "stale-seq",
                f"{reader} consumed seq {seq} on {chan} after {last} "
                "(dup/skipped frame)",
            )

    # ---------------------------------------------------------- op exec

    def _op_label(self, op: tuple) -> str:
        kind, chan, a, _b = op
        if kind in ("load", "store"):
            return f"{kind}:{chan}.{a}"
        if kind in ("load_chunk", "store_chunk"):
            return f"{kind}:{chan}.{a}"
        if kind == "park":
            return f"park:{chan}." + "+".join(a)
        return f"{kind}:{chan}"

    def _op_keys(self, op: tuple) -> FrozenSet:
        kind, chan, a, _b = op
        if kind == "load":
            return frozenset({("r", chan, a)})
        if kind == "store":
            return frozenset({("w", chan, a)})
        if kind == "load_chunk":
            return frozenset({("r", chan, "payload")})
        if kind == "store_chunk":
            return frozenset({("w", chan, "payload")})
        if kind == "grow":
            return frozenset({("w", chan, "file")})
        if kind == "remap":
            return frozenset({("r", chan, "file")})
        if kind == "park":
            return frozenset(("r", chan, w) for w in a)
        return frozenset({GLOBAL_KEY})

    def _store_invariants(self, mem: VirtualMem, word: str, value: int,
                          actor: str) -> None:
        cur = mem.words[word]
        if word == "magic" and value != cur:
            self.violate("magic-clobber",
                         f"{actor} rewrote magic on {mem.name}")
        elif word in ("closed", "error"):
            if value != 1:
                self.violate(
                    "flag-clear",
                    f"{actor} stored {value} to {word} on {mem.name}; "
                    "closed/error are write-once blind stores of 1 "
                    "(anything else can lose a racing close/poke)",
                )
        elif word == "version":
            if value not in (cur, cur + 1):
                self.violate(
                    "seq-skip",
                    f"{actor} moved version {cur} -> {value} on "
                    f"{mem.name} (must advance by exactly 1)",
                )
            if value > mem.words["ack"] + 1:
                self.violate(
                    "overrun",
                    f"{actor} committed seq {value} on {mem.name} with "
                    f"ack at {mem.words['ack']} (previous frame "
                    "unconsumed — SPSC alternation broken)",
                )
            for behind, ahead in self.order_pairs:
                if mem.name == behind and \
                        value > self.mems[ahead].words["version"]:
                    self.violate(
                        "cross-channel-order",
                        f"{actor} committed seq {value} on {behind} "
                        f"ahead of {ahead} (MultiOutput branch order)",
                    )
        elif word == "ack":
            if value != cur + 1:
                self.violate(
                    "ack-skip",
                    f"{actor} moved ack {cur} -> {value} on {mem.name}",
                )
            if value > mem.words["version"]:
                self.violate(
                    "ack-overrun",
                    f"{actor} acked seq {value} on {mem.name} beyond "
                    f"version {mem.words['version']}",
                )

    def _exec(self, actor: _Actor, op: tuple):
        kind, chan, a, b = op
        mem = self.mems[chan]
        if kind == "load":
            actor.seen_epochs[(chan, a)] = mem.epoch[a]
            return mem.words[a]
        if kind == "store":
            self._store_invariants(mem, a, b, actor.name)
            mem.words[a] = b
            mem.epoch[a] += 1
            for other in self.actors.values():
                if other.parked and other.parked[0] == chan and \
                        a in other.parked[1]:
                    self._wake(other, "woken")
            return None
        if kind == "store_chunk":
            seq, need = b
            if need > mem.mapped[actor.name]:
                self.violate(
                    "stale-mapping",
                    f"{actor.name} wrote payload of len {need} on "
                    f"{chan} with only {mem.mapped[actor.name]} mapped",
                )
            mem.chunks[a] = seq
            return None
        if kind == "load_chunk":
            seq, need = b
            if need > mem.mapped[actor.name]:
                self.violate(
                    "stale-mapping",
                    f"{actor.name} read payload of len {need} on {chan} "
                    f"with only {mem.mapped[actor.name]} mapped (missed "
                    "the grow-in-place remap)",
                )
            stamp = mem.chunks[a]
            # checked per chunk LOAD (earliest observable tear) — see
            # check_len
            if stamp != seq:
                self.violate(
                    "torn-frame",
                    f"{actor.name} read payload chunk {a} of seq {seq} "
                    f"on {chan} stamped {stamp} "
                    + ("(stale payload under a new seq)"
                       if a == 0 or stamp == mem.chunks[0]
                       else "(mid-copy tear)"),
                )
            return stamp
        if kind == "grow":
            mem.file_units = max(mem.file_units, a)
            mem.mapped[actor.name] = mem.file_units
            return None
        if kind == "remap":
            mem.mapped[actor.name] = mem.file_units
            return None
        if kind == "park":
            moved = any(
                mem.epoch[w] > actor.seen_epochs.get((chan, w), 0)
                for w in a
            )
            if moved:
                # a store to a watched word landed between this actor's
                # last look and the park: no-op, stay runnable
                return "woken"
            actor.parked = (chan, tuple(a))
            return None  # result delivered by _wake
        raise AssertionError(f"unknown op {op!r}")

    # ------------------------------------------------------- scheduling

    def _advance(self, actor: _Actor, first: bool = False,
                 send: Any = None) -> None:
        try:
            op = next(actor.gen) if first else actor.gen.send(send)
        except StopIteration:
            actor.done = True
            actor.pending = None
            return
        actor.pending = op
        actor.label = f"{actor.name}.{actor.ops}:{self._op_label(op)}"
        self.keys_of[actor.label] = self._op_keys(op)

    def _wake(self, actor: _Actor, result: str) -> None:
        actor.parked = None
        actor.ops += 1
        self._advance(actor, send=result)

    def _options(self) -> List[Tuple[str, Callable[[], None]]]:
        out: List[Tuple[str, Callable[[], None]]] = []
        for actor in self.actors.values():
            if actor.done or actor.parked is not None or \
                    actor.pending is None:
                continue
            out.append((actor.label, actor))
        for step in self.extra:
            if step.enabled():
                self.keys_of[step.label] = step.keys
                out.append((step.label, step))
        return out

    def _fire(self, chosen: str,
              options: List[Tuple[str, Any]]) -> None:
        target = dict(options)[chosen]
        if isinstance(target, _ExtraStep):
            target.fire()
            return
        actor = target
        op = actor.pending
        result = self._exec(actor, op)
        if op[0] == "park" and actor.parked is not None:
            return  # parked: resume comes through _wake
        actor.ops += 1
        self._advance(actor, send=result)

    def run(self) -> None:
        while True:
            options = self._options()
            if not options:
                parked = [a.name for a in self.actors.values()
                          if a.parked is not None]
                if parked:
                    self.violate(
                        "deadlock",
                        f"actors {parked} parked forever (no step can "
                        "wake them — a CLOSED/ERROR poke was lost?)",
                    )
                return
            if len(self.schedule) >= self.step_limit:
                self.violate(
                    "step-budget",
                    f"step budget exceeded ({self.step_limit}): the "
                    "scenario does not quiesce",
                )
                return
            labels = tuple(label for label, _ in options)
            chosen = self.chooser.choose(labels, at_interleave=False)
            if chosen is None:
                self.stopped_early = True
                return
            self.schedule.append(chosen)
            self.options_at.append(labels)
            self._fire(chosen, options)


# ----------------------------------------------------------- scenarios


@dataclasses.dataclass
class ChannelScenario:
    name: str
    description: str
    build: Callable[[ChannelWorld], None]
    postcheck: Optional[Callable[[ChannelWorld], List[str]]] = None


def _got(world: ChannelWorld, reader: str) -> Optional[Tuple[int, ...]]:
    for what in world.outcomes.get(reader, ()):
        if what[0] in ("closed-drained", "error-closed", "timeout"):
            return tuple(what[1])
    return None


def _check_reader(world: ChannelWorld, reader: str,
                  frames: Tuple[int, ...],
                  require_all: bool) -> List[str]:
    got = _got(world, reader)
    if got is None:
        return [f"{reader} never terminated (no closed/error outcome)"]
    want = tuple(range(1, len(frames) + 1))
    if require_all and got != want:
        return [f"{reader} consumed {got}, expected exactly {want}"]
    if got != want[:len(got)]:
        return [f"{reader} consumed {got}, not a prefix of {want}"]
    return []


def _build_spsc(world: ChannelWorld) -> None:
    world.add_channel("a", capacity=2)
    world.add_actor("writer", _writer(world, "writer", ("a",), (1, 2),
                                      world.bugs))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))


def _post_spsc(world: ChannelWorld) -> List[str]:
    return _check_reader(world, "reader", (1, 2), require_all=True)


def _build_kill(world: ChannelWorld) -> None:
    world.add_channel("a", capacity=2)
    world.add_actor("writer", _writer(world, "writer", ("a",), (1, 1),
                                      world.bugs))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))
    world.add_kill("writer", spawn_poker_on=("a",))


def _post_kill(world: ChannelWorld) -> List[str]:
    return _check_reader(world, "reader", (1, 1), require_all=False)


def _build_grow(world: ChannelWorld) -> None:
    world.add_channel("a", capacity=2)
    world.add_actor("writer", _writer(world, "writer", ("a",), (2, 4),
                                      world.bugs))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))


def _post_grow(world: ChannelWorld) -> List[str]:
    return _check_reader(world, "reader", (2, 4), require_all=True)


def _build_late_attach_grow(world: ChannelWorld) -> None:
    # pre-history: the writer grew the file 2 -> 4 units and committed a
    # len-4 frame BEFORE this world starts, but the reader's mapping
    # predates the grow (open_wait maps the file size at attach time) —
    # its very first read must take the remap path
    world.add_channel("a", capacity=4)
    mem = world.mem("a")
    mem.words["version"] = 1
    mem.words["len"] = 4
    mem.chunks = [1, 1]
    world.declare_frame("a", 1, 4)
    world.add_actor("writer", _writer(world, "writer", ("a",), (1,),
                                      world.bugs))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))
    mem.mapped["reader"] = 2  # attached before the grow


def _post_late_attach_grow(world: ChannelWorld) -> List[str]:
    # frame 1 is the pre-committed big frame, frame 2 the writer's
    return _check_reader(world, "reader", (4, 1), require_all=True)


def _build_close_vs_poke(world: ChannelWorld) -> None:
    world.add_channel("a", capacity=2)
    world.add_actor("writer", _writer(world, "writer", ("a",), (1, 1),
                                      world.bugs, close_after=False))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))
    world.add_actor("closer", _closer(("a",)))
    world.add_actor("poker", _poker(("a",)))


def _post_close_vs_poke(world: ChannelWorld) -> List[str]:
    return _check_reader(world, "reader", (1, 1), require_all=False)


def _build_timeout(world: ChannelWorld) -> None:
    world.add_channel("a", capacity=2)
    world.add_actor("writer", _writer(world, "writer", ("a",), (1, 1),
                                      world.bugs,
                                      rewind_on_timeout=True))
    world.add_actor("reader", _reader(world, "reader", "a", world.bugs))
    world.add_timeout("writer")


def _post_timeout(world: ChannelWorld) -> List[str]:
    # the zero-commit rewind retries the same seq: the reader must see
    # every frame exactly once whether or not the deadline fired
    return _check_reader(world, "reader", (1, 1), require_all=True)


def _build_dual(world: ChannelWorld) -> None:
    # MultiOutput / daemon-owned deposit shape: one writer committing
    # each frame to channel a THEN channel b (CompiledDAG.execute's
    # branch order), two independent readers, death sweep over both
    world.add_channel("a", capacity=2)
    world.add_channel("b", capacity=2)
    world.order_pairs.append(("b", "a"))
    world.add_actor("writer", _writer(world, "writer", ("a", "b"),
                                      (1, 1), world.bugs))
    world.add_actor("reader-a", _reader(world, "reader-a", "a",
                                        world.bugs))
    world.add_actor("reader-b", _reader(world, "reader-b", "b",
                                        world.bugs))
    world.add_kill("writer", spawn_poker_on=("a", "b"))


def _post_dual(world: ChannelWorld) -> List[str]:
    out = _check_reader(world, "reader-a", (1, 1), require_all=False)
    out += _check_reader(world, "reader-b", (1, 1), require_all=False)
    ga, gb = _got(world, "reader-a"), _got(world, "reader-b")
    if ga is not None and gb is not None and len(gb) > len(ga) + 1:
        out.append(
            f"reader-b consumed {gb} while reader-a consumed {ga}: "
            "channel b ran more than one frame ahead of a"
        )
    return out


CHANNEL_SCENARIOS: Dict[str, ChannelScenario] = {
    s.name: s for s in [
        ChannelScenario(
            "spsc-alternation",
            "writer/reader strict alternation over two frames of "
            "different sizes — every word-op interleaving",
            _build_spsc, _post_spsc,
        ),
        ChannelScenario(
            "writer-kill-midcommit",
            "writer killed at ANY op (crash consistency: old frame or "
            "CLOSED|ERROR, never torn) + daemon death-sweep poke",
            _build_kill, _post_kill,
        ),
        ChannelScenario(
            "grow-remap",
            "grow-in-place ftruncate+remap (frame larger than capacity) "
            "racing the reader's mapping re-check",
            _build_grow, _post_grow,
        ),
        ChannelScenario(
            "late-attach-grow",
            "a reader whose mapping predates a grow-in-place must remap "
            "before its first copy (open_wait attach-before-grow)",
            _build_late_attach_grow, _post_late_attach_grow,
        ),
        ChannelScenario(
            "close-vs-poke",
            "graceful CLOSED teardown racing a CLOSED|ERROR death poke "
            "against both (possibly parked) ends",
            _build_close_vs_poke, _post_close_vs_poke,
        ),
        ChannelScenario(
            "timeout-rewind",
            "write deadline expiry with zero frames committed: the "
            "CompiledDAG.execute seq rewind must keep frames aligned",
            _build_timeout, _post_timeout,
        ),
        ChannelScenario(
            "dual-reader-multioutput",
            "one writer, two channels (MultiOutput / daemon deposit), "
            "two readers, kill-at-any-op + sweep over both",
            _build_dual, _post_dual,
        ),
    ]
}


# -------------------------------------------------------------- results


@dataclasses.dataclass
class ChannelRunResult:
    scenario: str
    schedule: List[str]
    options_at: List[Tuple[str, ...]]
    keys_of: Dict[str, FrozenSet]
    violations: List[Violation]
    outcomes: Dict[str, List[tuple]]
    quiesced: bool
    crash_point: Optional[str]

    @property
    def violation_kinds(self) -> Set[str]:
        return {v.kind for v in self.violations}

    def schedule_log(self) -> str:
        return " | ".join(self.schedule)


def run_channel_world(scenario: ChannelScenario, chooser: Chooser,
                      seeded_bugs: Sequence[str] = (),
                      step_limit: int = 300) -> ChannelRunResult:
    """Execute one schedule of ``scenario`` from a fresh virtual
    channel; returns the schedule taken plus every violation (word-level
    invariants, torn/stale frames, deadlocks, unmet postconditions)."""
    world = ChannelWorld(chooser, bugs=seeded_bugs, step_limit=step_limit)
    scenario.build(world)
    world.run()
    quiesced = (
        not world.stopped_early
        and all(a.done for a in world.actors.values())
    )
    if quiesced and scenario.postcheck is not None:
        for msg in scenario.postcheck(world):
            world.violate("postcheck", msg)
    return ChannelRunResult(
        scenario=scenario.name,
        schedule=list(world.schedule),
        options_at=list(world.options_at),
        keys_of=dict(world.keys_of),
        violations=list(world.violations),
        outcomes=dict(world.outcomes),
        quiesced=quiesced,
        crash_point=world.crash_point,
    )


def _process_of(label: str) -> str:
    """Actor name of a step label ("writer.3:store:a.version" ->
    "writer"; extra steps like "kill:writer" are their own process)."""
    return label.split(":", 1)[0].split(".", 1)[0]


def _strip_counter(label: str) -> str:
    """Label without the per-actor op counter ("writer.3:store:a.version"
    -> "writer:store:a.version")."""
    head, _, rest = label.partition(":")
    return f"{_process_of(label)}:{rest}" if rest else head


class _LooseChooser(Chooser):
    """Chooser matching schedule entries by actor + op description,
    ignoring the per-actor op counters. Dropping a redundant spin-wait
    iteration from a counterexample renumbers every later op of that
    actor, so exact-label matching would refuse otherwise-valid shrink
    candidates. Unambiguous: each actor has exactly one pending op."""

    def choose(self, options, at_interleave):
        if self.i < len(self.prefix):
            want = _strip_counter(self.prefix[self.i])
            matches = [o for o in options if _strip_counter(o) == want]
            if not matches:
                raise ScheduleDiverged(
                    f"schedule step {self.i} wants {want!r}; enabled: "
                    f"{[_strip_counter(o) for o in options]}"
                )
            self.i += 1
            return matches[0]
        return super().choose(options, at_interleave)


def _actor_blocks(schedule: List[str]) -> List[Tuple[int, int]]:
    """Maximal same-actor contiguous runs [s, e) of a schedule — the
    removable units a per-actor-counter label scheme allows (e.g. one
    whole wait-loop iteration ending in a park)."""
    out: List[Tuple[int, int]] = []
    s = 0
    for i in range(1, len(schedule) + 1):
        if i == len(schedule) or \
                _process_of(schedule[i]) != _process_of(schedule[s]):
            out.append((s, i))
            s = i
    return out


def _mem_conflicts(a: FrozenSet, b: FrozenSet) -> bool:
    """Read/write-aware conflict relation over op keys: two accesses of
    the same (chan, word) conflict only if at least one writes — two
    loads commute, so the DFS never branches on their order."""
    if GLOBAL_KEY in a or GLOBAL_KEY in b:
        return True
    for ka in a:
        for kb in b:
            if ka[0] == "actor" or kb[0] == "actor":
                if ka == kb:
                    return True
                continue
            if ka[1:] == kb[1:] and "w" in (ka[0], kb[0]):
                return True
    return False


@dataclasses.dataclass
class ChannelExploreResult:
    scenario: str
    schedules_run: int
    dfs_schedules: int
    sampled_schedules: int
    branches_pruned: int
    branches_queued: int
    ops_covered: int
    crash_points: Set[str]
    elapsed_s: float
    violating: Optional[ChannelRunResult] = None
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
            f"{self.ops_covered} ops, "
            f"{len(self.crash_points)} crash points, "
            f"{self.elapsed_s:.2f}s"
        )
        if not self.found:
            return head + " — no violations"
        kinds = sorted({v.kind for v in self.violating.violations})
        n = len(self.shrunk or self.violating.schedule)
        return head + f" — VIOLATION {kinds}, shrunk to {n} ops"


def explore_channel(
    scenario: ChannelScenario,
    max_schedules: int = 400,
    max_depth: Optional[int] = 40,
    samples: int = 100,
    seed: int = 0,
    seeded_bugs: Sequence[str] = (),
    wall_cap_s: Optional[float] = None,
    shrink: bool = True,
    step_limit: int = 300,
) -> ChannelExploreResult:
    """DFS + random-sampling exploration of one channel scenario via the
    shared explore.py engine; rw-aware conflict pruning. Stops at the
    first violating schedule (shrinking it to a minimal replay)."""
    t0 = _time.monotonic()
    ops_covered = 0
    crash_points: Set[str] = set()

    def run_fn(chooser: Chooser) -> ChannelRunResult:
        return run_channel_world(
            scenario, chooser, seeded_bugs=seeded_bugs,
            step_limit=step_limit,
        )

    def on_result(res: ChannelRunResult) -> None:
        nonlocal ops_covered
        ops_covered += len(res.schedule)
        if res.crash_point is not None:
            crash_points.add(res.crash_point)

    stats = dfs_explore(
        run_fn,
        max_schedules=max_schedules,
        max_depth=max_depth,
        samples=samples,
        seed=seed,
        wall_cap_s=wall_cap_s,
        conflicts=_mem_conflicts,
        process_of=_process_of,
        on_result=on_result,
    )
    violating = stats.violating
    result = ChannelExploreResult(
        scenario=scenario.name,
        schedules_run=stats.dfs_runs + stats.sampled_runs,
        dfs_schedules=stats.dfs_runs,
        sampled_schedules=stats.sampled_runs,
        branches_pruned=stats.pruned,
        branches_queued=stats.queued,
        ops_covered=ops_covered,
        crash_points=crash_points,
        elapsed_s=_time.monotonic() - t0,
        violating=violating,
    )
    if violating is not None and shrink:
        kinds = violating.violation_kinds
        # postcheck/deadlock violations only exist at quiescence: shrink
        # those with the default tail instead of truncation
        stop_after = not (kinds & {"postcheck", "deadlock"})
        shrunk, viol = shrink_generic(
            run_fn, violating.schedule, kinds, stop_after,
            chooser_factory=lambda prefix, stop: _LooseChooser(
                prefix, stop_after=stop
            ),
            blocks_of=_actor_blocks,
        )
        result.shrunk = shrunk
        result.shrunk_violations = viol
        result.shrunk_stop_after = stop_after
    return result


def explore_all_channels(
    names: Optional[Sequence[str]] = None, **kw
) -> Dict[str, ChannelExploreResult]:
    out: Dict[str, ChannelExploreResult] = {}
    for name in names or sorted(CHANNEL_SCENARIOS):
        out[name] = explore_channel(CHANNEL_SCENARIOS[name], **kw)
    return out


# --------------------------------------------------------------- replay


def write_channel_replay(path: str, result: ChannelExploreResult,
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
            "kind": "memmodel",
            "scenario": result.scenario,
            "seeded_bugs": sorted(seeded_bugs),
            "stop_after": result.shrunk_stop_after,
            "schedule": schedule,
            "violation_kinds": sorted({v.kind for v in (viols or [])}),
            "violations": [v.format() for v in (viols or [])],
        }, f, indent=2)
        f.write("\n")


def replay_channel(path: str) -> ChannelRunResult:
    """Re-execute a recorded memmodel counterexample deterministically."""
    with open(path, "r", encoding="utf-8") as f:
        rec = json.load(f)
    if rec.get("kind") != "memmodel":
        raise ValueError(f"{path} is not a memmodel replay")
    scenario = CHANNEL_SCENARIOS.get(rec["scenario"])
    if scenario is None:
        raise ValueError(f"unknown channel scenario {rec['scenario']!r}")
    return run_channel_world(
        scenario,
        _LooseChooser(rec["schedule"],
                      stop_after=rec.get("stop_after", True)),
        seeded_bugs=rec.get("seeded_bugs", ()),
    )


# ------------------------------------------------- static round-trip
#
# AST-extract the op sequences of the real Channel.write/read/close and
# poke_error, in source order with loop/optional structure, and match
# them against DECLARED_SEQUENCES — the same load-bearing pattern as the
# METHOD_TABLE round-trip: the model checker above exercises the
# DECLARED tables, this gate pins the tables to the shipped code.

_OP_ATTRS = {
    "_get": "load", "load": "load",
    "_put": "store", "store": "store",
}
_PAYLOAD_ATTRS = {
    "write_payload": ("store", "payload"),
    "read_payload": ("load", "payload"),
    "grow": ("grow", ""),
    "remap": ("remap", ""),
}


# chan_word_of (analysis/core.py) is the ONE word-constant recognizer,
# shared with the chan-publication-order checker


def _test_mentions(node: ast.AST, ident: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == ident
        for n in ast.walk(node)
    )


def _seeded_branch_kind(test: ast.AST) -> Optional[str]:
    """For an ``if`` gated on SEEDED_BUGS: "in" (bug-injection body —
    skip it) or "not-in" (the body IS the unseeded path — keep it)."""
    if not _test_mentions(test, "SEEDED_BUGS"):
        return None
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        if isinstance(test.ops[0], ast.NotIn):
            return "not-in"
        if isinstance(test.ops[0], ast.In):
            return "in"
    return "in"  # unknown shape: treat as injected, skip


def extract_op_sequence(
    fn: ast.FunctionDef,
) -> List[Tuple[str, str, str]]:
    """The ordered (kind, target, flags) word-op sequence of one
    channel-protocol function, flags ∈ {"", "loop", "opt"}."""
    ops: List[Tuple[str, str, str]] = []

    def flags_str(loop: bool, opt: bool) -> str:
        if opt:
            return "opt"
        return "loop" if loop else ""

    def visit_expr(node: ast.AST, loop: bool, opt: bool) -> None:
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _OP_ATTRS and node.args:
                word = chan_word_of(node.args[0])
                if word is not None:
                    # a store's value expression evaluates first: any
                    # loads inside it precede the store itself
                    for arg in node.args[1:]:
                        visit_expr(arg, loop, opt)
                    ops.append((_OP_ATTRS[attr], word,
                                flags_str(loop, opt)))
                    return
            if attr in _PAYLOAD_ATTRS:
                for arg in node.args:
                    visit_expr(arg, loop, opt)
                kind, target = _PAYLOAD_ATTRS[attr]
                ops.append((kind, target, flags_str(loop, opt)))
                return
        for child in ast.iter_child_nodes(node):
            visit_expr(child, loop, opt)

    def visit_stmts(stmts: Sequence[ast.stmt], loop: bool,
                    opt: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.While):
                visit_expr(stmt.test, True, opt)
                visit_stmts(stmt.body, True, opt)
                visit_stmts(stmt.orelse, loop, True)
            elif isinstance(stmt, ast.For):
                visit_stmts(stmt.body, True, opt)
            elif isinstance(stmt, ast.If):
                seeded = _seeded_branch_kind(stmt.test)
                if seeded == "in":
                    visit_stmts(stmt.orelse, loop, opt)
                    continue
                if seeded == "not-in":
                    # the guarded body is the normal (unseeded) path
                    visit_stmts(stmt.body, loop, opt)
                    visit_stmts(stmt.orelse, loop, True)
                    continue
                if _test_mentions(stmt.test, "_CRASH_AT"):
                    continue  # chaos hook: no protocol ops inside
                visit_expr(stmt.test, loop, opt)
                visit_stmts(stmt.body, loop, True)
                visit_stmts(stmt.orelse, loop, True)
            elif isinstance(stmt, ast.Try):
                visit_stmts(stmt.body, loop, opt)
                for h in stmt.handlers:
                    visit_stmts(h.body, loop, True)
                visit_stmts(stmt.orelse, loop, opt)
                visit_stmts(stmt.finalbody, loop, opt)
            elif isinstance(stmt, ast.With):
                visit_stmts(stmt.body, loop, opt)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # nested defs run later, not here
            else:
                visit_expr(stmt, loop, opt)

    visit_stmts(fn.body, False, False)
    return ops


def channel_op_sequences(
    source: Optional[str] = None,
) -> Dict[str, List[Tuple[str, str, str]]]:
    """Extract the op sequences of Channel.write/read/close and
    poke_error from dag/channel.py (or ``source`` for tests)."""
    if source is None:
        from ray_tpu_torch.dag import channel as _chan

        with open(_chan.__file__, "r", encoding="utf-8") as f:
            source = f.read()
    tree = ast.parse(textwrap.dedent(source))
    out: Dict[str, List[Tuple[str, str, str]]] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Channel":
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \
                        item.name in ("write", "read", "close"):
                    out[item.name] = extract_op_sequence(item)
        elif isinstance(node, ast.FunctionDef) and \
                node.name == "poke_error":
            out[node.name] = extract_op_sequence(node)
    return out


def verify_op_sequences(source: Optional[str] = None) -> List[str]:
    """Round-trip gate: the real channel code's extracted op sequences
    must equal DECLARED_SEQUENCES (and the header word names must cover
    the declared layout). Returns mismatch descriptions; empty = ok."""
    problems: List[str] = []
    try:
        from ray_tpu_torch.dag.channel import HEADER_LAYOUT

        layout_names = tuple(name for name, _ in HEADER_LAYOUT)
        if layout_names != WORD_NAMES:
            problems.append(
                "memmodel WORD_NAMES disagree with channel.HEADER_LAYOUT: "
                f"{WORD_NAMES} vs {layout_names}"
            )
    except Exception as e:  # noqa: BLE001 - import trouble IS a finding
        problems.append(f"cannot import dag/channel.py layout: {e}")
    extracted = channel_op_sequences(source)
    for name, declared in DECLARED_SEQUENCES.items():
        got = extracted.get(name)
        if got is None:
            problems.append(f"channel.py has no function {name!r}")
            continue
        if tuple(got) != tuple(declared):
            problems.append(
                f"op sequence of {name}() diverged from the checked "
                f"model:\n  declared: {list(declared)}\n  extracted: "
                f"{got}"
            )
    return problems
