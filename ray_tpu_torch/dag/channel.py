"""Single-writer single-reader mutable channels for compiled DAGs.

Reference: Ray Compiled Graphs (aDAG) pre-allocate one *mutable* plasma
object per DAG edge and drive iterations by rewriting it in place
(python/ray/experimental/channel/), so the steady-state loop never touches
the control plane. Same design here, adapted to this repo's store: the
native shm segment hands non-creating processes read-only views, so a
channel cannot live inside it — each edge instead gets its own small
file-backed shm mapping (``mmap`` over a file under the daemon's channel
dir, tmpfs when session_dir_root points there), which every same-host
process can map read-write. Cross-node edges fall back to a push over the
daemon RPC transfer path (``rpc_dag_push`` / ``rpc_dag_pull``).

Seqlock layout (128-byte header, little-endian u64 words, payload after).
:data:`HEADER_LAYOUT` below is the single source of truth — the runtime
word offsets (``_W_*``), this table, and the ``analysis/memmodel.py``
checker's virtual memory are all derived from it:

====  =========  ====================================================
word  name       meaning
====  =========  ====================================================
0     magic      0x52544348 ("RTCH"); readers poll for it (creation)
1     closed     1 = closed gracefully (peer drains, then raises)
2     error      1 = peer died (pending frames are DROPPED, not drained)
3     version    seq of the last committed frame (0 = none yet)
4     ack        seq of the last consumed frame
5     len        payload byte length of the current frame
6     wclock     writer's Lamport clock at commit (trace merge)
7     rclock     reader's Lamport clock at ack (trace merge)
8     capacity   payload-area size; readers remap when len exceeds
                 what they mapped (writer grows the file in place)
9     cpid       creator (writer) end's os pid — stall attribution
10    apid       attacher (reader) end's os pid (0 = never attached)
====  =========  ====================================================

Protocol (strict alternation — the invariant the exec loop traces):
the writer blocks until ``ack == version`` (reader consumed the previous
frame: backpressure), writes payload then bumps ``version``; the reader
blocks on a version bump, copies the payload, then advances ``ack``.
Blocking is adaptive polling (spin, then sleep) — same-host latency is a
few microseconds and no cross-process futex is portable from Python.

``closed`` and ``error`` are SEPARATE words, each only ever blind-stored
to 1, never read-modify-written: the memmodel checker proved the
earlier single-``flags``-word design loses bits when a graceful
teardown ``close()`` races the daemon death sweep's :func:`poke_error`
(both did load-OR-store; the loser's store clears the winner's bit —
e.g. ERROR dropped, turning "peer died" into a clean drain). Blind
one-shot stores to distinct words cannot lose updates without needing a
cross-process CAS Python does not have. The reader's wait loop also
samples ``closed`` BEFORE ``version`` — in program order the writer
publishes ``version`` before ``closed``, so a reader that saw
``closed == 0`` re-polls, and a reader that sees ``closed == 1`` is
guaranteed to also see every prior commit; the first memmodel run
caught the reversed order dropping a committed final frame
("closed AND drained" judged from a stale ``version`` snapshot).

Every header-word load/store and payload copy goes through the
:class:`ChannelMem` ops layer (:class:`MmapMem` in production; the
memmodel checker substitutes a virtual memory with controlled
scheduling). The ``chan-raw-header-access`` lint rejects any raw
struct/mmap access outside a ``*Mem`` class, and the memmodel round-trip
gate AST-extracts the op sequences of :meth:`Channel.write` /
:meth:`Channel.read` / :meth:`Channel.close` / :func:`poke_error` and
matches them against the checker's declared model — the code below IS
the checked protocol.

The memmodel checker, the lint rules and the overhead gates named here
and below are the reference package's tooling (``ray_tpu/analysis``,
``bench.py``), not ported: this module keeps the op sequences they checked
unchanged, and ``tests/test_torch_dag.py`` holds the header layout and the
frames to the reference's channel on one file.

Happens-before: ``wclock``/``rclock`` carry each side's Lamport clock
through the shared memory (frames here never cross the RPC layer, so the
tracer's usual ``_lc`` piggyback cannot order them); each side merges the
peer's clock before emitting its ``chan_write``/``chan_read`` apply event,
so the offline invariant checker sees reads sorted after their writes.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from typing import Callable, Optional, Tuple

from ray_tpu_torch.core.exceptions import GetTimeoutError, RayTpuError
from ray_tpu_torch.util import metrics as _metrics

# --- observability (ray_tpu_torch.obs): the compiled-graph hot loop's metrics.
# This is a microsecond-scale data plane under GIL contention with a
# parked peer — per-frame registry work (tag dicts, locks) measurably
# widens the SPSC handoff window (the peer sleeps in 0.2–2ms quanta; miss
# the wake window, pay a quantum). Each channel END therefore accumulates
# into plain non-shared Python attributes (SPSC: one thread per end) and
# flushes to the registry once every ``_FLUSH_EVERY`` frames via the
# precomputed-key fast path; stall distribution is sampled on the same
# cadence. bench.py obs_overhead gates the loop at <3% overhead.
_STALL_BUCKETS = (
    0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0,
)
_M_WRITE_STALL = _metrics.Histogram(
    "ray_tpu_dag_chan_write_stall_s",
    "channel write wait for the reader ack (backpressure; 1-in-64 sample)",
    boundaries=_STALL_BUCKETS,
)
_M_READ_STALL = _metrics.Histogram(
    "ray_tpu_dag_chan_read_stall_s",
    "channel read wait for the writer's commit (1-in-64 sample)",
    boundaries=_STALL_BUCKETS,
)
_M_FRAMES = _metrics.Counter(
    "ray_tpu_dag_chan_frames_total",
    "frames committed through dag channels in this process",
)
_M_CHAN_BYTES = _metrics.Counter(
    "ray_tpu_dag_chan_bytes_total",
    "payload bytes committed through dag channels in this process",
)
_M_WRITE_STALL_SECONDS = _metrics.Counter(
    "ray_tpu_dag_chan_write_stall_seconds_total",
    "total seconds channel writes spent waiting for reader acks",
)
_M_READ_STALL_SECONDS = _metrics.Counter(
    "ray_tpu_dag_chan_read_stall_seconds_total",
    "total seconds channel reads spent waiting for writer commits",
)
_M_CHAN_FILL = _metrics.Gauge(
    "ray_tpu_dag_chan_fill_ratio",
    "last flushed frame's payload size / channel capacity (occupancy)",
)
_NOTAG = _M_FRAMES.series_key()
_FLUSH_EVERY = 64

MAGIC = 0x52544348  # "RTCH"
HDR = 128

#: Single source of truth for the seqlock header: ``(name, meaning)``
#: per u64 word, in layout order. The ``_W_*`` struct offsets, the module
#: docstring table, and ``analysis/memmodel.py``'s virtual memory are all
#: derived from (or test-checked against) this table. The header reserves
#: 128 bytes, so up to 16 words fit without a layout version bump.
#: ``closed``/``error`` are write-once blind-store words — see the
#: protocol notes in the module docstring.
HEADER_LAYOUT: Tuple[Tuple[str, str], ...] = (
    ("magic", 'creation sentinel 0x52544348 ("RTCH"); readers poll for it'),
    ("closed", "1 = closed gracefully (peer drains, then raises)"),
    ("error", "1 = peer died (pending frames dropped, not drained)"),
    ("version", "seq of the last committed frame (0 = none yet)"),
    ("ack", "seq of the last consumed frame"),
    ("len", "payload byte length of the current frame"),
    ("wclock", "writer's Lamport clock at commit (trace merge)"),
    ("rclock", "reader's Lamport clock at ack (trace merge)"),
    ("capacity", "payload-area size; readers remap when len exceeds it"),
    ("cpid", "creator (writer) end's os pid, stamped in create()"),
    ("apid", "attacher (reader) end's os pid, stamped in open_wait()"),
)

WORDS = {name: i for i, (name, _) in enumerate(HEADER_LAYOUT)}

_W_MAGIC = WORDS["magic"]
_W_CLOSED = WORDS["closed"]
_W_ERROR = WORDS["error"]
_W_VERSION = WORDS["version"]
_W_ACK = WORDS["ack"]
_W_LEN = WORDS["len"]
_W_WCLOCK = WORDS["wclock"]
_W_RCLOCK = WORDS["rclock"]
_W_CAP = WORDS["capacity"]
_W_CPID = WORDS["cpid"]
_W_APID = WORDS["apid"]

_U64 = struct.Struct("<Q")

#: Test-only regression switch (mirror of ``gcs.SEEDED_BUGS``): known,
#: fixed-by-construction protocol bugs the memmodel checker must find and
#: shrink to prove it earns its keep. Names:
#:
#: - ``version-before-payload``: publish the new seq BEFORE the payload
#:   lands (the classic seqlock torn-read bug);
#: - ``skip-remap-reread``: skip the reader's grow-in-place remap check,
#:   so a frame larger than the reader's mapping reads stale bytes.
SEEDED_BUGS: set = set()

#: Wait-graph seam (mirror of ``rpc.TRACE`` / ``racer.RACER``): an
#: installed wait-for sanitizer (the reference's ``WaitSanitizer``; the port
#: has none of its own, so this stays None unless a test installs one).
#: Consulted only when a wait loop crosses into its SLOW park tier
#: (``spins == spin_hot`` — once per wait, never on the hot path), plus
#: once per end at create/attach. A parked channel end is otherwise
#: indistinguishable from a wedged one to every other layer; the
#: park-begin/park-end stamps let stall attribution name the channel,
#: its peer end's pid and the last committed seq.
PARKWATCH = None

# Chaos hook for the worker-kill-at-mid-commit test: when set (env
# RAY_TPU_CHAN_CRASH_AT, honored only in daemon-spawned worker processes
# so a driver/test process never self-kills), write() hard-exits at the
# named point. "pre-version" = after the payload+len stores, before the
# version bump — the torn-commit window crash consistency must cover.
_CRASH_AT = (
    os.environ.get("RAY_TPU_CHAN_CRASH_AT")
    if os.environ.get("RAY_TPU_WORKER_ID") else None
)


class ChannelClosedError(RayTpuError):
    """The peer end of a compiled-DAG channel is gone (teardown, or a
    pinned worker / its node died mid-iteration)."""


class ChannelTimeoutError(GetTimeoutError):
    """A channel read/write exceeded its deadline."""


class ChannelMem:
    """The channel's word-operation seam: every header-word load/store,
    payload copy, and grow/remap goes through one of these. Production is
    :class:`MmapMem` (raw mmap over the channel file); the memmodel
    checker substitutes a virtual memory whose every op is a scheduling
    point, and tests can wrap any impl in a recording shim. The analog of
    ``cluster/runtime.py``'s runtime seam, one layer down."""

    def load(self, word: int) -> int:
        raise NotImplementedError

    def store(self, word: int, value: int) -> None:
        raise NotImplementedError

    def read_payload(self, length: int) -> bytes:
        raise NotImplementedError

    def write_payload(self, payload: bytes) -> None:
        raise NotImplementedError

    def grow(self, new_capacity: int) -> None:
        """Grow the backing file to ``HDR + new_capacity`` and extend
        this end's mapping over it."""
        raise NotImplementedError

    def remap(self) -> None:
        """Re-check the backing file size and extend this end's mapping
        (the reader's half of grow-in-place)."""
        raise NotImplementedError

    def size(self) -> int:
        """Bytes this end currently has mapped (header included)."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class MmapMem(ChannelMem):
    """Production ops layer: a raw ``mmap`` over the channel file. The
    ONLY code in ``dag/``/``object_store/`` allowed to touch header words
    or payload bytes directly — ``chan-raw-header-access`` enforces it."""

    def __init__(self, path: str, mm: mmap.mmap, fd: int):
        self.path = path
        self._mm = mm
        self._fd = fd

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def create(cls, path: str, capacity: int) -> "MmapMem":
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
        os.ftruncate(fd, HDR + capacity)
        mm = mmap.mmap(fd, HDR + capacity)
        return cls(path, mm, fd)

    @classmethod
    def open(cls, path: str, length: int = 0) -> Optional["MmapMem"]:
        """Map an existing channel file (``length`` 0 = whole file);
        returns None when the file is still smaller than the header."""
        fd = os.open(path, os.O_RDWR)
        size = os.fstat(fd).st_size
        if size < HDR:
            os.close(fd)
            return None
        mm = mmap.mmap(fd, length or size)
        return cls(path, mm, fd)

    def close(self) -> None:
        mm, self._mm = self._mm, None
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # an exported view is still alive; leak the map
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    # ------------------------------------------------------------ word ops

    def load(self, word: int) -> int:
        return _U64.unpack_from(self._mm, word * 8)[0]

    def store(self, word: int, value: int) -> None:
        _U64.pack_into(self._mm, word * 8, value)

    def read_payload(self, length: int) -> bytes:
        return bytes(self._mm[HDR:HDR + length])

    def write_payload(self, payload: bytes) -> None:
        self._mm[HDR:HDR + len(payload)] = payload

    def grow(self, new_capacity: int) -> None:
        os.ftruncate(self._fd, HDR + new_capacity)
        self.remap()

    def remap(self) -> None:
        size = os.fstat(self._fd).st_size
        if size > len(self._mm):
            old, self._mm = self._mm, mmap.mmap(self._fd, size)
            try:
                old.close()
            except BufferError:
                pass

    def size(self) -> int:
        return len(self._mm)


def _tracer():
    from ray_tpu_torch.cluster import rpc as _rpc

    t = _rpc.TRACE
    if t is not None and getattr(t, "is_flight_recorder", False):
        # the always-on flight recorder does NOT record data-plane frames:
        # a µs-scale channel would flood its bounded ring (evicting the
        # control-plane events a black box exists for), and sampling seqs
        # would self-flag as gaps under --check-trace's alternation
        # invariant. Channel events are traced when a real file tracer is
        # installed (tests, soaks); steady-state visibility comes from the
        # batched channel metrics above.
        return None
    return t


class Channel:
    """One end of a single-writer single-reader seqlock channel.

    Both ends map the same file read-write; ``write``/``read`` enforce the
    SPSC alternation. The creating (writer) side sizes the file; readers
    attach with :meth:`open_wait`, polling for the magic word.
    """

    def __init__(self, path: str, mem: ChannelMem, key: str):
        self.path = path
        self.key = key
        self._mem = mem
        # hot-path binding: one call frame per word op instead of two —
        # the ops seam costs ~2us per frame pair through an unbound
        # double dispatch (bench.py obs_overhead micro), ~1us bound
        self._get = mem.load
        self._put = mem.store
        self._closed_local = False
        self._wg_created = False  # True on the create() (writer) end
        # polls before a waiting end yields the core (see _park). The dag
        # driver loop keeps the hot default (its peer answers in
        # microseconds and owns a core); the serve fast path turns this
        # DOWN on its ends — many parked ends sharing a loaded host would
        # burn the GIL spinning while the peer computes
        self.spin_hot = 1000
        # per-end metric accumulators (SPSC: each end is single-threaded,
        # so plain attributes race-free); flushed every _FLUSH_EVERY
        # frames — see the module-level observability comment
        self._m_frames = 0  # frames written by THIS end since last flush
        self._m_reads = 0   # frames read by THIS end since last flush
        self._m_bytes = 0
        self._m_wstall = 0.0
        self._m_rstall = 0.0

    def _flush_metrics(self, need: int) -> None:
        if self._m_frames:
            _M_FRAMES.inc_k(_NOTAG, self._m_frames)
            _M_CHAN_BYTES.inc_k(_NOTAG, self._m_bytes)
        if self._m_wstall:
            _M_WRITE_STALL_SECONDS.inc_k(_NOTAG, self._m_wstall)
        if self._m_rstall:
            _M_READ_STALL_SECONDS.inc_k(_NOTAG, self._m_rstall)
        _M_CHAN_FILL.set_k(_NOTAG, need / max(self._get(_W_CAP), 1))
        self._m_frames = 0
        self._m_reads = 0
        self._m_bytes = 0
        self._m_wstall = 0.0
        self._m_rstall = 0.0

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def create(cls, path: str, capacity: int, key: str) -> "Channel":
        mem = MmapMem.create(path, capacity)
        ch = cls(path, mem, key)
        for w in (_W_CLOSED, _W_ERROR, _W_VERSION, _W_ACK, _W_LEN,
                  _W_WCLOCK, _W_RCLOCK, _W_APID):
            ch._put(w, 0)
        ch._put(_W_CAP, capacity)
        ch._put(_W_CPID, os.getpid())
        ch._put(_W_MAGIC, MAGIC)  # last: publishes the header to readers
        ch._wg_created = True
        pw = PARKWATCH
        if pw is not None:
            pw.chan_open(ch, "writer")
        return ch

    @classmethod
    def open_wait(cls, path: str, key: str, timeout: float = 30.0,
                  should_stop: Optional[Callable[[], bool]] = None) -> "Channel":
        """Attach to a channel another process creates; polls for the file
        and its magic word up to ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                mem = MmapMem.open(path)
            except FileNotFoundError:
                mem = None  # not created yet: poll; real I/O errors raise
            if mem is not None:
                if mem.load(_W_MAGIC) == MAGIC:
                    ch = cls(path, mem, key)
                    ch._put(_W_APID, os.getpid())
                    pw = PARKWATCH
                    if pw is not None:
                        pw.chan_open(ch, "reader")
                    return ch
                mem.close()
            if should_stop is not None and should_stop():
                raise ChannelClosedError(f"channel {key} never appeared "
                                         "(stage stopping)")
            if time.monotonic() >= deadline:
                raise ChannelTimeoutError(
                    f"channel {key} did not appear at {path} "
                    f"within {timeout:.0f}s"
                )
            time.sleep(0.002)

    def close(self, error: bool = False) -> None:
        """Set the closed (and optionally error) word, waking both ends.
        Idempotent; the mapping stays valid for a draining peer. BLIND
        one-shot stores — a load-OR-store here would race poke_error and
        lose the peer-died bit (memmodel's close-vs-poke scenario)."""
        if self._mem is None:
            return
        # error FIRST: a peer waking between the two stores must already
        # see the fatal bit — the reverse order opens a window where a
        # death-close drains like a graceful one
        if error:
            self._put(_W_ERROR, 1)
        self._put(_W_CLOSED, 1)

    def detach(self) -> None:
        """Drop this end's mapping (does NOT unlink the file)."""
        self._closed_local = True
        mem, self._mem = self._mem, None
        if mem is not None:
            mem.close()

    @staticmethod
    def unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # ------------------------------------------------------------ low-level
    # (_get/_put are the per-channel bindings of mem.load/mem.store made
    # in __init__ — the spelling the publication-order checker and the
    # memmodel op extraction recognize)

    @property
    def closed(self) -> bool:
        return bool(self._get(_W_CLOSED))

    @property
    def errored(self) -> bool:
        return bool(self._get(_W_ERROR))

    def _raise_closed(self) -> None:
        if self.errored:
            raise ChannelClosedError(
                f"channel {self.key}: peer died (stage worker or node lost)"
            )
        raise ChannelClosedError(f"channel {self.key} is closed")

    def wait_state(self) -> dict:
        """Stall-attribution snapshot (sanctioned ``_get`` loads): the
        last committed seq, the last consumed seq, and the close/error
        words — what a stall report needs to say WHY this end is parked
        (``version == ack`` = writer waiting on the reader's ack;
        ``version > ack`` = reader has an unconsumed frame ready)."""
        if self._mem is None:
            return {"state": "detached"}
        return {
            "version": self._get(_W_VERSION),
            "ack": self._get(_W_ACK),
            "closed": bool(self._get(_W_CLOSED)),
            "errored": bool(self._get(_W_ERROR)),
        }

    def peer_pid(self) -> Optional[int]:
        """The OTHER end's os pid (None = peer never attached / this end
        is detached). The creating end reads ``apid``, an attaching end
        reads ``cpid``."""
        if self._mem is None:
            return None
        pid = self._get(_W_APID) if self._wg_created else self._get(_W_CPID)
        return pid or None

    def _park(self, spins: int) -> None:
        # adaptive wait: stay hot for the first spin_hot polls (same-host
        # hand-off is microseconds), then yield the core
        if spins < self.spin_hot:
            time.sleep(0)
        else:
            time.sleep(0.0002 if spins < self.spin_hot + 4000 else 0.002)

    # ------------------------------------------------------------ data path

    def write(self, payload: bytes, timeout: Optional[float] = 60.0,
              should_stop: Optional[Callable[[], bool]] = None) -> int:
        """Commit one frame; blocks until the reader consumed the previous
        one (backpressure). Returns the committed seq."""
        t0 = time.monotonic() if _metrics.ENABLED else 0.0
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        wrec = None
        try:
            while True:
                if self._get(_W_ERROR) or self._get(_W_CLOSED):
                    self._raise_closed()
                version = self._get(_W_VERSION)
                if self._get(_W_ACK) == version:
                    break
                if should_stop is not None and should_stop():
                    raise ChannelClosedError(
                        f"channel {self.key}: stage stopping")
                if deadline is not None and time.monotonic() >= deadline:
                    raise ChannelTimeoutError(
                        f"write on {self.key} timed out waiting for reader "
                        f"ack (seq {version} unconsumed)"
                    )
                if spins == self.spin_hot:
                    # crossing into the slow park tier: this wait is no
                    # longer a microsecond hand-off — stamp it so the
                    # stall watchdog can attribute a wedge (one consult
                    # per wait, never on the hot path)
                    pw = PARKWATCH
                    if pw is not None:
                        wrec = pw.park_begin(self, "write")
                self._park(spins)
                spins += 1
        finally:
            if wrec is not None:
                pw = PARKWATCH
                if pw is not None:
                    pw.park_end(self, "write", wrec)
        seq = version + 1
        need = len(payload)
        cap = self._get(_W_CAP)
        if need > cap:
            new_cap = max(need, 2 * cap)
            self._mem.grow(new_cap)
            self._put(_W_CAP, new_cap)
        if "version-before-payload" in SEEDED_BUGS:
            # SEEDED BUG (test-only; see SEEDED_BUGS above): publish the
            # new seq before the payload lands — a reader that wakes here
            # copies the previous frame's bytes under the new seq
            self._put(_W_VERSION, seq)  # ray-lint: disable=chan-publication-order
        self._mem.write_payload(payload)
        self._put(_W_LEN, need)
        if _CRASH_AT == "pre-version":
            os._exit(3)  # chaos hook: die inside the torn-commit window
        t = _tracer()
        if t is not None:
            t.merge_clock(self._get(_W_RCLOCK))
            self._put(_W_WCLOCK, t.apply("chan_write", chan=self.key, seq=seq))
        self._put(_W_VERSION, seq)  # commit: readers wake on this word
        if _metrics.ENABLED:
            # AFTER the commit: the reader is already awake — accumulator
            # work here never widens the handoff window
            self._m_frames += 1
            self._m_bytes += need
            if spins:
                self._m_wstall += time.monotonic() - t0
            if self._m_frames >= _FLUSH_EVERY:
                if spins:  # sampled distribution on the flush cadence
                    _M_WRITE_STALL.observe_k(_NOTAG, time.monotonic() - t0)
                self._flush_metrics(need)
        return seq

    def read(self, timeout: Optional[float] = 60.0,
             should_stop: Optional[Callable[[], bool]] = None,
             ) -> Tuple[int, bytes]:
        """Consume the next frame; blocks until the writer commits one.
        Returns ``(seq, payload)``."""
        t0 = time.monotonic() if _metrics.ENABLED else 0.0
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        wrec = None
        try:
            while True:
                if self._get(_W_ERROR):
                    self._raise_closed()
                # closed is sampled BEFORE version: the writer publishes
                # its last commit before closing, so closed==1 here
                # implies the version load below already sees every
                # committed frame — the reversed order let a racing
                # graceful close drop a committed final frame (caught by
                # memmodel's first run)
                closed = self._get(_W_CLOSED)
                ack = self._get(_W_ACK)
                version = self._get(_W_VERSION)
                if version > ack:
                    break
                if closed:
                    self._raise_closed()  # closed AND drained
                if should_stop is not None and should_stop():
                    raise ChannelClosedError(
                        f"channel {self.key}: stage stopping")
                if deadline is not None and time.monotonic() >= deadline:
                    raise ChannelTimeoutError(
                        f"read on {self.key} timed out at seq {ack}"
                    )
                if spins == self.spin_hot:
                    # slow-tier transition: see the write() twin above
                    pw = PARKWATCH
                    if pw is not None:
                        wrec = pw.park_begin(self, "read")
                self._park(spins)
                spins += 1
        finally:
            if wrec is not None:
                pw = PARKWATCH
                if pw is not None:
                    pw.park_end(self, "read", wrec)
        need = self._get(_W_LEN)
        if "skip-remap-reread" not in SEEDED_BUGS:
            # grow-in-place: the writer may have grown the file under us;
            # SEEDED BUG skip-remap-reread drops this re-check, so a big
            # frame reads a short (stale) mapping
            if HDR + need > self._mem.size():
                self._mem.remap()
        payload = self._mem.read_payload(need)
        seq = version
        t = _tracer()
        if t is not None:
            t.merge_clock(self._get(_W_WCLOCK))
            self._put(_W_RCLOCK, t.apply("chan_read", chan=self.key, seq=seq))
        self._put(_W_ACK, seq)  # frees the writer's next frame
        if _metrics.ENABLED:
            # AFTER the ack: the writer is already unblocked — accumulator
            # work here never widens the handoff window
            self._m_reads += 1
            if spins:
                self._m_rstall += time.monotonic() - t0
            if self._m_reads >= _FLUSH_EVERY:
                if spins:  # sampled distribution on the flush cadence
                    _M_READ_STALL.observe_k(_NOTAG, time.monotonic() - t0)
                self._flush_metrics(need)
        return seq, payload

    def try_read(self) -> Optional[Tuple[int, bytes]]:
        """Non-blocking poll: consume the next frame if one is committed,
        else return ``None``. Raises :class:`ChannelClosedError` exactly
        like :meth:`read` once the channel is closed/errored AND drained.

        This is the primitive the serve fast path's replica loop drains
        MANY request channels with (``ray_tpu_torch/serve/fastpath.py``): each
        (client, replica) pair is one strictly-SPSC channel — the MPSC
        request plane is the *set* of pairs, polled round-robin, so no
        channel ever has two writers or two readers and the seqlock
        alternation invariant holds per pair. Implemented as a
        zero-deadline :meth:`read` so the checked protocol (publication
        order, closed-before-version sampling) is reused verbatim rather
        than duplicated."""
        try:
            return self.read(timeout=0)
        except ChannelTimeoutError:
            return None


def poke_error(path: str) -> bool:
    """Flag an existing channel file closed+errored without attaching a
    full end — used by the daemon to wake every parked reader/writer of a
    DAG whose pinned worker just died. Returns False when the file is
    absent (channel never created — nothing parked on it). Blind stores:
    racing a graceful close() must not lose either side's bit."""
    try:
        mem = MmapMem.open(path, length=HDR)
    except OSError:
        return False
    if mem is None:
        return False
    try:
        # error first — see Channel.close
        mem.store(_W_ERROR, 1)
        mem.store(_W_CLOSED, 1)
        return True
    finally:
        mem.close()
