"""Scalable task-event log: bounded memory, full history on disk.

Reference: src/ray/gcs/gcs_server/gcs_task_manager.cc — the GCS task-event
backend keeps a bounded in-memory window (RAY_task_events_max_num_task_in_gcs)
plus aggregate counters, and the state API reads from it. The upstream
design drops the oldest events past the cap; here the full stream also
spills to a JSONL file, so a 1M-task run keeps a complete queryable
timeline while owner memory stays O(recent_cap + distinct task names).

Three query surfaces:
  - ``tail(limit)``  — most recent events; served from memory when the
    window suffices, else from the spill file.
  - ``summary()`` / ``stats()`` — per-name per-status counts, maintained
    incrementally (O(1) per append), never truncated.
  - ``scan(filters)``— full-history iterator (spill file) for timeline
    export.

Locking: appends and flushes run under one internal lock; spill READS
bound their range to the flushed size under the lock, then read and parse
OUTSIDE it — a multi-MB tail or scan never stalls the append path (which
the GCS calls while holding its own global lock).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional


class TaskEventLog:
    def __init__(self, recent_cap: int = 10_000,
                 spill_path: Optional[str] = None,
                 anonymous_spill: bool = False,
                 flush_every: int = 2_000,
                 resume: Optional[dict] = None):
        self._recent: deque = deque(maxlen=max(int(recent_cap), 1))
        self._agg: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self._total = 0
        self._spill_is_anon = False
        if spill_path is None and anonymous_spill:
            # the log owns this file: created here, removed in close()
            fd, spill_path = tempfile.mkstemp(
                prefix="ray_tpu_task_events_", suffix=".jsonl"
            )
            os.close(fd)
            self._spill_is_anon = True
        self._spill_path = spill_path
        self._flush_every = flush_every
        self._pending: List[dict] = []
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        size = (
            os.path.getsize(spill_path)
            if spill_path and os.path.exists(spill_path) else 0
        )
        if resume is not None and not (
            isinstance(resume.get("offset"), int)
            and 0 <= resume["offset"] <= size
        ):
            # checkpoint without a usable spill range: if there is a file
            # it must replay whole (full recount — seeding would double
            # count); if there is none, the counters ARE the history
            if size:
                resume = None
            else:
                self._seed(resume)
                resume = None
        if size:
            self._recover(size, resume)

    def _seed(self, resume: dict) -> None:
        self._total = int(resume.get("total", 0))
        for name, m in (resume.get("agg") or {}).items():
            self._agg[name].update(m)

    def _recover(self, size: int, resume: Optional[dict]) -> None:
        """Restart recovery (reference: GCS FT replaying table storage):
        an existing spill belongs to the previous incarnation of a
        persistence-backed owner — reconcile with it so the aggregates,
        total, and recent window agree with the file this incarnation
        keeps appending to.

        With a ``resume`` checkpoint (from :meth:`snapshot_state`, stored
        in the owner's persistence snapshot) the counters are seeded
        directly and only the post-checkpoint delta is re-parsed —
        O(recent writes), not O(full task history). Without one, the
        whole file replays.

        A crash mid-flush can leave a torn trailing line; truncate it
        away, or the next append would merge into it and leave one
        permanently unparseable line."""
        start = 0
        if resume is not None:
            start = resume["offset"]
            self._seed(resume)
        good = start
        with open(self._spill_path, "rb") as f:
            f.seek(start)
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    ev = json.loads(line)
                except ValueError:
                    break  # torn write that happened to contain \n
                good += len(line)
                self._recent.append(ev)
                self._total += 1
                a = self._agg[ev.get("name") or "unknown"]
                a[ev.get("status") or "UNKNOWN"] += 1
                a["total"] += 1
        if good < size:
            with open(self._spill_path, "r+b") as f:
                f.truncate(good)

    # ------------------------------------------------------------ write

    def append(self, ev: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._recent.append(ev)
            self._total += 1
            a = self._agg[ev.get("name") or "unknown"]
            a[ev.get("status") or "UNKNOWN"] += 1
            a["total"] += 1
            if self._spill_path is not None:
                self._pending.append(ev)
                if len(self._pending) >= self._flush_every:
                    self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        if self._fh is None:
            self._fh = open(self._spill_path, "a", encoding="utf-8")
        self._fh.write(
            "".join(json.dumps(ev) + "\n" for ev in self._pending)
        )
        self._fh.flush()
        self._pending.clear()

    def flush(self) -> None:
        with self._lock:
            if self._spill_path is not None:
                self._flush_locked()

    def close(self, remove_spill: Optional[bool] = None) -> None:
        """Flush and neutralize: post-close appends become no-ops (they
        can race shutdown from in-flight RPC handlers) and can no longer
        resurrect a removed spill file. Anonymous spills are removed by
        default; pass remove_spill to override."""
        with self._lock:
            self._closed = True
            path = self._spill_path
            if path is not None:
                self._flush_locked()
            self._spill_path = None
            self._pending.clear()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if remove_spill is None:
                remove_spill = self._spill_is_anon
            if remove_spill and path:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # ------------------------------------------------------------ read

    def __len__(self) -> int:
        return self._total

    def tail(self, limit: int = 1000) -> List[dict]:
        """Most recent ``limit`` events, oldest first."""
        with self._lock:
            if limit <= len(self._recent) or self._total <= len(self._recent):
                return list(self._recent)[-limit:]
            # window too small for the ask: serve from the spill file —
            # it holds the FULL stream (memory events included), so it
            # alone is authoritative. Bound the read to the flushed size
            # under the lock, then read OUTSIDE it (a 1M-line parse must
            # not stall appends, which the GCS does under its own lock).
            if self._spill_path is None or not os.path.exists(
                self._spill_path
            ):
                return list(self._recent)[-limit:]
            self._flush_locked()
            path = self._spill_path
            stop = os.path.getsize(path)
            fallback = list(self._recent)[-limit:]
        try:
            return [
                json.loads(l) for l in _tail_lines(path, limit, end=stop)
            ]
        except OSError:
            # close() can unlink an anonymous spill between our lock
            # release and the open — shutdown racing a list RPC; serve
            # what memory still holds rather than erroring the caller
            return fallback

    def summary(self) -> Dict[str, Dict[str, int]]:
        """Per-task-name counts by status over the ENTIRE history —
        aggregation is incremental, so this is exact even when the recent
        window has long since dropped the events."""
        with self._lock:
            return {k: dict(v) for k, v in self._agg.items()}

    def stats(self) -> tuple:
        """(total, per-name summary) under ONE lock acquisition, so the
        total always equals the sum of the by-name totals."""
        with self._lock:
            return self._total, {k: dict(v) for k, v in self._agg.items()}

    def snapshot_state(self) -> dict:
        """Checkpoint for the owner's persistence snapshot: counters plus
        the flushed spill offset, so the next incarnation replays only the
        delta written after this snapshot."""
        with self._lock:
            if self._spill_path is not None:
                self._flush_locked()
                offset = (
                    os.path.getsize(self._spill_path)
                    if os.path.exists(self._spill_path) else 0
                )
            else:
                offset = None
            return {
                "total": self._total,
                "agg": {k: dict(v) for k, v in self._agg.items()},
                "offset": offset,
            }

    def scan(self, filters: Optional[dict] = None) -> Iterator[dict]:
        """Iterate the full history, oldest first. With spilling enabled
        the JSONL file is the authoritative stream; otherwise only the
        in-memory window survives."""
        path = None
        snap: List[dict] = []
        with self._lock:
            if self._spill_path is not None:
                self._flush_locked()
            if self._spill_path is not None and os.path.exists(
                self._spill_path
            ):
                # bound to the flushed size under the lock, stream outside
                # it: appends past the offset are a later flush (whole
                # lines), so the bounded read never sees a torn line and
                # never stalls the append path for the duration of a
                # multi-hundred-MB export
                path = self._spill_path
                stop = os.path.getsize(path)
            else:
                snap = list(self._recent)
        if path is not None:
            consumed = 0
            with open(path, "rb") as f:
                for line in f:
                    consumed += len(line)
                    if consumed > stop:
                        break
                    ev = json.loads(line)
                    if not filters or all(
                        ev.get(k) == v for k, v in filters.items()
                    ):
                        yield ev
            return
        for ev in snap:
            if not filters or all(ev.get(k) == v for k, v in filters.items()):
                yield ev


def _tail_lines(path: str, n: int, end: Optional[int] = None) -> List[str]:
    """Last n lines of file[0:end] without reading it whole (spill files
    reach hundreds of MB at 1M tasks). ``end`` bounds the read to a
    flushed prefix so concurrent appends past it are never observed."""
    with open(path, "rb") as f:
        if end is None:
            f.seek(0, os.SEEK_END)
            end = f.tell()
        size = end
        block = 1 << 16
        data = b""
        while size > 0 and data.count(b"\n") <= n:
            step = min(block, size)
            size -= step
            f.seek(size)
            data = f.read(step) + data
            block *= 2
    lines = data.splitlines()
    if size > 0:
        # first element is a partial line from the middle of the file
        lines = lines[1:]
    return [l.decode("utf-8") for l in lines[-n:]]
