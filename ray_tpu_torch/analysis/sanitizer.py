"""Runtime lock instrumentation layer + lock-order sanitizer.

This module owns THE one instrumentation seam for ``threading`` sync
primitives: ``add_listener()`` monkeypatches the ``threading.Lock`` /
``threading.RLock`` / ``threading.Condition`` factories (refcounted —
restored when the last listener leaves) so every lock allocated
afterwards is wrapped in an instrumented shim. The shim maintains a
per-OS-thread held-lock stack shared by every listener and notifies the
registered listeners on create/acquire/release. Two sanitizers ride the
same seam:

- :class:`LockOrderSanitizer` (here): records ``held -> acquiring``
  edges into a global order graph keyed by the lock's *allocation site*
  (file:line) — the runtime analogue of the static ``lock-order-cycle``
  checker's ``Class.attr`` nodes. ``cycles()`` reports any cyclic
  ordering actually observed (tests opt in via the ``lock_sanitizer``
  conftest fixture).
- :class:`ray_tpu_torch.analysis.racer.RaceSanitizer`: consumes the same
  acquire/release callbacks as happens-before release/acquire edges for
  its vector clocks, and reads the shared held stack for the lock set
  it attaches to every access report.

``threading.Condition`` participates fully: the factory wraps the
implicit ``RLock()`` a bare ``Condition()`` allocates, and the shim
implements ``_release_save`` / ``_acquire_restore`` / ``_is_owned`` so
``Condition.wait()``'s hidden release+reacquire maintains the held
stack and fires listener callbacks like any other release/acquire —
a Condition-vs-Lock order inversion is visible, and the racer sees
``wait()`` as the release/acquire pair it really is. (For a Condition
built on a plain ``Lock``, CPython's own fallback routes through the
shim's instrumented ``acquire``/``release``.)

Internal sanitizer locks are allocated with ``_thread.allocate_lock``
directly — never through the (possibly patched) factories — so listener
callbacks can take them without re-entering the instrumentation.
"""

from __future__ import annotations

import _thread
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import find_cycles

_THIS_DIR = __file__.rsplit("sanitizer.py", 1)[0]

# ------------------------------------------------------------------ seam
#
# Module-level state. uninstalling cannot unwrap locks that were already
# handed out, so a shim may outlive the listener set that existed when it
# was created; every notification therefore routes through the CURRENT
# listener tuple (else an inversion between an old-wrapped and a
# new-wrapped lock lands in neither graph), and the per-thread held stack
# is shared so cross-install nestings are seen at all.

_listeners: Tuple[object, ...] = ()
_listeners_mu = _thread.allocate_lock()
_orig_factories: Optional[Tuple] = None  # (Lock, RLock, Condition)
_held_tls = threading.local()


def _held_stack() -> List[Tuple]:
    """Per-thread stack of (site, shim) pairs currently held."""
    st = getattr(_held_tls, "stack", None)
    if st is None:
        st = _held_tls.stack = []
    return st


def held_sites() -> Tuple[Tuple[str, int], ...]:
    """The current thread's held-lock allocation sites, outermost first
    (the lock set the racer stamps onto each access report)."""
    return tuple(site for site, _lk in _held_stack())


def _caller_site(depth: int = 2) -> Tuple[str, int]:
    """Allocation site of the lock: first frame outside this module and
    outside threading.py (Condition() allocates an RLock internally)."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_THIS_DIR) and not fn.endswith("threading.py"):
            return (fn, f.f_lineno)
        f = f.f_back
    return ("<unknown>", 0)


def add_listener(listener) -> None:
    """Register a listener (optional methods: ``on_lock_created(lock,
    site)``, ``on_acquire(lock, site, held)`` — *held* is the site list
    BEFORE this acquisition is pushed — ``on_release(lock, site)``,
    and the blocked-waiter pair ``on_acquire_begin(lock, site)`` /
    ``on_acquire_abort(lock, site)``: *begin* fires BEFORE a blocking
    acquire parks, *abort* fires if that acquire then fails or times
    out, and a successful one resolves through ``on_acquire`` as usual —
    the wait-graph sanitizer needs the begin edge because a deadlocked
    thread, by definition, never reaches ``on_acquire``).
    The first listener installs the factory patches."""
    global _listeners, _orig_factories
    with _listeners_mu:
        if listener in _listeners:
            return
        if not _listeners:
            _orig_factories = (
                threading.Lock, threading.RLock, threading.Condition
            )
            threading.Lock = _make_lock
            threading.RLock = _make_rlock
            threading.Condition = _make_condition
        _listeners = _listeners + (listener,)


def remove_listener(listener) -> None:
    """Unregister; the last listener out restores the real factories."""
    global _listeners, _orig_factories
    with _listeners_mu:
        if listener not in _listeners:
            return
        _listeners = tuple(l for l in _listeners if l is not listener)
        if not _listeners and _orig_factories is not None:
            (threading.Lock, threading.RLock,
             threading.Condition) = _orig_factories
            _orig_factories = None


def _real_factories() -> Tuple:
    """The unpatched (Lock, RLock, Condition), whether or not the seam
    is currently installed."""
    with _listeners_mu:
        if _orig_factories is not None:
            return _orig_factories
    return (threading.Lock, threading.RLock, threading.Condition)


def _make_lock():
    lk = _InstrumentedLock(_real_factories()[0](), _caller_site())
    _notify_created(lk)
    return lk


def _make_rlock():
    lk = _InstrumentedLock(_real_factories()[1](), _caller_site())
    _notify_created(lk)
    return lk


def _make_condition(lock=None):
    """Condition factory: a bare ``Condition()`` gets a WRAPPED RLock
    (CPython would allocate a raw one through its module-local
    ``RLock`` name, bypassing the patched factory), then the real
    Condition class binds the shim's ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` so wait/notify stay
    instrumented."""
    if lock is None:
        lock = _InstrumentedLock(_real_factories()[1](), _caller_site())
        _notify_created(lock)
    return _real_factories()[2](lock)


def _notify_created(lk: "_InstrumentedLock") -> None:
    for lst in _listeners:
        fn = getattr(lst, "on_lock_created", None)
        if fn is not None:
            fn(lk, lk._site)


class _InstrumentedLock:
    """Wraps a real Lock/RLock; maintains the shared held stack and
    notifies the module's CURRENT listeners (not necessarily the ones
    alive when it was wrapped) on acquire/release."""

    def __init__(self, inner, site: Tuple[str, int]):
        self._inner = inner
        self._site = site

    # -------------------------------------------------- notify helpers

    def _notify_acquired(self):
        held = _held_stack()
        for lst in _listeners:
            fn = getattr(lst, "on_acquire", None)
            if fn is not None:
                fn(self, self._site, [s for s, _lk in held])
        held.append((self._site, self))

    def _notify_acquire_begin(self):
        for lst in _listeners:
            fn = getattr(lst, "on_acquire_begin", None)
            if fn is not None:
                fn(self, self._site)

    def _notify_acquire_abort(self):
        for lst in _listeners:
            fn = getattr(lst, "on_acquire_abort", None)
            if fn is not None:
                fn(self, self._site)

    def _notify_releasing(self):
        held = _held_stack()
        # Locks are usually released LIFO; tolerate out-of-order release.
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        for lst in _listeners:
            fn = getattr(lst, "on_release", None)
            if fn is not None:
                fn(self, self._site)

    # ------------------------------------------------------ Lock proto

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # begin fires only for acquires that can PARK: a deadlocked
        # thread never returns from the inner acquire, so a post-hoc
        # on_acquire can never see it — the wait edge must precede it
        began = blocking
        if began:
            self._notify_acquire_begin()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._notify_acquired()
        elif began:
            self._notify_acquire_abort()
        return ok

    def release(self):
        self._notify_releasing()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # Condition binds these three at construction when the lock has
        # them (RLock does; plain Lock raises AttributeError here and
        # Condition falls back to calling our instrumented
        # acquire/release). wait()'s hidden release/reacquire must
        # maintain the held stack and fire listeners, or a Condition
        # order inversion is invisible and the racer misses the
        # happens-before edge wait/notify really is.
        inner = object.__getattribute__(self, "_inner")
        val = getattr(inner, name)  # AttributeError falls through
        if name == "_release_save":
            def _release_save():
                self._notify_releasing()
                return val()
            return _release_save
        if name == "_acquire_restore":
            def _acquire_restore(state):
                # Condition.wait's hidden reacquire can park behind the
                # notifier: the begin/acquired pair makes that wait
                # visible to the wait-graph listener too
                self._notify_acquire_begin()
                val(state)
                self._notify_acquired()
            return _acquire_restore
        return val


class LockOrderSanitizer:
    """ThreadSanitizer-style lock-order recorder (one listener on the
    shared instrumentation seam)."""

    def __init__(self):
        # raw lock: _record runs inside listener callbacks; a wrapped
        # lock here would recurse into the seam
        self._graph_mu = _thread.allocate_lock()
        # (src_site, dst_site) -> observation count
        self.edges: Dict[Tuple[Tuple[str, int], Tuple[str, int]], int] = {}
        self.sites: Set[Tuple[str, int]] = set()
        self._installed = False

    # --------------------------------------------------- seam listener

    def on_lock_created(self, lock, site):
        with self._graph_mu:
            self.sites.add(site)

    def on_acquire(self, lock, site, held):
        with self._graph_mu:
            self.sites.add(site)
            for src in held:
                if src != site:
                    key = (src, site)
                    self.edges[key] = self.edges.get(key, 0) + 1

    # ----------------------------------------------------- install/undo

    def install(self):
        if not self._installed:
            add_listener(self)
            self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            remove_listener(self)
            self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    # -------------------------------------------------------- reporting

    def observed_edges(self) -> List[Tuple[Tuple[str, int], Tuple[str, int]]]:
        with self._graph_mu:
            return sorted(self.edges)

    def cycles(self) -> List[List[Tuple[str, int]]]:
        """Cyclic lock orderings observed at runtime. Any cycle here is a
        potential deadlock: two threads interleaving those paths wedge.
        Uses the same cycle enumeration (core.find_cycles) as the static
        ``lock-order-cycle`` checker, so the two halves cannot diverge on
        what counts as a cycle (``on_acquire`` never records self-edges)."""
        with self._graph_mu:
            adj: Dict[Tuple[str, int], List] = {}
            for (src, dst) in self.edges:
                adj.setdefault(src, []).append(dst)
        return find_cycles(adj)

    def assert_no_cycles(self):
        cyc = self.cycles()
        if cyc:
            lines = [
                " -> ".join(f"{f}:{ln}" for (f, ln) in c + [c[0]])
                for c in cyc
            ]
            raise AssertionError(
                "lock-order cycles observed at runtime:\n" + "\n".join(lines)
            )

    def site_for_line(self, filename_suffix: str, lineno: Optional[int] = None):
        """Find a recorded allocation site by file suffix (+ line), for
        mapping observed sites back to static lock nodes in tests."""
        with self._graph_mu:
            for (fn, ln) in self.sites:
                if fn.endswith(filename_suffix) and (
                    lineno is None or ln == lineno
                ):
                    return (fn, ln)
        return None
