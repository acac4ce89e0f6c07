"""Hybrid happens-before data-race sanitizer for the control plane.

Two stages, one tool:

**Stage 1 (static watchlist).** :func:`extract_watchlist` reuses the
``cross-thread-field-write`` checker's extraction machinery
(:class:`~ray_tpu_torch.analysis.checkers.CrossThreadFieldWriteChecker`) over
``cluster/`` + ``serve/`` + ``dag/`` and emits EVERY container/scalar
field reachable from >= 2 execution contexts — including the ones the
static pass considers lock-protected, together with the lock attribute
expression it credited (``locks``). Where the checker reports only
unlocked findings, the watchlist records the whole claim surface, so
the dynamic stage can *validate* the static analysis: a field the
checker believed lock-protected that races at runtime is a finding
against the static analysis itself (alias-laundered / rebound /
``__reduce__``-reconstructed lock identities are exactly what a
syntactic lock-propagation rule cannot see). ``python -m
ray_tpu_torch.analysis --dump-watchlist`` prints it as JSON.

**Stage 2 (dynamic vector clocks).** :class:`RaceSanitizer` is a
FastTrack-style happens-before engine (adaptive epochs: per-field state
is a single ``(tid, clock)`` epoch on the common same-thread path, and
promotes to a full read vector only when reads are genuinely
concurrent; a race-free write demotes it back). Release/acquire edges
come from one shared instrumentation layer
(:mod:`ray_tpu_torch.analysis.sanitizer` — the same wrap points the
lock-order sanitizer rides): ``threading.Lock``/``RLock``/
``Condition`` acquire+release (including ``Condition.wait``'s hidden
release/reacquire), ``Thread.start``/``join``, ``queue.Queue``
``put``/``get``, and ``ThreadPoolExecutor.submit`` /
``Future.result``. Watched fields are instrumented by an INSTALL-TIME
attribute-proxy swap on the live objects (plus a per-class
``__setattr__`` hook so rebinds re-wrap and scalar writes are seen):
the same zero-overhead-when-off ``is None`` module-global pattern as
``rpc.CHAOS``/``rpc.TRACE`` — uninstalled, no proxies exist and no
product code consults the racer at all (``CONSULTS`` stays 0,
test-asserted).

A detected race reports BOTH access stacks, both vector clocks, and
the lock set each side held, as JSONL artifacts beside the flight
recorder's (``artifacts/race-<pid>-<reason>-<n>.jsonl``). Seeded
regression teeth live in ``node_daemon.SEEDED_BUGS`` and
``fastpath.SEEDED_BUGS`` (:data:`SEEDED_RACES`): re-introduced known
bugs the racer must catch deterministically within
``run_probe(...)``'s quiescence rounds — the detection is
schedule-INsensitive (vector clocks flag the missing happens-before
edge whether or not the bad interleaving actually fired), which is
what makes the gate deterministic.

Known limits (documented, test-pinned): scalar fields get write
tracking only (attribute READS of a plain int don't pass through any
hook we own); cross-process edges (worker subprocesses, sockets) are
invisible — the racer covers the in-process control-plane threads,
which is where the thread-density lives; ``__slots__`` classes without
``__weakref__`` are skipped at attach; nested containers inside a
watched field (e.g. the sets a watched ``defaultdict(set)`` vivifies —
the vivification itself IS tracked as a write) are raw objects.
"""

from __future__ import annotations

import _thread
import ast
import importlib
import json
import os
import sys
import threading
import weakref
from collections import OrderedDict, defaultdict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.analysis import sanitizer as _san

#: THE module global (rpc.CHAOS / rpc.TRACE pattern): ``None`` = no racer
#: installed anywhere, and — because installation is what creates the
#: proxies and patches — no instrumentation exists to consult.
RACER: Optional["RaceSanitizer"] = None

#: instrumentation consult counter (proxy ops, setattr hooks, sync
#: edges). The uninstalled-zero-overhead contract is asserted on this.
CONSULTS = 0

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: stage-1 scan scope: the thread-dense control-plane packages
WATCH_SEGMENTS = ("cluster", "serve", "dag")

#: (seeded-bug name, module with the SEEDED_BUGS set, probe that must
#: catch it) — the one table the CLI, lint_gate and tests share.
SEEDED_RACES = (
    ("metrics-push-unlocked", "ray_tpu_torch.cluster.node_daemon",
     "daemon-metrics-push"),
    ("stats-lock-alias", "ray_tpu_torch.serve.fastpath",
     "fastpath-stats-alias"),
)


# =====================================================================
# Stage 1: static watchlist
# =====================================================================

_SCALAR_CONSTS = (int, float, bool, str, bytes, type(None))


def _scalar_fields(init) -> set:
    """``self.X = <constant>`` fields in __init__ (counters, flags,
    seqs): rebind-tracked by the dynamic stage (writes only)."""
    if init is None:
        return set()
    out = set()
    for node in ast.walk(init):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not (isinstance(v, ast.Constant)
                and isinstance(v.value, _SCALAR_CONSTS)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) and isinstance(
                t.value, ast.Name
            ) and t.value.id == "self":
                out.add(t.attr)
    return out


def _locks_covering(fn, lock_attrs) -> Dict[int, frozenset]:
    """Like the checker's ``_nodes_under_lock`` but records WHICH lock
    attrs lexically cover each node (the credited-lock expression the
    watchlist carries for dynamic validation)."""
    out: Dict[int, frozenset] = {}

    def locks_of(w) -> frozenset:
        if not isinstance(w, ast.With):
            return frozenset()
        names = set()
        for item in w.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) and isinstance(
                e.value, ast.Name
            ) and e.value.id == "self" and e.attr in lock_attrs:
                names.add(e.attr)
        return frozenset(names)

    def walk(node, held: frozenset):
        for child in ast.iter_child_nodes(node):
            child_held = held | locks_of(child)
            if child_held:
                out[id(child)] = child_held
                for sub in ast.walk(child):
                    out[id(sub)] = child_held
            else:
                walk(child, child_held)

    walk(fn, frozenset())
    return out


def extract_watchlist(paths: Optional[Sequence[str]] = None,
                      root: Optional[str] = None) -> List[dict]:
    """Stage 1: every container/scalar field of every class with >= 2
    execution contexts in scope, with the contexts that mutate it and
    the lock attrs the static pass credits. Pragma-suppressed mutation
    sites (``# ray-lint: disable=cross-thread-field-write``) do not
    count toward lockedness claims — same suppression semantics as the
    checker. Entries sort deterministically."""
    from ray_tpu_torch.analysis.checkers import CrossThreadFieldWriteChecker
    from ray_tpu_torch.analysis.core import Finding, Pragmas, iter_modules

    root = root or _REPO
    if paths is None:
        paths = [os.path.join(root, "ray_tpu_torch", seg)
                 for seg in WATCH_SEGMENTS]
    chk = CrossThreadFieldWriteChecker()
    entries: List[dict] = []
    errors: List[str] = []
    for ctx in iter_modules(paths, root=root, errors=errors):
        pragmas = Pragmas(ctx.source)
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            entries.extend(
                _class_watch_entries(chk, ctx, cls, pragmas, Finding)
            )
    if errors:
        raise ValueError(
            "extract_watchlist: unparseable file(s): " + "; ".join(errors)
        )
    entries.sort(key=lambda e: (e["module"], e["cls"], e["field"]))
    return entries


def _class_watch_entries(chk, ctx, cls, pragmas, Finding) -> List[dict]:
    methods = {
        n.name: n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    lock_attrs = chk._lock_attrs(cls)
    containers = chk._mutable_fields(methods.get("__init__"))
    scalars = _scalar_fields(methods.get("__init__")) - containers \
        - lock_attrs
    fields = containers | scalars
    if not fields:
        return []
    roots = list(chk._context_roots(cls, methods))
    # watchlist-only widening over the checker: public entry points are a
    # distinct "caller" context (the checker stays conservative to keep
    # findings high-precision; the WATCHLIST wants reachability — e.g.
    # FastPathRouter.submit runs on arbitrary user threads)
    roots += [
        (name, "caller") for name in methods
        if not name.startswith("_") and name != "__init__"
    ]
    if len({c for _m, c in roots}) < 2:
        return []
    # effective (context, locked) per method through the same-class call
    # graph — the checker's propagation, verbatim
    reach: Dict[str, set] = {}
    work = [(m, c, False) for m, c in roots if m in methods]
    while work:
        name, context, locked = work.pop()
        eff_locked = locked or name.endswith("_locked")
        key = (context, eff_locked)
        if key in reach.setdefault(name, set()):
            continue
        reach[name].add(key)
        for callee, call_locked in chk._calls_of(methods[name], lock_attrs):
            if callee in methods:
                work.append((callee, context, eff_locked or call_locked))
    per_field: Dict[str, dict] = {}
    for name, fn in methods.items():
        if name == "__init__":
            continue
        cover = _locks_covering(fn, lock_attrs)
        for context, locked in reach.get(name, ()):
            for field, node, _in_with in chk._mutations(
                fn, fields, lock_attrs
            ):
                line = getattr(node, "lineno", 1)
                probe = Finding(
                    path=ctx.relpath, line=line, col=0,
                    check="cross-thread-field-write", message="",
                    line_text=ctx.line_text(line),
                    end_line=getattr(node, "end_lineno", None) or line,
                )
                if pragmas.suppressed(probe):
                    continue
                rec = per_field.setdefault(field, {
                    "contexts": set(), "locks": set(), "all_locked": True,
                })
                rec["contexts"].add(context)
                here = cover.get(id(node), frozenset())
                if locked or here or name.endswith("_locked"):
                    rec["locks"].update(here)
                else:
                    rec["all_locked"] = False
    out = []
    for field, rec in per_field.items():
        out.append({
            "module": ctx.relpath.replace("\\", "/"),
            "cls": cls.name,
            "field": field,
            "kind": "container" if field in containers else "scalar",
            "contexts": sorted(rec["contexts"]),
            "locked": rec["all_locked"] and bool(rec["locks"]),
            "locks": sorted("self." + a for a in rec["locks"]),
        })
    return out


# =====================================================================
# Stage 2: vector clocks (FastTrack-style adaptive epochs)
# =====================================================================


def _join(vc: Dict[int, int], other: Dict[int, int]) -> None:
    for t, c in other.items():
        if c > vc.get(t, 0):
            vc[t] = c


class _ThreadState:
    __slots__ = ("tid", "vc", "name")

    def __init__(self, tid: int, vc: Dict[int, int], name: str):
        self.tid = tid
        self.vc = vc
        self.name = name


class _FieldState:
    """FastTrack per-field state: last-write epoch, and read state that
    is an epoch on the common path, a vector only while reads are
    concurrent (promotion), reset by a race-free write (demotion)."""

    __slots__ = ("wepoch", "winfo", "repoch", "rinfo", "rvc", "rinfos")

    def __init__(self):
        self.wepoch = None
        self.winfo = None
        self.repoch = None
        self.rinfo = None
        self.rvc = None
        self.rinfos = None


#: exact container types the proxy swap covers (subclasses excluded on
#: purpose: a subclass may carry behavior the proxy would mask)
_WRAP_TYPES = {dict, list, set, deque, defaultdict, OrderedDict}

_READ_METHODS = (
    "get", "keys", "values", "items", "copy", "count", "index",
)
_WRITE_METHODS = (
    "append", "appendleft", "add", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "update", "setdefault", "extend",
    "insert", "move_to_end", "sort", "reverse",
)


def _unwrap(obj):
    """Pickle helper: a proxy serializes as its underlying container
    (an instrumented field riding an RPC payload must not leak shims
    into a peer process)."""
    return obj


class _RaceProxy:
    """Wraps one watched container; every read/write method reports to
    the racer, then delegates. Unknown attributes delegate silently.

    Each proxy carries its OWN happens-before state (races are per heap
    object): the drain-swap idiom — ``batch, self.q = self.q, []`` under
    a lock, then iterate ``batch`` outside it — is race-free because the
    swapped-out object is private, and per-slot keying would false-flag
    exactly that. The attribute slot itself is a separate location whose
    rebinds are tracked under the ``(label, field)`` key."""

    __slots__ = ("_obj", "_ikey", "_racer", "__weakref__")

    def __init__(self, obj, ikey, racer):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_ikey", ikey)
        object.__setattr__(self, "_racer", racer)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_obj"), name)

    def __repr__(self):
        return repr(object.__getattribute__(self, "_obj"))

    def __reduce__(self):
        return (_unwrap, (object.__getattribute__(self, "_obj"),))

    # dunders delegate through the OPERATION, not attribute lookup —
    # ``dict`` has no ``__bool__`` (truthiness falls back to __len__),
    # ``set`` has no ``__reversed__``, etc.

    def _ev(self, op):
        object.__getattribute__(self, "_racer")._on_access(
            object.__getattribute__(self, "_ikey"), op, holder=self
        )

    def __len__(self):
        self._ev("r")
        return len(object.__getattribute__(self, "_obj"))

    def __bool__(self):
        self._ev("r")
        return bool(object.__getattribute__(self, "_obj"))

    def __iter__(self):
        self._ev("r")
        return iter(object.__getattribute__(self, "_obj"))

    def __reversed__(self):
        self._ev("r")
        return reversed(object.__getattribute__(self, "_obj"))

    def __contains__(self, item):
        self._ev("r")
        return item in object.__getattribute__(self, "_obj")

    def __eq__(self, other):
        self._ev("r")
        if isinstance(other, _RaceProxy):
            other = object.__getattribute__(other, "_obj")
        return object.__getattribute__(self, "_obj") == other

    def __ne__(self, other):
        return not self.__eq__(other)

    # defining __eq__ in the class body would otherwise null __hash__
    __hash__ = object.__hash__

    def __getitem__(self, key):
        obj = object.__getattribute__(self, "_obj")
        # defaultdict auto-vivification: a missing-key lookup INSERTS,
        # so it must count as a write or the unlocked-shared-index bug
        # class (two threads doing `self.index[k].add(...)`) would look
        # like concurrent reads. (The vivified inner container itself
        # is a raw object — a documented limit.)
        if (isinstance(obj, defaultdict)
                and obj.default_factory is not None and key not in obj):
            self._ev("w")
        else:
            self._ev("r")
        return obj[key]

    def __setitem__(self, key, value):
        self._ev("w")
        object.__getattribute__(self, "_obj")[key] = value

    def __delitem__(self, key):
        self._ev("w")
        del object.__getattribute__(self, "_obj")[key]

    def __ior__(self, other):
        self._ev("w")
        obj = object.__getattribute__(self, "_obj")
        if isinstance(other, _RaceProxy):
            other = object.__getattribute__(other, "_obj")
        obj |= other
        return self

    def __iadd__(self, other):
        self._ev("w")
        obj = object.__getattribute__(self, "_obj")
        if isinstance(other, _RaceProxy):
            other = object.__getattribute__(other, "_obj")
        obj += other
        return self


def _proxy_method(name: str, op: str):
    def method(self, *a, **k):
        racer = object.__getattribute__(self, "_racer")
        racer._on_access(object.__getattribute__(self, "_ikey"), op,
                         holder=self)
        return getattr(object.__getattribute__(self, "_obj"), name)(*a, **k)
    method.__name__ = name
    return method


for _n in _READ_METHODS:
    setattr(_RaceProxy, _n, _proxy_method(_n, "r"))
for _n in _WRITE_METHODS:
    setattr(_RaceProxy, _n, _proxy_method(_n, "w"))
del _n


class _Attached:
    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label


class RaceSanitizer:
    """The dynamic stage. ``install()`` patches the sync seams and
    proxy-swaps every watched field on live (and future) instances;
    ``uninstall()`` restores everything. One racer may be active at a
    time (module global ``RACER``)."""

    def __init__(self, watchlist: Optional[List[dict]] = None,
                 stack_depth: int = 10, max_races: int = 64):
        self.watchlist = (extract_watchlist() if watchlist is None
                          else list(watchlist))
        self.stack_depth = stack_depth
        self.max_races = max_races
        self.races: List[dict] = []
        self.unresolved: List[Tuple[dict, str]] = []
        # raw locks only: these are taken inside listener callbacks and
        # proxy ops — a wrapped lock here would recurse into the seam
        self._mu = _thread.allocate_lock()
        self._tls = threading.local()
        self._next_tid = 0
        self._thread_states: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._lock_vcs: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._chan_vcs: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._fields: Dict[Tuple[str, str], _FieldState] = {}
        # per-container-object state (see _RaceProxy: races are per heap
        # object; the attribute slot is its own location in _fields)
        self._obj_states: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._static: Dict[Tuple[str, str], dict] = {}
        self._attached: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._class_fields: Dict[type, Dict[str, dict]] = {}
        self._class_counts: Dict[str, int] = {}
        self._patched_setattr: List[Tuple[type, Any]] = []
        self._seen_races: set = set()
        self._installed = False

    # --------------------------------------------------- install / undo

    def install(self) -> "RaceSanitizer":
        global RACER
        if self._installed:
            return self
        if RACER is not None:
            raise RuntimeError("a RaceSanitizer is already installed")
        self._resolve_watchlist()
        RACER = self
        self._installed = True
        _san.add_listener(self)
        _patch_runtime()
        for cls, fields in self._class_fields.items():
            self._patch_class(cls, fields)
        self._scan_existing()
        return self

    def uninstall(self) -> None:
        global RACER
        if not self._installed:
            return
        RACER = None
        self._installed = False
        for cls, orig in self._patched_setattr:
            cls.__setattr__ = orig
        self._patched_setattr.clear()
        # unwrap live proxies: uninstalled means NO proxies exist
        with self._mu:
            objs = list(self._attached.keys())
        for obj in objs:
            fields = self._class_fields.get(type(obj), ())
            for field in fields:
                cur = getattr(obj, field, None)
                if isinstance(cur, _RaceProxy):
                    object.__setattr__(
                        obj, field, object.__getattribute__(cur, "_obj")
                    )
        _unpatch_runtime()
        _san.remove_listener(self)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _resolve_watchlist(self) -> None:
        for e in self.watchlist:
            modname = e["module"].replace("\\", "/")
            if modname.endswith(".py"):
                modname = modname[:-3]
            modname = modname.replace("/", ".")
            try:
                mod = importlib.import_module(modname)
                cls = getattr(mod, e["cls"])
                # @remote-decorated classes bind the module name to an
                # ActorClass wrapper; the instances whose fields we
                # watch are of the class INSIDE it
                if not isinstance(cls, type):
                    cls = getattr(cls, "_cls", cls)
                if not isinstance(cls, type):
                    raise TypeError(
                        f"{e['cls']} resolves to {type(cls).__name__}, "
                        "not a class"
                    )
            except Exception as ex:  # noqa: BLE001 - report, don't die
                self.unresolved.append((e, f"{type(ex).__name__}: {ex}"))
                continue
            self._class_fields.setdefault(cls, {})[e["field"]] = e

    def _patch_class(self, cls: type, fields: Dict[str, dict]) -> None:
        orig = cls.__setattr__
        racer = self

        def __setattr__(obj, name, value, _orig=orig, _fields=fields):
            r = RACER
            if r is racer and name in _fields:
                value = r._intercept_setattr(obj, name, value)
            _orig(obj, name, value)

        cls.__setattr__ = __setattr__
        self._patched_setattr.append((cls, orig))

    def _scan_existing(self) -> None:
        import gc

        watched = tuple(self._class_fields)
        if not watched:
            return
        for obj in gc.get_objects():
            if type(obj) in self._class_fields:
                self._attach(obj)

    # -------------------------------------------------------- attaching

    def _attach(self, obj) -> Optional[_Attached]:
        cls = type(obj)
        fields = self._class_fields.get(cls)
        if fields is None:
            return None
        with self._mu:
            try:
                rec = self._attached.get(obj)
            except TypeError:
                return None  # unhashable
            if rec is not None:
                return rec
            n = self._class_counts.get(cls.__name__, 0)
            self._class_counts[cls.__name__] = n + 1
            rec = _Attached(f"{cls.__name__}#{n}")
            try:
                self._attached[obj] = rec
            except TypeError:
                return None  # no __weakref__ (slots class): skip
            for field, entry in fields.items():
                self._static[(rec.label, field)] = entry
        for field in fields:
            v = getattr(obj, field, None)
            if type(v) in _WRAP_TYPES:
                object.__setattr__(
                    obj, field,
                    _RaceProxy(v, (rec.label, field), self),
                )
        return rec

    def _intercept_setattr(self, obj, name, value):
        global CONSULTS
        CONSULTS += 1
        rec = self._attach(obj)
        if rec is None:
            return value
        ikey = (rec.label, name)
        self._on_access(ikey, "w")
        if type(value) in _WRAP_TYPES:
            value = _RaceProxy(value, ikey, self)
        return value

    # ----------------------------------------------------- thread state

    def _state(self) -> Optional[_ThreadState]:
        """The calling thread's vector-clock state, or ``None`` while
        the thread is still bootstrapping. ``threading.current_thread``
        is OFF LIMITS here: called from the lock-acquire callback it
        would mint a ``_DummyThread`` whose ``__init__`` allocates an
        (instrumented) Event and recurses forever — a thread's own
        ``_started.set()`` fires BEFORE CPython registers it in
        ``threading._active``. Events from that bootstrap window (and
        from foreign/dummy threads) are skipped; the thread's real
        state is created on its first event after registration, which
        still carries the ``_racer_parent`` start-edge snapshot."""
        tls = self._tls
        st = getattr(tls, "st", None)
        if st is not None:
            return st
        if getattr(tls, "making", False):
            return None
        tls.making = True
        try:
            th = threading._active.get(threading.get_ident())
            if th is None:
                return None
            with self._mu:
                tid = self._next_tid
                self._next_tid += 1
            vc: Dict[int, int] = {}
            parent = getattr(th, "_racer_parent", None)
            if parent is not None and parent[0] is self:
                vc.update(parent[1])
            vc[tid] = vc.get(tid, 0) + 1
            st = _ThreadState(tid, vc, th.name)
            tls.st = st
            with self._mu:
                try:
                    self._thread_states[th] = st
                except TypeError:
                    pass
            return st
        finally:
            tls.making = False

    def _fork(self) -> Optional[Dict[int, int]]:
        """Snapshot the current thread's clock and advance it (the
        release half of a release/acquire edge)."""
        st = self._state()
        if st is None:
            return None
        snap = dict(st.vc)
        st.vc[st.tid] += 1
        return snap

    def _join_snapshot(self, snap: Optional[Dict[int, int]]) -> None:
        st = self._state()
        if st is not None and snap:
            _join(st.vc, snap)

    def _join_thread(self, thread) -> None:
        with self._mu:
            st = self._thread_states.get(thread)
        if st is not None:
            self._join_snapshot(dict(st.vc))

    # ------------------------------------------------ sync-object edges

    def on_lock_created(self, lock, site) -> None:  # seam listener
        pass

    def on_acquire(self, lock, site, held) -> None:  # seam listener
        if not self._installed:
            return
        global CONSULTS
        CONSULTS += 1
        st = self._state()
        if st is None:
            return
        with self._mu:
            lvc = self._lock_vcs.get(lock)
        if lvc:
            _join(st.vc, lvc)

    def on_release(self, lock, site) -> None:  # seam listener
        if not self._installed:
            return
        global CONSULTS
        CONSULTS += 1
        st = self._state()
        if st is None:
            return
        snap = dict(st.vc)
        with self._mu:
            self._lock_vcs[lock] = snap
        st.vc[st.tid] += 1

    def _chan_send(self, chan) -> None:
        if not self._installed:
            return
        global CONSULTS
        CONSULTS += 1
        st = self._state()
        if st is None:
            return
        with self._mu:
            vc = self._chan_vcs.get(chan)
            if vc is None:
                vc = self._chan_vcs[chan] = {}
            _join(vc, st.vc)
        st.vc[st.tid] += 1

    def _chan_recv(self, chan) -> None:
        if not self._installed:
            return
        global CONSULTS
        CONSULTS += 1
        st = self._state()
        if st is None:
            return
        with self._mu:
            vc = self._chan_vcs.get(chan)
            snap = dict(vc) if vc else None
        if snap:
            _join(st.vc, snap)

    # --------------------------------------------------- access checks

    def _stack(self) -> Tuple[Tuple[str, int, str], ...]:
        f = sys._getframe(2)
        out = []
        here = os.path.dirname(os.path.abspath(__file__))
        while f is not None and len(out) < self.stack_depth:
            fn = f.f_code.co_filename
            if not (os.path.dirname(fn) == here
                    and os.path.basename(fn) in (
                        "racer.py", "sanitizer.py")):
                rel = fn
                if rel.startswith(_REPO + os.sep):
                    rel = rel[len(_REPO) + 1:]
                out.append((rel.replace("\\", "/"), f.f_lineno,
                            f.f_code.co_name))
            f = f.f_back
        return tuple(out)

    def _access_info(self, st: _ThreadState, epoch) -> dict:
        return {
            "thread": st.name,
            "tid": st.tid,
            "clock": epoch[1],
            "vc": {str(t): c for t, c in sorted(st.vc.items())},
            "locks": ["%s:%d" % s for s in _san.held_sites()],
            "stack": ["%s:%d %s" % fr for fr in self._stack()],
        }

    def _on_access(self, ikey: Tuple[str, str], op: str,
                   holder=None) -> None:
        # a proxy can outlive uninstall (e.g. a drained snapshot a
        # thread is still iterating): once uninstalled, locks are raw
        # again — recording through this engine would manufacture
        # phantom races and break the 0-consults contract
        if not self._installed:
            return
        global CONSULTS
        CONSULTS += 1
        tls = self._tls
        if getattr(tls, "busy", False):
            return
        tls.busy = True
        try:
            st = self._state()
            if st is None:
                return
            epoch = (st.tid, st.vc[st.tid])
            with self._mu:
                if holder is not None:
                    fs = self._obj_states.get(holder)
                    if fs is None:
                        fs = self._obj_states[holder] = _FieldState()
                else:
                    fs = self._fields.get(ikey)
                    if fs is None:
                        fs = self._fields[ikey] = _FieldState()
                if op == "w":
                    if fs.wepoch == epoch and fs.rvc is None \
                            and fs.repoch is None:
                        return  # FastTrack same-epoch fast path
                    self._check_write(ikey, fs, st, epoch)
                else:
                    if fs.repoch == epoch or (
                        fs.rvc is not None
                        and fs.rvc.get(st.tid) == epoch[1]
                    ):
                        return  # same-epoch read
                    self._check_read(ikey, fs, st, epoch)
        finally:
            tls.busy = False

    def _check_write(self, ikey, fs, st, epoch) -> None:
        if fs.rvc is not None:
            for t, c in fs.rvc.items():
                if t != st.tid and c > st.vc.get(t, 0):
                    self._record(ikey, "read-write",
                                 fs.rinfos.get(t), st, epoch)
        elif fs.repoch is not None:
            t, c = fs.repoch
            if t != st.tid and c > st.vc.get(t, 0):
                self._record(ikey, "read-write", fs.rinfo, st, epoch)
        if fs.wepoch is not None:
            t, c = fs.wepoch
            if t != st.tid and c > st.vc.get(t, 0):
                self._record(ikey, "write-write", fs.winfo, st, epoch)
        fs.wepoch = epoch
        fs.winfo = self._access_info(st, epoch)
        # demotion: a write resets read state (FastTrack WrShared)
        fs.rvc = fs.rinfos = fs.repoch = fs.rinfo = None

    def _check_read(self, ikey, fs, st, epoch) -> None:
        if fs.wepoch is not None:
            t, c = fs.wepoch
            if t != st.tid and c > st.vc.get(t, 0):
                self._record(ikey, "write-read", fs.winfo, st, epoch)
        if fs.rvc is None:
            if (fs.repoch is None or fs.repoch[0] == st.tid
                    or fs.repoch[1] <= st.vc.get(fs.repoch[0], 0)):
                fs.repoch = epoch
                fs.rinfo = self._access_info(st, epoch)
            else:
                # promotion: two genuinely concurrent readers
                self._record_promote(fs, st, epoch)
        else:
            fs.rvc[st.tid] = epoch[1]
            fs.rinfos[st.tid] = self._access_info(st, epoch)

    def _record_promote(self, fs, st, epoch) -> None:
        fs.rvc = {fs.repoch[0]: fs.repoch[1], st.tid: epoch[1]}
        fs.rinfos = {fs.repoch[0]: fs.rinfo,
                     st.tid: self._access_info(st, epoch)}
        fs.repoch = None
        fs.rinfo = None

    def _record(self, ikey, kind, prior: Optional[dict],
                st: _ThreadState, epoch) -> None:
        label, field = ikey
        cur = self._access_info(st, epoch)
        prior = prior or {}
        key = (label, field, kind,
               tuple(prior.get("stack", ())[:1]),
               tuple(cur["stack"][:1]))
        if key in self._seen_races or len(self.races) >= self.max_races:
            return
        self._seen_races.add(key)
        entry = self._static.get(ikey, {})
        race = {
            "field": f"{label}.{field}",
            "kind": kind,
            "prior": prior,
            "current": cur,
            "static": {
                "module": entry.get("module"),
                "locked": entry.get("locked", False),
                "locks": entry.get("locks", []),
                "contexts": entry.get("contexts", []),
            },
            "static_claim_violated": bool(entry.get("locked")),
        }
        if race["static_claim_violated"]:
            race["suggestion"] = (
                "the static pass credited %s as protecting this field, "
                "but the accesses were not serialized at runtime: lock "
                "identity is laundered through an alias/rebind/"
                "__reduce__ path the syntactic lock-propagation rule "
                "cannot see — fix the locking, then teach the checker "
                "the propagation shape" % (entry.get("locks") or ["?"],)
            )
        self.races.append(race)

    # -------------------------------------------------------- reporting

    @property
    def found(self) -> bool:
        return bool(self.races)

    def report(self) -> dict:
        return {
            "kind": "race-report",
            "races": list(self.races),
            "watched_classes": sorted(
                getattr(c, "__name__", str(c)) for c in self._class_fields
            ),
            "watched_fields": len(
                {(e["cls"], e["field"]) for e in self.watchlist}
            ),
            "unresolved": [
                {"entry": e, "error": err} for e, err in self.unresolved
            ],
        }

    def format_races(self) -> str:
        lines = []
        for r in self.races:
            lines.append(f"RACE {r['kind']} on {r['field']} "
                         f"(static locked={r['static']['locked']} "
                         f"via {r['static']['locks']})")
            for side in ("prior", "current"):
                a = r[side]
                lines.append(f"  {side}: thread={a.get('thread')} "
                             f"clock={a.get('tid')}@{a.get('clock')} "
                             f"locks={a.get('locks')}")
                for fr in a.get("stack", ())[:4]:
                    lines.append(f"    {fr}")
            if r.get("suggestion"):
                lines.append(f"  note: {r['suggestion']}")
        return "\n".join(lines)

    def write_report(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
            f.write("\n")

    _dump_seq = 0

    def dump(self, reason: str = "race",
             out_dir: Optional[str] = None) -> str:
        """Flight-recorder-style artifact: JSONL, one header line then
        one line per race, under ``artifacts/`` (or
        ``$RAY_TPU_FLIGHTREC_DIR``) as
        ``race-<pid>-<reason>-<n>.jsonl``."""
        out_dir = out_dir or os.environ.get(
            "RAY_TPU_FLIGHTREC_DIR", "artifacts"
        )
        os.makedirs(out_dir, exist_ok=True)
        RaceSanitizer._dump_seq += 1
        path = os.path.join(
            out_dir,
            f"race-{os.getpid()}-{reason}-{RaceSanitizer._dump_seq}.jsonl",
        )
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "kind": "race-report", "races": len(self.races),
                "reason": reason,
            }, sort_keys=True) + "\n")
            for r in self.races:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        return path


# =====================================================================
# runtime seam patches (Thread / Queue / executor)
# =====================================================================

_runtime_orig: Optional[dict] = None


def _patch_runtime() -> None:
    global _runtime_orig
    if _runtime_orig is not None:
        return
    import concurrent.futures as cf
    import queue as queue_mod

    orig = {
        "thread_start": threading.Thread.start,
        "thread_join": threading.Thread.join,
        "queue_put": queue_mod.Queue.put,
        "queue_get": queue_mod.Queue.get,
        "submit": cf.ThreadPoolExecutor.submit,
        "result": cf.Future.result,
    }

    def start(self):
        r = RACER
        if r is not None:
            snap = r._fork()
            if snap is not None:
                self._racer_parent = (r, snap)
        return orig["thread_start"](self)

    def join(self, timeout=None):
        orig["thread_join"](self, timeout)
        r = RACER
        if r is not None and not self.is_alive():
            r._join_thread(self)

    def put(self, item, *a, **k):
        r = RACER
        if r is not None:
            r._chan_send(self)
        return orig["queue_put"](self, item, *a, **k)

    def get(self, *a, **k):
        item = orig["queue_get"](self, *a, **k)
        r = RACER
        if r is not None:
            r._chan_recv(self)
        return item

    def submit(self, fn, *args, **kwargs):
        r = RACER
        if r is None:
            return orig["submit"](self, fn, *args, **kwargs)
        snap = r._fork() or {}
        box: dict = {}

        def task(*a, **k):
            r2 = RACER
            if r2 is not None:
                r2._join_snapshot(snap)
            try:
                return fn(*a, **k)
            finally:
                if r2 is not None:
                    box["vc"] = r2._fork()

        fut = orig["submit"](self, task, *args, **kwargs)
        fut._racer_done = box
        return fut

    def result(self, timeout=None):
        try:
            return orig["result"](self, timeout)
        finally:
            r = RACER
            box = getattr(self, "_racer_done", None)
            if r is not None and box and "vc" in box:
                r._join_snapshot(box["vc"])

    threading.Thread.start = start
    threading.Thread.join = join
    queue_mod.Queue.put = put
    queue_mod.Queue.get = get
    cf.ThreadPoolExecutor.submit = submit
    cf.Future.result = result
    _runtime_orig = orig


def _unpatch_runtime() -> None:
    global _runtime_orig
    if _runtime_orig is None:
        return
    import concurrent.futures as cf
    import queue as queue_mod

    threading.Thread.start = _runtime_orig["thread_start"]
    threading.Thread.join = _runtime_orig["thread_join"]
    queue_mod.Queue.put = _runtime_orig["queue_put"]
    queue_mod.Queue.get = _runtime_orig["queue_get"]
    cf.ThreadPoolExecutor.submit = _runtime_orig["submit"]
    cf.Future.result = _runtime_orig["result"]
    _runtime_orig = None


# =====================================================================
# seeded-bug probes (the regression teeth)
# =====================================================================


class ProbeResult:
    def __init__(self, name: str, seeded: Tuple[str, ...],
                 detected: bool, rounds: int, races: List[dict],
                 unresolved: List):
        self.name = name
        self.seeded = seeded
        self.detected = detected
        self.rounds = rounds
        self.races = races
        self.unresolved = unresolved

    def summary(self) -> str:
        state = (f"RACE after {self.rounds} round(s)" if self.detected
                 else f"clean after {self.rounds} round(s)")
        seed = f" [seeded: {','.join(self.seeded)}]" if self.seeded else ""
        return (f"racer:{self.name}: {state}, "
                f"{len(self.races)} race(s){seed}")


def _barrier_pair(fn_a, fn_b) -> None:
    """One quiescence round: run two REAL code paths on two fresh
    threads released by one barrier. Happens-before between the two
    accesses then comes ONLY from locks the paths themselves take — the
    detection is schedule-insensitive, hence deterministic."""
    go = threading.Event()
    errs: List[BaseException] = []

    def wrap(fn):
        def run():
            go.wait(5.0)
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errs.append(e)
        return run

    t1 = threading.Thread(target=wrap(fn_a), name="racer-probe-a")
    t2 = threading.Thread(target=wrap(fn_b), name="racer-probe-b")
    t1.start()
    t2.start()
    go.set()
    t1.join(10.0)
    t2.join(10.0)
    if errs:
        raise errs[0]


def _probe_daemon_metrics(_round: int) -> None:
    """node_daemon layer: a worker's ``rpc_metrics_push`` (rpc-handler
    loop) racing the heartbeat thread's drain of ``_worker_metrics`` —
    the exact field/thread pair one of the node_daemon lock fixes
    covered. Drives the REAL methods on a minimal instance."""
    import time as _time

    from ray_tpu_torch.cluster.node_daemon import NodeDaemon

    d = object.__new__(NodeDaemon)
    d._lock = threading.Lock()
    d._worker_metrics = []

    def drain_until_seen():
        # drain-and-iterate until the pushed delta shows up: the drain
        # that picks it up iterates exactly the object the push wrote,
        # so the (write, read) pair lands on one heap object no matter
        # which side of a swap the push hit — detection stays
        # deterministic under per-object race state
        for _ in range(200):
            if list(NodeDaemon._drain_worker_metrics(d)):
                return
            _time.sleep(0.005)
        raise AssertionError("pushed delta never drained")

    _barrier_pair(
        lambda: NodeDaemon.rpc_metrics_push(d, {"delta": {"m": 1}}, None),
        drain_until_seen,
    )


def _probe_fastpath_stats(_round: int) -> None:
    """serve layer: two submitter threads bumping ``FastPathRouter``
    gate counters through the REAL ``_bump``. Clean code serializes on
    ``_stats_lock``; the seeded alias-laundered lock makes each bump
    hold a DIFFERENT lock object — statically invisible (the ``with
    self._stats_lock`` text is unchanged), dynamically a race."""
    from ray_tpu_torch.serve.fastpath import FastPathRouter

    r = object.__new__(FastPathRouter)
    r._stats_lock = threading.Lock()
    r.stats = {"submitted": 0, "completed": 0}
    _barrier_pair(
        lambda: FastPathRouter._bump(r, "submitted"),
        lambda: FastPathRouter._bump(r, "completed"),
    )


RACE_PROBES = {
    "daemon-metrics-push": _probe_daemon_metrics,
    "fastpath-stats-alias": _probe_fastpath_stats,
}

#: watchlist classes each probe exercises (the probe installs a racer
#: scoped to them so unrelated background threads stay quiet)
_PROBE_CLASSES = {
    "daemon-metrics-push": ("NodeDaemon",),
    "fastpath-stats-alias": ("FastPathRouter",),
}


def _seed_sets(names: Sequence[str]):
    """(module SEEDED_BUGS set, prior contents) per module touched.
    Unknown names are an error: silently ignoring a typo'd seed would
    make a never-armed run read as 'seeded and clean'."""
    known = {bug for bug, _m, _p in SEEDED_RACES}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(
            f"unknown seeded race(s) {unknown}; have {sorted(known)}"
        )
    touched = []
    for bug, modname, _probe in SEEDED_RACES:
        mod = importlib.import_module(modname)
        touched.append((mod.SEEDED_BUGS, set(mod.SEEDED_BUGS)))
        if bug in names:
            mod.SEEDED_BUGS.add(bug)
    return touched


def run_probe(name: str, seeded_bugs: Sequence[str] = (),
              rounds: int = 3,
              watchlist: Optional[List[dict]] = None) -> ProbeResult:
    """Run one probe for up to ``rounds`` quiescence rounds (stop as
    soon as a race is found). With a seeded bug armed the racer must
    detect in round 1 — the gate bar lint_gate enforces."""
    if name not in RACE_PROBES:
        raise ValueError(
            f"unknown race probe {name!r}; have {sorted(RACE_PROBES)}"
        )
    wl = watchlist if watchlist is not None else extract_watchlist()
    scoped = [e for e in wl if e["cls"] in _PROBE_CLASSES[name]]
    prev = _seed_sets(seeded_bugs)
    racer = RaceSanitizer(watchlist=scoped)
    ran = 0
    try:
        racer.install()
        for i in range(rounds):
            ran = i + 1
            RACE_PROBES[name](i)
            if racer.found:
                break
    finally:
        racer.uninstall()
        for bugset, before in prev:
            bugset.clear()
            bugset.update(before)
    return ProbeResult(
        name, tuple(seeded_bugs), racer.found, ran,
        list(racer.races), list(racer.unresolved),
    )
