"""Static blocking-cycle analysis + distributed wait-for deadlock & stall
sanitizer.

Every other verification layer in the tree checks *safety* (invariants,
races, memory-model ordering, RPC budgets); this one checks *liveness*.
Two halves, one tool:

**Static half.** :func:`build_waitgraph` reuses rpcflow's
interprocedural ``_FuncIndex`` machinery over ``cluster/`` + ``serve/``
+ ``dag/`` to extract a *blocking graph*: nodes are execution contexts
(rpc handlers, background threads, subscriber callbacks — the same
roots the ``cross-thread-field-write`` checker derives), annotated with
every blocking site reachable from them (``.call()`` RPCs, chained
``call_async(...).result()``, bare ``Future.result``, ``queue.get``,
``Condition.wait``, ``Thread.join``, ``Channel.read/write``); edges are
"context A blocks on a resource released by context B", where the
cross-PROCESS edges come from the protocol index — a blocking
``.call("m")`` edges into every ``rpc_m`` handler context on the server
that implements it. ``core.find_cycles`` over that graph reports
potential distributed deadlocks, and :func:`reentry_chains` feeds the
``rpc-reentry-cycle`` checker (a handler whose blocking RPC chain can
re-enter its own server class — the GCS→daemon→GCS shape that exhausts
dispatcher threads). The sibling ``blocking-wait-under-lock`` checker
generalizes ``rpc-under-lock`` to every blocking kind classified here.

**Dynamic half.** :class:`WaitSanitizer` rides the SAME instrumentation
seams the racer does — ``sanitizer.add_listener`` for lock
acquire/release (plus the blocked-waiter ``on_acquire_begin`` /
``on_acquire_abort`` pair: a deadlocked thread never reaches
``on_acquire``, so the wait edge must precede the park), its own
``queue.get`` / ``Future.result`` / ``Condition.wait`` / executor
``submit`` patches, the ``rpc.TRACE`` send/recv hooks (it is a
delegating TRACE shim exactly like rpcflow's profiler), and the channel
layer's ``PARKWATCH`` park-begin/park-end stamps — to maintain a live
cross-thread AND cross-process wait-for graph. An in-flight blocking
RPC is a wait edge from the caller thread to the server's handler
context (stitched through ``on_send``/``on_recv`` the same way the
invariant tracer Lamport-stitches). Owners are resolved LAZILY at
cycle-walk time (who holds the lock *now*, which thread is the server
loop *now*), so checking for a cycle only on wait-ENTER is sufficient
and order-insensitive. A cycle fires a deadlock report with BOTH
stacks (``sys._current_frames``), both held-lock sets, and the
in-flight RPC chain; a stall watchdog attributes any wait older than
``stall_warn_s`` (what it waits on, who holds it, for how long —
channel waits name the channel, its peer end's pid and the last
committed seq) into ``artifacts/waitgraph-*.jsonl`` flight-recorder
artifacts. Uninstalled, the ``WAITGRAPH is None`` module-global gate
means product code never consults it (``CONSULTS`` stays 0,
test-asserted) — the rpc.CHAOS / rpc.TRACE / racer.RACER pattern.

Seeded regression teeth live in ``gcs.SEEDED_BUGS``
(``stream-ack-under-lock``: a blocking GCS→daemon call re-introduced
UNDER the GCS lock) and ``compiled.SEEDED_BUGS``
(``chan-read-under-lock``: an output-channel read parked under the DAG
lifecycle lock) — :data:`SEEDED_WAITS` is the one table the CLI,
lint_gate and tests share; each must be caught statically (pragma-
stripped rescan) AND dynamically within ``run_probe``'s rounds.

Known limits (documented, test-pinned): a ``call_async`` whose future
is ``.result()``-ed in a *different* statement resolves statically to a
plain ``future-result`` (no RPC edge — the target method string is not
tracked through the variable); queue/condition waits have no single
releaser, so they get stall attribution but no owner edge (an idle
consumer parked on ``queue.get`` is not a deadlock); dynamic RPC edges
point at the server's *handler loop thread*, which over-approximates
when the loop is busy with an unrelated request — a reported cycle
still requires every thread on it to be genuinely blocked.
"""

from __future__ import annotations

import _thread
import ast
import importlib
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis import protocol as _protocol
from ray_tpu_torch.analysis import sanitizer as _san
from ray_tpu_torch.analysis.core import find_cycles, iter_modules
from ray_tpu_torch.analysis.rpcflow import _MAX_DEPTH, _FuncIndex

#: THE module global (rpc.CHAOS / rpc.TRACE / racer.RACER pattern):
#: ``None`` = no wait sanitizer installed anywhere, and — because
#: installation is what creates the patches — nothing to consult.
WAITGRAPH: Optional["WaitSanitizer"] = None

#: instrumentation consult counter (seam callbacks, runtime patches,
#: TRACE hooks, channel park stamps). The uninstalled-zero-overhead
#: contract is asserted on this.
CONSULTS = 0

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_THIS_DIR = __file__.rsplit("waitgraph.py", 1)[0]

#: static scan scope: the thread-dense control-plane packages
SCAN_SEGMENTS = ("cluster", "serve", "dag")

#: (seeded-bug name, module with the SEEDED_BUGS set, probe that must
#: catch it) — the one table the CLI, lint_gate and tests share.
SEEDED_WAITS = (
    ("stream-ack-under-lock", "ray_tpu_torch.cluster.gcs",
     "gcs-stream-ack-reentry"),
    ("chan-read-under-lock", "ray_tpu_torch.dag.compiled",
     "dag-read-under-lock"),
)


# =====================================================================
# Static half: blocking-site classification + the blocking graph
# =====================================================================

#: kinds the ``blocking-wait-under-lock`` checker flags. ``rpc-call``
#: is deliberately absent: a bare blocking ``.call`` under a lock is
#: ``rpc-under-lock``'s finding, and double-reporting one site under
#: two names would make the baseline discipline ambiguous.
WAIT_KINDS_UNDER_LOCK = (
    "rpc-result", "future-result", "cond-wait", "queue-get",
    "thread-join", "chan-read", "chan-write",
)


def blocking_wait_kind(call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
    """Classify a call node as a blocking-wait site.

    Returns ``(kind, rpc_method)`` or ``None``; *rpc_method* is the
    string-literal method for ``rpc-call`` / ``rpc-result`` (the kinds
    that grow cross-process edges) and ``None`` otherwise. Kinds:

    - ``rpc-call``:      ``x.call("m", ...)`` (blocking round trip)
    - ``rpc-result``:    ``x.call_async("m", ...).result(...)`` chained
      in one expression — the same round trip spelled in two steps
    - ``future-result``: ``f.result()`` / ``f.result(timeout=...)``
    - ``cond-wait``:     ``cv.wait()`` / ``cv.wait(t)`` (also Event)
    - ``queue-get``:     ``q.get(...)`` with no positional key (which
      excludes ``dict.get(k)``)
    - ``thread-join``:   ``t.join()`` with no positionals (excludes
      ``sep.join(parts)``)
    - ``chan-read`` / ``chan-write``: ``.read`` / ``.write`` carrying a
      ``timeout=`` or ``should_stop=`` keyword — the channel-layer wait
      signature (a bare file ``.read()`` never does)
    """
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    args = call.args
    kwargs = {kw.arg for kw in call.keywords if kw.arg}
    if attr == "call":
        if args and isinstance(args[0], ast.Constant) \
                and isinstance(args[0].value, str):
            return ("rpc-call", args[0].value)
        return None
    if attr == "result":
        inner = f.value
        if isinstance(inner, ast.Call) \
                and isinstance(inner.func, ast.Attribute) \
                and inner.func.attr == "call_async" \
                and inner.args \
                and isinstance(inner.args[0], ast.Constant) \
                and isinstance(inner.args[0].value, str):
            return ("rpc-result", inner.args[0].value)
        if not args:
            return ("future-result", None)
        return None
    if attr == "wait" and len(args) <= 1 and kwargs <= {"timeout"}:
        # extra keywords (num_returns=..., fetch_local=...) mean a
        # result-collection API like ray_tpu_torch.wait, not a condition park
        return ("cond-wait", None)
    if attr == "get" and not args:
        return ("queue-get", None)
    if attr == "join" and not args:
        return ("thread-join", None)
    if attr in ("read", "write") and (kwargs & {"timeout", "should_stop"}):
        return ("chan-read" if attr == "read" else "chan-write", None)
    return None


@dataclass
class BlockSite:
    """One blocking wait reachable from a context root."""

    path: str                   # repo-relative module path
    line: int
    kind: str                   # one of the blocking_wait_kind kinds
    method: Optional[str]       # rpc method for rpc-call / rpc-result
    via: Tuple[str, ...]        # same-class/module call chain from root
    end_line: int = 0           # last physical line (pragma range)

    def to_dict(self) -> Dict[str, Any]:
        return {"path": self.path, "line": self.line, "kind": self.kind,
                "method": self.method, "via": list(self.via)}


def _executor_offloaded(fn) -> Set[int]:
    """ids of AST nodes inside a lambda handed to ``run_in_executor``:
    that code runs on the EXECUTOR context (which ``_context_roots``
    walks as its own root), not on the enclosing handler — a handler
    that offloads its blocking work and returns the future does not
    block the dispatcher, so charging the lambda's waits to the handler
    would fabricate reentry cycles (the daemon's object-pull shape)."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr == "run_in_executor":
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    for sub in ast.walk(arg):
                        out.add(id(sub))
    return out


def _is_seeded_test(test) -> bool:
    """``"bug" in SEEDED_BUGS`` (possibly one conjunct of an ``and``)."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_is_seeded_test(v) for v in test.values)
    return (isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.In)
            and any(isinstance(c, ast.Name) and c.id == "SEEDED_BUGS"
                    for c in test.comparators))


def _seeded_gated(fn) -> Set[int]:
    """ids of AST nodes inside an ``if "..." in SEEDED_BUGS:`` body:
    the seeded teeth only run when a test arms them, so the blocking
    graph models the NORMAL path (memmodel's ``_seeded_branch_kind``
    rule). The teeth are still proven statically by the gate's
    pragma-stripped ``blocking-wait-under-lock`` rescan — through the
    checker, not the graph."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _is_seeded_test(node.test):
            for sub in node.body:
                for n in ast.walk(sub):
                    out.add(id(n))
    return out


class _BlockWalker:
    """Collect every blocking site reachable from a root function by
    following rpcflow's call resolution (same-class ``self.m()``, bare
    module functions, unique repo-wide methods), depth-capped like the
    rpc-cost walker. Blocking calls are classified FIRST — a ``.call``
    is a site, never an edge to some unrelated ``call`` method."""

    def __init__(self, index: _FuncIndex):
        self.index = index

    def walk(self, root) -> List[BlockSite]:
        sites: List[BlockSite] = []
        seen: Set[Tuple] = set()

        def visit(info, chain: Tuple[str, ...]) -> None:
            if info.key in seen or len(chain) > _MAX_DEPTH:
                return
            seen.add(info.key)
            skipped = _executor_offloaded(info.node)
            skipped |= _seeded_gated(info.node)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call) \
                        or id(node) in skipped:
                    continue
                kind = blocking_wait_kind(node)
                if kind is not None:
                    sites.append(BlockSite(
                        path=info.relpath, line=node.lineno,
                        kind=kind[0], method=kind[1], via=chain,
                        end_line=getattr(node, "end_lineno", 0) or 0,
                    ))
                    continue
                callee = self.index.resolve_call(node, info)
                if callee is not None:
                    visit(callee, chain + (callee.name,))

        visit(root, ())
        return sites


@dataclass
class WaitGraphReport:
    """The static blocking graph: context label -> blocking sites, RPC
    edges between contexts, and the cycles found over them."""

    root: str
    contexts: Dict[str, List[BlockSite]]
    edges: Dict[Tuple[str, str], BlockSite]
    cycles: List[List[str]]

    def adjacency(self) -> Dict[str, List[str]]:
        adj: Dict[str, List[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, []).append(dst)
        return adj

    def to_dict(self) -> Dict[str, Any]:
        return {
            "contexts": {
                label: [s.to_dict() for s in sites]
                for label, sites in sorted(self.contexts.items())
            },
            "edges": [
                {"src": src, "dst": dst, "path": site.path,
                 "line": site.line, "kind": site.kind,
                 "method": site.method}
                for (src, dst), site in sorted(self.edges.items())
            ],
            "cycles": [list(c) for c in self.cycles],
        }


def _is_control_plane(relpath: str) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return bool(set(parts[:-1]) & set(SCAN_SEGMENTS))


def _is_handler_label(label: str) -> bool:
    """Handler contexts are ``server.rpc_m``; thread/subscriber roots
    carry the class (``server.Cls.meth``) so the two never collide."""
    parts = label.split(".")
    return len(parts) == 2 and parts[1].startswith(
        _protocol.HANDLER_PREFIX)


def build_from_contexts(ctxs: Sequence, root: str) -> WaitGraphReport:
    """Build the blocking graph from already-parsed ModuleContexts (the
    ``rpc-reentry-cycle`` checker path: the lint pass parsed everything
    once; reparsing would double the cost of the whole run). Every
    module is indexed — helpers outside the control plane still resolve
    — but context roots come only from control-plane modules."""
    from ray_tpu_torch.analysis.checkers import CrossThreadFieldWriteChecker

    index = _FuncIndex()
    proto = _protocol.ProtocolIndex()
    for ctx in ctxs:
        index.add_module(ctx)
        proto.merge(_protocol.ProtocolIndex.piece_for(ctx))

    helper = CrossThreadFieldWriteChecker()
    walker = _BlockWalker(index)
    contexts: Dict[str, List[BlockSite]] = {}
    for ctx in ctxs:
        rel = ctx.relpath.replace("\\", "/")
        if not _is_control_plane(rel):
            continue
        server = _protocol._server_label(rel)
        for cls in ctx.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for meth, _desc in helper._context_roots(cls, methods):
                if meth not in methods:
                    continue
                label = (f"{server}.{meth}"
                         if meth.startswith(_protocol.HANDLER_PREFIX)
                         else f"{server}.{cls.name}.{meth}")
                if label in contexts:
                    continue
                info = index.lookup(rel, cls.name, meth)
                if info is not None:
                    contexts[label] = walker.walk(info)

    # cross-process RPC edges: a blocking call with method m edges into
    # every rpc_m handler context reachable through the protocol index
    edges: Dict[Tuple[str, str], BlockSite] = {}
    for label, sites in contexts.items():
        for s in sites:
            if s.kind not in ("rpc-call", "rpc-result") or not s.method:
                continue
            for h in proto.handlers.get(s.method, ()):
                dst = f"{h.server}.{_protocol.HANDLER_PREFIX}{s.method}"
                if dst in contexts and (label, dst) not in edges:
                    edges[(label, dst)] = s

    adj: Dict[str, List[str]] = {}
    for (src, dst) in edges:
        adj.setdefault(src, []).append(dst)
    return WaitGraphReport(root=root, contexts=contexts, edges=edges,
                           cycles=find_cycles(adj))


def build_waitgraph(paths: Optional[Sequence[str]] = None,
                    root: Optional[str] = None) -> WaitGraphReport:
    """Build the blocking graph for the control plane (or an explicit
    path set). Raises on unparseable input — a silently partial graph
    would make the cycle scan pass vacuously (same contract as
    ``extract_protocol``)."""
    root = root or _REPO
    if paths is None:
        paths = [os.path.join(root, "ray_tpu_torch", seg)
                 for seg in SCAN_SEGMENTS]
    errors: List[str] = []
    ctxs = list(iter_modules(paths, root=root, errors=errors))
    if errors:
        raise ValueError(
            "build_waitgraph: unparseable file(s): " + "; ".join(errors)
        )
    return build_from_contexts(ctxs, root)


def reentry_chains(report: WaitGraphReport) -> List[Dict[str, Any]]:
    """Handler contexts whose blocking RPC closure re-enters their own
    server (including the 1-hop self-call): each entry carries the
    originating handler, the context chain, and the first blocking site
    on the offending path — the line the ``rpc-reentry-cycle`` checker
    anchors its finding to."""
    adj = report.adjacency()
    out: List[Dict[str, Any]] = []
    seen: Set[Tuple] = set()
    for origin in sorted(report.contexts):
        if not _is_handler_label(origin):
            continue
        server = origin.split(".", 1)[0]
        stack: List[Tuple[str, Tuple[str, ...]]] = [(origin, (origin,))]
        visited: Set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if _is_handler_label(nxt) \
                        and nxt.split(".", 1)[0] == server:
                    chain = path + (nxt,)
                    key = (origin, frozenset(chain))
                    if key not in seen:
                        seen.add(key)
                        first_hop = path[1] if len(path) > 1 else nxt
                        out.append({
                            "origin": origin,
                            "chain": list(chain),
                            "site": report.edges[(origin, first_hop)],
                        })
                    continue
                if nxt not in visited and len(path) < 8:
                    visited.add(nxt)
                    stack.append((nxt, path + (nxt,)))
    return out


# =====================================================================
# Dynamic half: the wait-for sanitizer
# =====================================================================


def _is_rlock(lock) -> bool:
    """Reentrant? (an owner re-acquiring an RLock never parks, so it
    must not grow a wait record — that would be a 1-cycle)."""
    inner = getattr(lock, "_inner", lock)
    return "rlock" in type(inner).__name__.lower()


def _fmt_frames(frame, depth: int) -> List[list]:
    """[relpath, line, func] rows for one live frame, own-machinery
    frames (this module + the seam) elided, innermost last."""
    out: List[list] = []
    for fs in traceback.extract_stack(frame):
        fn = fs.filename
        if fn.startswith(_THIS_DIR) and (
                fn.endswith("waitgraph.py") or fn.endswith("sanitizer.py")):
            continue
        rel = fn[len(_REPO) + 1:] if fn.startswith(_REPO) else fn
        out.append([rel, fs.lineno, fs.name])
    return out[-depth:]


class WaitSanitizer:
    """Live cross-thread + cross-process wait-for graph (see module
    docstring). One instance installs globally (the ``WAITGRAPH``
    module global); a second concurrent install is an error."""

    _dump_seq = 0

    def __init__(self, stall_warn_s: float = 5.0, stack_depth: int = 16,
                 max_reports: int = 32,
                 watchdog_interval_s: Optional[float] = None):
        # raw lock: every method here runs inside instrumentation
        # callbacks; a wrapped lock would recurse into the seam
        self._mu = _thread.allocate_lock()
        self._tls = threading.local()
        self._installed = False
        self._inner = None          # wrapped rpc.TRACE (delegation)
        self.stall_warn_s = stall_warn_s
        self.stack_depth = stack_depth
        self.max_reports = max_reports
        self._watch_interval = watchdog_interval_s if \
            watchdog_interval_s is not None else \
            min(1.0, max(0.05, stall_warn_s / 4.0))
        # ---- wait-for state (all under _mu) -------------------------
        self._waits: Dict[int, List[dict]] = {}   # tid -> wait-record stack
        self._held: Dict[int, List[str]] = {}     # tid -> held lock sites
        self._lock_owner: Dict[int, Tuple[int, int]] = {}  # id -> (tid, n)
        self._lock_site: Dict[int, Tuple[str, int]] = {}
        self._srv_thread: Dict[str, int] = {}     # server name -> loop tid
        self._chan_end: Dict[Tuple, int] = {}     # (key, role) -> tid
        self._rpc_stack: Dict[int, deque] = {}    # tid -> in-flight sends
        self._dedup: Set[frozenset] = set()
        self._warned: Set[int] = set()
        self._lc = 0                              # lamport fallback clock
        # ---- results ------------------------------------------------
        self.deadlocks: List[dict] = []
        self.stalls: List[dict] = []
        self._stop = False
        self._watchdog: Optional[threading.Thread] = None

    @property
    def found(self) -> bool:
        return bool(self.deadlocks)

    # ------------------------------------------------- install / undo

    def install(self) -> "WaitSanitizer":
        global WAITGRAPH
        if WAITGRAPH is not None:
            raise RuntimeError("a WaitSanitizer is already installed")
        from ray_tpu_torch.cluster import rpc as rpc_mod
        from ray_tpu_torch.dag import channel as chan_mod
        self._inner = rpc_mod.TRACE
        rpc_mod.TRACE = self
        chan_mod.PARKWATCH = self
        WAITGRAPH = self
        _san.add_listener(self)
        _patch_runtime()
        self._installed = True
        self._stop = False
        t = threading.Thread(target=self._watch_loop,
                             name="waitgraph-watchdog", daemon=True)
        self._watchdog = t
        t.start()
        return self

    def uninstall(self) -> None:
        global WAITGRAPH
        if not self._installed:
            return
        from ray_tpu_torch.cluster import rpc as rpc_mod
        from ray_tpu_torch.dag import channel as chan_mod
        self._stop = True
        WAITGRAPH = None
        if chan_mod.PARKWATCH is self:
            chan_mod.PARKWATCH = None
        if rpc_mod.TRACE is self:
            rpc_mod.TRACE = self._inner
        _unpatch_runtime()
        _san.remove_listener(self)
        self._installed = False
        w = self._watchdog
        if w is not None:
            w.join(2.0)
            self._watchdog = None

    def __enter__(self) -> "WaitSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------- plumbing

    def _internal(self) -> bool:
        return bool(getattr(self._tls, "internal", False))

    def _pend(self) -> List[dict]:
        """TLS stack of unresolved acquire-begin records (begin/acquired
        strictly nest per thread, incl. Condition.wait's reacquire)."""
        st = getattr(self._tls, "pend", None)
        if st is None:
            st = self._tls.pend = []
        return st

    @staticmethod
    def _thread_name(tid: int) -> str:
        # NEVER threading.current_thread() here: minting a _DummyThread
        # allocates an instrumented Event -> infinite recursion
        t = threading._active.get(tid)
        return t.name if t is not None else f"tid-{tid}"

    @staticmethod
    def _res_descr(rec: dict) -> str:
        return rec.get("descr") or str(rec.get("res"))

    # ----------------------------------------------- wait-record core

    def _wait_enter(self, reskey: Tuple, descr: str,
                    extra: Optional[dict] = None) -> Optional[dict]:
        """Push a wait record for the current thread and walk for a
        cycle. Lazy owner resolution makes enter-only checking
        sufficient: whichever of two mutually-blocked threads parks
        LAST sees the full cycle."""
        if self._internal():
            return None
        tid = threading.get_ident()
        rec = {"res": reskey, "descr": descr, "tid": tid,
               "t": time.monotonic()}
        if extra:
            rec.update(extra)
        with self._mu:
            self._waits.setdefault(tid, []).append(rec)
            cycle = self._find_cycle_locked(tid)
            if cycle is not None:
                self._report_deadlock_locked(cycle)
        return rec

    def _wait_exit(self, rec: Optional[dict]) -> None:
        if rec is None:
            return
        tid = rec["tid"]
        with self._mu:
            st = self._waits.get(tid)
            if st:
                for i in range(len(st) - 1, -1, -1):
                    if st[i] is rec:
                        del st[i]
                        break
                if not st:
                    self._waits.pop(tid, None)

    def _owner_of_locked(self, rec: dict) -> Optional[int]:
        """Who releases this resource, resolved NOW (under _mu)."""
        res = rec["res"]
        kind = res[0]
        if kind == "lock":
            own = self._lock_owner.get(res[1])
            return own[0] if own else None
        if kind == "rpc-srv":
            tid = self._srv_thread.get(res[1])
            if tid is not None:
                return tid
            box = rec.get("box")
            if box and not box.get("done"):
                return box.get("tid")
            return None
        if kind == "future":
            box = rec.get("box")
            if box and not box.get("done"):
                return box.get("tid")
            return None
        if kind == "chan":
            return self._chan_end.get((res[1], res[2]))
        return None  # queue / cond: no single releaser

    def _resolvable_locked(self, tid: int) -> Tuple[Optional[dict],
                                                    Optional[int]]:
        """The innermost wait record with a resolvable owner. Waits
        NEST: ``Future.result`` / ``queue.get`` park on an internal
        Condition, stacking an ownerless ``cond`` record on top of the
        meaningful ``future``/``rpc-srv``/``queue`` one — a walk that
        only looked at the top of the stack would dead-end there and
        detection would hinge on which side happened to park last."""
        st = self._waits.get(tid)
        if not st:
            return None, None
        for rec in reversed(st):
            owner = self._owner_of_locked(rec)
            if owner is not None:
                return rec, owner
        return st[-1], None

    def _find_cycle_locked(self, start_tid: int) -> Optional[List[dict]]:
        seen: Dict[int, int] = {}
        path: List[dict] = []
        tid = start_tid
        while True:
            if tid in seen:
                return path[seen[tid]:]
            rec, owner = self._resolvable_locked(tid)
            if rec is None or owner is None:
                return None
            seen[tid] = len(path)
            path.append(rec)
            tid = owner

    def _report_deadlock_locked(self, cycle: List[dict]) -> None:
        if len(self.deadlocks) >= self.max_reports:
            return
        key = frozenset(r["res"] for r in cycle)
        if key in self._dedup:
            return
        self._dedup.add(key)
        frames = sys._current_frames()
        threads, chain = [], []
        for r in cycle:
            tid = r["tid"]
            frame = frames.get(tid)
            threads.append({
                "tid": tid,
                "thread": self._thread_name(tid),
                "waiting_on": self._res_descr(r),
                "age_s": round(time.monotonic() - r["t"], 4),
                "held": list(self._held.get(tid, [])),
                "stack": (_fmt_frames(frame, self.stack_depth)
                          if frame is not None else []),
            })
            dq = self._rpc_stack.get(tid)
            if dq:
                for e in dq:
                    chain.append({"src": e["src"], "dst": e["dst"],
                                  "method": e["method"]})
        self.deadlocks.append({
            "kind": "deadlock",
            "pid": os.getpid(),
            "cycle": [self._res_descr(r) for r in cycle],
            "threads": threads,
            "rpc_chain": chain,
        })

    # --------------------------------------- seam listener (lock seam)

    def on_lock_created(self, lock, site) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        with self._mu:
            self._lock_site[id(lock)] = site

    def on_acquire_begin(self, lock, site) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        lid = id(lock)
        me = threading.get_ident()
        with self._mu:
            self._lock_site.setdefault(lid, site)
            own = self._lock_owner.get(lid)
        if own is not None and own[0] == me and _is_rlock(lock):
            return  # reentrant re-acquire never parks
        rec = self._wait_enter(("lock", lid), f"lock {site[0]}:{site[1]}")
        if rec is not None:
            self._pend().append(rec)

    def on_acquire_abort(self, lock, site) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        pend = self._pend()
        if pend and pend[-1]["res"] == ("lock", id(lock)):
            self._wait_exit(pend.pop())

    def on_acquire(self, lock, site, held) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        lid = id(lock)
        me = threading.get_ident()
        pend = self._pend()
        if pend and pend[-1]["res"] == ("lock", lid):
            self._wait_exit(pend.pop())
        with self._mu:
            own = self._lock_owner.get(lid)
            if own is not None and own[0] == me:
                self._lock_owner[lid] = (me, own[1] + 1)
            else:
                self._lock_owner[lid] = (me, 1)
            self._held.setdefault(me, []).append(f"{site[0]}:{site[1]}")

    def on_release(self, lock, site) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        lid = id(lock)
        me = threading.get_ident()
        with self._mu:
            own = self._lock_owner.get(lid)
            if own is not None and own[0] == me:
                if own[1] <= 1:
                    self._lock_owner.pop(lid, None)
                else:
                    self._lock_owner[lid] = (me, own[1] - 1)
            hl = self._held.get(me)
            if hl:
                s = f"{site[0]}:{site[1]}"
                for i in range(len(hl) - 1, -1, -1):
                    if hl[i] == s:
                        del hl[i]
                        break

    # --------------------------------------------- rpc.TRACE delegate

    def on_send(self, src, dst, method):
        inner = self._inner
        if not self._internal():
            global CONSULTS
            CONSULTS += 1
            me = threading.get_ident()
            with self._mu:
                dq = self._rpc_stack.get(me)
                if dq is None:
                    dq = self._rpc_stack[me] = deque(maxlen=8)
                dq.append({"src": src, "dst": dst, "method": method,
                           "t": time.monotonic()})
        if inner is not None:
            return inner.on_send(src, dst, method)
        self._lc += 1
        return self._lc

    def on_send_bytes(self, method, nbytes, kind):
        if not self._internal():
            global CONSULTS
            CONSULTS += 1
            if kind == "notify":
                # a notify never blocks: drop its in-flight entry so it
                # cannot masquerade as the wait target of a later
                # Future.result on this thread
                me = threading.get_ident()
                with self._mu:
                    dq = self._rpc_stack.get(me)
                    if dq and dq[-1]["method"] == method:
                        dq.pop()
        inner = self._inner
        if inner is not None:
            osb = getattr(inner, "on_send_bytes", None)
            if osb is not None:
                return osb(method, nbytes, kind)
        return None

    def on_recv(self, src, dst, method, lc):
        if not self._internal():
            global CONSULTS
            CONSULTS += 1
            with self._mu:
                # fires on the server's loop thread: THE thread an
                # in-flight rpc to `dst` is waiting on
                self._srv_thread[dst] = threading.get_ident()
        inner = self._inner
        if inner is not None:
            return inner.on_recv(src, dst, method, lc)
        return None

    def apply(self, *a, **k):
        inner = self._inner
        return inner.apply(*a, **k) if inner is not None else None

    def merge_clock(self, clock):
        inner = self._inner
        return inner.merge_clock(clock) if inner is not None else None

    def __getattr__(self, name: str):
        # transparent facade: unknown TRACE attrs (is_flight_recorder,
        # ring dumps, ...) resolve against the wrapped tracer
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ---------------------------------------------- runtime-patch hooks

    def _queue_wait(self, q) -> Optional[dict]:
        global CONSULTS
        if self._internal():
            return None
        CONSULTS += 1
        return self._wait_enter(("queue", id(q)),
                                f"queue.get 0x{id(q):x}")

    def _cond_wait(self, cv) -> Optional[dict]:
        global CONSULTS
        if self._internal():
            return None
        CONSULTS += 1
        return self._wait_enter(("cond", id(cv)),
                                f"condition.wait 0x{id(cv):x}")

    def _future_wait(self, fut) -> Optional[dict]:
        global CONSULTS
        if self._internal():
            return None
        CONSULTS += 1
        if fut.done():
            return None
        me = threading.get_ident()
        box = getattr(fut, "_wg_box", None)
        with self._mu:
            dq = self._rpc_stack.get(me)
            top = dict(dq[-1]) if dq else None
        if top is not None:
            # blocking on the reply to the newest in-flight rpc: the
            # wait edge crosses into the server's handler context
            return self._wait_enter(
                ("rpc-srv", top["dst"]),
                f"rpc {top['src']}->{top['dst']} `{top['method']}`",
                extra={"rpc": top, "box": box},
            )
        return self._wait_enter(("future", id(fut)),
                                f"future.result 0x{id(fut):x}",
                                extra={"box": box})

    def _future_wait_done(self, rec: Optional[dict]) -> None:
        if rec is None:
            return
        self._wait_exit(rec)
        rpc = rec.get("rpc")
        if rpc is not None:
            with self._mu:
                dq = self._rpc_stack.get(rec["tid"])
                if dq:
                    for i in range(len(dq) - 1, -1, -1):
                        if dq[i]["method"] == rpc["method"] \
                                and dq[i]["dst"] == rpc["dst"]:
                            del dq[i]
                            break

    # --------------------------------------- channel PARKWATCH target

    def chan_open(self, ch, role: str) -> None:
        global CONSULTS
        if self._internal():
            return
        CONSULTS += 1
        with self._mu:
            self._chan_end[(ch.key, role)] = threading.get_ident()

    def park_begin(self, ch, op: str) -> Optional[dict]:
        global CONSULTS
        if self._internal():
            return None
        CONSULTS += 1
        role = "writer" if op == "write" else "reader"
        peer = "reader" if op == "write" else "writer"
        with self._mu:
            self._chan_end[(ch.key, role)] = threading.get_ident()
        return self._wait_enter(
            ("chan", ch.key, peer),
            f"channel.{op} `{ch.key}` (peer: {peer})",
            extra={"chan": ch.key, "op": op, "ch": ch},
        )

    def park_end(self, ch, op: str, rec: Optional[dict]) -> None:
        if rec is None:
            return
        self._wait_exit(rec)

    # ------------------------------------------------- stall watchdog

    def _watch_loop(self) -> None:
        # the internal flag makes every own lock/queue/etc op invisible
        # to the instrumentation — the watchdog must never grow wait
        # records of its own
        self._tls.internal = True
        while not self._stop:
            time.sleep(self._watch_interval)
            try:
                self._scan_stalls()
            except Exception:
                # a crashed watchdog would silently disable stall
                # detection for the rest of the run; skip the bad scan
                pass

    def _chan_attribution(self, rec: dict) -> Dict[str, Any]:
        out: Dict[str, Any] = {"key": rec.get("chan"), "op": rec.get("op")}
        ch = rec.get("ch")
        if ch is not None:
            try:
                out.update(ch.wait_state())
                out["peer_pid"] = ch.peer_pid()
            except Exception:
                out["state"] = "unreadable"
        return out

    def _scan_stalls(self) -> None:
        now = time.monotonic()
        stale = []
        with self._mu:
            for tid, st in self._waits.items():
                if not st:
                    continue
                # attribute the OUTERMOST record: it names the
                # API-level wait (future.result, rpc, queue.get) rather
                # than the internal Condition it parks on, and carries
                # the owner/channel attribution the report needs
                rec = st[0]
                age = now - rec["t"]
                if age < self.stall_warn_s or id(rec) in self._warned:
                    continue
                self._warned.add(id(rec))
                stale.append((tid, rec, self._owner_of_locked(rec), age))
            held_snap = {t: list(h) for t, h in self._held.items()}
        if not stale:
            return
        stacks = self.dump_stacks()
        reports = []
        for tid, rec, owner, age in stale:
            holder = None
            if owner is not None:
                holder = {"tid": owner,
                          "thread": self._thread_name(owner),
                          "held": held_snap.get(owner, [])}
            entry: Dict[str, Any] = {
                "tid": tid,
                "thread": self._thread_name(tid),
                "resource": self._res_descr(rec),
                "age_s": round(age, 3),
                "holder": holder,
                # queue/cond waits are idle-consumer shapes, channel
                # waits carry their own attribution below: only a
                # lock/future/rpc wait with NO resolvable owner is a
                # genuinely unattributed stall
                "unattributed": owner is None
                and rec["res"][0] in ("lock", "future", "rpc-srv"),
                "stacks": stacks,
            }
            if rec.get("chan") is not None:
                entry["channel"] = self._chan_attribution(rec)
            reports.append(entry)
        with self._mu:
            self.stalls.extend(reports)
        self.dump("stall")

    # ------------------------------------------------------ reporting

    def dump_stacks(self) -> List[dict]:
        """All-thread stacks annotated with current wait edges and held
        locks (the `ray_tpu stacks` payload)."""
        frames = sys._current_frames()
        with self._mu:
            waits = {t: [self._res_descr(r) for r in st]
                     for t, st in self._waits.items()}
            held = {t: list(h) for t, h in self._held.items()}
        out = []
        for tid in sorted(frames):
            out.append({
                "tid": tid,
                "thread": self._thread_name(tid),
                "waiting_on": waits.get(tid, []),
                "held": held.get(tid, []),
                "stack": _fmt_frames(frames[tid], self.stack_depth),
            })
        return out

    def format_stacks(self, stacks: Optional[List[dict]] = None) -> str:
        stacks = stacks if stacks is not None else self.dump_stacks()
        lines = []
        for e in stacks:
            hdr = f"-- {e['thread']} (tid {e['tid']})"
            if e.get("waiting_on"):
                hdr += f"  WAITING on {e['waiting_on'][-1]}"
            if e.get("held"):
                hdr += f"  holding [{', '.join(e['held'])}]"
            lines.append(hdr)
            for rel, ln, name in e.get("stack", ()):
                lines.append(f"    {rel}:{ln} in {name}")
        return "\n".join(lines)

    def dump(self, reason: str = "report",
             out_dir: Optional[str] = None) -> str:
        """Write the accumulated deadlock + stall reports as a JSONL
        artifact beside the flight recorder's."""
        out_dir = out_dir or os.environ.get("RAY_TPU_FLIGHTREC_DIR",
                                            "artifacts")
        os.makedirs(out_dir, exist_ok=True)
        WaitSanitizer._dump_seq += 1
        path = os.path.join(
            out_dir,
            f"waitgraph-{os.getpid()}-{reason}-{WaitSanitizer._dump_seq}"
            ".jsonl",
        )
        with self._mu:
            deadlocks = list(self.deadlocks)
            stalls = list(self.stalls)
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "kind": "waitgraph-report", "pid": os.getpid(),
                "reason": reason, "deadlocks": len(deadlocks),
                "stalls": len(stalls),
            }) + "\n")
            for d in deadlocks:
                f.write(json.dumps(d) + "\n")
            for s in stalls:
                f.write(json.dumps({"kind": "stall", **s}) + "\n")
        return path

    def dump_stacks_artifact(self, out_dir: Optional[str] = None) -> str:
        """Write an annotated all-thread stack dump artifact (the
        `ray_tpu stacks` collection protocol; also the SIGUSR1 path)."""
        out_dir = out_dir or os.environ.get("RAY_TPU_FLIGHTREC_DIR",
                                            "artifacts")
        os.makedirs(out_dir, exist_ok=True)
        WaitSanitizer._dump_seq += 1
        path = os.path.join(
            out_dir,
            f"waitgraph-{os.getpid()}-stacks-{WaitSanitizer._dump_seq}"
            ".jsonl",
        )
        stacks = self.dump_stacks()
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"kind": "waitgraph-stacks",
                                "pid": os.getpid()}) + "\n")
            for e in stacks:
                f.write(json.dumps(e) + "\n")
        return path


def install_stack_signal(signum=None) -> None:
    """Install a SIGUSR1 handler that writes a
    ``waitgraph-<pid>-stacks-*.jsonl`` artifact — the collection
    protocol `ray_tpu stacks` drives against every local cluster
    process. Works with no sanitizer installed too: stacks without wait
    annotations are still stacks."""
    import signal

    signum = signum if signum is not None else signal.SIGUSR1

    def _on_sig(_sig, _frame):
        w = WAITGRAPH
        (w if w is not None else WaitSanitizer()).dump_stacks_artifact()

    signal.signal(signum, _on_sig)


# ------------------------------------------------------ runtime patches

_runtime_orig: Optional[dict] = None


def _patch_runtime() -> None:
    """Patch the blocking stdlib waits the lock seam cannot see:
    ``queue.Queue.get``, ``Future.result`` (+ ``submit``, which stamps
    the executing thread into a box so the future's owner resolves),
    and ``wait`` on the REAL Condition class (Event.wait routes through
    it). Every wrapper re-reads the WAITGRAPH global — the racer's
    zero-overhead-when-off pattern — and composes with the racer's own
    patches in LIFO install order."""
    global _runtime_orig
    if _runtime_orig is not None:
        return
    import concurrent.futures as cf
    import queue as queue_mod

    real_cond = _san._real_factories()[2]
    orig = {
        "queue_get": queue_mod.Queue.get,
        "submit": cf.ThreadPoolExecutor.submit,
        "result": cf.Future.result,
        "cond_wait": real_cond.wait,
        "cond_cls": real_cond,
    }

    def get(self, *a, **k):
        w = WAITGRAPH
        if w is None:
            return orig["queue_get"](self, *a, **k)
        rec = w._queue_wait(self)
        try:
            return orig["queue_get"](self, *a, **k)
        finally:
            w2 = WAITGRAPH
            if w2 is not None:
                w2._wait_exit(rec)

    def submit(self, fn, *args, **kwargs):
        w = WAITGRAPH
        if w is None:
            return orig["submit"](self, fn, *args, **kwargs)
        global CONSULTS
        CONSULTS += 1
        box: dict = {}

        def task(*a, **k):
            box["tid"] = threading.get_ident()
            try:
                return fn(*a, **k)
            finally:
                box["done"] = True

        fut = orig["submit"](self, task, *args, **kwargs)
        fut._wg_box = box
        return fut

    def result(self, timeout=None):
        w = WAITGRAPH
        if w is None:
            return orig["result"](self, timeout)
        rec = w._future_wait(self)
        try:
            return orig["result"](self, timeout)
        finally:
            w2 = WAITGRAPH
            if w2 is not None:
                w2._future_wait_done(rec)

    def cond_wait(self, timeout=None):
        w = WAITGRAPH
        if w is None:
            return orig["cond_wait"](self, timeout)
        rec = w._cond_wait(self)
        try:
            return orig["cond_wait"](self, timeout)
        finally:
            w2 = WAITGRAPH
            if w2 is not None:
                w2._wait_exit(rec)

    queue_mod.Queue.get = get
    cf.ThreadPoolExecutor.submit = submit
    cf.Future.result = result
    real_cond.wait = cond_wait
    _runtime_orig = orig


def _unpatch_runtime() -> None:
    global _runtime_orig
    if _runtime_orig is None:
        return
    import concurrent.futures as cf
    import queue as queue_mod

    queue_mod.Queue.get = _runtime_orig["queue_get"]
    cf.ThreadPoolExecutor.submit = _runtime_orig["submit"]
    cf.Future.result = _runtime_orig["result"]
    _runtime_orig["cond_cls"].wait = _runtime_orig["cond_wait"]
    _runtime_orig = None


# =====================================================================
# seeded-bug probes (the regression teeth)
# =====================================================================


class ProbeResult:
    def __init__(self, name: str, seeded: Tuple[str, ...],
                 detected: bool, rounds: int, deadlocks: List[dict],
                 stalls: List[dict]):
        self.name = name
        self.seeded = seeded
        self.detected = detected
        self.rounds = rounds
        self.deadlocks = deadlocks
        self.stalls = stalls

    def summary(self) -> str:
        state = (f"DEADLOCK after {self.rounds} round(s)" if self.detected
                 else f"clean after {self.rounds} round(s)")
        seed = f" [seeded: {','.join(self.seeded)}]" if self.seeded else ""
        return (f"waitgraph:{self.name}: {state}, "
                f"{len(self.deadlocks)} report(s){seed}")


def _probe_gcs_stream_ack(_round: int) -> None:
    """gcs layer: drives the REAL ``rpc_stream_ack`` against a fake
    daemon client whose handler (on a real executor thread) needs the
    GCS lock. Clean code snapshots under the lock and notifies OUTSIDE
    it — no cycle; the seeded ``stream-ack-under-lock`` branch blocks
    on the daemon's reply while HOLDING it: main waits
    rpc-srv(daemon), the daemon worker waits the gcs lock — a
    lock-RPC wait cycle, detected at whichever side parks last."""
    import concurrent.futures as cf

    from ray_tpu_torch.cluster import rpc as rpc_mod
    from ray_tpu_torch.cluster.gcs import GcsServer

    g = object.__new__(GcsServer)
    g._lock = threading.RLock()  # instrumented: allocated under the seam
    g.running = {"t-probe": {"node_id": "n1"}}
    g.nodes = {"n1": {"alive": True, "addr": "127.0.0.1", "port": 0}}

    pool = cf.ThreadPoolExecutor(max_workers=1,
                                 thread_name_prefix="waitprobe-daemon")
    started = threading.Event()

    class _Client:
        """Just enough of a daemon RpcClient for `_daemon_client`'s
        cache hit: sends consult rpc.TRACE exactly like the real client
        so the sanitizer sees the in-flight rpc, and the handler runs
        on the pool thread after registering via on_recv."""

        _closed = False

        def _handle(self, method, lc):
            t = rpc_mod.TRACE
            if t is not None:
                t.on_recv("gcs", "daemon", method, lc)
            started.set()
            if g._lock.acquire(timeout=8.0):
                g._lock.release()
            return {"ok": True}

        def call_async(self, method, payload=None, **kw):
            t = rpc_mod.TRACE
            lc = t.on_send("gcs", "daemon", method) if t is not None \
                else None
            fut = pool.submit(self._handle, method, lc)
            # the handler must be REGISTERED (on_recv) before the
            # caller blocks on the reply, or the probe round becomes
            # schedule-sensitive
            started.wait(5.0)
            return fut

        def notify(self, method, payload=None, **kw):
            t = rpc_mod.TRACE
            lc = None
            if t is not None:
                lc = t.on_send("gcs", "daemon", method)
                osb = getattr(t, "on_send_bytes", None)
                if osb is not None:
                    osb(method, 0, "notify")
            pool.submit(self._handle, method, lc)

    g._daemon_clients = {"n1": _Client()}
    try:
        GcsServer.rpc_stream_ack(
            g, {"task_id": "t-probe", "consumed": 1}, None)
    finally:
        pool.shutdown(wait=True)


def _probe_dag_read_under_lock(_round: int) -> None:
    """dag layer: a reader thread in the REAL per-output read-retry
    loop vs a closer thread driving the REAL ``teardown``. Clean code
    reads with no lock held — teardown proceeds, the read unblocks with
    a drained/timeout error; the seeded ``chan-read-under-lock`` branch
    parks the read while HOLDING ``_life_lock``: closer blocks on the
    lock, reader blocks on the channel whose writer end the closer
    owns — a lock-channel wait cycle."""
    import tempfile

    from ray_tpu_torch.dag import channel as chan_mod
    from ray_tpu_torch.dag.compiled import CompiledDAG

    dag = object.__new__(CompiledDAG)
    dag._life_lock = threading.Lock()
    dag._torn_down = False
    dag._seq = 0
    dag._inputs = []
    dag._outputs = []
    dag.dag_id = "wait-probe"
    dag._rt = type("_Rt", (), {
        "dag_teardown": staticmethod(lambda _id: None),
        "dag_state": staticmethod(lambda _id: {}),
    })()

    created = threading.Event()
    holding = threading.Event()
    path = tempfile.mktemp(prefix="wg-chan-")
    key = "wg-probe"
    errs: List[BaseException] = []

    def closer():
        # the CLOSER creates the channel so the writer end — the
        # resource the parked reader waits on — is owned by the thread
        # that will block on _life_lock
        ch = chan_mod.Channel.create(path, capacity=4096, key=key)
        created.set()
        holding.wait(8.0)
        try:
            CompiledDAG.teardown(dag)
        finally:
            ch.close()
            ch.detach()

    def reader():
        created.wait(8.0)
        r = chan_mod.Channel.open_wait(path, key, timeout=8.0)
        try:
            deadline = time.monotonic() + 2.5
            # should_stop fires INSIDE the read wait loop, i.e. after
            # the seeded branch took _life_lock: only then may the
            # closer start its teardown (Event.set returns None -> the
            # probe never actually stops the read)
            CompiledDAG._read_output(
                dag, r, deadline,
                should_stop=lambda: (holding.set() or False))
        except chan_mod.ChannelTimeoutError:
            pass
        except chan_mod.ChannelClosedError:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
        finally:
            r.detach()

    t1 = threading.Thread(target=closer, name="waitprobe-closer")
    t2 = threading.Thread(target=reader, name="waitprobe-reader")
    t2.start()
    t1.start()
    t1.join(20.0)
    t2.join(20.0)
    try:
        os.unlink(path)
    except OSError:
        pass
    if errs:
        raise errs[0]


WAIT_PROBES = {
    "gcs-stream-ack-reentry": _probe_gcs_stream_ack,
    "dag-read-under-lock": _probe_dag_read_under_lock,
}


def _seed_sets(names: Sequence[str]):
    """(module SEEDED_BUGS set, prior contents) per module touched.
    Unknown names are an error: silently ignoring a typo'd seed would
    make a never-armed run read as 'seeded and clean'."""
    known = {bug for bug, _m, _p in SEEDED_WAITS}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(
            f"unknown seeded wait(s) {unknown}; have {sorted(known)}"
        )
    touched = []
    for bug, modname, _probe in SEEDED_WAITS:
        mod = importlib.import_module(modname)
        touched.append((mod.SEEDED_BUGS, set(mod.SEEDED_BUGS)))
        if bug in names:
            mod.SEEDED_BUGS.add(bug)
    return touched


def run_probe(name: str, seeded_bugs: Sequence[str] = (),
              rounds: int = 3, stall_warn_s: float = 30.0) -> ProbeResult:
    """Run one probe for up to ``rounds`` rounds (stop as soon as a
    deadlock is reported). With a seeded bug armed the sanitizer must
    detect within the gate bar lint_gate enforces (<= 2 rounds)."""
    if name not in WAIT_PROBES:
        raise ValueError(
            f"unknown wait probe {name!r}; have {sorted(WAIT_PROBES)}"
        )
    prev = _seed_sets(seeded_bugs)
    san = WaitSanitizer(stall_warn_s=stall_warn_s)
    ran = 0
    try:
        san.install()
        for i in range(rounds):
            ran = i + 1
            WAIT_PROBES[name](i)
            if san.found:
                break
    finally:
        san.uninstall()
        for bugset, before in prev:
            bugset.clear()
            bugset.update(before)
    return ProbeResult(name, tuple(seeded_bugs), san.found, ran,
                       list(san.deadlocks), list(san.stalls))
