"""Interprocedural RPC-cost analysis + per-operation RPC budget ratchet.

BENCH_r05 showed the scheduling kernel doing 9.6M decisions/s while the
cluster tops out at ~2.9k tasks/s end-to-end: per-task control-plane RPC
chatter is the bottleneck, and the planned daemon-local-lease refactor
(ROADMAP #1, the Raylet/GCS split) is *about* deleting round trips. This
module answers, statically and machine-readably, "how many control-plane
RPCs does each driver-facing operation cost, and where do they come
from?" — and freezes the answer in a committed budget so CI refuses any
PR that sneaks a new per-task round trip in.

Three pieces, in the house style (static claim -> dynamic verification ->
honesty gate):

- **Static** (`build_rpcflow`): an interprocedural call graph from the
  public entry points (client.py driver API, dag execute, serve handle
  request, autoscaler tick, daemon/GCS background loops) down to every
  `.call` / `.call_async` / `.notify` / push site, reusing protocol.py's
  RPC-surface tables (CALL_ATTRS/PUSH_ATTRS + literal-method extraction).
  Each reachable site is classified by multiplicity: ``per-call`` (runs
  once per operation), ``per-item`` (inside a loop, with loop-nest
  depth — the N+1 smell), ``amortized`` (behind a `not in` cache-miss
  guard), ``once`` (behind an `is None`/`not flag` one-shot guard), or
  ``batched`` (payload carries a list-valued batch key). `--dump-rpcflow`
  prints the per-operation cost table.

- **Dynamic** (`RpcProfiler`): a transparent wrapper over the `rpc.TRACE`
  seam that attributes round trips / notifies / pushes / frame bytes to
  driver *operation spans* (thread-local stack, entered via the
  `util.tracing.PROFILE` seam by client.py / dag/compiled.py /
  serve/handle.py). Everything the inner tracer (flight recorder or
  invariant tracer) does is delegated, so the profiler stacks on top of
  either without changing semantics.

- **Gate** (`check_measured` / `ratchet_check`, driven by
  ``lint_gate --rpc-budget``): measured per-operation RPC counts must fit
  the committed `.rpc-budget.json` AND the statically-predicted
  multiplicity class (a zero-RPC op must measure zero). Budget entries
  may decrease, never increase — the ratchet the sharding refactor will
  prove its >= 10x against.

Reference: Ray's own GCS-chatter postmortems (task submission cost in
rounds trips is the headline metric of the Raylet split), plus the
rpc-metrics tables gcs_server emits per method.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis.core import ModuleContext, iter_modules
from ray_tpu_torch.analysis.protocol import CALL_ATTRS, PUSH_ATTRS

# --------------------------------------------------------------- constants

#: payload-dict keys whose presence marks a call site as carrying a batch
#: (one frame, N items) rather than a per-item round trip
BATCH_PAYLOAD_KEYS = frozenset({
    "object_ids", "results", "tasks", "items", "updates", "events",
    "specs", "batch", "bundles", "metrics",
})

#: per-item methods with a known batched counterpart in this tree — the
#: table the `rpc-in-loop` checker keys on. Values are the remediation
#: hint shown in the finding.
BATCHED_COUNTERPARTS: Dict[str, str] = {
    "add_object_location": (
        "send one call with `object_ids=[...]` (the handler accepts the "
        "batched form; task_done already reports result locations in one "
        "frame)"
    ),
    "free_objects": (
        "already takes `object_ids` — aggregate the ids and send one call"
    ),
    "note_object": (
        "aggregate into the next heartbeat or send one batched "
        "`add_object_location` with `object_ids=[...]`"
    ),
}

#: entry points the cost table is computed from:
#: op name -> (relpath suffix, class name or None, function name)
ENTRY_POINTS: Dict[str, Tuple[str, Optional[str], str]] = {
    "submit_task": ("cluster/client.py", "ClusterClient", "submit_task"),
    "get": ("cluster/client.py", "ClusterClient", "get"),
    "wait": ("cluster/client.py", "ClusterClient", "wait"),
    "put": ("cluster/client.py", "ClusterClient", "put"),
    # the actor-call frame is sent by the per-actor dispatcher thread
    # (ordered submission), not by the enqueue in _submit_actor_call_meta
    "actor_call": ("cluster/client.py", "ClusterClient",
                   "_actor_dispatch_loop"),
    # actor creation rides submit_task with spec.actor_creation=True (the
    # register_actor branch); same entry, budgeted separately
    "actor_create": ("cluster/client.py", "ClusterClient", "submit_task"),
    "pg_create": ("cluster/client.py", "ClusterClient",
                  "create_placement_group"),
    "dag_execute": ("dag/compiled.py", "CompiledDAG", "execute"),
    "serve_request": ("serve/fastpath.py", "FastPathRouter", "submit"),
    "autoscaler_tick": ("autoscaler/autoscaler.py", "Autoscaler", "_loop"),
    "daemon_heartbeat": ("cluster/node_daemon.py", "NodeDaemon",
                         "_heartbeat_loop"),
    "gcs_sched_loop": ("cluster/gcs.py", "GcsServer", "_sched_loop"),
}

#: loops are the *body* of these entry ops; one "operation" is one pass,
#: so the top-level While of the loop function itself does not count as
#: per-item nesting
_LOOP_BODY_OPS = frozenset({
    "autoscaler_tick", "daemon_heartbeat", "gcs_sched_loop", "actor_call",
})

_MAX_DEPTH = 4          # loop-nest depth cap (memoization granularity)
_MAX_CHAIN = 24         # call-chain length cap
_MULT_ORDER = {"repair": 0, "once": 1, "amortized": 2, "batched": 3,
               "per-call": 4, "per-item": 5}

# ------------------------------------------------------------ static model


@dataclasses.dataclass
class SiteUse:
    """One RPC site as reached from one entry operation."""

    path: str
    line: int
    kind: str           # call | call_async | notify | push
    method: str         # literal method/topic, or "<dynamic>"
    target: str         # receiver expression text, e.g. "self.gcs"
    depth: int          # accumulated loop-nest depth along the chain
    guard: Optional[str]  # "once" | "amortized" | None
    mclass: str         # once|amortized|batched|per-call|per-item
    via: Tuple[str, ...]  # qualname chain from the entry function

    def to_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path, "line": self.line, "kind": self.kind,
            "method": self.method, "target": self.target,
            "depth": self.depth, "guard": self.guard, "class": self.mclass,
            "via": list(self.via),
        }


@dataclasses.dataclass
class OpCost:
    """Per-operation cost row: every RPC site reachable from the entry."""

    op: str
    entry: str                 # "cluster/client.py:ClusterClient.submit_task"
    sites: List[SiteUse] = dataclasses.field(default_factory=list)

    @property
    def steady_sites(self) -> List[SiteUse]:
        """Sites that cost a frame on EVERY operation (per-call/per-item/
        batched round trips and notifies; once/amortized excluded)."""
        return [s for s in self.sites
                if s.mclass in ("per-call", "per-item", "batched")
                and s.kind in ("call", "call_async", "notify")]

    @property
    def predicted_class(self) -> str:
        """zero | bounded | per-item — the claim the dynamic gate checks."""
        steady = self.steady_sites
        if not steady:
            return "zero"
        if any(s.mclass == "per-item" for s in steady):
            return "per-item"
        return "bounded"

    @property
    def bounded_count(self) -> int:
        """Upper bound of steady-state frames/op for a `bounded` op."""
        return len(self.steady_sites)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "op": self.op, "entry": self.entry,
            "predicted_class": self.predicted_class,
            "bounded_count": self.bounded_count,
            "sites": [s.to_dict() for s in self.sites],
        }


@dataclasses.dataclass
class RpcFlowReport:
    ops: Dict[str, OpCost]
    functions_indexed: int
    files_scanned: int
    unresolved_entries: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "functions_indexed": self.functions_indexed,
            "files_scanned": self.files_scanned,
            "unresolved_entries": self.unresolved_entries,
            "ops": {k: v.to_dict() for k, v in sorted(self.ops.items())},
        }


@dataclasses.dataclass
class _FuncInfo:
    key: Tuple[str, str]       # (relpath, qualname)
    relpath: str
    cls: Optional[str]
    name: str
    node: Any                  # ast.FunctionDef | ast.AsyncFunctionDef


class _FuncIndex:
    """Whole-tree function table with the pragmatic resolvers the call
    graph uses: ``self.m()`` -> same class, bare ``f()`` -> same module
    then unique global, ``obj.m()`` -> unique method name repo-wide."""

    def __init__(self) -> None:
        self.funcs: Dict[Tuple[str, str], _FuncInfo] = {}
        self._module_fns: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self._class_methods: Dict[Tuple[str, str, str], Tuple[str, str]] = {}
        self._by_method: Dict[str, List[Tuple[str, str]]] = {}
        self._by_name: Dict[str, List[Tuple[str, str]]] = {}
        self.files = 0

    def add_module(self, ctx: ModuleContext) -> None:
        self.files += 1
        rel = ctx.relpath.replace("\\", "/")
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add(rel, None, node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._add(rel, node.name, sub)

    def _add(self, rel: str, cls: Optional[str], node) -> None:
        qual = f"{cls}.{node.name}" if cls else node.name
        key = (rel, qual)
        info = _FuncInfo(key=key, relpath=rel, cls=cls, name=node.name,
                         node=node)
        self.funcs[key] = info
        if cls is None:
            self._module_fns[(rel, node.name)] = key
            self._by_name.setdefault(node.name, []).append(key)
        else:
            self._class_methods[(rel, cls, node.name)] = key
            self._by_method.setdefault(node.name, []).append(key)

    def lookup(self, rel: str, cls: Optional[str],
               name: str) -> Optional[_FuncInfo]:
        key = (self._class_methods.get((rel, cls, name))
               if cls else self._module_fns.get((rel, name)))
        return self.funcs.get(key) if key else None

    def resolve_call(self, call: ast.Call, caller: _FuncInfo
                     ) -> Optional[_FuncInfo]:
        f = call.func
        if isinstance(f, ast.Name):
            # bare f(): same module first, else unique repo-wide
            info = self.lookup(caller.relpath, None, f.id)
            if info is not None:
                return info
            cands = self._by_name.get(f.id, [])
            return self.funcs[cands[0]] if len(cands) == 1 else None
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and caller.cls is not None:
                # the class is known: a miss means a stored callable or
                # an inherited method — falling back to the unique-name
                # heuristic here fabricates cross-class edges
                return self.lookup(caller.relpath, caller.cls, f.attr)
            if f.attr.startswith("__"):
                return None
            # obj.m(): only when the method name is unambiguous repo-wide
            cands = self._by_method.get(f.attr, [])
            if len(cands) == 1:
                return self.funcs[cands[0]]
        return None


def _guard_kind(test: ast.AST) -> Optional[str]:
    """Classify an if-test as a cache/one-shot miss guard.

    ``x not in cache`` -> "amortized" (container membership: pays a frame
    only on cache misses); ``x is None`` / ``not x`` -> "once" (scalar
    one-shot flag: pays a frame on first use). An ``and``-conjunction is
    a miss guard if any conjunct is (the branch runs at most when that
    conjunct holds)."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            g = _guard_kind(v)
            if g is not None:
                return g
        return None
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        op = test.ops[0]
        if isinstance(op, ast.NotIn):
            return "amortized"
        if isinstance(op, ast.Is) and isinstance(
            test.comparators[0], ast.Constant
        ) and test.comparators[0].value is None:
            return "once"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, (ast.Name, ast.Attribute)):
        return "once"
    return None


def _hit_guard(test: ast.AST, ret: ast.Return) -> bool:
    """True for a cache-HIT early exit: `if p is not None: return p` /
    `if k in cache: return cache[k]`. The returned value must share a
    name with the test — a dispatch branch that early-returns something
    unrelated (`if spec.actor_id is not None: ...; return refs`) is a
    code path split, not a cache hit, and the fall-through is still
    steady state."""

    def _matches(t: ast.AST) -> bool:
        if isinstance(t, ast.BoolOp) and isinstance(t.op, ast.And):
            return any(_matches(v) for v in t.values)
        if isinstance(t, ast.Compare) and len(t.ops) == 1:
            op = t.ops[0]
            if isinstance(op, ast.In):
                return True
            if isinstance(op, ast.IsNot) and isinstance(
                t.comparators[0], ast.Constant
            ) and t.comparators[0].value is None:
                return True
        return False

    if not _matches(test) or ret.value is None:
        return False
    test_names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
    test_names |= {n.attr for n in ast.walk(test)
                   if isinstance(n, ast.Attribute)}
    ret_names = {n.id for n in ast.walk(ret.value)
                 if isinstance(n, ast.Name)}
    ret_names |= {n.attr for n in ast.walk(ret.value)
                  if isinstance(n, ast.Attribute)}
    return bool(test_names & ret_names)


def _expr_text(node: ast.AST, limit: int = 40) -> str:
    try:
        s = ast.unparse(node)
    except Exception:  # noqa: BLE001 - unparse is best-effort labeling
        s = "<expr>"
    return s if len(s) <= limit else s[: limit - 3] + "..."


def _literal_method(call: ast.Call, argpos: int = 0) -> str:
    if len(call.args) > argpos and isinstance(
        call.args[argpos], ast.Constant
    ) and isinstance(call.args[argpos].value, str):
        return call.args[argpos].value
    return "<dynamic>"


def _payload_keys(call: ast.Call) -> Optional[List[str]]:
    """Literal keys of a dict-literal payload (2nd positional arg)."""
    if len(call.args) < 2 or not isinstance(call.args[1], ast.Dict):
        return None
    keys = []
    for k in call.args[1].keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.append(k.value)
    return keys


def _classify(kind: str, method: str, keys: Optional[List[str]],
              depth: int, guard: Optional[str]) -> str:
    if guard == "repair":
        return "repair"
    if keys and BATCH_PAYLOAD_KEYS & set(keys):
        return "batched"
    if guard is not None:
        return guard
    if depth > 0:
        return "per-item"
    return "per-call"


class _Walker:
    """DFS from one entry function, tracking loop depth + cache guards."""

    def __init__(self, index: _FuncIndex) -> None:
        self.index = index
        self.sites: List[SiteUse] = []
        # (funckey, capped depth, guard) -> visited: bounds re-walks while
        # still letting the same helper contribute at different depths
        self._seen: Set[Tuple[Tuple[str, str], int, Optional[str]]] = set()

    def walk(self, info: _FuncInfo, depth: int = 0,
             guard: Optional[str] = None,
             chain: Tuple[str, ...] = ()) -> None:
        key = (info.key, min(depth, _MAX_DEPTH), guard)
        if key in self._seen or len(chain) >= _MAX_CHAIN:
            return
        self._seen.add(key)
        chain = chain + (f"{info.relpath}:{info.key[1]}",)
        self._visit_body(info.node.body, info, depth, guard, chain)

    # ------------------------------------------------------ body traversal

    def _visit_body(self, stmts, info, depth, guard, chain) -> None:
        for st in stmts:
            self._visit_stmt(st, info, depth, guard, chain)
            # early-return cache hit (`if p is not None: return p`): the
            # rest of this block is the miss path
            if guard is None and isinstance(st, ast.If) and st.body \
                    and isinstance(st.body[-1], ast.Return) \
                    and not st.orelse \
                    and _hit_guard(st.test, st.body[-1]):
                guard = "amortized"

    def _visit_stmt(self, st, info, depth, guard, chain) -> None:
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._visit_expr(st.iter, info, depth, guard, chain)
            self._visit_body(st.body, info, depth + 1, guard, chain)
            self._visit_body(st.orelse, info, depth, guard, chain)
            return
        if isinstance(st, ast.While):
            self._visit_expr(st.test, info, depth, guard, chain)
            self._visit_body(st.body, info, depth + 1, guard, chain)
            self._visit_body(st.orelse, info, depth, guard, chain)
            return
        if isinstance(st, ast.If):
            self._visit_expr(st.test, info, depth, guard, chain)
            g = _guard_kind(st.test)
            self._visit_body(st.body, info, depth, g or guard, chain)
            self._visit_body(st.orelse, info, depth, guard, chain)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def (callback): body runs at most once per outer call
            # in every pattern this tree uses — walk it at current depth
            self._visit_body(st.body, info, depth, guard, chain)
            return
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, (ast.Try,)):
            self._visit_body(st.body, info, depth, guard, chain)
            for h in st.handlers:
                # except bodies are fault-repair paths, not steady state
                self._visit_body(h.body, info, depth, guard or "repair",
                                 chain)
            self._visit_body(st.orelse, info, depth, guard, chain)
            self._visit_body(st.finalbody, info, depth, guard, chain)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._visit_expr(item.context_expr, info, depth, guard,
                                 chain)
            self._visit_body(st.body, info, depth, guard, chain)
            return
        # leaf statements: scan embedded expressions for calls
        for sub in ast.iter_child_nodes(st):
            self._visit_expr(sub, info, depth, guard, chain)

    def _visit_expr(self, expr, info, depth, guard, chain) -> None:
        if expr is None or isinstance(expr, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.ClassDef)):
            return
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # comprehension element + conditions run per item: one extra
            # loop level for everything inside
            for sub in ast.iter_child_nodes(expr):
                self._visit_expr(sub, info, depth + 1, guard, chain)
            return
        if isinstance(expr, ast.Call):
            self._handle_call(expr, info, depth, guard, chain)
        for sub in ast.iter_child_nodes(expr):
            self._visit_expr(sub, info, depth, guard, chain)

    # ----------------------------------------------------------- call sites

    def _handle_call(self, call: ast.Call, info, depth, guard,
                     chain) -> None:
        f = call.func
        eff_depth = depth
        if isinstance(f, ast.Attribute):
            if f.attr in CALL_ATTRS and call.args:
                # zero-arg .notify()/.call() is threading.Condition or an
                # unrelated callable — the rpc idiom always passes the
                # method name first
                method = _literal_method(call)
                self.sites.append(SiteUse(
                    path=info.relpath, line=call.lineno, kind=f.attr,
                    method=method, target=_expr_text(f.value),
                    depth=eff_depth, guard=guard,
                    mclass=_classify(f.attr, method, _payload_keys(call),
                                     eff_depth, guard),
                    via=chain,
                ))
                return
            if f.attr in PUSH_ATTRS:
                pos = PUSH_ATTRS[f.attr]
                method = _literal_method(call, pos)
                # pushes with a dict payload right after the topic
                keys = None
                if len(call.args) > pos + 1 and isinstance(
                    call.args[pos + 1], ast.Dict
                ):
                    keys = [k.value for k in call.args[pos + 1].keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)]
                self.sites.append(SiteUse(
                    path=info.relpath, line=call.lineno, kind="push",
                    method=method, target=_expr_text(f.value),
                    depth=eff_depth, guard=guard,
                    mclass=_classify("push", method, keys, eff_depth,
                                     guard),
                    via=chain,
                ))
                return
        callee = self.index.resolve_call(call, info)
        if callee is not None:
            self.walk(callee, eff_depth, guard, chain)


def build_rpcflow(paths: Sequence[str], root: str) -> RpcFlowReport:
    """Index the tree, then trace each entry operation to its RPC sites."""
    index = _FuncIndex()
    for ctx in iter_modules(paths, root):
        index.add_module(ctx)
    ops: Dict[str, OpCost] = {}
    unresolved: List[str] = []
    for op, (suffix, cls, name) in sorted(ENTRY_POINTS.items()):
        info = None
        for (rel, _qual), fi in index.funcs.items():
            if rel.endswith(suffix) and fi.cls == cls and fi.name == name:
                info = fi
                break
        if info is None:
            unresolved.append(op)
            continue
        w = _Walker(index)
        w.walk(info)
        sites = w.sites
        if op in _LOOP_BODY_OPS:
            # one operation == one pass of the loop body: strip the loop
            # function's own top-level While from every site's depth
            sites = [dataclasses.replace(
                s, depth=max(0, s.depth - 1),
                mclass=_classify(s.kind, s.method, None,
                                 max(0, s.depth - 1), s.guard)
                if s.mclass in ("per-call", "per-item") else s.mclass,
            ) for s in sites]
        entry = f"{info.relpath}:{info.key[1]}"
        ops[op] = OpCost(op=op, entry=entry, sites=sites)
    return RpcFlowReport(ops=ops, functions_indexed=len(index.funcs),
                         files_scanned=index.files,
                         unresolved_entries=unresolved)


def format_rpcflow(report: RpcFlowReport) -> str:
    lines = [
        f"rpcflow: {report.functions_indexed} functions over "
        f"{report.files_scanned} files",
    ]
    if report.unresolved_entries:
        lines.append(
            f"  UNRESOLVED entries: {', '.join(report.unresolved_entries)}"
        )
    for op, cost in sorted(report.ops.items()):
        steady = cost.steady_sites
        lines.append(
            f"\n{op}  [{cost.predicted_class}"
            + (f", <= {cost.bounded_count} frames/op"
               if cost.predicted_class == "bounded" else "")
            + f"]  entry={cost.entry}"
        )
        for s in sorted(cost.sites,
                        key=lambda s: (-_MULT_ORDER[s.mclass], s.path,
                                       s.line)):
            d = f" depth={s.depth}" if s.mclass == "per-item" else ""
            lines.append(
                f"  {s.mclass:>9}{d}  {s.kind:>10} {s.method:<24} "
                f"{s.target:<22} {s.path}:{s.line}"
            )
        if not cost.sites:
            lines.append("  (no reachable RPC sites)")
    return "\n".join(lines)


# --------------------------------------------------------- dynamic profiler


class _OpStats:
    __slots__ = ("invocations", "calls", "notifies", "pushes", "bytes")

    def __init__(self) -> None:
        self.invocations = 0
        self.calls = 0
        self.notifies = 0
        self.pushes = 0
        self.bytes = 0

    def to_dict(self) -> Dict[str, int]:
        return {"invocations": self.invocations, "calls": self.calls,
                "notifies": self.notifies, "pushes": self.pushes,
                "bytes": self.bytes}


class RpcProfiler:
    """Per-operation RPC profiler riding the ``rpc.TRACE`` seam.

    Installs as a TRANSPARENT wrapper: every tracer hook is counted and
    then delegated to whatever tracer was installed before (the default
    flight recorder, the invariant tracer, or nothing), so stacking the
    profiler never changes recording/invariant semantics. Operation spans
    are entered by the driver entry points via the ``tracing.PROFILE``
    seam (zero overhead when no profiler is installed: a module-global
    ``is None`` check, same discipline as ``rpc.TRACE`` itself)."""

    is_rpc_profiler = True

    def __init__(self) -> None:
        self._ops: Dict[str, _OpStats] = {}
        self._unattributed = _OpStats()
        # frames by RPC method, across ALL threads — background-plane
        # frames (daemon/GCS loops) carry no driver op span, so a regrown
        # N+1 there surfaces here, not in the per-op table
        self._methods: Dict[str, int] = {}
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._inner: Any = None
        self._installed = False

    # ------------------------------------------------------------ lifecycle

    def install(self) -> "RpcProfiler":
        from ray_tpu_torch.cluster import rpc as rpc_mod
        from ray_tpu_torch.util import tracing

        if self._installed:
            return self
        self._inner = rpc_mod.TRACE
        rpc_mod.TRACE = self
        tracing.PROFILE = self
        self._installed = True
        return self

    def uninstall(self) -> None:
        from ray_tpu_torch.cluster import rpc as rpc_mod
        from ray_tpu_torch.util import tracing

        if not self._installed:
            return
        if rpc_mod.TRACE is self:
            rpc_mod.TRACE = self._inner
        if tracing.PROFILE is self:
            tracing.PROFILE = None
        self._installed = False

    # ----------------------------------------------------------- op spans

    def _stack(self) -> List[List[Any]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def op_begin(self, name: str) -> List[Any]:
        # frame: [name, t0, stats-delta] — mutated in place by the hooks
        frame = [name, time.time(), _OpStats()]
        self._stack().append(frame)
        return frame

    def op_end(self, frame: List[Any]) -> None:
        from ray_tpu_torch.util import tracing

        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is frame:
                del st[i]
                break
        name, t0, delta = frame
        with self._mu:
            agg = self._ops.get(name)
            if agg is None:
                agg = self._ops[name] = _OpStats()
            agg.invocations += 1
            agg.calls += delta.calls
            agg.notifies += delta.notifies
            agg.pushes += delta.pushes
            agg.bytes += delta.bytes
        tracing.record_span(
            f"op:{name}", t0, time.time(), rpcs=delta.calls,
            notifies=delta.notifies, pushes=delta.pushes,
            rpc_bytes=delta.bytes,
        )

    @contextlib.contextmanager
    def operation(self, name: str):
        frame = self.op_begin(name)
        try:
            yield
        finally:
            self.op_end(frame)

    def _current(self) -> Optional[_OpStats]:
        st = getattr(self._tls, "stack", None)
        return st[-1][2] if st else None

    # ----------------------------------------------- counted tracer hooks

    def on_send(self, src: str, dst: str, method: str):
        # counting happens in on_send_bytes (which also knows frame size
        # and call-vs-notify); this hook only preserves inner semantics
        inner = self._inner
        return inner.on_send(src, dst, method) if inner is not None else None

    def on_send_bytes(self, method: str, nbytes: int, kind: str) -> None:
        cur = self._current()
        if cur is None:
            with self._mu:
                self._bump(self._unattributed, kind, nbytes)
                self._methods[method] = self._methods.get(method, 0) + 1
            return
        self._bump(cur, kind, nbytes)
        with self._mu:
            self._methods[method] = self._methods.get(method, 0) + 1

    @staticmethod
    def _bump(stats: _OpStats, kind: str, nbytes: int) -> None:
        if kind == "notify":
            stats.notifies += 1
        else:
            stats.calls += 1
        stats.bytes += nbytes

    def on_push(self, server: str, peer: str, channel: str):
        cur = self._current()
        if cur is None:
            with self._mu:
                self._unattributed.pushes += 1
        else:
            cur.pushes += 1
        inner = self._inner
        if inner is not None:
            return inner.on_push(server, peer, channel)
        return None

    # -------------------------------------------- pure-delegation hooks

    def on_recv(self, *a, **kw):
        inner = self._inner
        return inner.on_recv(*a, **kw) if inner is not None else None

    def apply(self, kind, **fields):
        inner = self._inner
        return inner.apply(kind, **fields) if inner is not None else None

    def merge_clock(self, clock):
        inner = self._inner
        return inner.merge_clock(clock) if inner is not None else None

    def __getattr__(self, name: str):
        # transparent facade: unknown attrs (is_flight_recorder, ring
        # dumps, ...) resolve against the wrapped tracer
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ------------------------------------------------------------ results

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "ops": {k: v.to_dict() for k, v in sorted(self._ops.items())},
                "unattributed": self._unattributed.to_dict(),
                "methods": dict(sorted(self._methods.items())),
            }

    def method_count(self, method: str) -> int:
        with self._mu:
            return self._methods.get(method, 0)

    def reset(self) -> None:
        """Zero the aggregates (keeps op spans live). Callers measuring
        steady state run a warmup pass, reset(), then the measured pass —
        once/amortized sites pay their frames before the reset."""
        with self._mu:
            self._ops.clear()
            self._unattributed = _OpStats()
            self._methods.clear()

    def per_op_rpcs(self) -> Dict[str, float]:
        """Round trips + notifies per invocation, by operation."""
        with self._mu:
            return {
                name: (s.calls + s.notifies) / max(1, s.invocations)
                for name, s in self._ops.items()
            }


@contextlib.contextmanager
def profiled_operation(name: str):
    """Module-level convenience for call sites that don't hold a profiler
    reference: no-op when no profiler is installed."""
    from ray_tpu_torch.util import tracing

    p = tracing.PROFILE
    if p is None:
        yield
        return
    frame = p.op_begin(name)
    try:
        yield
    finally:
        p.op_end(frame)


# ---------------------------------------------------------- budget ratchet

DEFAULT_BUDGET_FILE = ".rpc-budget.json"

#: ops whose committed budget MUST be zero steady-state frames — the
#: flight-recorder-proven claims of the compiled graphs (dag) and the
#: serve fast path
ZERO_STEADY_STATE_OPS = ("dag_execute", "serve_request")


def load_budget(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    ops = data.get("ops")
    if not isinstance(ops, dict):
        raise ValueError(f"{path}: missing 'ops' table")
    return ops


def ratchet_check(committed: Dict[str, Dict[str, Any]],
                  proposed: Dict[str, Dict[str, Any]]) -> List[str]:
    """Budget entries may decrease, never increase; ops may be added but
    never dropped. Returns violation strings (empty == ok)."""
    errors: List[str] = []
    for op, entry in sorted(committed.items()):
        new = proposed.get(op)
        if new is None:
            errors.append(f"{op}: budgeted operation dropped from the table")
            continue
        old_v, new_v = float(entry["rpcs"]), float(new["rpcs"])
        if new_v > old_v:
            errors.append(
                f"{op}: budget raised {old_v:g} -> {new_v:g} — the ratchet "
                "only goes down; fix the regression instead"
            )
    for op in ZERO_STEADY_STATE_OPS:
        entry = proposed.get(op) or committed.get(op)
        if entry is not None and float(entry["rpcs"]) != 0:
            errors.append(f"{op}: must stay at 0 steady-state RPCs")
    return errors


def check_measured(measured: Dict[str, float],
                   budget: Dict[str, Dict[str, Any]],
                   report: Optional[RpcFlowReport] = None) -> List[str]:
    """The honesty gate: measured per-op frames must fit the committed
    budget AND the statically-predicted multiplicity class."""
    errors: List[str] = []
    for op, entry in sorted(budget.items()):
        if op not in measured:
            errors.append(f"{op}: budgeted but not measured")
            continue
        got, allowed = measured[op], float(entry["rpcs"])
        if got > allowed + 1e-9:
            errors.append(
                f"{op}: measured {got:.2f} RPCs/op over budget "
                f"{allowed:g} — a new round trip snuck in"
            )
        if report is not None and op in report.ops:
            pred = report.ops[op].predicted_class
            if pred == "zero" and got > 1e-9:
                errors.append(
                    f"{op}: statically predicted zero steady-state RPCs "
                    f"but measured {got:.2f}/op"
                )
            elif pred == "bounded" and got > report.ops[op].bounded_count:
                errors.append(
                    f"{op}: measured {got:.2f}/op exceeds the static "
                    f"bound of {report.ops[op].bounded_count} reachable "
                    "per-call sites"
                )
    return errors


def budget_table(measured: Dict[str, float],
                 report: Optional[RpcFlowReport] = None) -> str:
    lines = [f"{'operation':<18} {'RPCs/op':>8}  {'static class':<10}"]
    for op in sorted(measured):
        pred = (report.ops[op].predicted_class
                if report is not None and op in report.ops else "-")
        lines.append(f"{op:<18} {measured[op]:>8.2f}  {pred:<10}")
    return "\n".join(lines)


def repo_root() -> str:
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..")
    )


# ------------------------------------------------------ measurement driver


def measure_rpc_budget(iters: int = 12, warmup: int = 3) -> Dict[str, Any]:
    """Spin an embedded one-node cluster and drive every budgeted driver
    operation under the :class:`RpcProfiler`.

    Steady-state discipline: a warmup pass pays every once/amortized frame
    (function/actor exports, serve pair registration, dag compile), then
    the profiler is reset and the measured pass runs. Returns
    ``{"iters", "per_op", "snapshot"}`` where ``per_op`` is round
    trips + notifies per invocation by operation — the numbers the
    committed ``.rpc-budget.json`` freezes.

    Shared by ``lint_gate --rpc-budget`` (in-process gate) and
    ``bench.py rpc_budget``.
    """
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    ray_tpu_torch.shutdown()
    cluster = Cluster()
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes(1)
    ray_tpu_torch.init(address=cluster.address,
                 config={"serve_fastpath_refresh_s": 60.0,
                         "log_to_driver": False})
    prof = RpcProfiler().install()
    compiled = None
    try:
        @ray_tpu_torch.remote
        def _noop(x):
            return x

        @ray_tpu_torch.remote
        def _inc(x):
            return x + 1

        @ray_tpu_torch.remote
        class _Counter:
            def __init__(self):
                self.n = 0

            def bump(self, k=1):
                self.n += k
                return self.n

        @serve.deployment(fast_path=True)
        def _echo(payload):
            return payload

        handle = serve.run(_echo.bind(), route_prefix=None)
        with InputNode() as inp:
            dag = _inc.bind(inp)
        compiled = dag.compile()
        actor = _Counter.remote()

        def drive(n: int) -> None:
            refs = [_noop.remote(i) for i in range(n)]        # submit_task
            for r in refs:
                ray_tpu_torch.get(r)                                # get
            for r in refs:
                ray_tpu_torch.wait([r], num_returns=1, timeout=10)  # wait
            for i in range(n):
                ray_tpu_torch.put({"i": i})                         # put
            arefs = [actor.bump.remote() for _ in range(n)]   # actor_call
            for r in arefs:
                ray_tpu_torch.get(r)
            for _ in range(max(1, n // 4)):                   # actor_create
                a = _Counter.remote()
                ray_tpu_torch.get(a.bump.remote())
                ray_tpu_torch.kill(a)
            for _ in range(max(1, n // 4)):                   # pg_create
                pg = placement_group([{"CPU": 1}], strategy="PACK")
                remove_placement_group(pg)
            for i in range(n):                                # dag_execute
                compiled.execute(i)
            for i in range(n):                                # serve_request
                handle.remote({"x": i}).result(timeout=30)

        drive(warmup)
        prof.reset()
        drive(iters)
        per_op = prof.per_op_rpcs()
        snap = prof.snapshot()
        return {
            "iters": iters,
            "per_op": {k: round(v, 4) for k, v in sorted(per_op.items())},
            "snapshot": snap,
        }
    finally:
        prof.uninstall()
        if compiled is not None:
            try:
                compiled.teardown()
            except Exception:  # noqa: BLE001
                pass
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001
            pass
        ray_tpu_torch.shutdown()
        cluster.shutdown()
