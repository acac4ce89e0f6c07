"""Distributed-correctness checkers (the plugin table).

Each checker is a small AST visitor registered via ``@register``:

- ``blocking-in-async``     blocking calls on an asyncio event loop
- ``unsafe-closure-capture`` remote closures capturing unserializable state
- ``lock-order-cycle``      cycles in the static lock-acquisition graph
- ``unawaited-coroutine``   coroutine created and never awaited
- ``dropped-object-ref``    ``.remote()`` result discarded (lost task/error)
- ``resource-spec-validation`` task/actor resource requests the scheduler
                            layer can never satisfy

The lock graph and resource-name registry are whole-program: they
accumulate across ``check_module`` calls and report from ``finalize``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import (
    Checker,
    Finding,
    ModuleContext,
    chan_word_of,
    find_cycles,
    register,
)

# ------------------------------------------------------------------- utilities


class ImportMap:
    """alias -> canonical dotted prefix, from a module's import statements."""

    def __init__(self, tree: ast.AST):
        self.modules: Dict[str, str] = {}  # "np" -> "numpy"
        self.names: Dict[str, str] = {}  # "sleep" -> "time.sleep"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.modules[a.asname] = a.name
                    else:
                        # `import a.b` binds only `a`, and an attribute
                        # chain through it already spells the full dotted
                        # path — mapping `a -> a.b` would double-expand
                        # (`concurrent.futures.futures.…`).
                        top = a.name.split(".")[0]
                        self.modules[top] = top
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name for a Name/Attribute chain, resolving
        top-level import aliases; None for non-name expressions."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        base = cur.id
        parts.append(base)
        parts.reverse()
        if base in self.names:
            parts[0:1] = self.names[base].split(".")
        elif base in self.modules:
            parts[0:1] = self.modules[base].split(".")
        return ".".join(parts)


def _is_remote_decorator(dec: ast.AST) -> bool:
    """Matches @remote, @ray_tpu_torch.remote, @<alias>.remote, and the
    argument-taking forms @remote(...), @ray_tpu_torch.remote(...)."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    if isinstance(dec, ast.Name):
        return dec.id == "remote"
    if isinstance(dec, ast.Attribute):
        return dec.attr == "remote"
    return False


def _remote_decorator_calls(node) -> List[ast.Call]:
    return [
        d for d in getattr(node, "decorator_list", [])
        if isinstance(d, ast.Call) and _is_remote_decorator(d)
    ]


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# ------------------------------------------------------------ blocking-in-async

# Calls that block the calling OS thread; on an event loop they stall every
# other coroutine sharing that loop (reference: Ray's asyncio-actor docs ban
# exactly these inside async actor methods).
_BLOCKING_CALLS: Dict[str, str] = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "use `asyncio.create_subprocess_exec` or an executor",
    "subprocess.call": "use `asyncio.create_subprocess_exec` or an executor",
    "subprocess.check_call": "use an executor",
    "subprocess.check_output": "use an executor",
    "os.system": "use an executor",
    "socket.create_connection": "use `asyncio.open_connection`",
    "requests.get": "use an executor or async client",
    "requests.post": "use an executor or async client",
    "ray_tpu_torch.get": "blocking driver API stalls the loop; "
    "use `asyncio.wrap_future`/an executor or restructure",
    "ray_tpu_torch.wait": "blocking driver API stalls the loop; use an executor",
}

# Constructors whose instances have thread-blocking methods worth tracking
# when bound to locals inside the async function.
_BLOCKING_CTORS: Dict[str, Set[str]] = {
    "queue.Queue": {"get", "put", "join"},
    "queue.SimpleQueue": {"get", "put"},
    "threading.Lock": {"acquire"},
    "threading.RLock": {"acquire"},
    "threading.Event": {"wait"},
    "threading.Condition": {"wait", "acquire", "wait_for"},
    "threading.Semaphore": {"acquire"},
    "threading.Thread": {"join"},
}


def _walk_body(fn):
    """Yield nodes executing in fn's own frame: skips nested defs/lambdas
    (they run elsewhere, or are separate bodies visited on their own)."""

    def gen(node, top):
        if not top and isinstance(node, _FUNC_NODES + (ast.Lambda,)):
            return
        yield node
        for child in ast.iter_child_nodes(node):
            yield from gen(child, False)

    yield from gen(fn, True)


def _class_lock_attrs(cls: ast.ClassDef, imports: "ImportMap") -> Dict[str, str]:
    """{attr: ctor} for `self.X = threading.Lock()/RLock()/Condition()`."""
    out: Dict[str, str] = {}
    for sub in ast.walk(cls):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            ctor = imports.resolve(sub.value.func)
            if ctor in _LOCK_CTORS:
                for tgt in sub.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        out[tgt.attr] = ctor
    return out


@register
class BlockingInAsyncChecker(Checker):
    name = "blocking-in-async"
    description = (
        "thread-blocking call on an event loop: inside an `async def` "
        "body, a sync function it (transitively) calls, or a sync method "
        "of an async actor (those run ON the actor's loop thread)"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        imports = ImportMap(ctx.tree)
        out: List[Finding] = []
        blockers = self._module_blockers(ctx.tree, imports)

        for node in ctx.tree.body:
            if isinstance(node, ast.AsyncFunctionDef):
                self._check_on_loop_body(
                    node, imports, ctx, out, blockers, lock_attrs={},
                    cls=None,
                )
            elif isinstance(node, ast.ClassDef):
                lock_attrs = _class_lock_attrs(node, imports)
                has_async = any(
                    isinstance(m, ast.AsyncFunctionDef) for m in node.body
                )
                is_remote = any(
                    _is_remote_decorator(d) for d in node.decorator_list
                )
                # Methods handed to threading.Thread(target=self.X) run on
                # their own OS thread, not the actor loop — exempt from the
                # sync-method-on-loop rule.
                thread_targets: Set[str] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        for kw in sub.keywords:
                            if (
                                kw.arg == "target"
                                and isinstance(kw.value, ast.Attribute)
                                and isinstance(kw.value.value, ast.Name)
                                and kw.value.value.id == "self"
                            ):
                                thread_targets.add(kw.value.attr)
                for m in node.body:
                    if isinstance(m, ast.AsyncFunctionDef):
                        self._check_on_loop_body(
                            m, imports, ctx, out, blockers, lock_attrs,
                            cls=node.name,
                        )
                    elif (
                        isinstance(m, ast.FunctionDef)
                        and has_async
                        and is_remote
                        and not m.name.startswith("__")
                        and m.name not in thread_targets
                    ):
                        # Async-actor contract: sync methods of an async
                        # actor execute ON the loop thread too.
                        self._check_on_loop_body(
                            m, imports, ctx, out, blockers, lock_attrs,
                            cls=node.name, sync_on_loop=True,
                        )
        # Nested async defs anywhere (e.g. inside sync helpers).
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef) and not any(
                node is t or (isinstance(t, ast.ClassDef) and node in t.body)
                for t in ctx.tree.body
            ):
                self._check_on_loop_body(
                    node, imports, ctx, out, blockers, lock_attrs={},
                    cls=None,
                )
        return out

    # -- transitive "does this sync function/method block?" summaries

    def _direct_reason(self, fn, imports) -> Optional[str]:
        for sub in _walk_body(fn):
            if isinstance(sub, ast.Call):
                dotted = imports.resolve(sub.func)
                if dotted in _BLOCKING_CALLS:
                    return f"calls `{dotted}` at line {sub.lineno}"
        return None

    def _module_blockers(self, tree, imports) -> Dict[Tuple, str]:
        """{(class or None, func name): reason} for sync defs that block,
        propagated through same-module/same-class sync call chains."""
        funcs: Dict[Tuple, ast.AST] = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                funcs[(None, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef):
                        funcs[(node.name, m.name)] = m
        reasons: Dict[Tuple, str] = {}
        for key, fn in funcs.items():
            r = self._direct_reason(fn, imports)
            if r:
                reasons[key] = r
        changed = True
        while changed:
            changed = False
            for key, fn in funcs.items():
                if key in reasons:
                    continue
                cls = key[0]
                for sub in _walk_body(fn):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = None
                    f = sub.func
                    if isinstance(f, ast.Name) and (None, f.id) in reasons:
                        callee = (None, f.id)
                    elif (
                        isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                        and (cls, f.attr) in reasons
                    ):
                        callee = (cls, f.attr)
                    if callee:
                        reasons[key] = (
                            f"calls `{'.'.join(filter(None, callee))}` "
                            f"which {reasons[callee]}"
                        )
                        changed = True
                        break
        return reasons

    # -- per-body check

    def _check_on_loop_body(
        self, fn, imports, ctx, out, blockers, lock_attrs, cls,
        sync_on_loop=False,
    ):
        where = (
            f"`async def {fn.name}`"
            if not sync_on_loop
            else f"sync method `{fn.name}` of async actor `{cls}` "
            "(runs on the actor event loop)"
        )
        local_ctors: Dict[str, str] = {}
        awaited: Set[int] = set()
        for node in _walk_body(fn):
            if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
                awaited.add(id(node.value))
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = imports.resolve(node.value.func)
                if ctor in _BLOCKING_CTORS:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            local_ctors[tgt.id] = ctor
            # threading lock/condition acquisition on the loop thread
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    e = item.context_expr
                    if (
                        isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"
                        and e.attr in lock_attrs
                    ):
                        out.append(
                            ctx.finding(
                                e,
                                self.name,
                                f"`with self.{e.attr}` "
                                f"({lock_attrs[e.attr]}) inside {where} "
                                "blocks the event loop when contended; "
                                "use asyncio primitives or confine the "
                                "state to the loop thread",
                            )
                        )
            if isinstance(node, ast.Call) and id(node) not in awaited:
                self._check_call(
                    node, imports, local_ctors, where, cls, blockers,
                    lock_attrs, ctx, out,
                )

    def _check_call(
        self, call, imports, local_ctors, where, cls, blockers, lock_attrs,
        ctx, out,
    ):
        dotted = imports.resolve(call.func)
        if dotted in _BLOCKING_CALLS:
            out.append(
                ctx.finding(
                    call,
                    self.name,
                    f"blocking call `{dotted}` inside {where}; "
                    f"{_BLOCKING_CALLS[dotted]}",
                )
            )
            return
        func = call.func
        if not isinstance(func, ast.Attribute):
            # sync same-module function that (transitively) blocks
            if isinstance(func, ast.Name) and (None, func.id) in blockers:
                out.append(
                    ctx.finding(
                        call,
                        self.name,
                        f"call to `{func.id}` inside {where} blocks: "
                        f"{blockers[(None, func.id)]}",
                    )
                )
            return
        # self.<m>() where m (transitively) blocks
        if (
            isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and (cls, func.attr) in blockers
        ):
            out.append(
                ctx.finding(
                    call,
                    self.name,
                    f"call to `self.{func.attr}` inside {where} blocks: "
                    f"{blockers[(cls, func.attr)]}",
                )
            )
            return
        # Unawaited concurrent.futures-style join.
        if func.attr == "result":
            out.append(
                ctx.finding(
                    call,
                    self.name,
                    f"un-awaited `.result()` inside {where} blocks the "
                    "event loop; await the future (or wrap with "
                    "`asyncio.wrap_future`)",
                )
            )
            return
        # `self._lock.acquire()` on a class threading lock.
        if (
            func.attr in ("acquire", "wait", "wait_for")
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
            and func.value.attr in lock_attrs
        ):
            out.append(
                ctx.finding(
                    call,
                    self.name,
                    f"blocking `self.{func.value.attr}.{func.attr}()` "
                    f"({lock_attrs[func.value.attr]}) inside {where}; use "
                    "asyncio primitives",
                )
            )
            return
        # Blocking method on a local bound to a known blocking ctor.
        if isinstance(func.value, ast.Name):
            ctor = local_ctors.get(func.value.id)
            if ctor and func.attr in _BLOCKING_CTORS[ctor]:
                out.append(
                    ctx.finding(
                        call,
                        self.name,
                        f"blocking `{func.value.id}.{func.attr}()` "
                        f"({ctor}) inside {where}; use the asyncio "
                        "equivalent",
                    )
                )


# ------------------------------------------------------ unsafe-closure-capture

# Constructors producing objects that cannot cross a serialization boundary
# (cloudpickle refuses locks/sockets/files; device arrays must travel via
# the object store, not closure bytes).
_UNSERIALIZABLE_CTORS: Dict[str, str] = {
    "threading.Lock": "lock",
    "threading.RLock": "lock",
    "threading.Condition": "condition",
    "threading.Event": "event",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "asyncio.Lock": "asyncio lock",
    "asyncio.Event": "asyncio event",
    "asyncio.Condition": "asyncio condition",
    "asyncio.Queue": "asyncio queue",
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "open": "file handle",
    "concurrent.futures.ThreadPoolExecutor": "thread pool",
    "concurrent.futures.ProcessPoolExecutor": "process pool",
}

# A torch tensor made on a device other than the CPU: the port's way to
# put an array on the card (`torch.empty(n, device=dev)`). A CPU tensor
# serializes; one with a `device=` that is not the literal "cpu" is held
# to be a CUDA tensor.
_DEVICE_TENSOR_CTORS = {
    "torch.tensor", "torch.as_tensor", "torch.empty", "torch.zeros",
    "torch.ones", "torch.full",
}


def _unserializable_ctor(ctor: Optional[str], call: ast.Call) -> Optional[str]:
    """The kind of unserializable object `call` (resolved to `ctor`) makes,
    or None."""
    if ctor in _UNSERIALIZABLE_CTORS:
        return _UNSERIALIZABLE_CTORS[ctor]
    if ctor in _DEVICE_TENSOR_CTORS:
        for kw in call.keywords:
            if kw.arg == "device" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value == "cpu"
            ):
                return "device tensor"
    return None


@register
class UnsafeClosureCaptureChecker(Checker):
    name = "unsafe-closure-capture"
    description = (
        "@remote task/actor closure captures an unserializable object "
        "(lock, socket, file handle, executor, device tensor) from an "
        "enclosing function scope"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        imports = ImportMap(ctx.tree)
        out: List[Finding] = []
        # Stack of enclosing-function binding maps: var -> ctor dotted name.
        scopes: List[Dict[str, Tuple[str, str]]] = []

        def visit(node):
            if isinstance(node, _FUNC_NODES):
                if scopes and any(
                    _is_remote_decorator(d) for d in node.decorator_list
                ):
                    self._check_remote_closure(node, scopes, ctx, out)
                # Own-frame bindings only: a sibling helper's local can
                # never be captured by this function's nested closures.
                bindings: Dict[str, Tuple[str, str]] = {}
                for sub in _walk_body(node):
                    if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call
                    ):
                        ctor = imports.resolve(sub.value.func)
                        kind = _unserializable_ctor(ctor, sub.value)
                        if kind:
                            for tgt in sub.targets:
                                if isinstance(tgt, ast.Name):
                                    bindings[tgt.id] = (ctor, kind)
                scopes.append(bindings)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                scopes.pop()
            else:
                for child in ast.iter_child_nodes(node):
                    visit(child)

        visit(ctx.tree)
        return out

    def _check_remote_closure(self, fn, scopes, ctx, out):
        local: Set[str] = {a.arg for a in fn.args.args}
        local.update(a.arg for a in fn.args.kwonlyargs)
        if fn.args.vararg:
            local.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            local.add(fn.args.kwarg.arg)
        reported: Set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        local.add(tgt.id)
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                name = sub.id
                if name in local or name in reported:
                    continue
                for bindings in reversed(scopes):
                    bound = bindings.get(name)
                    if bound:
                        ctor, kind = bound
                        reported.add(name)
                        out.append(
                            ctx.finding(
                                sub,
                                self.name,
                                f"remote closure `{fn.name}` captures "
                                f"`{name}` "
                                f"({kind} from "
                                f"`{ctor}`), which cannot serialize to a "
                                "worker; pass state via args/ObjectRefs "
                                "or create it inside the task",
                            )
                        )
                        break


# ------------------------------------------------------------- lock-order-cycle

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}


@register
class LockOrderCycleChecker(Checker):
    name = "lock-order-cycle"
    description = (
        "cycle in the static lock-acquisition graph (`with a: with b:` in "
        "one code path, `with b: with a:` in another)"
    )

    def __init__(self):
        # node -> {"kind": Lock|RLock|Condition, "where": (path, line)}
        self.nodes: Dict[str, Dict] = {}
        # (src, dst) -> (path, line) of the inner acquisition
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # Plain-Lock self-nesting is an immediate deadlock, found per-module.
        self._module_findings: List[Finding] = []

    # -- module pass: collect lock nodes, then acquisition orderings

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        imports = ImportMap(ctx.tree)
        class_locks = self._collect_locks(ctx, imports)
        self._module_findings = []
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                self._walk_class(node, class_locks.get(node.name, {}), ctx)
            elif isinstance(node, _FUNC_NODES):
                self._walk_function(
                    node, owner=None, locks=class_locks.get(None, {}),
                    summaries={}, ctx=ctx,
                )
        return self._module_findings

    def _collect_locks(self, ctx, imports) -> Dict[Optional[str], Dict[str, str]]:
        """{class name (None = module level): {attr/var: node name}}."""
        locks: Dict[Optional[str], Dict[str, str]] = {None: {}}
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = imports.resolve(node.value.func)
                if ctor in _LOCK_CTORS:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            nid = f"{ctx.modname}.{tgt.id}"
                            locks[None][tgt.id] = nid
                            self.nodes[nid] = {
                                "kind": _LOCK_CTORS[ctor],
                                "where": (ctx.relpath, node.lineno),
                            }
            elif isinstance(node, ast.ClassDef):
                attrs: Dict[str, str] = {}
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call
                    ):
                        ctor = imports.resolve(sub.value.func)
                        if ctor not in _LOCK_CTORS:
                            continue
                        for tgt in sub.targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                nid = f"{ctx.modname}.{node.name}.{tgt.attr}"
                                attrs[tgt.attr] = nid
                                self.nodes[nid] = {
                                    "kind": _LOCK_CTORS[ctor],
                                    "where": (ctx.relpath, sub.lineno),
                                }
                locks[node.name] = attrs
        return locks

    def _walk_class(self, cls: ast.ClassDef, locks: Dict[str, str], ctx):
        # Method summaries: locks a method acquires anywhere inside, to
        # propagate one interprocedural level (self.m() under a held lock).
        methods = [n for n in cls.body if isinstance(n, _FUNC_NODES)]
        direct: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for m in methods:
            acq: Set[str] = set()
            called: Set[str] = set()
            for sub in ast.walk(m):
                # Only true acquisitions count toward a method's summary:
                # `with <lock>` items and bare `.acquire()` calls, not any
                # mention of the attribute.
                if isinstance(sub, ast.withitem):
                    nid = self._lock_of(sub.context_expr, locks)
                    if nid:
                        acq.add(nid)
                elif isinstance(sub, ast.Call):
                    nid = self._lock_of(sub, locks)
                    if nid:
                        acq.add(nid)
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "self"
                ):
                    called.add(sub.func.attr)
            direct[m.name] = acq
            calls[m.name] = called
        # Fixpoint: summary = direct ∪ summaries of self-calls.
        summaries = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for m, callees in calls.items():
                for c in callees:
                    extra = summaries.get(c, set()) - summaries[m]
                    if extra:
                        summaries[m].update(extra)
                        changed = True
        for m in methods:
            self._walk_function(m, cls.name, locks, summaries, ctx)

    def _lock_of(self, node, locks: Dict[str, str]) -> Optional[str]:
        """Lock node for `with self._x` / `with mod_lock` context exprs and
        bare `.acquire()` calls."""
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                node = f.value
            else:
                return None
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return locks.get(node.attr)
        if isinstance(node, ast.Name):
            return locks.get(node.id)
        return None

    def _walk_function(self, fn, owner, locks, summaries, ctx):
        held: List[Tuple[str, int]] = []  # (node, lineno acquired)

        def add_edges(dst: str, lineno: int):
            for src, _ in held:
                if src == dst:
                    kind = self.nodes.get(src, {}).get("kind")
                    if kind == "Lock":
                        self._module_findings.append(
                            Finding(
                                path=ctx.relpath,
                                line=lineno,
                                col=0,
                                check=self.name,
                                message=(
                                    f"nested re-acquisition of plain Lock "
                                    f"`{src}` — self-deadlock (use RLock "
                                    "or restructure)"
                                ),
                                line_text=ctx.line_text(lineno),
                            )
                        )
                    continue
                key = (src, dst)
                if key not in self.edges:
                    self.edges[key] = (ctx.relpath, lineno)

        def walk(node, top=False):
            if not top and isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    nid = self._lock_of(item.context_expr, locks)
                    if nid:
                        add_edges(nid, item.context_expr.lineno)
                        held.append((nid, item.context_expr.lineno))
                        acquired.append(nid)
                for stmt in node.body:
                    walk(stmt)
                for _ in acquired:
                    held.pop()
                return
            if (
                held
                and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            ):
                for dst in summaries.get(node.func.attr, ()):  # interproc edge
                    add_edges(dst, node.lineno)
            for child in ast.iter_child_nodes(node):
                walk(child)

        walk(fn, top=True)

    # -- whole-program pass: cycle detection over the accumulated graph

    def finalize(self) -> List[Finding]:
        # Shared cycle enumeration (core.find_cycles) keeps this and the
        # runtime sanitizer agreeing on what counts as a cycle; add_edges
        # never inserts self-edges, so no self-loop guard is needed here.
        adj: Dict[str, List[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, []).append(dst)
        return [self._cycle_finding(path) for path in find_cycles(adj)]

    def _cycle_finding(self, path: List[str]) -> Finding:
        hops = []
        for i, src in enumerate(path):
            dst = path[(i + 1) % len(path)]
            where = self.edges.get((src, dst))
            loc = f"{where[0]}:{where[1]}" if where else "?"
            hops.append(f"{src} -> {dst} ({loc})")
        first = self.edges.get((path[0], path[1 % len(path)]), ("?", 1))
        return Finding(
            path=first[0],
            line=first[1],
            col=0,
            check=self.name,
            message="lock-order cycle: " + "; ".join(hops),
            line_text="",
        )


# ---------------------------------------------------------- unawaited-coroutine


@register
class UnawaitedCoroutineChecker(Checker):
    name = "unawaited-coroutine"
    description = (
        "call to a locally-defined `async def` whose coroutine is never "
        "awaited/scheduled (the body silently never runs)"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        module_async: Set[str] = {
            n.name
            for n in ctx.tree.body
            if isinstance(n, ast.AsyncFunctionDef)
        }
        out: List[Finding] = []

        def visit(node, class_async: Set[str], local_async: Set[str]):
            if isinstance(node, ast.ClassDef):
                methods = {
                    m.name
                    for m in node.body
                    if isinstance(m, ast.AsyncFunctionDef)
                }
                for child in ast.iter_child_nodes(node):
                    visit(child, methods, local_async)
                return
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                call = node.value
                f = call.func
                name = None
                if isinstance(f, ast.Name) and (
                    f.id in module_async or f.id in local_async
                ):
                    name = f.id
                elif (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and f.attr in class_async
                ):
                    name = f"self.{f.attr}"
                if name:
                    out.append(
                        ctx.finding(
                            call,
                            self.name,
                            f"coroutine `{name}(...)` is created but never "
                            "awaited — the body never runs; `await` it or "
                            "schedule with `asyncio.create_task`/"
                            "`run_coroutine_threadsafe`",
                        )
                    )
            if isinstance(node, _FUNC_NODES):
                # A nested async def is only callable bare inside its
                # definer — scope it to this function's subtree, so an
                # unrelated same-named sync function elsewhere in the
                # module is never flagged. Collect defs anywhere in this
                # function's own frame (if/try/for blocks included) via
                # _walk_body, which stops at deeper function boundaries.
                nested = {
                    sub.name
                    for frame_node in _walk_body(node)
                    for sub in ast.iter_child_nodes(frame_node)
                    if isinstance(sub, ast.AsyncFunctionDef)
                }
                for child in ast.iter_child_nodes(node):
                    visit(child, class_async, local_async | nested)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, class_async, local_async)

        visit(ctx.tree, set(), set())
        return out


# ----------------------------------------------------------- dropped-object-ref


@register
class DroppedObjectRefChecker(Checker):
    name = "dropped-object-ref"
    description = (
        "`.remote()` result discarded: task errors and completion are "
        "unobservable, and the ref cannot be cancelled or fetched"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
                continue
            f = node.value.func
            if isinstance(f, ast.Attribute) and f.attr == "remote":
                out.append(
                    ctx.finding(
                        node.value,
                        self.name,
                        "ObjectRef from `.remote(...)` is dropped — task "
                        "failures vanish silently; store/fetch the ref, or "
                        "suppress with `# ray-lint: disable="
                        "dropped-object-ref` for intentional "
                        "fire-and-forget",
                    )
                )
        return out


# ----------------------------------------------------- resource-spec-validation

# Kept in sync with ray_tpu_torch.core.api._VALID_OPTIONS via a unit test (the
# checker must not import the runtime: linting cannot depend on torch).
_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "num_returns",
    "max_retries", "max_restarts", "max_concurrency", "name",
    "scheduling_strategy", "memory", "runtime_env", "lifetime",
    "_backpressure_num_objects",
}

_PREDEFINED_RESOURCES = {"CPU", "GPU", "TPU", "memory", "object_store_memory"}

_NUMERIC_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "memory", "num_returns",
    "max_retries", "max_restarts", "max_concurrency",
}

# Calls whose `resources=` kwarg *registers* capacity (vs requesting it).
_REGISTRATION_CALLS = {"init", "add_node", "revive_node", "start_node"}


def _const_num(node) -> Optional[float]:
    """Numeric value of a literal, including the `-1` UnaryOp spelling."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
        and isinstance(node.operand.value, (int, float))
    ):
        return -node.operand.value
    return None


@register
class ResourceSpecChecker(Checker):
    name = "resource-spec-validation"
    description = (
        "task/actor resource spec the scheduler layer can never satisfy: "
        "unknown option, negative amount, predefined name in custom "
        "`resources`, or custom resource no node registers"
    )

    def __init__(self):
        # custom resource name -> first request site
        self._requested: Dict[str, Tuple[str, int, str]] = {}
        self._registered: Set[str] = set(_PREDEFINED_RESOURCES)

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, _FUNC_NODES + (ast.ClassDef,)):
                for dec in _remote_decorator_calls(node):
                    self._check_options(
                        dec, ctx, out, strict_unknown=True
                    )
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "options":
                    known = any(
                        kw.arg in _VALID_OPTIONS for kw in node.keywords
                    )
                    if known:
                        self._check_options(
                            node, ctx, out, strict_unknown=False
                        )
                # capacity registration sites feed the known-names set
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None
                )
                if name in _REGISTRATION_CALLS:
                    for kw in node.keywords:
                        if kw.arg == "resources" and isinstance(
                            kw.value, ast.Dict
                        ):
                            for k in kw.value.keys:
                                if isinstance(k, ast.Constant) and isinstance(
                                    k.value, str
                                ):
                                    self._registered.add(k.value)
        return out

    def _check_options(self, call: ast.Call, ctx, out, strict_unknown: bool):
        for kw in call.keywords:
            if kw.arg is None:  # **kwargs — can't validate statically
                continue
            if strict_unknown and kw.arg not in _VALID_OPTIONS:
                out.append(
                    ctx.finding(
                        kw.value,
                        self.name,
                        f"unknown remote option `{kw.arg}` (valid: "
                        f"{', '.join(sorted(_VALID_OPTIONS))})",
                    )
                )
                continue
            v = kw.value
            if kw.arg in _NUMERIC_OPTIONS:
                num = _const_num(v)
                # -1 is the conventional "infinite" sentinel for retry
                # budgets (reference: ray.remote(max_retries=-1)).
                if (
                    kw.arg in ("max_retries", "max_restarts")
                    and num == -1
                ):
                    num = None
                if num is not None and num < 0:
                    out.append(
                        ctx.finding(
                            v,
                            self.name,
                            f"negative resource amount `{kw.arg}={num}` "
                            "can never be satisfied",
                        )
                    )
                if kw.arg == "max_concurrency" and num == 0:
                    out.append(
                        ctx.finding(
                            v, self.name, "`max_concurrency=0` — the actor "
                            "could never run a task",
                        )
                    )
            if kw.arg == "resources" and isinstance(v, ast.Dict):
                for k, val in zip(v.keys, v.values):
                    if not isinstance(k, ast.Constant):
                        continue
                    if not isinstance(k.value, str):
                        out.append(
                            ctx.finding(
                                k,
                                self.name,
                                f"resource name {k.value!r} must be a "
                                "string",
                            )
                        )
                        continue
                    if k.value in _PREDEFINED_RESOURCES:
                        out.append(
                            ctx.finding(
                                k,
                                self.name,
                                f"predefined resource `{k.value}` in "
                                "custom `resources=`; use the dedicated "
                                "option (num_cpus/num_gpus/num_tpus/"
                                "memory)",
                            )
                        )
                        continue
                    amount = _const_num(val)
                    if amount is not None and amount < 0:
                        out.append(
                            ctx.finding(
                                val,
                                self.name,
                                f"negative amount for resource "
                                f"`{k.value}`",
                            )
                        )
                    if k.value not in self._requested:
                        self._requested[k.value] = (
                            ctx.relpath,
                            k.lineno,
                            ctx.line_text(k.lineno),
                        )

    def finalize(self) -> List[Finding]:
        out: List[Finding] = []
        for name, (path, line, text) in sorted(self._requested.items()):
            if name not in self._registered:
                out.append(
                    Finding(
                        path=path,
                        line=line,
                        col=0,
                        check=self.name,
                        message=(
                            f"custom resource `{name}` is requested but no "
                            "scanned registration site (init/add_node) "
                            "ever provides it — tasks would pend forever"
                        ),
                        line_text=text,
                    )
                )
        return out


# --------------------------------------------------------- unbounded-rpc-call

# Directory segments that count as control plane: a blocked thread there
# wedges a daemon loop, the GCS, or a driver's submission path. serve/ is
# included since its fast path (serve/fastpath.py) talks to daemons
# directly for pair registration.
_CONTROL_PLANE_SEGMENTS = {"cluster", "dag", "serve"}


@register
class UnboundedRpcCallChecker(Checker):
    name = "unbounded-rpc-call"
    description = (
        "control-plane `.call(\"method\", ...)` without an explicit "
        "`timeout=`: the call rides the client-default deadline, which a "
        "daemon/GCS/driver loop never chose — every blocking rpc in "
        "cluster/ must bound its wait explicitly"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        parts = ctx.relpath.replace("\\", "/").split("/")
        if not (set(parts[:-1]) & _CONTROL_PLANE_SEGMENTS):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr == "call"):
                continue
            # the rpc idiom: first positional arg is the method-name string
            # (skips unrelated `.call(x)` where x is a variable)
            if not (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            out.append(
                ctx.finding(
                    node,
                    self.name,
                    f"rpc `{node.args[0].value}` has no explicit timeout — "
                    "a hung peer wedges this thread for the client-default "
                    "window; pass `timeout=` (config rpc_call_timeout_s or "
                    "tighter), or suppress with `# ray-lint: "
                    "disable=unbounded-rpc-call`",
                )
            )
        return out


# ------------------------------------------------------ protocol checkers
#
# Four whole-program checks over the ProtocolIndex (analysis/protocol.py):
# the stringly-typed control plane gets the cross-referencing a generated
# gRPC stub would give the reference. Each checker builds the index during
# check_module and emits from finalize; every check self-gates on having
# seen the relevant counterpart surface (handlers, subscriptions, the
# config table) so linting a single file never false-positives.


class _ProtocolCheckerBase(Checker):
    def __init__(self):
        from ray_tpu_torch.analysis.protocol import ProtocolIndex

        self.index = ProtocolIndex()

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        from ray_tpu_torch.analysis.protocol import ProtocolIndex

        # the per-module AST extraction is cached on the ctx: all four
        # protocol checkers share one walk per file, merging cheap lists
        self.index.merge(ProtocolIndex.piece_for(ctx))
        return []

    @staticmethod
    def _site_finding(site, check: str, message: str) -> Finding:
        return Finding(
            path=site.path,
            line=site.line,
            col=0,
            check=check,
            message=message,
            line_text=site.line_text,
            end_line=site.end_line,
        )


@register
class RpcMethodUnknownChecker(_ProtocolCheckerBase):
    name = "rpc-method-unknown"
    description = (
        "`.call/.call_async/.notify(\"method\", ...)` whose string-literal "
        "method has NO `rpc_<method>` handler anywhere in the scanned tree "
        "— a typo'd or renamed rpc fails only at runtime with 'unknown "
        "method'"
    )

    def finalize(self) -> List[Finding]:
        known = self.index.handler_methods()
        if not known:
            return []  # no handler surface in scope: nothing to check against
        out: List[Finding] = []
        for site in self.index.calls:
            if site.method not in known:
                out.append(self._site_finding(
                    site, self.name,
                    f"rpc `{site.method}` has no rpc_{site.method} handler "
                    f"in the scanned tree (known methods: "
                    f"{len(known)}); typo, rename drift, or a handler "
                    "outside the scan",
                ))
        return out


@register
class RpcPayloadKeyMismatchChecker(_ProtocolCheckerBase):
    name = "rpc-payload-key-mismatch"
    description = (
        "literal payload-dict keys at a call site disagree with the "
        "`p[\"...\"]`/`p.get(\"...\")` keys the handler reads: a missing "
        "required key is a guaranteed KeyError in the handler; a key no "
        "handler ever reads is dead weight or rename drift"
    )

    def finalize(self) -> List[Finding]:
        out: List[Finding] = []
        for site in self.index.calls:
            if site.keys is None:
                continue  # payload is a variable/absent: uncheckable here
            candidates = self.index.handlers.get(site.method)
            if not candidates:
                continue  # rpc-method-unknown owns that case
            keys = set(site.keys)
            if not site.open_keys:
                # required keys: satisfied if ANY candidate handler's
                # required set is covered (methods like stream_item exist
                # on both gcs and daemon with different contracts)
                missing_per = [(h, h.required - keys) for h in candidates]
                if all(miss for _h, miss in missing_per):
                    h, miss = min(missing_per, key=lambda t: len(t[1]))
                    out.append(self._site_finding(
                        site, self.name,
                        f"rpc `{site.method}` payload is missing key(s) "
                        f"{sorted(miss)} that {h.path}:{h.line} reads as "
                        "required `p[\"...\"]`",
                    ))
            if all(not h.open_payload for h in candidates):
                readable = set()
                for h in candidates:
                    readable |= h.required | h.optional
                dead = sorted(keys - readable)
                if dead:
                    out.append(self._site_finding(
                        site, self.name,
                        f"rpc `{site.method}` payload key(s) {dead} are "
                        "never read by any handler — dead weight or a "
                        "renamed key the handler no longer sees",
                    ))
        return out


@register
class PushTopicUnknownChecker(_ProtocolCheckerBase):
    name = "push-topic-unknown"
    description = (
        "a push/broadcast topic literal that no `.subscribe(\"topic\")` in "
        "the scanned tree listens to: the frame is built, sent, and "
        "silently dropped at every client"
    )

    def finalize(self) -> List[Finding]:
        subscribed = self.index.subscribed_topics()
        if not subscribed:
            return []  # no subscriber surface in scope
        out: List[Finding] = []
        for site in self.index.pushes:
            if site.topic not in subscribed:
                out.append(self._site_finding(
                    site, self.name,
                    f"push topic `{site.topic}` has no subscriber in the "
                    "scanned tree — every delivery is silently dropped",
                ))
        return out


@register
class ConfigKeyUnknownChecker(_ProtocolCheckerBase):
    name = "config-key-unknown"
    description = (
        "a config-knob usage (attribute read on a Config/GLOBAL_CONFIG, an "
        "override-dict key, or a literal RAY_TPU_<lowercase> env name) "
        "that core/config.py's _DEFS table does not define: reads raise "
        "AttributeError at runtime, overrides raise ValueError, env knobs "
        "are silently ignored"
    )

    def finalize(self) -> List[Finding]:
        from ray_tpu_torch.analysis.protocol import CONFIG_API_ATTRS

        defined = self.index.config_keys
        if not defined:
            return []  # _DEFS not in scope: nothing to validate against
        out: List[Finding] = []
        for use in self.index.config_uses:
            if use.key in defined or use.key in CONFIG_API_ATTRS:
                continue
            what = {
                "attr": "attribute read",
                "override": "override key",
                "env": "env knob",
            }[use.via]
            out.append(self._site_finding(
                use, self.name,
                f"config {what} `{use.key}` is not defined in "
                f"{self.index.config_defs_path} _DEFS — "
                + ("reads raise AttributeError" if use.via == "attr" else
                   "Config(overrides) raises ValueError" if use.via == "override"
                   else "the env var is silently ignored"),
            ))
        return out


# --------------------------------------------- lifecycle / thread checkers


@register
class IllegalStateTransitionChecker(Checker):
    name = "illegal-state-transition"
    description = (
        "a GCS/daemon handler writes an entity lifecycle state the "
        "declared state machine (analysis/statemachine.py) does not "
        "allow: an unknown state string (typo), a row created in a "
        "non-initial state, a state no declared edge produces, or a "
        "guarded write out of an observed state with no such edge"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        from ray_tpu_torch.analysis import statemachine as sm

        if not sm.applies_to(ctx):
            return []
        out: List[Finding] = []
        for w, problem in sm.check_writes(sm.extract_module(ctx)):
            out.append(Finding(
                path=w.path, line=w.line, col=0, check=self.name,
                message=f"{problem} (in {w.func}); declare the edge in "
                        "statemachine.MACHINES if the protocol really "
                        "grew, or fix the write",
                line_text=w.line_text, end_line=w.end_line,
            ))
        return out


#: attribute-call names that mutate a container in place
_MUTATOR_ATTRS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "update", "setdefault", "extend", "insert",
    "move_to_end",
})

#: constructors whose result is a shared mutable container
_CONTAINER_CTORS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
})


@register
class CrossThreadFieldWriteChecker(Checker):
    """The static half of the hybrid race sanitizer. As a CHECKER it
    reports only high-confidence unlocked findings in the daemon/GCS;
    its extraction machinery (`_mutable_fields`/`_context_roots`/
    `_calls_of`/`_mutations` + lock propagation) is also reused by
    :func:`ray_tpu_torch.analysis.racer.extract_watchlist` to emit the FULL
    claim surface over cluster//serve//dag/ — every >= 2-context field
    including the lock-protected ones with their credited lock attr —
    which the dynamic vector-clock stage then validates at runtime
    (``--dump-watchlist`` / ``--race``)."""

    name = "cross-thread-field-write"
    description = (
        "a GCS/daemon mutable container field is written from two "
        "different execution contexts (rpc-handler loop, push-subscriber "
        "thread, background thread, executor) with at least one write "
        "not under a class lock: read-modify-write races the GIL does "
        "not serialize"
    )

    #: execution-context roots by method-name shape
    _THREAD_SUFFIX = "_loop"

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        from ray_tpu_torch.analysis import statemachine as sm

        if not sm.applies_to(ctx):
            return []
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(ctx, cls))
        return out

    # ------------------------------------------------------ class model

    def _check_class(self, ctx: ModuleContext,
                     cls: ast.ClassDef) -> List[Finding]:
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        lock_attrs = self._lock_attrs(cls)
        fields = self._mutable_fields(methods.get("__init__"))
        if not fields:
            return []
        roots = self._context_roots(cls, methods)
        if len({c for _m, c in roots}) < 2:
            return []  # single execution context: nothing can race
        # effective context/locked per method, propagated through the
        # same-class call graph (a helper called only under the lock
        # inherits lock-held-ness; the _locked suffix asserts it)
        reach: Dict[str, Set[Tuple[str, bool]]] = {}
        work = [(m, c, False) for m, c in roots if m in methods]
        while work:
            name, context, locked = work.pop()
            eff_locked = locked or name.endswith("_locked")
            key = (context, eff_locked)
            if key in reach.setdefault(name, set()):
                continue
            reach[name].add(key)
            for callee, call_locked in self._calls_of(
                methods[name], lock_attrs
            ):
                if callee in methods:
                    work.append((callee, context, eff_locked or call_locked))
        # collect mutations: field -> [(context, locked, node, method)]
        mutations: Dict[str, List[Tuple[str, bool, ast.AST, str]]] = {}
        for name, fn in methods.items():
            if name == "__init__":
                continue
            for context, locked in reach.get(name, ()):
                for field, node, in_with in self._mutations(fn, fields,
                                                            lock_attrs):
                    mutations.setdefault(field, []).append(
                        (context, locked or in_with, node, name)
                    )
        out: List[Finding] = []
        flagged: Set[int] = set()
        for field, muts in mutations.items():
            contexts = {c for c, _l, _n, _m in muts}
            if len(contexts) < 2:
                continue
            if all(locked for _c, locked, _n, _m in muts):
                continue
            for context, locked, node, mname in muts:
                if locked or id(node) in flagged:
                    continue
                flagged.add(id(node))
                others = sorted(contexts - {context}) or sorted(contexts)
                out.append(ctx.finding(
                    node, self.name,
                    f"`self.{field}` is mutated here on the {context} "
                    f"context without holding a class lock, and also "
                    f"from {', '.join(others)} — wrap both in `with "
                    f"self.{sorted(lock_attrs)[0] if lock_attrs else '_lock'}"
                    "`, or suppress with `# ray-lint: "
                    "disable=cross-thread-field-write` if the field is "
                    "provably confined",
                ))
        return out

    # ------------------------------------------------------- extraction

    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                    and v.func.attr in ("Lock", "RLock", "Condition"):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name
                    ) and t.value.id == "self":
                        out.add(t.attr)
        return out

    @staticmethod
    def _mutable_fields(init) -> Set[str]:
        if init is None:
            return set()
        out: Set[str] = set()
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                targets, v = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, v = [node.target], node.value
            else:
                continue
            is_container = isinstance(v, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(v, ast.Call) and (
                    (isinstance(v.func, ast.Name)
                     and v.func.id in _CONTAINER_CTORS)
                    or (isinstance(v.func, ast.Attribute)
                        and v.func.attr in _CONTAINER_CTORS)
                )
            )
            if not is_container:
                continue
            for t in targets:
                if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name
                ) and t.value.id == "self":
                    out.add(t.attr)
        return out

    def _context_roots(self, cls: ast.ClassDef,
                       methods) -> List[Tuple[str, str]]:
        """(method, context) execution entry points."""
        roots: List[Tuple[str, str]] = []
        for name in methods:
            if name.startswith("rpc_"):
                roots.append((name, "rpc-handler loop"))
            elif name.endswith(self._THREAD_SUFFIX):
                roots.append((name, "background thread"))
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else None
            # .subscribe("topic", self._on_x) -> client dispatch thread
            if attr == "subscribe" and len(node.args) > 1:
                m = self._self_method(node.args[1])
                if m:
                    roots.append((m, "push-subscriber thread"))
            # Thread(target=self._x)
            if attr == "Thread" or (isinstance(f, ast.Name)
                                    and f.id == "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        m = self._self_method(kw.value)
                        if m:
                            roots.append((m, "background thread"))
            # run_in_executor(None, self._x | lambda: self._x(...))
            if attr == "run_in_executor" and len(node.args) > 1:
                m = self._self_method(node.args[1])
                if m:
                    roots.append((m, "executor"))
            # on_disconnect=self._x runs on the server loop
            for kw in node.keywords:
                if kw.arg == "on_disconnect":
                    m = self._self_method(kw.value)
                    if m:
                        roots.append((m, "rpc-handler loop"))
        return roots

    @staticmethod
    def _self_method(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id == "self":
            return expr.attr
        if isinstance(expr, ast.Lambda):
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ) and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "self":
                    return sub.func.attr
        return None

    def _calls_of(self, fn, lock_attrs) -> List[Tuple[str, bool]]:
        """Same-class ``self.m()`` calls with their lock-held-ness."""
        out: List[Tuple[str, bool]] = []
        locked_ids = self._nodes_under_lock(fn, lock_attrs)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                out.append((node.func.attr, id(node) in locked_ids))
        return out

    @staticmethod
    def _nodes_under_lock(fn, lock_attrs) -> Set[int]:
        """ids of AST nodes lexically inside `with self.<lock>:`."""
        out: Set[int] = set()

        def is_lock_with(w: ast.AST) -> bool:
            if not isinstance(w, ast.With):
                return False
            for item in w.items:
                e = item.context_expr
                if isinstance(e, ast.Attribute) and isinstance(
                    e.value, ast.Name
                ) and e.value.id == "self" and e.attr in lock_attrs:
                    return True
            return False

        def walk(node, locked):
            for child in ast.iter_child_nodes(node):
                child_locked = locked or is_lock_with(child)
                if child_locked:
                    out.add(id(child))
                    for sub in ast.walk(child):
                        out.add(id(sub))
                else:
                    walk(child, child_locked)

        walk(fn, False)
        return out

    def _mutations(self, fn, fields: Set[str],
                   lock_attrs: Set[str]) -> List[Tuple[str, ast.AST, bool]]:
        """(field, node, under_with_lock) mutation sites of tracked
        fields inside one method."""
        locked_ids = self._nodes_under_lock(fn, lock_attrs)
        out: List[Tuple[str, ast.AST, bool]] = []

        def self_field(expr) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name
            ) and expr.value.id == "self" and expr.attr in fields:
                return expr.attr
            return None

        for node in ast.walk(fn):
            field = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    # self.F = ... (rebind) or self.F[k] = ...
                    field = self_field(t) or (
                        self_field(t.value)
                        if isinstance(t, ast.Subscript) else None
                    )
                    if field:
                        break
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        field = self_field(t.value)
                        if field:
                            break
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in _MUTATOR_ATTRS:
                field = self_field(node.func.value)
            if field:
                out.append((field, node, id(node) in locked_ids))
        return out


# ------------------------------------------------- metric hygiene checker

_METRIC_CLASSES = {
    "ray_tpu_torch.util.metrics.Counter",
    "ray_tpu_torch.util.metrics.Gauge",
    "ray_tpu_torch.util.metrics.Histogram",
}
_METRIC_NAME_RE = re.compile(r"ray_tpu_[a-z0-9_]+\Z")


@register
class MetricNameChecker(Checker):
    """Two contracts on Counter/Gauge/Histogram constructions (the
    observability plane's lint half, ray_tpu_torch.obs):

    - the metric name must match ``ray_tpu_[a-z0-9_]+`` — one namespace,
      Prometheus-safe, grep-able;
    - the construction must run at import time (module scope, class body,
      or ``__init__``): the registry is process-global and permanent, so a
      metric constructed per call/request leaks a registry entry per
      unique name and re-registers forever on the hot path.

    Non-literal names are skipped (dynamic factories judge themselves).
    """

    name = "metric-name-invalid"
    description = (
        "metric constructed with a non-`ray_tpu_[a-z0-9_]+` literal name, "
        "or outside module/__init__ scope (per-call registry leak)"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        imap = ImportMap(ctx.tree)
        out: List[Finding] = []

        def visit(node: ast.AST, func_stack: Tuple[str, ...]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_stack = func_stack + (node.name,)
            elif isinstance(node, ast.Call):
                resolved = imap.resolve(node.func)
                if resolved in _METRIC_CLASSES:
                    self._check_call(ctx, node, resolved, func_stack, out)
            for child in ast.iter_child_nodes(node):
                visit(child, func_stack)

        visit(ctx.tree, ())
        return out

    def _check_call(self, ctx: ModuleContext, node: ast.Call,
                    resolved: str, func_stack: Tuple[str, ...],
                    out: List[Finding]) -> None:
        cls = resolved.rsplit(".", 1)[1]
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None
        )
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            return  # dynamic name: out of scope
        if not _METRIC_NAME_RE.fullmatch(arg.value):
            out.append(ctx.finding(
                node, self.name,
                f"{cls} name {arg.value!r} does not match "
                "`ray_tpu_[a-z0-9_]+` — metrics share one cluster-wide "
                "Prometheus namespace; rename (or suppress with `# ray-"
                "lint: disable=metric-name-invalid`)",
            ))
        if func_stack and func_stack[-1] != "__init__":
            out.append(ctx.finding(
                node, self.name,
                f"{cls} {arg.value!r} constructed inside "
                f"`{func_stack[-1]}()`: the registry is process-global — "
                "construct metrics at module//__init__ scope and observe "
                "per call, or each call leaks a registry entry",
            ))


# ------------------------------------------------------- channel memory
#
# Access-discipline checkers for the dag seqlock channel (the static
# half of analysis/memmodel.py): the word-level model checker is only
# sound while ALL header/payload access funnels through the ChannelMem
# ops layer and the publication order the model verified is the order
# the code ships. Scoped to dag/ and object_store/ — the two subsystems
# built on (or absorbing) the channel's mmap machinery.

_CHAN_SCOPE_DIRS = ("dag", "object_store")
_MMAP_NAMES = ("mm", "_mm")


def _in_channel_scope(relpath: str) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return any(p in _CHAN_SCOPE_DIRS for p in parts[:-1])


@register
class ChanRawHeaderAccessChecker(Checker):
    """Any raw access to seqlock channel memory — ``struct``
    ``pack_into``/``unpack_from``, an ``mmap.mmap`` construction, or
    indexing an ``mm``/``_mm`` mapping — outside a ``*Mem`` ops-layer
    class. The memmodel checker verifies the protocol through the
    :class:`~ray_tpu_torch.dag.channel.ChannelMem` seam; a header word poked
    anywhere else is invisible to it (and to the AST round-trip gate),
    so the model silently stops covering the shipped code."""

    name = "chan-raw-header-access"
    description = (
        "raw channel header/payload access (struct pack/unpack, "
        "mmap.mmap, mm[...] indexing) outside the ChannelMem ops layer "
        "in dag//object_store/"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_channel_scope(ctx.relpath):
            return []
        imap = ImportMap(ctx.tree)
        out: List[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            out.append(ctx.finding(
                node, self.name,
                f"{what} outside a *Mem ops-layer class: every channel "
                "header-word/payload access must go through ChannelMem "
                "(dag/channel.py) so the memmodel checker keeps covering "
                "the real protocol",
            ))

        def visit(node: ast.AST, in_mem_class: bool) -> None:
            if isinstance(node, ast.ClassDef):
                in_mem_class = in_mem_class or node.name.endswith("Mem")
            elif not in_mem_class:
                if isinstance(node, ast.Call):
                    if isinstance(node.func, ast.Attribute) and \
                            node.func.attr in ("pack_into", "unpack_from"):
                        flag(node, f"struct .{node.func.attr}()")
                    elif imap.resolve(node.func) == "mmap.mmap":
                        flag(node, "mmap.mmap() construction")
                elif isinstance(node, ast.Subscript):
                    v = node.value
                    nm = v.attr if isinstance(v, ast.Attribute) else (
                        v.id if isinstance(v, ast.Name) else None
                    )
                    if nm in _MMAP_NAMES:
                        flag(node, f"`{nm}[...]` mapping access")
            for child in ast.iter_child_nodes(node):
                visit(child, in_mem_class)

        visit(ctx.tree, False)
        return out


@register
class ChanPublicationOrderChecker(Checker):
    """Seqlock publication order, statically enforced where the channel
    protocol is implemented (dag//object_store/): within one function,
    the payload store must precede the ``version`` bump (the commit a
    reader wakes on) and the payload copy must precede the ``ack``
    advance (which frees the writer to overwrite). The memmodel checker
    proved the inverted orders lose: a reader woken by an early
    ``version`` copies torn/stale bytes (seeded bug
    ``version-before-payload``); an early ``ack`` lets the writer
    overwrite mid-copy."""

    name = "chan-publication-order"
    description = (
        "channel `version`/`ack` published before the payload "
        "store/copy it guards (seqlock commit-order inversion)"
    )

    #: method attrs that move payload bytes (the ChannelMem seam ops and
    #: their raw struct-era spellings)
    _PAYLOAD_WRITES = ("write_payload",)
    _PAYLOAD_READS = ("read_payload",)
    #: method attrs that store a header word (first arg names the word)
    _WORD_STORES = ("_put", "store")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_channel_scope(ctx.relpath):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(ctx, node, out)
        return out

    def _check_function(self, ctx: ModuleContext, fn: ast.AST,
                        out: List[Finding]) -> None:
        payload_writes: List[int] = []
        payload_reads: List[int] = []
        word_stores: List[Tuple[str, ast.Call]] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in self._PAYLOAD_WRITES:
                payload_writes.append(node.lineno)
            elif attr in self._PAYLOAD_READS:
                payload_reads.append(node.lineno)
            elif attr in self._WORD_STORES and node.args:
                word = chan_word_of(node.args[0])
                if word in ("version", "ack"):
                    word_stores.append((word, node))
        for word, call in word_stores:
            if word == "version" and any(
                line > call.lineno for line in payload_writes
            ):
                out.append(ctx.finding(
                    call, self.name,
                    "`version` published before the payload store: a "
                    "reader woken by this bump copies torn/stale bytes "
                    "— commit order is payload, len, THEN version",
                ))
            elif word == "ack" and any(
                line > call.lineno for line in payload_reads
            ):
                out.append(ctx.finding(
                    call, self.name,
                    "`ack` advanced before the payload copy: the writer "
                    "is freed to overwrite the frame mid-copy — copy "
                    "the payload, THEN advance ack",
                ))


def static_lock_graph(paths, root=None):
    """The lock-order checker's accumulated graph for the given paths:
    ({node: {kind, where}}, {(src, dst): (path, line)}). Used by tests to
    cross-check the static graph against sanitizer-observed orderings.
    Raises on unparseable input — a silently empty graph would make that
    cross-check pass vacuously."""
    from ray_tpu_torch.analysis.core import iter_modules

    chk = LockOrderCycleChecker()
    errors: List[str] = []
    for ctx in iter_modules(paths, root=root, errors=errors):
        chk.check_module(ctx)
    if errors:
        raise ValueError(
            "static_lock_graph: unparseable file(s): " + "; ".join(errors)
        )
    return chk.nodes, chk.edges


# --------------------------------------------------- rpc cost checkers
#
# The static halves of the RPC budget (analysis/rpcflow.py): the N+1
# pattern and the hold-a-lock-across-a-round-trip pattern. Both feed the
# sharding refactor (ROADMAP #1) — every fix is a deleted round trip or
# an unwedged control-plane thread.


@register
class RpcInLoopChecker(Checker):
    """Per-item RPC inside a loop where a batched counterpart exists —
    the N+1 chatter pattern the rpcflow cost table calls ``per-item``.
    Keyed on rpcflow.BATCHED_COUNTERPARTS so the checker never flags a
    loop that has no batched alternative to offer."""

    name = "rpc-in-loop"
    description = (
        "per-item `.call/.call_async(\"method\", ...)` inside a loop for "
        "a method with a batched counterpart: N frames (and for blocking "
        "calls, N round-trip latencies) where one would do"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        from ray_tpu_torch.analysis.rpcflow import BATCHED_COUNTERPARTS

        parts = ctx.relpath.replace("\\", "/").split("/")
        if not (set(parts[:-1]) & _CONTROL_PLANE_SEGMENTS):
            return []
        out: List[Finding] = []
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(ctx, fn, BATCHED_COUNTERPARTS, out)
        return out

    def _check_function(self, ctx, fn, counterparts, out) -> None:
        from ray_tpu_torch.analysis.rpcflow import BATCH_PAYLOAD_KEYS

        parents = {
            id(child): parent for parent in ast.walk(fn)
            for child in ast.iter_child_nodes(parent)
        }
        seen: Set[int] = set()
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in ast.walk(loop):
                if node is loop or not isinstance(node, ast.Call) \
                        or id(node) in seen:
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute)
                        and f.attr in ("call", "call_async")):
                    continue
                if not (node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                method = node.args[0].value
                hint = counterparts.get(method)
                if hint is None:
                    continue
                # already the batched form: payload carries a batch key
                # (e.g. free_objects over an aggregated id list inside a
                # drain loop is one frame per BATCH, not per item)
                if len(node.args) > 1 and isinstance(node.args[1], ast.Dict) \
                        and any(
                            isinstance(k, ast.Constant)
                            and k.value in BATCH_PAYLOAD_KEYS
                            for k in node.args[1].keys
                        ):
                    continue
                # the loop exits right after the call (next sibling on the
                # climb to the loop is return/break/raise): at most one
                # frame per loop entry, e.g. publish-after-successful-pull
                if self._loop_exits_after(node, loop, parents):
                    continue
                seen.add(id(node))
                blocking = ("blocking round trip" if f.attr == "call"
                            else "frame")
                out.append(ctx.finding(
                    node, self.name,
                    f"per-item rpc `{method}` inside a loop: one "
                    f"{blocking} per item where a batched form exists — "
                    f"{hint}; or suppress with "
                    "`# ray-lint: disable=rpc-in-loop`",
                ))

    @staticmethod
    def _loop_exits_after(call: ast.AST, loop: ast.AST, parents) -> bool:
        """True when control provably leaves the loop right after the
        statement containing ``call``: climbing block-by-block toward the
        loop, the immediate next sibling is an unconditional
        return/break/raise before any other statement (or an inner loop
        boundary) intervenes."""
        node = call
        while node is not loop:
            parent = parents.get(id(node))
            if parent is None:
                return False
            if isinstance(parent, (ast.For, ast.AsyncFor, ast.While)) \
                    and parent is not loop:
                return False  # inner loop body: still per-item there
            for field in ("body", "orelse", "finalbody"):
                block = getattr(parent, field, None)
                if isinstance(block, list) and node in block:
                    idx = block.index(node)
                    rest = block[idx + 1:]
                    if rest:
                        return isinstance(
                            rest[0], (ast.Return, ast.Break, ast.Raise)
                        )
                    break
            node = parent
        return False


@register
class RpcUnderLockChecker(Checker):
    """Blocking `.call` while a `threading` lock is held: the round trip
    (client-default deadline: seconds) serializes every other thread
    queued on that lock, and a lock-ordered peer calling back in deadlocks.
    Reuses CrossThreadFieldWriteChecker's lock machinery — `with
    self.<lock>:` scoping plus propagation through same-class calls made
    under the lock and the ``_locked`` suffix convention."""

    name = "rpc-under-lock"
    description = (
        "blocking `.call(\"method\", ...)` while holding a class "
        "`threading` lock: every thread queued on the lock eats the "
        "round-trip latency, and a callback from the peer deadlocks"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        parts = ctx.relpath.replace("\\", "/").split("/")
        if not (set(parts[:-1]) & _CONTROL_PLANE_SEGMENTS):
            return []
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                self._check_class(ctx, cls, out)
        return out

    def _check_class(self, ctx, cls: ast.ClassDef, out) -> None:
        helper = CrossThreadFieldWriteChecker()
        lock_attrs = helper._lock_attrs(cls)
        if not lock_attrs:
            return
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # lock-held-ness propagated through the same-class call graph:
        # seed every method as a root (any caller context), then mark
        # callees reached from under a lock
        called_locked: Dict[str, bool] = {
            name: name.endswith("_locked") for name in methods
        }
        work = [n for n, locked in called_locked.items() if locked]
        for name, fn in methods.items():
            for callee, under in helper._calls_of(fn, lock_attrs):
                if under and callee in methods \
                        and not called_locked[callee]:
                    called_locked[callee] = True
                    work.append(callee)
        while work:
            name = work.pop()
            for callee, _under in helper._calls_of(
                methods[name], lock_attrs
            ):
                if callee in methods and not called_locked[callee]:
                    called_locked[callee] = True
                    work.append(callee)
        for name, fn in methods.items():
            locked_ids = helper._nodes_under_lock(fn, lock_attrs)
            whole_fn_locked = called_locked[name]
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "call"):
                    continue
                if not (node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                if not (id(node) in locked_ids or whole_fn_locked):
                    continue
                how = (
                    "inside `with self.<lock>:`" if id(node) in locked_ids
                    else "in a method reached from under the class lock"
                )
                out.append(ctx.finding(
                    node, self.name,
                    f"blocking rpc `{node.args[0].value}` {how} "
                    f"({'/'.join(sorted(lock_attrs))}): hoist the call "
                    "out of the critical section (snapshot under the "
                    "lock, call after), or suppress with "
                    "`# ray-lint: disable=rpc-under-lock`",
                ))


@register
class BlockingWaitUnderLockChecker(Checker):
    """Generalizes `rpc-under-lock` to every OTHER blocking wait the
    waitgraph classifier knows (chained ``call_async(...).result()``,
    bare ``Future.result``, ``queue.get``, ``Condition.wait``,
    ``Thread.join``, ``Channel.read/write``): the lock is pinned for
    the whole wait, and whoever must release the awaited resource may
    need that lock — the lock-channel / lock-RPC halves of the wait
    cycles the dynamic WaitSanitizer hunts. Same lock machinery and
    same-class propagation as ``rpc-under-lock``; the ``with self._cv:
    self._cv.wait()`` condition idiom is exempt (waiting RELEASES the
    lock it waits on)."""

    name = "blocking-wait-under-lock"
    description = (
        "blocking wait (chained rpc result, future, queue get, "
        "condition wait, thread join, channel read/write) while "
        "holding a class `threading` lock: the lock is pinned for the "
        "whole wait and the releaser may need it"
    )

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        parts = ctx.relpath.replace("\\", "/").split("/")
        if not (set(parts[:-1]) & _CONTROL_PLANE_SEGMENTS):
            return []
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                self._check_class(ctx, cls, out)
        return out

    @staticmethod
    def _receiver_attr(node: ast.Call) -> Optional[str]:
        v = node.func.value
        if isinstance(v, ast.Attribute) and isinstance(
            v.value, ast.Name
        ) and v.value.id == "self":
            return v.attr
        return None

    def _check_class(self, ctx, cls: ast.ClassDef, out) -> None:
        from ray_tpu_torch.analysis.racer import _locks_covering
        from ray_tpu_torch.analysis.waitgraph import (
            WAIT_KINDS_UNDER_LOCK, blocking_wait_kind)

        helper = CrossThreadFieldWriteChecker()
        lock_attrs = helper._lock_attrs(cls)
        if not lock_attrs:
            return
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        called_locked: Dict[str, bool] = {
            name: name.endswith("_locked") for name in methods
        }
        work = [n for n, locked in called_locked.items() if locked]
        for name, fn in methods.items():
            for callee, under in helper._calls_of(fn, lock_attrs):
                if under and callee in methods \
                        and not called_locked[callee]:
                    called_locked[callee] = True
                    work.append(callee)
        while work:
            name = work.pop()
            for callee, _under in helper._calls_of(
                methods[name], lock_attrs
            ):
                if callee in methods and not called_locked[callee]:
                    called_locked[callee] = True
                    work.append(callee)
        for name, fn in methods.items():
            locked_ids = helper._nodes_under_lock(fn, lock_attrs)
            covering = _locks_covering(fn, lock_attrs)
            whole_fn_locked = called_locked[name]
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                k = blocking_wait_kind(node)
                if k is None or k[0] not in WAIT_KINDS_UNDER_LOCK:
                    continue
                kind, method = k
                lexically = id(node) in locked_ids
                if not (lexically or whole_fn_locked):
                    continue
                if kind == "cond-wait":
                    # waiting on a condition RELEASES the lock it waits
                    # on: flag only when some OTHER lock stays held
                    recv = self._receiver_attr(node)
                    if lexically:
                        held = covering.get(id(node), frozenset())
                        if not (held - ({recv} if recv else set())):
                            continue
                    elif recv is not None and recv in lock_attrs:
                        continue
                how = (
                    "inside `with self.<lock>:`" if lexically
                    else "in a method reached from under the class lock"
                )
                what = f"blocking {kind}" + (
                    f" `{method}`" if method else ""
                )
                out.append(ctx.finding(
                    node, self.name,
                    f"{what} {how} ({'/'.join(sorted(lock_attrs))}): "
                    "the lock is pinned for the whole wait and the "
                    "releaser may need it — hoist the wait out of the "
                    "critical section (snapshot under the lock, wait "
                    "after), or suppress with "
                    "`# ray-lint: disable=blocking-wait-under-lock`",
                ))


@register
class RpcReentryCycleChecker(Checker):
    """A handler whose blocking RPC chain can re-enter its own server
    class — the GCS→daemon→GCS shape. With a bounded dispatcher every
    such chain is one concurrent burst away from thread exhaustion, and
    under a held lock it is a cross-process deadlock. Whole-program:
    modules accumulate through ``check_module`` (helpers outside the
    control plane must still resolve), the blocking graph builds once
    in ``finalize`` via :func:`ray_tpu_torch.analysis.waitgraph.
    build_from_contexts` and every reentry chain is reported at the
    originating handler's first blocking RPC site."""

    name = "rpc-reentry-cycle"
    description = (
        "rpc handler whose blocking rpc chain re-enters its own server "
        "class: the reply depends on a dispatcher slot the caller may "
        "hold (thread exhaustion; deadlock under a lock)"
    )

    def __init__(self) -> None:
        self._ctxs: List[ModuleContext] = []

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        self._ctxs.append(ctx)
        return []

    def finalize(self) -> List[Finding]:
        from ray_tpu_torch.analysis import waitgraph as _wg

        if not self._ctxs:
            return []
        report = _wg.build_from_contexts(self._ctxs, root="")
        out: List[Finding] = []
        for entry in _wg.reentry_chains(report):
            site = entry["site"]
            chain = " -> ".join(entry["chain"])
            out.append(Finding(
                path=site.path, line=site.line, col=0,
                check=self.name,
                message=(
                    f"blocking rpc `{site.method}` starts a chain that "
                    f"re-enters this handler's own server ({chain}): "
                    "the reply depends on a dispatcher slot the caller "
                    "may be holding — break the cycle (async notify, "
                    "or move the work off the handler), or suppress "
                    "with `# ray-lint: disable=rpc-reentry-cycle`"
                ),
                line_text="", end_line=site.end_line,
            ))
        return out
