"""Static RPC-protocol model extraction (AST, no runtime imports).

The control plane is stringly typed: ``client.call("submit_task", {...})``
is dispatched by name to ``GcsServer.rpc_submit_task`` and payload dicts
are read back as ``p["task_id"]`` / ``p.get("owner")``. Nothing ties the
two sides together at import time, so a typo'd method name, a renamed
payload key, or a push topic nobody subscribes to is invisible until a
live test happens to cross it. This module extracts the full protocol
surface from the AST — handlers (with the payload keys they read), call
sites (with the literal payload keys they send), push/subscribe topic
literals, and config-knob definitions/usages — into one inspectable
:class:`ProtocolIndex`. The protocol checkers in
:mod:`ray_tpu_torch.analysis.checkers` consume it, and the CLI's
``--dump-protocol`` serializes it so the model is diffable and the
dynamic invariant checker's method table can be validated against it
(reference: the reference repo's generated gRPC stubs make this whole
class of drift a compile error; here the linter is the compiler).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set

from ray_tpu_torch.analysis.core import ModuleContext

#: method-name prefix that marks a server-side handler
HANDLER_PREFIX = "rpc_"

#: attribute names that send a request with a string-literal method
CALL_ATTRS = ("call", "call_async", "notify")

#: (attribute name -> positional index of the topic argument) for
#: server->client pushes; wrappers in gcs.py and the RpcServer.send_push
#: seam take the topic second
PUSH_ATTRS = {"push": 0, "broadcast": 0, "_push_conn": 1,
              "_push_to_node": 1, "send_push": 1}

#: env literals like RAY_TPU_scheduling_policy are config knobs; the
#: all-caps infra vars (RAY_TPU_CHAOS_SPEC, RAY_TPU_WORKER_ID, ...) are not
_ENV_KNOB_RE = re.compile(r"^RAY_TPU_([a-z][a-z0-9_]*)$")

#: Config attributes that are API surface, not knobs (consumed by the
#: config-key-unknown checker — single definition, no drift)
CONFIG_API_ATTRS = frozenset({"to_dict", "_values"})


def _server_label(relpath: str) -> str:
    base = relpath.replace("\\", "/").rsplit("/", 1)[-1]
    if base == "gcs.py":
        return "gcs"
    if base == "node_daemon.py":
        return "daemon"
    return base[:-3] if base.endswith(".py") else base


@dataclasses.dataclass
class Handler:
    method: str
    server: str
    path: str
    line: int
    param: str
    required: Set[str] = dataclasses.field(default_factory=set)
    optional: Set[str] = dataclasses.field(default_factory=set)
    # True when the payload escapes whole (dict(p), **p, p.items(), passed
    # on): the key universe is then unknowable, so unknown-key checks are
    # suppressed (required-key reads still hold)
    open_payload: bool = False

    def to_dict(self) -> Dict:
        return {
            "method": self.method,
            "server": self.server,
            "path": self.path,
            "line": self.line,
            "required": sorted(self.required),
            "optional": sorted(self.optional),
            "open_payload": self.open_payload,
        }


@dataclasses.dataclass
class CallSite:
    path: str
    line: int
    line_text: str
    end_line: int
    kind: str  # call | call_async | notify
    method: str
    # literal payload-dict keys, or None when the payload is a variable /
    # absent; open_keys marks a dict literal with non-literal parts (**x)
    keys: Optional[List[str]] = None
    open_keys: bool = False

    def to_dict(self) -> Dict:
        return {
            "path": self.path,
            "line": self.line,
            "kind": self.kind,
            "method": self.method,
            "keys": self.keys,
            "open_keys": self.open_keys,
        }


@dataclasses.dataclass
class TopicSite:
    path: str
    line: int
    line_text: str
    end_line: int
    topic: str
    via: str  # push | broadcast | _push_conn | _push_to_node | subscribe

    def to_dict(self) -> Dict:
        return {
            "path": self.path,
            "line": self.line,
            "topic": self.topic,
            "via": self.via,
        }


@dataclasses.dataclass
class ConfigUse:
    path: str
    line: int
    line_text: str
    end_line: int
    key: str
    via: str  # attr | override | env

    def to_dict(self) -> Dict:
        return {
            "path": self.path,
            "line": self.line,
            "key": self.key,
            "via": self.via,
        }


class ProtocolIndex:
    """Whole-program protocol surface, built one module at a time."""

    def __init__(self):
        self.handlers: Dict[str, List[Handler]] = {}
        self.calls: List[CallSite] = []
        self.pushes: List[TopicSite] = []
        self.subscriptions: List[TopicSite] = []
        self.config_keys: Set[str] = set()
        self.config_defs_path: Optional[str] = None
        self.config_uses: List[ConfigUse] = []
        # per-entity lifecycle writes (analysis/statemachine.py): the
        # extracted counterpart of the declared MACHINES table
        self.state_writes: List = []

    # ------------------------------------------------------------ building

    def add_module(self, ctx: ModuleContext) -> None:
        from ray_tpu_torch.analysis import statemachine as _sm

        self._collect_handlers(ctx)
        self._collect_wire_sites(ctx)
        self._collect_config_defs(ctx)
        self._collect_config_uses(ctx)
        self.state_writes.extend(_sm.extract_module(ctx))

    @classmethod
    def piece_for(cls, ctx: ModuleContext) -> "ProtocolIndex":
        """The single-module extraction, computed once per ModuleContext
        and cached on it: four protocol checkers run per lint pass, and
        the AST walks are the expensive part — they must not quadruple."""
        piece = getattr(ctx, "_protocol_index_piece", None)
        if piece is None:
            piece = cls()
            piece.add_module(ctx)
            ctx._protocol_index_piece = piece
        return piece

    def merge(self, other: "ProtocolIndex") -> None:
        """Fold another index (typically a per-module piece) into this one."""
        for m, hs in other.handlers.items():
            self.handlers.setdefault(m, []).extend(hs)
        self.calls.extend(other.calls)
        self.pushes.extend(other.pushes)
        self.subscriptions.extend(other.subscriptions)
        self.config_keys |= other.config_keys
        if other.config_defs_path is not None:
            self.config_defs_path = other.config_defs_path
        self.config_uses.extend(other.config_uses)
        self.state_writes.extend(other.state_writes)

    def _collect_handlers(self, ctx: ModuleContext) -> None:
        server = _server_label(ctx.relpath)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not node.name.startswith(HANDLER_PREFIX):
                continue
            args = [a.arg for a in node.args.args if a.arg != "self"]
            if not args:
                continue
            h = Handler(
                method=node.name[len(HANDLER_PREFIX):],
                server=server,
                path=ctx.relpath,
                line=node.lineno,
                param=args[0],
            )
            self._scan_payload_reads(node, h)
            self.handlers.setdefault(h.method, []).append(h)

    @staticmethod
    def _scan_payload_reads(fn: ast.AST, h: Handler) -> None:
        """Classify every use of the payload param inside the handler:
        ``p["k"]`` loads are required keys, ``p.get("k")`` optional; any
        other use of the bare name means the payload escapes (open)."""
        consumed: Set[int] = set()
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == h.param
            ):
                consumed.add(id(node.value))
                key = node.slice
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    if isinstance(node.ctx, ast.Load):
                        h.required.add(key.value)
                    # Store/Del = handler-added keys, not caller contract
                else:
                    h.open_payload = True  # p[var]: unknowable key
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == h.param
            ):
                consumed.add(id(node.func.value))
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    h.optional.add(node.args[0].value)
                else:
                    h.open_payload = True
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Name)
                and node.id == h.param
                and id(node) not in consumed
                and isinstance(node.ctx, ast.Load)
            ):
                h.open_payload = True
                return

    def _collect_wire_sites(self, ctx: ModuleContext) -> None:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in CALL_ATTRS:
                if not (node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                site = CallSite(
                    path=ctx.relpath,
                    line=node.lineno,
                    line_text=ctx.line_text(node.lineno),
                    end_line=getattr(node, "end_lineno", None) or node.lineno,
                    kind=attr,
                    method=node.args[0].value,
                )
                if len(node.args) > 1 and isinstance(node.args[1], ast.Dict):
                    keys: List[str] = []
                    open_keys = False
                    for k in node.args[1].keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            keys.append(k.value)
                        else:  # **expansion or computed key
                            open_keys = True
                    site.keys = keys
                    site.open_keys = open_keys
                self.calls.append(site)
            elif attr in PUSH_ATTRS:
                idx = PUSH_ATTRS[attr]
                if len(node.args) > idx and isinstance(
                    node.args[idx], ast.Constant
                ) and isinstance(node.args[idx].value, str):
                    self.pushes.append(TopicSite(
                        path=ctx.relpath,
                        line=node.lineno,
                        line_text=ctx.line_text(node.lineno),
                        end_line=getattr(node, "end_lineno", None) or node.lineno,
                        topic=node.args[idx].value,
                        via=attr,
                    ))
            elif attr == "subscribe":
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    self.subscriptions.append(TopicSite(
                        path=ctx.relpath,
                        line=node.lineno,
                        line_text=ctx.line_text(node.lineno),
                        end_line=getattr(node, "end_lineno", None) or node.lineno,
                        topic=node.args[0].value,
                        via="subscribe",
                    ))

    def _collect_config_defs(self, ctx: ModuleContext) -> None:
        """Knob names from the ``_DEFS`` table in core/config.py (or any
        module declaring one at top level)."""
        for node in ctx.tree.body if isinstance(ctx.tree, ast.Module) else ():
            if not isinstance(node, ast.Assign):
                continue
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "_DEFS" not in targets:
                continue
            value = node.value
            # handle the annotated/dict-literal form only
            if isinstance(value, ast.Dict):
                for k in value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        self.config_keys.add(k.value)
                self.config_defs_path = ctx.relpath
        for node in ctx.tree.body if isinstance(ctx.tree, ast.Module) else ():
            if isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ) and node.target.id == "_DEFS" and isinstance(
                node.value, ast.Dict
            ):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        self.config_keys.add(k.value)
                self.config_defs_path = ctx.relpath

    # --- config usage extraction ---

    @classmethod
    def _is_configish(cls, expr: ast.AST) -> bool:
        """Does this RHS expression EVALUATE TO a ray_tpu Config? True for
        GLOBAL_CONFIG references, ``Config(...)`` calls, and boolean/
        conditional compositions of those — `cfg = config or Config()`,
        `cfg = config if ... else _config.GLOBAL_CONFIG`. Deliberately
        structural, not containment: `Cluster(config=Config(...))` builds
        a Cluster, not a Config, and must not mark the target."""
        if isinstance(expr, ast.BoolOp):
            return any(cls._is_configish(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return cls._is_configish(expr.body) or cls._is_configish(expr.orelse)
        if isinstance(expr, ast.Name):
            return expr.id == "GLOBAL_CONFIG"
        if isinstance(expr, ast.Attribute):
            return expr.attr == "GLOBAL_CONFIG"
        if isinstance(expr, ast.Call):
            f = expr.func
            return (isinstance(f, ast.Name) and f.id == "Config") or (
                isinstance(f, ast.Attribute) and f.attr == "Config"
            )
        return False

    def _config_use(self, ctx: ModuleContext, node: ast.AST, key: str,
                    via: str) -> None:
        self.config_uses.append(ConfigUse(
            path=ctx.relpath,
            line=node.lineno,
            line_text=ctx.line_text(node.lineno),
            end_line=getattr(node, "end_lineno", None) or node.lineno,
            key=key,
            via=via,
        ))

    def _collect_config_uses(self, ctx: ModuleContext) -> None:
        if ctx.relpath == self.config_defs_path or ctx.relpath.replace(
            "\\", "/"
        ).endswith("core/config.py"):
            return  # the defining module's internals aren't knob uses
        # (1) env literals
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                m = _ENV_KNOB_RE.match(node.value)
                if m:
                    self._config_use(ctx, node, m.group(1), "env")
        # (2) override-dict literals: Config({...}) / Config(overrides={...})
        #     / set_global_config({...}) / _system_config={...}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = (
                f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None
            )
            dicts: List[ast.Dict] = []
            if name in ("Config", "set_global_config"):
                if node.args and isinstance(node.args[0], ast.Dict):
                    dicts.append(node.args[0])
                for kw in node.keywords:
                    if kw.arg == "overrides" and isinstance(kw.value, ast.Dict):
                        dicts.append(kw.value)
            for kw in node.keywords:
                if kw.arg == "_system_config" and isinstance(kw.value, ast.Dict):
                    dicts.append(kw.value)
            for d in dicts:
                for k in d.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        self._config_use(ctx, k, k.value, "override")
        # (3) attribute reads on config-typed expressions
        self._collect_config_attr_reads(ctx)

    def _collect_config_attr_reads(self, ctx: ModuleContext) -> None:
        # class-level: self.<attr> assigned from a config-ish RHS anywhere
        # in the class -> reads of self.<attr>.<knob> in that class count
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            config_attrs: Set[str] = set()
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and self._is_configish(node.value):
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            config_attrs.add(t.attr)
            if not config_attrs:
                continue
            for node in ast.walk(cls):
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Attribute)
                    and isinstance(node.value.value, ast.Name)
                    and node.value.value.id == "self"
                    and node.value.attr in config_attrs
                ):
                    self._config_use(ctx, node, node.attr, "attr")
        # function-local names assigned from config-ish RHS, plus direct
        # GLOBAL_CONFIG.<knob> reads anywhere
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            config_names: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and self._is_configish(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            config_names.add(t.id)
            if not config_names:
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in config_names
                ):
                    self._config_use(ctx, node, node.attr, "attr")
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and (
                    (isinstance(node.value, ast.Name)
                     and node.value.id == "GLOBAL_CONFIG")
                    or (isinstance(node.value, ast.Attribute)
                        and node.value.attr == "GLOBAL_CONFIG")
                )
            ):
                self._config_use(ctx, node, node.attr, "attr")

    # ----------------------------------------------------------- queries

    def handler_methods(self) -> Set[str]:
        return set(self.handlers)

    def subscribed_topics(self) -> Set[str]:
        return {s.topic for s in self.subscriptions}

    # --------------------------------------------------------------- dump

    def to_dict(self) -> Dict:
        return {
            "handlers": {
                m: [h.to_dict() for h in hs]
                for m, hs in sorted(self.handlers.items())
            },
            "calls": [c.to_dict() for c in self.calls],
            "pushes": [p.to_dict() for p in self.pushes],
            "subscriptions": [s.to_dict() for s in self.subscriptions],
            "config": {
                "defined": sorted(self.config_keys),
                "defs_path": self.config_defs_path,
                "uses": [u.to_dict() for u in self.config_uses],
            },
            "statemachines": {
                "declared": {
                    name: m.to_dict()
                    for name, m in sorted(_machines().items())
                },
                "writes": [w.to_dict() for w in self.state_writes],
            },
        }


def _machines():
    from ray_tpu_torch.analysis.statemachine import MACHINES

    return MACHINES


def extract_protocol(paths, root=None) -> ProtocolIndex:
    """Build the protocol index for the .py files under ``paths``.
    Raises on unparseable input — a silently partial model would make
    every cross-check pass vacuously (same contract as
    ``static_lock_graph``)."""
    from ray_tpu_torch.analysis.core import iter_modules

    idx = ProtocolIndex()
    errors: List[str] = []
    for mctx in iter_modules(paths, root=root, errors=errors):
        idx.add_module(mctx)
    if errors:
        raise ValueError(
            "extract_protocol: unparseable file(s): " + "; ".join(errors)
        )
    return idx
