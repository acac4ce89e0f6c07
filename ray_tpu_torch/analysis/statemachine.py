"""Per-entity lifecycle state machines: declared protocol + AST extraction.

The control plane keeps each entity's lifecycle in a stringly-typed
status field — ``self.actors[aid]["state"] = "ALIVE"``, ``pg["state"] =
"PENDING"``, ``ent["state"] = "COMMITTED"`` — with the legal transition
structure living only in its authors' heads. This module makes it
machine-checked:

- :data:`MACHINES` *declares* the intended state machine per entity
  (actor, placement group, dag, node, job, daemon-side 2PC bundle, task
  report statuses; the object lifecycle is declared for documentation
  but enforced dynamically by ``invariants.py``, since objects carry no
  status field);
- :func:`extract_module` AST-extracts every status-field **write**
  (including dict-literal row creations) and the locally *observed*
  states (positive ``== "S"`` / ``in ("S", ...)`` guards whose branch
  dominates the write) from ``cluster/gcs.py`` / ``cluster/
  node_daemon.py``;
- the ``illegal-state-transition`` checker (``checkers.py``) validates
  each write against the declared machine: unknown state strings
  (typos), row creations in non-initial states, writes of states no
  declared edge ever produces, and guarded writes whose observed source
  state has no edge to the written state.

Observation extraction is deliberately branch-local and positive-only
(a write under ``if x["state"] == "A":`` observes {A}; negations,
``!=``, and else-branches observe nothing), so the checker never guesses
— everything it flags is either an undeclared state or an undeclared
transition out of a state the code *explicitly matched*.

The extraction lands in the ProtocolIndex (``--dump-protocol`` emits it
under ``"statemachines"``), so the declared/extracted surfaces are
diffable and the explorer's scenarios, the invariant checker, and this
static model can be cross-checked.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import ModuleContext

#: ``self.<attr>`` tables whose rows carry a lifecycle field
ENTITY_TABLES: Dict[str, str] = {
    "actors": "actor",
    "placement_groups": "pg",
    "nodes": "node",
    "dags": "dag",
    "jobs": "job",
    "_bundles": "bundle",
}

#: row-parameter name heuristics for lock-held helpers that take the row
#: itself (``_maybe_restart_actor_locked(self, a, cause)``)
ENTITY_PARAMS: Dict[str, str] = {
    "a": "actor", "actor": "actor", "pg": "pg", "dag": "dag",
    "n": "node", "node": "node", "ent": "bundle",
}

#: lifecycle field per entity ("alive" is a bool field: True=ALIVE)
STATE_FIELD: Dict[str, str] = {
    "actor": "state", "pg": "state", "dag": "state", "job": "state",
    "bundle": "state", "node": "alive",
}

#: secondary lifecycle fields riding on an existing entity row:
#: (row entity, field name) -> machine entity. The node row carries two
#: machines — liveness (``alive``, bool) and gray-failure health
#: (``health``, string) — and the extractor routes each field's writes
#: to its own machine.
FIELD_MACHINES: Dict[Tuple[str, str], str] = {
    ("node", "health"): "node-health",
}

#: modules the extractor applies to (basename match)
STATE_MODULES = ("gcs.py", "node_daemon.py")


@dataclasses.dataclass(frozen=True)
class StateMachine:
    entity: str
    states: FrozenSet[str]
    initial: FrozenSet[str]
    edges: FrozenSet[Tuple[str, str]]
    #: None = statically checked; otherwise names the dynamic checker
    enforced_by: Optional[str] = None

    def targets(self) -> Set[str]:
        return {dst for _src, dst in self.edges}

    def to_dict(self) -> Dict:
        return {
            "entity": self.entity,
            "states": sorted(self.states),
            "initial": sorted(self.initial),
            "edges": sorted([list(e) for e in self.edges]),
            "enforced_by": self.enforced_by,
        }


def _m(entity, states, initial, edges, enforced_by=None) -> StateMachine:
    return StateMachine(
        entity=entity,
        states=frozenset(states),
        initial=frozenset(initial),
        edges=frozenset(edges),
        enforced_by=enforced_by,
    )


#: The declared protocol. Every edge corresponds to a handler path in
#: cluster/gcs.py / cluster/node_daemon.py; the explorer's scenarios
#: drive most of them dynamically.
MACHINES: Dict[str, StateMachine] = {
    "actor": _m(
        "actor",
        states=["PENDING", "STARTING", "ALIVE", "RESTARTING",
                "RESTARTING_GCS", "DEAD"],
        # PENDING via register_actor; ALIVE via node_sync backfill after
        # a GCS restart (the daemon re-reports a live actor)
        initial=["PENDING", "ALIVE"],
        edges=[
            ("PENDING", "STARTING"),      # creation dispatched
            ("PENDING", "RESTARTING"),    # died before dispatch, budget left
            ("PENDING", "DEAD"),          # kill / creation failed
            ("STARTING", "ALIVE"),        # creation FINISHED
            ("STARTING", "PENDING"),      # retryable creation failure
            ("STARTING", "RESTARTING"),   # node died mid-creation
            ("STARTING", "DEAD"),
            ("ALIVE", "RESTARTING"),      # worker/node death, budget left
            ("ALIVE", "RESTARTING_GCS"),  # snapshot restore
            ("ALIVE", "DEAD"),
            ("RESTARTING", "STARTING"),   # re-dispatch
            ("RESTARTING", "ALIVE"),      # node_sync found it live after all
            ("RESTARTING", "DEAD"),
            ("RESTARTING_GCS", "ALIVE"),  # daemon re-sync confirmed
            ("RESTARTING_GCS", "DEAD"),
        ],
    ),
    "pg": _m(
        "pg",
        states=["PENDING", "PREPARING", "CREATED"],
        initial=["PENDING", "PREPARING"],  # infeasible-now vs staged
        edges=[
            ("PENDING", "PREPARING"),   # staged for 2PC
            ("PREPARING", "CREATED"),   # both phases acked
            ("PREPARING", "PENDING"),   # prepare/commit failed -> re-park
            ("CREATED", "PENDING"),     # member node died -> re-pack
        ],
    ),
    "dag": _m(
        "dag",
        states=["RUNNING", "BROKEN"],
        initial=["RUNNING"],
        edges=[("RUNNING", "BROKEN")],
    ),
    "node": _m(
        "node",
        states=["ALIVE", "DEAD"],  # the boolean `alive` field
        initial=["ALIVE"],
        edges=[("ALIVE", "DEAD"), ("DEAD", "ALIVE")],
    ),
    # gray-failure defense plane (gcs._gray_sweep + quarantine helpers):
    # an ALIVE node's health rides the suspicion score through
    # OK -> SUSPECT -> QUARANTINED -> PROBATION -> OK, with instant
    # relapse from PROBATION and manual quarantine from any pre-mask
    # state (rpc_quarantine_node).
    "node-health": _m(
        "node-health",
        states=["OK", "SUSPECT", "QUARANTINED", "PROBATION"],
        initial=["OK"],
        edges=[
            ("OK", "SUSPECT"),            # score crossed quarantine_high
            ("SUSPECT", "OK"),            # decayed below quarantine_low
            ("SUSPECT", "QUARANTINED"),   # sustained over N sweeps
            ("OK", "QUARANTINED"),        # manual rpc_quarantine_node
            ("QUARANTINED", "PROBATION"), # clean probes earned exit
            ("PROBATION", "OK"),          # probation served clean
            ("PROBATION", "QUARANTINED"), # relapse: straight back
        ],
    ),
    "job": _m(
        "job",
        states=["RUNNING", "FINISHED"],
        initial=["RUNNING"],
        edges=[("RUNNING", "FINISHED")],
    ),
    "bundle": _m(
        "bundle",
        states=["PREPARED", "COMMITTED"],
        initial=["PREPARED"],
        edges=[("PREPARED", "COMMITTED"),
               ("COMMITTED", "COMMITTED")],  # idempotent re-commit
    ),
    # task lifecycle lives in report payloads, not a table row: the
    # static check is vocabulary-only (a typo'd status string silently
    # falls through every status dispatch); ordering is checked
    # dynamically (exactly-once / exec-seq invariants)
    "task-status": _m(
        "task-status",
        states=["FINISHED", "FAILED", "WORKER_DIED", "NODE_DIED",
                "DEPS_LOST", "DEPS_UNAVAILABLE", "UNSCHEDULABLE",
                "ACTOR_UNREACHABLE", "ACTOR_DEAD", "DAG_ITER"],
        initial=["FINISHED", "FAILED", "WORKER_DIED", "NODE_DIED",
                 "DEPS_LOST", "DEPS_UNAVAILABLE", "UNSCHEDULABLE",
                 "ACTOR_UNREACHABLE", "ACTOR_DEAD", "DAG_ITER"],
        edges=[],
    ),
    # declared for completeness; enforced by the object-lifecycle
    # invariant in invariants.py (objects carry no status field)
    "object": _m(
        "object",
        states=["CREATED", "LOCATED", "FREED"],
        initial=["CREATED"],
        edges=[("CREATED", "LOCATED"), ("LOCATED", "FREED"),
               ("FREED", "CREATED")],
        enforced_by="invariants.check_trace (object-lifecycle)",
    ),
}


@dataclasses.dataclass
class StateWrite:
    entity: str
    field: str
    value: str  # normalized state (bools map to ALIVE/DEAD)
    path: str
    line: int
    end_line: int
    line_text: str
    func: str
    creation: bool  # row creation (dict literal) vs field overwrite
    observed: FrozenSet[str]  # branch-local positive guards

    def to_dict(self) -> Dict:
        return {
            "entity": self.entity, "field": self.field,
            "value": self.value, "path": self.path, "line": self.line,
            "func": self.func, "creation": self.creation,
            "observed": sorted(self.observed),
        }


def applies_to(ctx: ModuleContext) -> bool:
    base = ctx.relpath.replace("\\", "/").rsplit("/", 1)[-1]
    return base in STATE_MODULES


def _norm_state(entity: str, value: ast.AST) -> Optional[str]:
    """Constant state value -> normalized name, None if non-constant."""
    if not isinstance(value, ast.Constant):
        return None
    v = value.value
    if entity == "node":
        if v is True:
            return "ALIVE"
        if v is False:
            return "DEAD"
        return None
    return v if isinstance(v, str) else None


class _FuncExtractor(ast.NodeVisitor):
    """Walks one function: resolves row variables to entities, collects
    state writes with their branch-local positive observations."""

    def __init__(self, ctx: ModuleContext, func: ast.AST, qualname: str):
        self.ctx = ctx
        self.func = func
        self.qualname = qualname
        self.out: List[StateWrite] = []
        # var name -> entity, resolved from `x = self.<table>...`
        # assignments, `for x in self.<table>.values()`, and row-param
        # name heuristics
        self.var_entity: Dict[str, str] = {}
        args = getattr(func, "args", None)
        if args is not None:
            for a in args.args:
                if a.arg in ENTITY_PARAMS:
                    self.var_entity[a.arg] = ENTITY_PARAMS[a.arg]
        self._observed: List[Tuple[str, FrozenSet[str]]] = []  # stack

    # ------------------------------------------------- entity resolution

    def _table_entity(self, node: ast.AST) -> Optional[str]:
        """`self.<table>` (possibly behind .get/.pop/[k]/.values()) ->
        entity."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return ENTITY_TABLES.get(node.attr)
        return None

    def _row_entity(self, node: ast.AST) -> Optional[str]:
        """Entity of an expression that denotes one table ROW."""
        # self.table[k]
        if isinstance(node, ast.Subscript):
            return self._table_entity(node.value)
        # self.table.get(k) / self.table.pop(k)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in ("get", "pop"):
                return self._table_entity(node.func.value)
        if isinstance(node, ast.Name):
            return self.var_entity.get(node.id)
        return None

    def _learn_assign(self, node: ast.Assign) -> None:
        ent = self._row_entity(node.value)
        if ent is None:
            return
        for t in node.targets:
            if isinstance(t, ast.Name):
                self.var_entity[t.id] = ent

    def _learn_for(self, node: ast.For) -> None:
        # for x in self.table.values(): / for k, x in self.table.items():
        it = node.iter
        ent = None
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("values", "items"):
            ent = self._table_entity(it.func.value)
            # list(self.table.items()) wrapper
            if ent is None and isinstance(it.func.value, ast.Call):
                inner = it.func.value
                if isinstance(inner.func, ast.Name) and \
                        inner.func.id == "list":
                    pass
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "list" and it.args:
            inner = it.args[0]
            if isinstance(inner, ast.Call) and \
                    isinstance(inner.func, ast.Attribute) and \
                    inner.func.attr in ("values", "items"):
                ent = self._table_entity(inner.func.value)
                it = inner
        if ent is None:
            return
        is_items = isinstance(it, ast.Call) and \
            isinstance(it.func, ast.Attribute) and it.func.attr == "items"
        tgt = node.target
        if is_items and isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2 \
                and isinstance(tgt.elts[1], ast.Name):
            self.var_entity[tgt.elts[1].id] = ent
        elif not is_items and isinstance(tgt, ast.Name):
            self.var_entity[tgt.id] = ent

    # ---------------------------------------------------- observations

    def _guard_states(self, test: ast.AST) -> List[Tuple[str, FrozenSet[str]]]:
        """Positive state observations in an if-test: [(entity, states)].
        `x["state"] == "S"`, `x.get("state") == "S"`, `... in ("A","B")`,
        and conjunctions thereof. Negations contribute nothing."""
        out: List[Tuple[str, FrozenSet[str]]] = []
        tests = [test]
        while tests:
            t = tests.pop()
            if isinstance(t, ast.BoolOp) and isinstance(t.op, ast.And):
                tests.extend(t.values)
                continue
            if not isinstance(t, ast.Compare) or len(t.ops) != 1:
                continue
            op = t.ops[0]
            ent_field = self._state_read(t.left)
            if ent_field is None:
                continue
            entity, field = ent_field
            if field != STATE_FIELD.get(entity):
                entity = FIELD_MACHINES.get((entity, field))
                if entity is None:
                    continue
            comp = t.comparators[0]
            states: Set[str] = set()
            if isinstance(op, ast.Eq):
                s = _norm_state(entity, comp)
                if s is not None:
                    states.add(s)
            elif isinstance(op, ast.In) and isinstance(
                comp, (ast.Tuple, ast.List, ast.Set)
            ):
                for e in comp.elts:
                    s = _norm_state(entity, e)
                    if s is not None:
                        states.add(s)
            if states:
                out.append((entity, frozenset(states)))
        return out

    def _state_read(self, node: ast.AST) -> Optional[Tuple[str, str]]:
        """`x["state"]` / `x.get("state")` -> (entity, field)."""
        if isinstance(node, ast.Subscript):
            ent = self._row_entity(node.value)
            if ent is not None and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                return ent, node.slice.value
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args:
            ent = self._row_entity(node.func.value)
            k = node.args[0]
            if ent is not None and isinstance(k, ast.Constant) \
                    and isinstance(k.value, str):
                return ent, k.value
        return None

    def _observed_for(self, entity: str) -> FrozenSet[str]:
        obs: Set[str] = set()
        for ent, states in self._observed:
            if ent == entity:
                obs |= states
        return frozenset(obs)

    # ---------------------------------------------------------- visits

    def _emit(self, node: ast.AST, entity: str, field: str, value: str,
              creation: bool) -> None:
        self.out.append(StateWrite(
            entity=entity, field=field, value=value,
            path=self.ctx.relpath, line=node.lineno,
            end_line=getattr(node, "end_lineno", None) or node.lineno,
            line_text=self.ctx.line_text(node.lineno),
            func=self.qualname, creation=creation,
            observed=frozenset() if creation else self._observed_for(entity),
        ))

    def _scan_creation_dict(self, node: ast.AST, entity: str,
                            d: ast.Dict) -> None:
        field = STATE_FIELD.get(entity)
        for k, v in zip(d.keys, d.values):
            if not isinstance(k, ast.Constant):
                continue
            if k.value == field:
                ment = entity
            else:
                ment = FIELD_MACHINES.get((entity, k.value))
                if ment is None:
                    continue
            s = _norm_state(ment, v)
            if s is not None or isinstance(v, ast.Constant):
                self._emit(node, ment, k.value,
                           s if s is not None else repr(v.value),
                           creation=True)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._learn_assign(node)
        for t in node.targets:
            # x["state"] = <const> / self.table[k]["state"] = <const>;
            # conditional writes (`"A" if cond else "B"`) emit one write
            # per constant arm
            if isinstance(t, ast.Subscript) and isinstance(
                t.slice, ast.Constant
            ) and isinstance(t.slice.value, str):
                ent = self._row_entity(t.value)
                if ent is not None and t.slice.value != STATE_FIELD.get(ent):
                    ent = FIELD_MACHINES.get((ent, t.slice.value))
                if ent is not None:
                    values = (
                        [node.value.body, node.value.orelse]
                        if isinstance(node.value, ast.IfExp)
                        else [node.value]
                    )
                    for v in values:
                        s = _norm_state(ent, v)
                        if s is not None or isinstance(v, ast.Constant):
                            self._emit(
                                node, ent, t.slice.value,
                                s if s is not None else repr(v.value),
                                creation=False,
                            )
            # self.table[k] = {... "state": X ...} (row creation)
            if isinstance(t, ast.Subscript):
                ent = self._table_entity(t.value)
                if ent is not None and isinstance(node.value, ast.Dict):
                    self._scan_creation_dict(node, ent, node.value)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._learn_for(node)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        guards = self._guard_states(node.test)
        self._observed.extend(guards)
        for child in node.body:
            self.visit(child)
        del self._observed[len(self._observed) - len(guards):]
        for child in node.orelse:
            self.visit(child)

    def visit_FunctionDef(self, node):
        pass  # nested defs get their own extractor pass

    visit_AsyncFunctionDef = visit_FunctionDef


def extract_module(ctx: ModuleContext) -> List[StateWrite]:
    """Every status-field write (+ task-status literals) in a
    gcs/node_daemon module."""
    if not applies_to(ctx):
        return []
    out: List[StateWrite] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fx = _FuncExtractor(ctx, node, node.name)
        for stmt in node.body:
            fx.visit(stmt)
        out.extend(fx.out)
        # task-status vocabulary: literal {"status": "X"} payload keys
        # and `status == "X"` / `status in (...)` dispatches
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                for k, v in zip(sub.keys, sub.values):
                    if (
                        isinstance(k, ast.Constant) and k.value == "status"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                    ):
                        out.append(StateWrite(
                            entity="task-status", field="status",
                            value=v.value, path=ctx.relpath,
                            line=sub.lineno,
                            end_line=getattr(sub, "end_lineno", None)
                            or sub.lineno,
                            line_text=ctx.line_text(sub.lineno),
                            func=node.name, creation=True,
                            observed=frozenset(),
                        ))
    out.sort(key=lambda w: (w.path, w.line))
    return out


def check_writes(writes: List[StateWrite]) -> List[Tuple[StateWrite, str]]:
    """Validate extracted writes against the declared machines. Returns
    [(write, problem)] — empty on a protocol-conforming tree."""
    problems: List[Tuple[StateWrite, str]] = []
    for w in writes:
        m = MACHINES.get(w.entity)
        if m is None or m.enforced_by is not None:
            continue
        if w.value not in m.states:
            problems.append((w, (
                f"{w.entity} state {w.value!r} is not a declared state "
                f"(have {sorted(m.states)}) — typo or undeclared "
                "lifecycle extension"
            )))
            continue
        if w.entity == "task-status":
            continue  # vocabulary-only
        if w.creation:
            if w.value not in m.initial:
                problems.append((w, (
                    f"{w.entity} row created in state {w.value!r}; "
                    f"declared initial states: {sorted(m.initial)}"
                )))
            continue
        if w.observed:
            bad = [s for s in w.observed if (s, w.value) not in m.edges]
            if bad:
                problems.append((w, (
                    f"{w.entity} transition {sorted(bad)} -> {w.value!r} "
                    "has no declared edge (the guard observes a state "
                    "this write is illegal from)"
                )))
        elif w.value not in m.targets():
            problems.append((w, (
                f"{w.entity} state {w.value!r} is never the target of a "
                "declared edge — no handler may write it outside row "
                "creation"
            )))
    return problems
