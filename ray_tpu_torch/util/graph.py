"""Dask-style task-graph execution over ray_tpu_torch tasks (dask-on-ray
equivalent).

Reference: python/ray/util/dask/scheduler.py (`ray_dask_get`) — a dask
custom scheduler that walks the graph dict, submits one Ray task per graph
task with upstream ObjectRefs as arguments, and lets the core runtime do
dependency-ordered parallel execution. The same contract is implemented
here WITHOUT importing dask (not in this image): `get(dsk, keys)` accepts
the dask graph protocol —

  - a graph is a dict: key -> computation
  - a computation is either a literal, a key reference, or a "task":
    a tuple whose first element is callable: (fn, arg1, arg2, ...)
  - arguments may themselves be keys, nested lists/tuples of computations,
    or literals

so any library emitting dask graphs (or hand-built graphs) can run on the
cluster scheduler: `get` is signature-compatible with dask's `scheduler=`
hook (`dask.compute(..., scheduler=ray_tpu_torch.util.graph.get)` works when
dask is present).

Each graph task becomes one ray_tpu_torch task; inter-task edges are ObjectRefs,
so the cluster data plane (shm store, chunked transfer) moves intermediate
results and independent subtrees run in parallel across nodes. The runtime
resolves only TOP-LEVEL task arguments (same contract as the reference:
refs nested in containers are not awaited), so upstream refs are flattened
into varargs at submit time and spliced back into the argument tree inside
the worker.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence, Union

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef

Key = Hashable


def ishashable(x: Any) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def istask(x: Any) -> bool:
    """The dask task convention: a tuple with a callable head."""
    return isinstance(x, tuple) and bool(x) and callable(x[0])


class _Slot:
    """Placeholder for a flattened upstream ref inside the argument tree."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _extract_refs(tree: Any):
    """Replace every ObjectRef in `tree` with a _Slot; return (tree, refs)."""
    refs: List[ObjectRef] = []

    def walk(x):
        if isinstance(x, ObjectRef):
            refs.append(x)
            return _Slot(len(refs) - 1)
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree), refs


def _fill_slots(tree: Any, vals: Sequence[Any]):
    def walk(x):
        if isinstance(x, _Slot):
            return vals[x.i]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree)


@ray_tpu_torch.remote
def _exec_graph_task(fn, tree, *vals):
    return fn(*_fill_slots(tree, vals))


def _key_deps(dsk: Dict[Key, Any], comp: Any, acc: List[Key]) -> None:
    """Collect key references inside a computation (recursion depth is
    bounded by literal nesting, not by graph depth)."""
    if ishashable(comp) and comp in dsk:
        acc.append(comp)
        return
    if istask(comp):
        for a in comp[1:]:
            _key_deps(dsk, a, acc)
    elif isinstance(comp, (list, tuple)):
        for a in comp:
            _key_deps(dsk, a, acc)
    elif isinstance(comp, dict):
        for v in comp.values():
            _key_deps(dsk, v, acc)


def _submit_graph(
    dsk: Dict[Key, Any], targets: Optional[List[Key]] = None
) -> Dict[Key, Any]:
    """Submit each graph node reachable from `targets` (default: all keys)
    exactly once; returns key -> ObjectRef (tasks) or resolved structure
    (literal / alias nodes). Iterative DFS — deep linear chains (thousands
    of sequential nodes, routine for generated graphs) must not hit the
    interpreter recursion limit, and unreachable subgraphs must not burn
    cluster time (dask relies on cull() for this; here it's built in)."""
    produced: Dict[Key, Any] = {}
    on_stack: set = set()

    def build(comp: Any) -> Any:
        # key deps are all in `produced` by post-order; recursion here only
        # descends literal nesting
        if ishashable(comp) and comp in dsk:
            return produced[comp]  # dask rule: keys shadow equal literals
        if istask(comp):
            fn = comp[0]
            args = tuple(build(a) for a in comp[1:])
            tree, refs = _extract_refs(args)
            return _exec_graph_task.remote(fn, tree, *refs)
        if isinstance(comp, (list, tuple)):
            return type(comp)(build(a) for a in comp)
        if isinstance(comp, dict):
            # slightly more permissive than dask (which treats dict
            # literals as opaque): key references in dict VALUES resolve
            return {k: build(v) for k, v in comp.items()}
        return comp

    roots = list(dsk) if targets is None else targets
    stack: List[tuple] = [(k, False) for k in reversed(roots)]
    while stack:
        key, expanded = stack.pop()
        if key in produced:
            continue
        if expanded:
            on_stack.discard(key)
            produced[key] = build(dsk[key])
            continue
        if key in on_stack:
            raise ValueError(f"cycle in graph at key {key!r}")
        on_stack.add(key)
        stack.append((key, True))
        acc: List[Key] = []
        _key_deps(dsk, dsk[key], acc)
        for d in acc:
            if d not in produced:
                stack.append((d, False))
    return produced


def get(
    dsk: Dict[Key, Any],
    keys: Union[Key, Sequence[Key]],
    **_kwargs: Any,
):
    """Execute graph `dsk`; return the value(s) for `keys`.

    `keys` may be a single key or a (possibly nested) list of keys; the
    result mirrors its shape (dask passes e.g. [[k1, k2]] for collections).
    Only nodes reachable from `keys` are submitted (built-in cull).
    """
    targets: List[Key] = []

    def collect(k):
        if isinstance(k, list):
            for x in k:
                collect(x)
        elif ishashable(k) and k in dsk:
            targets.append(k)

    collect(keys if isinstance(keys, list) else [keys])
    produced = _submit_graph(dsk, targets)

    def fetch(v):
        if isinstance(v, ObjectRef):
            return ray_tpu_torch.get(v)
        if isinstance(v, (list, tuple)):
            return type(v)(fetch(x) for x in v)
        if isinstance(v, dict):
            return {k: fetch(x) for k, x in v.items()}
        return v

    def materialize(k):
        if isinstance(k, list):
            return [materialize(x) for x in k]
        if k not in produced:
            raise KeyError(f"key {k!r} not in graph")
        return fetch(produced[k])

    if not isinstance(keys, list):
        return materialize(keys)
    return [materialize(k) for k in keys]


# name used by the reference integration (python/ray/util/dask/__init__.py)
ray_dask_get = get
