"""Lazy DAG construction API: ``fn.bind(...)`` / ``actor.method.bind(...)``.

Reference: ray.dag (python/ray/dag/) — ``.bind`` builds a lazy graph of
``DAGNode``s instead of submitting; ``.execute(input)`` eager-interprets
the graph through the normal task layer (so the API is useful before
compilation), and ``.experimental_compile()`` — here plain
:meth:`DAGNode.compile` — turns it into a pinned-worker pipeline with
preallocated channels (see :mod:`ray_tpu_torch.dag.compiled`).

The graph is a plain DAG of nodes; only *top-level* positional/keyword
arguments participate as edges (a node nested inside a list/dict argument
is not discovered — same contract as the reference's bind)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base of all lazy nodes. Subclasses fill ``_bound_args``/``_bound_kwargs``
    whose DAGNode entries are the graph's edges."""

    def __init__(self, args: Tuple = (), kwargs: Optional[Dict] = None):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs or {})

    # ------------------------------------------------------------- structure

    def _upstream(self) -> List["DAGNode"]:
        return [
            a for a in list(self._bound_args) + list(self._bound_kwargs.values())
            if isinstance(a, DAGNode)
        ]

    def _walk(self, seen: Optional[dict] = None) -> List["DAGNode"]:
        """Post-order (topological) traversal of this node's ancestry,
        deduped; cycle-safe because bind can only reference existing
        nodes (the graph is constructed acyclic)."""
        if seen is None:
            seen = {}
        for up in self._upstream():
            if id(up) not in seen:
                up._walk(seen)
        if id(self) not in seen:
            seen[id(self)] = self
        return list(seen.values())

    # ------------------------------------------------------------- execution

    def execute(self, *input_args):
        """Eager interpretation via the existing task layer: every
        FunctionNode becomes a ``.remote()`` call (its DAGNode args resolve
        to the upstream calls' ObjectRefs), actor-method nodes call through
        their handle. Returns the final node's ObjectRef(s) — ``get()``
        them like any task output."""
        memo: Dict[int, Any] = {}
        for node in self._walk():
            memo[id(node)] = node._eager(memo, input_args)
        return memo[id(self)]

    def _eager(self, memo: Dict[int, Any], input_args: Tuple):
        raise NotImplementedError

    def _resolve_args(self, memo: Dict[int, Any]) -> Tuple[Tuple, Dict]:
        args = tuple(
            memo[id(a)] if isinstance(a, DAGNode) else a
            for a in self._bound_args
        )
        kwargs = {
            k: memo[id(v)] if isinstance(v, DAGNode) else v
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    def compile(self, **options) -> "Any":
        """Compile this (output) node's graph into a pinned-worker pipeline
        with preallocated channels; see :class:`ray_tpu_torch.dag.CompiledDAG`."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **options)


class InputNode(DAGNode):
    """Placeholder for the driver's per-iteration input. Usable as a plain
    constructor or a context manager (``with InputNode() as inp:``) for
    parity with the reference API."""

    def __init__(self):
        super().__init__()

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def _eager(self, memo, input_args):
        if not input_args:
            raise TypeError("this DAG takes an input; call execute(value)")
        return input_args[0] if len(input_args) == 1 else input_args


class FunctionNode(DAGNode):
    """``remote_fn.bind(*args, **kwargs)`` — one stage running a plain
    remote function; its @remote options (resources etc.) ride along and
    drive compiled placement."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    @property
    def name(self) -> str:
        return getattr(self._remote_fn, "__name__", "stage")

    def _eager(self, memo, input_args):
        args, kwargs = self._resolve_args(memo)
        return self._remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """``actor.method.bind(...)`` — a stage executed by a live actor's
    method; compiled placement pins the stage to the worker already
    hosting the actor (actors stay where they live)."""

    def __init__(self, handle, method_name: str, args: Tuple, kwargs: Dict):
        super().__init__(args, kwargs)
        self._handle = handle
        self._method_name = method_name

    @property
    def name(self) -> str:
        return self._method_name

    @property
    def actor_id(self) -> str:
        return self._handle._actor_id

    def _eager(self, memo, input_args):
        args, kwargs = self._resolve_args(memo)
        return getattr(self._handle, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal fan-in: ``MultiOutputNode([a, b])`` makes execute/compile
    return one value per listed node."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs))
        if not outputs:
            raise ValueError("MultiOutputNode needs at least one output")
        for o in outputs:
            if not isinstance(o, DAGNode):
                raise TypeError(f"MultiOutputNode outputs must be DAGNodes, got {type(o)}")

    def _eager(self, memo, input_args):
        return [memo[id(a)] for a in self._bound_args]
