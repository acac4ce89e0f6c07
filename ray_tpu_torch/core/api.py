"""Public API: init/get/put/wait + the @remote machinery.

Reference surfaces:
- init/get/put/wait: python/ray/_private/worker.py (init, get, put, wait)
- @remote for functions: python/ray/remote_function.py (RemoteFunction._remote)
- @remote for classes: python/ray/actor.py (ActorClass._remote, ActorHandle)
- option validation: python/ray/_private/ray_option_utils.py
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.config import set_global_config
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import SchedulingStrategy, TaskSpec, new_id

_global_lock = threading.Lock()
_runtime = None

_CLUSTER_TODO = (
    "cluster mode (init(address=...) / init(cluster=True)) is not ported "
    "yet: the GCS, node daemon, RPC and client are the next slice of the "
    "port (ROADMAP.md, queue 1); use local mode (init() with no address)"
)


def init(
    address: Optional[str] = None,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
    cluster: bool = False,
    num_nodes: int = 1,
    resources_per_node: Optional[Dict[str, float]] = None,
    config: Optional[Dict[str, Any]] = None,
    **kwargs,
):
    """Start the runtime.

    address=None -> local mode (one in-process node, reference local Ray),
    the only mode of this slice of the port: address= and cluster=True
    raise NotImplementedError until cluster mode is ported. With
    ``_system_config={"scheduling_policy": "torch_cuda"}`` every
    scheduling round runs on the CUDA kernels (``scheduler_device``,
    default "cuda"; "cpu" runs their plain PyTorch versions).
    """
    global _runtime
    if kwargs:
        # silently swallowing typos/unsupported options sent callers to
        # local mode while they believed a flag took effect
        raise TypeError(f"init() got unexpected arguments: {sorted(kwargs)}")
    if address is not None or cluster:
        raise NotImplementedError(_CLUSTER_TODO)
    with _global_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError("ray_tpu_torch.init() called twice; use shutdown() first")
        if config and _system_config:
            raise TypeError("pass config= or _system_config=, not both")
        config_dict = config or _system_config
        try:
            config = set_global_config(config_dict)
            res = dict(resources or {})
            if num_tpus is not None:
                res["TPU"] = float(num_tpus)
            from ray_tpu_torch.core.runtime import LocalRuntime

            _runtime = LocalRuntime(
                num_cpus=num_cpus, resources=res, config=config
            )
        except BaseException:
            _runtime = None
            raise
        # opt-in tracing (reference: RAY_TRACING_ENABLED installing the
        # span wrappers at init)
        from ray_tpu_torch.util import tracing as _tracing

        if _tracing.tracing_enabled():
            _tracing.enable_task_spans()
        return _runtime


def shutdown():
    global _runtime
    with _global_lock:
        try:
            if _runtime is not None:
                _runtime.shutdown()
        finally:
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def _get_runtime():
    if _runtime is None:
        # Auto-init only from the main thread (reference: implicit ray.init
        # on first use). Background/daemon threads must never resurrect a
        # runtime after shutdown — a stray actor-side thread doing so leaks
        # a whole new runtime between tests/apps.
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "ray_tpu is not initialized (and auto-init is main-thread "
                "only); call ray_tpu.init() first"
            )
        init()
    return _runtime


def _set_runtime_for_worker(rt):
    """Internal: cluster worker processes install their runtime here."""
    global _runtime
    _runtime = rt


# --------------------------------------------------------------------- options

_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "num_returns",
    "max_retries", "max_restarts", "max_concurrency", "name",
    "scheduling_strategy", "memory", "runtime_env", "lifetime",
    # streaming generators: bound on unacked in-flight yielded objects
    # (reference: _raylet.pyx _generator_backpressure_num_objects)
    "_backpressure_num_objects",
}


def _resources_from_options(opts: Dict[str, Any], default_cpus: float) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    res["CPU"] = float(opts.get("num_cpus", default_cpus))
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus"):
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return {k: v for k, v in res.items() if v}


def _strategy_from_options(opts: Dict[str, Any]) -> SchedulingStrategy:
    s = opts.get("scheduling_strategy")
    if s is None or s == "DEFAULT":
        return SchedulingStrategy()
    if s == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if isinstance(s, SchedulingStrategy):
        return s
    # PlacementGroupSchedulingStrategy / NodeAffinitySchedulingStrategy objects
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        NodeLabelSchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(s, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=s.node_id, soft=s.soft)
    if isinstance(s, NodeLabelSchedulingStrategy):
        def _norm(d):
            # accept "value" or ["v1", "v2"] per key
            return {
                k: list(v) if isinstance(v, (list, tuple, set)) else [v]
                for k, v in (d or {}).items()
            }

        return SchedulingStrategy(
            kind="NODE_LABEL",
            labels_hard=_norm(s.hard),
            labels_soft=_norm(s.soft),
        )
    if isinstance(s, PlacementGroupSchedulingStrategy):
        pg = s.placement_group
        pg_id = pg.id if hasattr(pg, "id") else str(pg)
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=pg_id,
            bundle_index=s.placement_group_bundle_index,
        )
    raise ValueError(f"unsupported scheduling_strategy: {s!r}")


def _check_options(opts: Dict[str, Any]):
    bad = set(opts) - _VALID_OPTIONS
    if bad:
        raise ValueError(f"invalid @remote options: {sorted(bad)}")
    # validate eagerly: a typo'd runtime_env key must fail at definition
    # time, never silently no-op (reference: runtime env validation in
    # python/ray/_private/ray_option_utils.py)
    from ray_tpu_torch.core import runtime_env as _rtenv

    _rtenv.validate(opts.get("runtime_env"))


# ------------------------------------------------------------ remote functions

_DAG_TODO = "the DAG layer (.bind) is not ported yet (ROADMAP.md, queue 1)"

class RemoteFunction:
    """Handle produced by @remote on a function (reference:
    python/ray/remote_function.py)."""

    def __init__(self, func, options: Dict[str, Any]):
        _check_options(options)
        self._func = func
        self._options = options
        functools.update_wrapper(self, func)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(opts)
        return RemoteFunction(self._func, merged)

    def remote(self, *args, **kwargs):
        rt = _get_runtime()
        opts = self._options
        nr = opts.get("num_returns", 1)
        # streaming generator returns (reference: _raylet.pyx
        # num_returns="streaming"): the caller gets an ObjectRefGenerator
        # yielding refs as the task produces them; the declared return
        # slot carries the end-of-stream marker (see core/generator.py)
        streaming = nr == "streaming"
        num_returns = 1 if streaming else int(nr)
        max_retries = int(opts.get("max_retries", rt.config.task_max_retries))
        spec = TaskSpec(
            task_id=new_id("task"),
            func=self._func,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=_resources_from_options(opts, default_cpus=1.0),
            max_retries=max_retries,
            retries_left=max_retries,
            strategy=_strategy_from_options(opts),
            owner_id=rt.worker_id,
            name=opts.get("name") or getattr(self._func, "__name__", "task"),
            runtime_env=opts.get("runtime_env"),
            streaming=streaming,
            backpressure=int(opts.get("_backpressure_num_objects", 0)),
        )
        refs = rt.submit_task(spec)
        if streaming:
            from ray_tpu_torch.core.generator import ObjectRefGenerator

            return ObjectRefGenerator(
                spec.task_id, rt.worker_id, ack=spec.backpressure > 0
            )
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: ray.dag — fn.bind); the DAG
        layer is not ported yet."""
        raise NotImplementedError(_DAG_TODO)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Remote functions cannot be called directly; use .remote()."
        )


# --------------------------------------------------------------------- actors

class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, **opts):
        nr = opts.get("num_returns", self._num_returns)
        m = ActorMethod(self._handle, self._method_name,
                        nr if nr == "streaming" else int(nr))
        return m

    def remote(self, *args, **kwargs):
        return self._handle._invoke(
            self._method_name, args, kwargs, self._num_returns
        )

    def bind(self, *args, **kwargs):
        """Lazy DAG construction (reference: ray.dag —
        actor.method.bind); the DAG layer is not ported yet."""
        raise NotImplementedError(_DAG_TODO)


class ActorHandle:
    """Reference to a live actor (reference: python/ray/actor.py ActorHandle).
    Picklable: other tasks can call through it."""

    def __init__(self, actor_id: str, method_meta: Dict[str, int], creation_ref: ObjectRef,
                 name: str = ""):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._creation_ref = creation_ref
        self._name = name

    def _invoke(self, method_name: str, args, kwargs, num_returns):
        rt = _get_runtime()
        streaming = num_returns == "streaming"
        nr = 1 if streaming else int(num_returns)
        spec = TaskSpec(
            task_id=new_id("atask"),
            func=None,
            args=args,
            kwargs=kwargs,
            num_returns=nr,
            resources={},
            max_retries=0,
            retries_left=0,
            actor_id=self._actor_id,
            method_name=method_name,
            owner_id=rt.worker_id,
            name=f"{self._actor_id[:12]}.{method_name}",
            streaming=streaming,
        )
        refs = rt.submit_task(spec)
        if streaming:
            from ray_tpu_torch.core.generator import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt.worker_id)
        return refs[0] if nr == 1 else refs

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_meta:
            raise AttributeError(f"actor has no method {name!r}")
        return ActorMethod(self, name, self._method_meta[name])

    def __reduce__(self):
        return (_rebuild_actor_handle,
                (self._actor_id, self._method_meta, self._creation_ref,
                 self._name))

    def __repr__(self):
        return f"ActorHandle({self._actor_id})"


def _rebuild_actor_handle(actor_id, method_meta, creation_ref, name=""):
    return ActorHandle(actor_id, method_meta, creation_ref, name)


class ActorClass:
    """Produced by @remote on a class (reference: python/ray/actor.py)."""

    def __init__(self, cls, options: Dict[str, Any]):
        _check_options(options)
        self._cls = cls
        self._options = options

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = _get_runtime()
        opts = self._options
        actor_id = new_id("actor")
        # Async actors (reference: python/ray/actor.py — a class with any
        # coroutine method runs its tasks on a per-actor asyncio event
        # loop). Detection happens here so the default concurrency matches
        # upstream: async actors admit many in-flight coroutines unless
        # the user caps them explicitly.
        from ray_tpu_torch.core.async_actor import class_is_async

        default_mc = 1000 if class_is_async(self._cls) else 1
        spec = TaskSpec(
            task_id=new_id("acreate"),
            func=self._cls,
            args=args,
            kwargs=kwargs,
            num_returns=1,
            resources=_resources_from_options(opts, default_cpus=1.0),
            max_retries=0,
            retries_left=0,
            strategy=_strategy_from_options(opts),
            actor_id=actor_id,
            actor_creation=True,
            max_restarts=int(opts.get("max_restarts", 0)),
            max_concurrency=int(opts.get("max_concurrency", default_mc)),
            owner_id=rt.worker_id,
            name=opts.get("name") or f"{self._cls.__name__}.__init__",
            runtime_env=opts.get("runtime_env"),
        )
        refs = rt.submit_task(spec)
        method_meta = {}
        for mname, m in inspect.getmembers(self._cls, inspect.isfunction):
            if not mname.startswith("_"):
                method_meta[mname] = int(getattr(m, "__num_returns__", 1))
        handle = ActorHandle(actor_id, method_meta, refs[0],
                             name=opts.get("name") or "")
        if opts.get("name"):
            # named-actor registry via the internal KV (reference:
            # gcs_actor_manager named actors + ray.get_actor); last
            # registration wins
            import pickle as _pickle

            rt.kv_put(f"named_actor:{opts['name']}", _pickle.dumps(handle))
        return handle

    def __call__(self, *a, **kw):
        raise TypeError("Actor classes cannot be instantiated directly; use .remote().")


def method(*, num_returns: int = 1):
    """Per-method options decorator (reference: ray.method)."""

    def deco(f):
        f.__num_returns__ = num_returns
        return f

    return deco


def remote(*args, **options):
    """@remote / @remote(num_cpus=...) on functions and classes."""
    if len(args) == 1 and callable(args[0]) and not options:
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target, {})
        return RemoteFunction(target, {})
    if args:
        raise TypeError("use @remote or @remote(**options)")

    def deco(target):
        if inspect.isclass(target):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return deco


# ----------------------------------------------------------------- data plane

def put(value: Any) -> ObjectRef:
    return _get_runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    rt = _get_runtime()
    single = isinstance(refs, ObjectRef)
    if not single and not hasattr(refs, "__iter__"):
        raise TypeError(
            f"get() expects an ObjectRef or a list of ObjectRefs, got {type(refs)}"
        )
    lst = [refs] if single else list(refs)
    for r in lst:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    vals = rt.get(lst, timeout=timeout)
    return vals[0] if single else vals


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns={num_returns} exceeds the number of refs ({len(refs)})"
        )
    return _get_runtime().wait(refs, num_returns=num_returns, timeout=timeout)


def cancel(ref: ObjectRef, *, force: bool = False):
    rt = _get_runtime()
    if hasattr(rt, "cancel"):
        rt.cancel(ref, force=force)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    rt = _get_runtime()
    rt.kill_actor(actor._actor_id, no_restart=no_restart)
    # drop the named-actor registration so get_actor stops returning a
    # handle to a dead actor (reference: named actor entry removed on death)
    # — but only if the registry still points at THIS actor (a newer actor
    # may have reused the name; last-registration-wins must survive the kill
    # of its predecessor)
    if getattr(actor, "_name", ""):
        import pickle as _pickle

        key = f"named_actor:{actor._name}"
        try:
            data = rt.kv_get(key)
            if data is not None and _pickle.loads(data)._actor_id == actor._actor_id:
                rt.kv_del(key)
        except Exception:
            pass


# ------------------------------------------------------------------- metadata

class RuntimeContext:
    def __init__(self, rt):
        self._rt = rt

    @property
    def node_id(self):
        return self._rt.node_id

    def get_task_id(self):
        return self._rt.current_task_id()

    def get_actor_id(self):
        return self._rt.current_actor_id()

    def get_node_id(self):
        return self._rt.node_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_get_runtime())


def get_actor(name: str) -> ActorHandle:
    """Look up a live named actor (reference: ray.get_actor)."""
    import pickle as _pickle

    data = _get_runtime().kv_get(f"named_actor:{name}")
    if data is None:
        raise ValueError(f"no actor registered with name {name!r}")
    return _pickle.loads(data)


def nodes() -> List[dict]:
    return _get_runtime().nodes()


def cluster_resources() -> Dict[str, float]:
    return _get_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _get_runtime().available_resources()


def timeline() -> List[dict]:
    """Task-event timeline (reference: `ray timeline` Chrome-trace export)."""
    return _get_runtime().timeline()
