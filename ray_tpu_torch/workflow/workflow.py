"""Workflows-lite: durable DAG execution on top of the task layer.

Reference structure being matched (not translated):
- python/ray/workflow/workflow_executor.py — walk the DAG, submit steps as
  tasks, feed results forward;
- python/ray/workflow/workflow_storage.py — persist the DAG spec at start
  and each step's result on completion, so `resume(workflow_id)` after a
  driver crash re-runs ONLY steps with no stored result.

Deterministic step ids: a step's id is the hash of its function's qualified
name, its concrete args, and its parents' ids — so the same DAG produces the
same ids across processes and `resume` can match stored results to steps.

Storage is a filesystem directory (default <session_dir_root>/workflows):
    <root>/<workflow_id>/dag.pkl          the pickled step graph
    <root>/<workflow_id>/results/<sid>    one pickle per finished step
    <root>/<workflow_id>/status           RUNNING | FINISHED | FAILED
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization


def _default_root() -> str:
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    return os.path.join(GLOBAL_CONFIG.session_dir_root, "workflows")


@dataclass
class Step:
    """One node of a workflow DAG; args may themselves be Steps."""

    func: Any
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    options: Dict[str, Any] = field(default_factory=dict)

    @property
    def step_id(self) -> str:
        # Memoized (diamond DAGs would otherwise recompute ancestor hashes
        # exponentially) and value-based: plain args hash by their PICKLED
        # bytes, never repr() — a repr with a memory address would change
        # across processes and break resume's result matching, and truncated
        # array reprs could collide two different steps onto one result.
        cached = self.__dict__.get("_sid")
        if cached is not None:
            return cached

        def _aid(v):
            if isinstance(v, Step):
                return ("s", v.step_id)
            return ("v", hashlib.sha1(serialization.dumps(v)).hexdigest())

        payload = serialization.dumps((
            getattr(self.func, "__module__", ""),
            getattr(self.func, "__qualname__", repr(self.func)),
            tuple(_aid(a) for a in self.args),
            tuple(sorted((k, _aid(v)) for k, v in self.kwargs.items())),
        ))
        sid = hashlib.sha1(payload).hexdigest()[:20]
        self.__dict__["_sid"] = sid
        return sid

    def parents(self) -> List["Step"]:
        out = [a for a in self.args if isinstance(a, Step)]
        out.extend(v for v in self.kwargs.values() if isinstance(v, Step))
        return out


def step(func, **options):
    """Wrap a plain function (NOT a RemoteFunction — the workflow layer owns
    submission) as a step factory: step(f)(x, y) builds a DAG node."""

    def bind(*args, **kwargs):
        return Step(func=func, args=args, kwargs=kwargs, options=options)

    return bind


class _Storage:
    def __init__(self, root: str, workflow_id: str):
        self.dir = os.path.join(root, workflow_id)
        self.results_dir = os.path.join(self.dir, "results")
        os.makedirs(self.results_dir, exist_ok=True)

    def save_dag(self, entry: Step) -> None:
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(serialization.dumps(entry))

    def load_dag(self) -> Step:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return serialization.loads(f.read())

    def set_status(self, status: str) -> None:
        with open(os.path.join(self.dir, "status"), "w") as f:
            f.write(status)

    def status(self) -> Optional[str]:
        try:
            with open(os.path.join(self.dir, "status")) as f:
                return f.read().strip()
        except OSError:
            return None

    def has_result(self, step_id: str) -> bool:
        return os.path.exists(os.path.join(self.results_dir, step_id))

    def load_result(self, step_id: str) -> Any:
        with open(os.path.join(self.results_dir, step_id), "rb") as f:
            return pickle.loads(f.read())

    def save_result(self, step_id: str, value: Any) -> None:
        path = os.path.join(self.results_dir, step_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(pickle.dumps(value))
        os.replace(tmp, path)  # atomic: a crash never leaves a torn result


def _topo_order(entry: Step) -> List[Step]:
    order: List[Step] = []
    seen: set = set()

    def visit(s: Step):
        if s.step_id in seen:
            return
        seen.add(s.step_id)
        for p in s.parents():
            visit(p)
        order.append(s)

    visit(entry)
    return order


def _execute(entry: Step, storage: _Storage) -> Any:
    """Run the DAG bottom-up, skipping steps with stored results (the
    resume semantics: only missing steps re-run)."""
    import ray_tpu_torch

    storage.set_status("RUNNING")
    values: Dict[str, Any] = {}
    try:
        for s in _topo_order(entry):
            sid = s.step_id
            if storage.has_result(sid):
                values[sid] = storage.load_result(sid)
                continue
            args = [
                values[a.step_id] if isinstance(a, Step) else a
                for a in s.args
            ]
            kwargs = {
                k: values[v.step_id] if isinstance(v, Step) else v
                for k, v in s.kwargs.items()
            }
            remote_fn = ray_tpu_torch.remote(**s.options)(s.func) if s.options \
                else ray_tpu_torch.remote(s.func)
            value = ray_tpu_torch.get(remote_fn.remote(*args, **kwargs))
            storage.save_result(sid, value)
            values[sid] = value
    except BaseException:
        storage.set_status("FAILED")
        raise
    storage.set_status("FINISHED")
    return values[entry.step_id]


def run(entry: Step, workflow_id: str, storage_root: Optional[str] = None) -> Any:
    """Execute a workflow durably; each finished step's result is persisted
    before the next starts, and the DAG itself is stored first so a dead
    driver's workflow can be resumed by id alone."""
    storage = _Storage(storage_root or _default_root(), workflow_id)
    storage.save_dag(entry)
    return _execute(entry, storage)


def resume(workflow_id: str, storage_root: Optional[str] = None) -> Any:
    """Re-run a stored workflow: steps with persisted results are fed
    forward from storage; only the missing ones execute."""
    storage = _Storage(storage_root or _default_root(), workflow_id)
    entry = storage.load_dag()
    return _execute(entry, storage)


def list_all(storage_root: Optional[str] = None) -> List[dict]:
    root = storage_root or _default_root()
    out = []
    try:
        ids = sorted(os.listdir(root))
    except OSError:
        return out
    for wid in ids:
        if not os.path.isdir(os.path.join(root, wid)):
            continue
        st = _Storage(root, wid)
        out.append({
            "workflow_id": wid,
            "status": st.status(),
            "steps_done": len(os.listdir(st.results_dir)),
        })
    return out
