"""Compiled execution graphs: pin stages to workers, preallocate channels.

Reference: Ray Compiled Graphs (python/ray/dag/compiled_dag_node.py) — the
answer to NormalTaskSubmitter's per-call control-plane cost for *static*
repeated graphs: compile once (topo-sort, place each node on a worker,
allocate one mutable channel per edge, ship every worker a static exec
loop), then drive iterations with ZERO per-call GCS traffic. The driver's
``execute(x)`` is: write the input channel(s), read the output channel(s).

Division of labor:

- this module (driver side): topology extraction, one ``dag_register``
  RPC to the GCS (stage→node packing reuses ``sched/policy.py`` — the same
  batched kernel the task scheduler runs; actor-bound stages stay on the
  node already hosting their actor), one ``dag_start_stage`` RPC per stage
  to the owning daemon, then the channel-only hot loop and ``teardown()``;
- :mod:`ray_tpu_torch.dag.channel`: the seqlock shm channels (layout documented
  there);
- ``cluster/worker.py``: the pinned per-stage exec loop;
- ``cluster/node_daemon.py`` / ``cluster/gcs.py``: the ``rpc_dag_*``
  control plane (start/teardown/death propagation) and the cross-node
  fallback path (``dag_push``/``dag_pull`` frame relay).

Failure contract: a pinned worker (or its node) dying mid-iteration flags
every local channel of the DAG CLOSED|ERROR and reports up to the GCS,
which pushes ``dag_update`` to the owner — the driver's next (or parked)
``execute`` raises :class:`ChannelClosedError` instead of hanging.
``teardown()`` is idempotent and releases all channels and worker pins.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.task_spec import new_id
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.dag.api import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)


# TEST-ONLY regression switchboard (same protocol as gcs.SEEDED_BUGS):
# names added here re-introduce known, FIXED driver-side bugs so the
# waitgraph sanitizer's seeded-probe harness can prove it still catches
# them. Empty in production; never consulted on a hot path beyond a
# set-membership test inside the affected method.
SEEDED_BUGS: set = set()


@dataclass
class _EdgeArg:
    """Placeholder inside a stage's pickled arg template: 'substitute the
    value read from in-channel #index this iteration'."""

    index: int


def _addr_is_local(addr: str) -> bool:
    if addr in ("127.0.0.1", "::1", "localhost", "0.0.0.0"):
        return True
    try:
        return addr in socket.gethostbyname_ex(socket.gethostname())[2]
    except OSError:
        return False


class _RemoteEdgeWriter:
    """Driver/worker end of a cross-node edge: frames ride the daemon
    transfer path (``rpc_dag_push`` deposits into the channel the reader's
    daemon owns) instead of a same-host mapping."""

    def __init__(self, daemon, key: str):
        self._daemon = daemon
        self.key = key

    def write(self, payload: bytes, timeout: Optional[float] = 60.0,
              should_stop=None) -> None:
        from ray_tpu_torch.cluster.rpc import RpcTimeout

        try:
            r = self._daemon.call("dag_push", {
                "key": self.key, "payload": payload,
                "close": False, "error": False,
            }, timeout=timeout or 120.0)
        except RpcTimeout as e:
            # surface transport timeouts under the CHANNEL hierarchy so
            # callers' rewind/poison handling covers remote edges too
            raise ChannelTimeoutError(
                f"remote deposit on {self.key} timed out: {e}"
            ) from e
        except Exception as e:  # noqa: BLE001 - daemon gone / conn reset
            raise ChannelClosedError(
                f"channel {self.key}: remote deposit failed ({e!r})"
            ) from e
        if not (r or {}).get("ok"):
            raise ChannelClosedError(
                f"channel {self.key}: remote deposit refused "
                f"({(r or {}).get('error')})"
            )

    def close(self, error: bool = False) -> None:
        try:
            self._daemon.call("dag_push", {
                "key": self.key, "payload": None,
                "close": True, "error": error,
            }, timeout=10.0)
        except Exception:  # noqa: BLE001 - peer daemon already gone
            pass

    def detach(self) -> None:
        pass


class _RemoteEdgeReader:
    """Driver end of an output edge whose channel lives on a remote node:
    frames are pulled through the daemon (which attaches the channel
    locally and consumes on the driver's behalf)."""

    def __init__(self, daemon, key: str):
        self._daemon = daemon
        self.key = key

    def read(self, timeout: Optional[float] = 60.0, should_stop=None):
        from ray_tpu_torch.cluster.rpc import RpcTimeout

        t = min(timeout or 30.0, 30.0)
        try:
            r = self._daemon.call(
                "dag_pull", {"key": self.key, "timeout": t}, timeout=t + 15.0
            )
        except RpcTimeout as e:
            raise ChannelTimeoutError(
                f"remote read on {self.key} timed out: {e}"
            ) from e
        except Exception as e:  # noqa: BLE001 - daemon gone / conn reset
            raise ChannelClosedError(
                f"channel {self.key}: remote read failed ({e!r})"
            ) from e
        if (r or {}).get("closed"):
            raise ChannelClosedError(f"channel {self.key} closed at the peer")
        if not (r or {}).get("ok"):
            raise ChannelTimeoutError(f"remote read on {self.key} timed out")
        return r["seq"], r["payload"]

    def close(self, error: bool = False) -> None:
        pass

    def detach(self) -> None:
        pass


class CompiledDAG:
    """A compiled pipeline over pinned workers and preallocated channels.

    ``execute(x)`` returns the output VALUE (the hot loop is synchronous —
    one in-flight iteration per channel frame), unlike the eager
    ``DAGNode.execute`` which returns ObjectRefs; parity tests compare
    ``get(dag.execute(x)) == compiled.execute(x)``.
    """

    def __init__(self, output_node: DAGNode, buffer_bytes: Optional[int] = None,
                 name: Optional[str] = None, _force_remote_io: bool = False):
        from ray_tpu_torch.core import api as _api

        rt = _api._get_runtime()
        if not hasattr(rt, "dag_register"):
            raise RuntimeError(
                "DAGNode.compile() needs cluster mode "
                "(init(address=...) or init(cluster=True)); local mode "
                "runs the same graph eagerly via .execute()"
            )
        self._rt = rt
        self.dag_id = new_id("dag")
        self.name = name or "dag"
        self._capacity = int(
            buffer_bytes or rt.config.dag_channel_buffer_bytes
        )
        self._force_remote = _force_remote_io
        self._seq = 0
        self._poisoned: Optional[str] = None  # set on partial input commit
        self._torn_down = False
        # lifecycle lock: `__del__`-driven teardown (gc on an arbitrary
        # thread) can race an explicit teardown() — the torn-down flag's
        # check-and-set must be atomic or both sides release channels
        self._life_lock = threading.Lock()
        self._inputs: List[Any] = []   # writer ends, driver side
        self._outputs: List[Any] = []  # reader ends, driver side
        self._trace_spans = False
        self._build(output_node)
        self._deploy()

    # ------------------------------------------------------------- topology

    def _build(self, output_node: DAGNode) -> None:
        nodes = output_node._walk()
        self._input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if len(self._input_nodes) > 1:
            raise ValueError("a DAG may bind at most one InputNode")
        if isinstance(output_node, MultiOutputNode):
            out_members = list(output_node._bound_args)
        else:
            out_members = [output_node]
        for m in out_members:
            if not isinstance(m, (FunctionNode, ClassMethodNode)):
                raise ValueError(
                    "compile() output(s) must be function/actor-method "
                    f"stages, got {type(m).__name__}"
                )
        self._multi_output = isinstance(output_node, MultiOutputNode)
        self._stages = [
            n for n in nodes
            if isinstance(n, (FunctionNode, ClassMethodNode))
        ]
        if not self._stages:
            raise ValueError("DAG has no function/actor-method stages")
        self._stage_idx = {id(n): i for i, n in enumerate(self._stages)}
        # edges: {"idx", "src": "input"|stage, "dst": stage|"driver"}
        self._edges: List[dict] = []

        def _edge(src, dst) -> int:
            for e in self._edges:
                if e["src"] == src and e["dst"] == dst:
                    return e["idx"]
            e = {"idx": len(self._edges), "src": src, "dst": dst}
            self._edges.append(e)
            return e["idx"]

        self._stage_meta: List[dict] = []
        for i, node in enumerate(self._stages):
            in_edges: List[int] = []

            def _placeholder(a, i=i, in_edges=in_edges):
                if isinstance(a, InputNode):
                    eidx = _edge("input", i)
                elif isinstance(a, DAGNode):
                    eidx = _edge(self._stage_idx[id(a)], i)
                else:
                    return a
                if eidx not in in_edges:
                    in_edges.append(eidx)
                return _EdgeArg(in_edges.index(eidx))

            args = tuple(_placeholder(a) for a in node._bound_args)
            kwargs = {k: _placeholder(v)
                      for k, v in node._bound_kwargs.items()}
            self._stage_meta.append({
                "node": node,
                "in_edges": in_edges,
                "args_template": serialization.dumps((args, kwargs)),
            })
        # driver-output edges are NOT deduped: MultiOutputNode([a, a]) is
        # two channels (each SPSC channel tolerates exactly one reader, so
        # sharing one edge between two driver readers would deadlock)
        self._output_edges = []
        for m in out_members:
            e = {"idx": len(self._edges), "src": self._stage_idx[id(m)],
                 "dst": "driver"}
            self._edges.append(e)
            self._output_edges.append(e["idx"])

    # ------------------------------------------------------------ deployment

    def _deploy(self) -> None:
        from ray_tpu_torch.core.api import _resources_from_options
        from ray_tpu_torch.util import tracing as _tracing

        self._trace_spans = _tracing.tracing_enabled()
        stages_payload = []
        for i, meta in enumerate(self._stage_meta):
            node = meta["node"]
            if isinstance(node, ClassMethodNode):
                stages_payload.append({
                    "stage": i, "name": node.name,
                    "actor_id": node.actor_id, "resources": None,
                })
            else:
                res = _resources_from_options(
                    node._remote_fn._options, default_cpus=1.0
                )
                stages_payload.append({
                    "stage": i, "name": node.name,
                    "actor_id": None, "resources": res,
                })
        # actor stages must be ALIVE with a node before packing; creation
        # may still be in flight — retry registration briefly
        deadline = time.monotonic() + 30.0
        while True:
            reply = self._rt.dag_register({
                "dag_id": self.dag_id,
                "stages": stages_payload,
                "owner": self._rt.worker_id,
            })
            if reply.get("ok"):
                break
            if not reply.get("retry") or time.monotonic() > deadline:
                raise RuntimeError(
                    f"dag compile failed: {reply.get('error')}"
                )
            time.sleep(0.1)
        self._placements = {p["stage"]: p for p in reply["placements"]}
        # channel homes: the reader's node for input/stage edges, the
        # writer's node for driver-output edges
        for e in self._edges:
            home = e["dst"] if e["dst"] != "driver" else e["src"]
            p = self._placements[home]
            e["node_id"], e["addr"], e["port"] = \
                p["node_id"], p["addr"], p["port"]
            e["key"] = f"{self.dag_id}-e{e['idx']}"
            e["path"] = f"{p['chan_dir']}/{e['key']}.chan"
            e["driver_local"] = (
                not self._force_remote and _addr_is_local(p["addr"])
                and bool(p.get("chan_dir"))
            )
        started: List[int] = []
        try:
            # driver-input channels first (readers poll for the file):
            # created HERE when same-host, else by the reader's daemon
            for e in self._edges:
                if e["src"] != "input":
                    continue
                if e["driver_local"]:
                    self._inputs.append(
                        Channel.create(e["path"], self._capacity, e["key"])
                    )
                else:
                    self._inputs.append(_RemoteEdgeWriter(
                        self._rt._daemon(e["node_id"], e["addr"], e["port"]),
                        e["key"],
                    ))
            for i, meta in enumerate(self._stage_meta):
                self._start_stage(i, meta)
                started.append(i)
            for eidx in self._output_edges:
                e = self._edges[eidx]
                if e["driver_local"]:
                    self._outputs.append(
                        Channel.open_wait(e["path"], e["key"], timeout=30.0)
                    )
                else:
                    self._outputs.append(_RemoteEdgeReader(
                        self._rt._daemon(e["node_id"], e["addr"], e["port"]),
                        e["key"],
                    ))
        except BaseException:
            self.teardown()
            raise

    def _start_stage(self, i: int, meta: dict) -> None:
        node = meta["node"]
        e_in, e_out = [], []
        own_channels = []
        my_node = self._placements[i]["node_id"]
        for eidx in meta["in_edges"]:
            e = self._edges[eidx]
            e_in.append({"key": e["key"], "path": e["path"]})
            # edges deposited by a non-local writer are owned by this
            # stage's daemon (it holds the writable end for rpc_dag_push)
            if e["src"] == "input":
                if not e["driver_local"]:
                    own_channels.append({"key": e["key"], "path": e["path"]})
            elif self._placements[e["src"]]["node_id"] != my_node:
                own_channels.append({"key": e["key"], "path": e["path"]})
        for e in self._edges:
            if e["src"] != i:
                continue
            if e["dst"] == "driver" or e["node_id"] == my_node:
                e_out.append({"key": e["key"], "path": e["path"],
                              "remote": False})
            else:
                e_out.append({"key": e["key"], "remote": True,
                              "addr": e["addr"], "port": e["port"],
                              "node_id": e["node_id"]})
        spec = {
            "dag_id": self.dag_id,
            "stage": i,
            "name": node.name,
            "actor_id": getattr(node, "actor_id", None)
            if isinstance(node, ClassMethodNode) else None,
            "method_name": node._method_name
            if isinstance(node, ClassMethodNode) else None,
            "func_b": None if isinstance(node, ClassMethodNode)
            else serialization.dumps(node._remote_fn._func),
            "args_template": meta["args_template"],
            "in_edges": e_in,
            "out_edges": e_out,
            "capacity": self._capacity,
        }
        p = self._placements[i]
        daemon = self._rt._daemon(p["node_id"], p["addr"], p["port"])
        r = daemon.call("dag_start_stage", {
            "dag_id": self.dag_id, "stage": i, "spec": spec,
            "actor_id": spec["actor_id"], "own_channels": own_channels,
            "capacity": self._capacity,
        }, timeout=60.0)
        if not (r or {}).get("ok"):
            raise RuntimeError(
                f"dag stage {i} ({node.name}) failed to start on "
                f"{p['node_id']}: {(r or {}).get('error')}"
            )

    # ------------------------------------------------------------- hot loop

    def _broken(self) -> Optional[str]:
        st = self._rt.dag_state(self.dag_id)
        if st.get("state") in ("BROKEN", "DEAD"):
            return st.get("error") or "dag worker died"
        return None

    def execute(self, *input_args, timeout: Optional[float] = None):
        """One iteration: write the input channel(s), read the output
        channel(s); no GCS traffic. Returns the output value (list of
        values for a MultiOutputNode target); raises the stage's exception
        if the iteration failed, ChannelClosedError if the pipeline died."""
        # explicit guard instead of op_span(): this is the hot loop, and
        # the no-profiler path must stay one attribute load
        p = _tracing.PROFILE
        if p is None:
            return self._execute_inner(input_args, timeout)
        frame = p.op_begin("dag_execute")
        try:
            return self._execute_inner(input_args, timeout)
        finally:
            p.op_end(frame)

    def _execute_inner(self, input_args, timeout):
        if self._torn_down:
            raise ChannelClosedError(f"dag {self.dag_id[:12]} is torn down")
        if self._poisoned:
            raise ChannelClosedError(self._poisoned)
        err = self._broken()
        if err:
            raise ChannelClosedError(err)
        timeout = timeout or self._rt.config.dag_execute_timeout_s
        t0 = time.time()
        payload = None
        if self._inputs:
            # validate + serialize BEFORE advancing the iteration counter:
            # a TypeError/pickle failure here must leave the driver's seq
            # aligned with the channel frames
            if not input_args:
                raise TypeError("this DAG takes an input; execute(value)")
            value = input_args[0] if len(input_args) == 1 else input_args
            payload = serialization.pack({"e": False, "v": value})
        self._seq += 1
        results = []
        # throttled liveness probe passed into the channel waits: wakes a
        # parked read when the control plane reports the pipeline broken,
        # without taking the client lock on every poll iteration
        last_probe = [0.0]

        def _broken_probe() -> bool:
            now = time.monotonic()
            if now - last_probe[0] < 0.05:
                return False
            last_probe[0] = now
            return self._broken() is not None

        try:
            written = 0
            try:
                for w in self._inputs:
                    w.write(payload, timeout=timeout,
                            should_stop=_broken_probe)
                    written += 1
            except Exception:
                if written == 0:
                    # nothing committed: the iteration never started —
                    # rewind so a retry reuses this seq (frames aligned)
                    self._seq -= 1
                else:
                    # some branches got this iteration's frame and some
                    # didn't: the pipeline's branches are now mixing
                    # different iterations — unrecoverable without a flush
                    self._poisoned = (
                        f"dag {self.dag_id[:12]}: input write failed after "
                        f"{written}/{len(self._inputs)} branches committed; "
                        "pipeline desynchronized — teardown() and recompile"
                    )
                raise
            for r in self._outputs:
                deadline = time.monotonic() + timeout
                seq, data = self._read_output(
                    r, deadline, should_stop=_broken_probe
                )
                results.append(serialization.unpack(data))
        except ChannelClosedError:
            # prefer the control plane's cause (worker/node death detail)
            err = self._broken()
            if err:
                raise ChannelClosedError(err) from None
            raise
        if self._trace_spans:
            from ray_tpu_torch.util.tracing import record_span

            record_span(f"dag:{self.name}:execute", t0, time.time(),
                        seq=self._seq, dag_id=self.dag_id)
        for rec in results:
            if rec["e"]:
                v = rec["v"]
                raise v if isinstance(v, BaseException) else \
                    RuntimeError(str(v))
        values = [rec["v"] for rec in results]
        return values if self._multi_output else values[0]

    def _read_output(self, r, deadline, should_stop=None):
        """One output-channel read with the broken-DAG retry loop."""
        if "chan-read-under-lock" in SEEDED_BUGS:
            # SEEDED BUG (test-only; see SEEDED_BUGS above): park the
            # read while HOLDING the lifecycle lock — a concurrent
            # teardown() wedges on _life_lock while this read waits on
            # a channel only the teardown side can unblock (the
            # lock-channel wait cycle the waitgraph sanitizer must
            # catch)
            with self._life_lock:
                return self._read_output_retry(r, deadline, should_stop)
        return self._read_output_retry(r, deadline, should_stop)

    def _read_output_retry(self, r, deadline, should_stop=None):
        while True:
            try:
                seq, data = r.read(  # ray-lint: disable=blocking-wait-under-lock
                    timeout=max(0.05, deadline - time.monotonic()),
                    should_stop=should_stop,
                )
            except ChannelTimeoutError:
                # a remote reader bounds each attempt (~30s) below
                # the full deadline: retry until ours expires
                if time.monotonic() >= deadline:
                    raise
                err = self._broken()
                if err:
                    raise ChannelClosedError(err) from None
                continue
            # frames are seq-stamped: drop stale ones left by an
            # earlier timed-out iteration (the stage still
            # committed its result after the driver gave up)
            # instead of returning iteration N-1's output as N
            if seq >= self._seq:
                return seq, data

    # ------------------------------------------------------------- teardown

    def teardown(self) -> None:
        """Release every channel and worker pin; idempotent (and
        serialized: gc can drive ``__del__``-teardown on an arbitrary
        thread while the owner calls it explicitly)."""
        with self._life_lock:
            if self._torn_down:
                return
            self._torn_down = True
        for ch in self._inputs:
            try:
                ch.close()  # graceful CLOSED: stages drain, then exit
            except Exception:  # noqa: BLE001
                pass
        try:
            self._rt.dag_teardown(self.dag_id)
        except Exception:  # noqa: BLE001 - GCS mid-restart; daemons sweep
            pass
        for ch in self._inputs + self._outputs:
            try:
                ch.detach()
            except Exception:  # noqa: BLE001
                pass

    def __del__(self):  # noqa: D105 - best-effort release
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass
