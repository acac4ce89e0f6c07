"""Execution-runtime seam for the GCS (threads/sockets vs virtual clock).

The GCS head is wired for production as threads + asyncio sockets: an
``RpcServer`` accepts daemon/driver connections, scheduler/health/persist
loops run on their own threads, placement-group 2PC finalizers spawn
worker threads, and wall-clock time stamps heartbeats and leases. All of
that is ambient — which makes the handler protocol impossible to *model
check*: you cannot enumerate interleavings of code whose scheduling the
OS owns.

This module is the seam that makes the ambient parts injectable.
:class:`ThreadRuntime` is the production implementation (byte-for-byte
the behavior the GCS always had); the deterministic explorer
(:mod:`ray_tpu.analysis.explore`) supplies a virtual runtime whose
``now()`` is a step-counted clock, whose "server" records pushes as
schedulable events, whose "daemon clients" dispatch straight into
simulated peers, and whose ``spawn`` turns would-be threads into steps
on a controlled queue. ``GcsServer`` only ever talks to the seam:

==================  ===============================  ======================
call                ThreadRuntime                    virtual runtime
==================  ===============================  ======================
``now()``           ``time.time()``                  virtual clock
``make_server``     ``rpc.RpcServer`` (asyncio TCP)  in-process recorder
``make_daemon_client``  ``rpc.RpcClient`` (TCP)      simulated daemon stub
``spawn``           daemon ``threading.Thread``      enqueue as a step
``kick``            notify the sched loop's cv       enable a sched step
``threaded``        True (start the loops)           False (steps instead)
==================  ===============================  ======================
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer


class ThreadRuntime:
    """Production runtime: real sockets, real threads, wall-clock time."""

    #: GcsServer starts its scheduler/health/persist loops only when the
    #: runtime is threaded; a virtual runtime drives those ticks as steps.
    threaded = True

    def now(self) -> float:
        return time.time()

    def make_server(self, handler: Callable, host: str, port: int,
                    on_disconnect: Callable, name: str) -> RpcServer:
        return RpcServer(
            handler, host=host, port=port,
            on_disconnect=on_disconnect, name=name,
        )

    def make_daemon_client(self, addr: str, port: int,
                           node_id: str) -> Optional[RpcClient]:
        """GCS-initiated request/response client to a node daemon (2PC
        prepare/commit, stream acks). None when the daemon is unreachable."""
        try:
            return RpcClient(addr, port, name="gcs", peer=node_id)
        except OSError:
            return None

    def spawn(self, name: str, fn: Callable) -> None:
        """Run ``fn`` concurrently (PG 2PC finalizers). The virtual
        runtime makes this a schedulable step instead."""
        threading.Thread(target=fn, daemon=True, name=name).start()

    def kick(self, gcs) -> None:
        """Wake the scheduler loop (virtual: enable a sched-round step)."""
        with gcs._sched_cv:
            gcs._sched_cv.notify()
