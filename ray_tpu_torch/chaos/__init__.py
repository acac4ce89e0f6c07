"""ray_tpu.chaos — deterministic fault injection for the control plane.

Reference points: the reference repo proves its fault tolerance with
chaos tests (python/ray/tests/test_chaos.py + the node-killer utilities in
test_utils); this package makes the same class of testing *deterministic*:
a seeded :class:`FaultSchedule` decides, per frame of each RPC stream,
whether to drop/delay/duplicate the frame, reset the connection, enforce a
one-way partition between named endpoints, or kill a registered process at
a step — and records a byte-identical fault trace for a fixed seed.

Activation:

- per-test: ``chaos.install(FaultSchedule(seed=7, rules=[...]))`` /
  ``chaos.uninstall()`` (pair them in try/finally);
- via env: ``RAY_TPU_CHAOS_SPEC='{"seed":7,"rules":[...]}'`` — read once
  at RPC-layer import, so worker subprocesses inherit the same plane.

When nothing is installed the RPC hot path pays exactly one module-global
``is None`` check per frame (``rpc.CHAOS``); no chaos code runs.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ray_tpu_torch.chaos.schedule import (  # noqa: F401 - public API
    HOOKS,
    KINDS,
    FaultSchedule,
    Rule,
    delay,
    drop,
    duplicate,
    kill,
    kill_at,
    partition,
    register_kill,
    reset,
    slow,
    unregister_kill,
)

ENV_SPEC = "RAY_TPU_CHAOS_SPEC"


def install(schedule: FaultSchedule) -> FaultSchedule:
    """Make ``schedule`` the process-wide active fault plane."""
    from ray_tpu_torch.cluster import rpc as _rpc

    _rpc.CHAOS = schedule
    return schedule


def uninstall() -> None:
    """Deactivate injection (the hot-path flag goes back to None)."""
    from ray_tpu_torch.cluster import rpc as _rpc

    _rpc.CHAOS = None


def active() -> Optional[FaultSchedule]:
    from ray_tpu_torch.cluster import rpc as _rpc

    return _rpc.CHAOS


def install_from_env() -> Optional[FaultSchedule]:
    """Install a schedule from the ``RAY_TPU_CHAOS_SPEC`` JSON env var
    (no-op returning None when unset)."""
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return None
    return install(FaultSchedule.from_spec(json.loads(spec)))
