"""Usage telemetry (local, opt-out).

Reference: python/ray/_private/usage/usage_lib.py — opt-out usage stats
collected at cluster start. This environment has zero egress, so records
land in a local JSONL (<session_dir_root>/usage/usage.jsonl) instead of a
collector endpoint; the write path, schema, and the opt-out knob
(RAY_TPU_usage_stats_enabled=false) are the component.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


def usage_stats_enabled() -> bool:
    # The knob now lives in core/config.py _DEFS (config-key-unknown
    # flagged the old free-floating env read — _system_config overrides
    # silently did nothing). A LIVE environ read stays first so flipping
    # RAY_TPU_usage_stats_enabled mid-process still opts out (GLOBAL_CONFIG
    # snapshots the environment at import).
    env = os.environ.get("RAY_TPU_usage_stats_enabled")
    if env is not None:
        return env.lower() not in ("0", "false", "no", "off")
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    return bool(GLOBAL_CONFIG.usage_stats_enabled)


def _usage_path() -> str:
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    d = os.path.join(GLOBAL_CONFIG.session_dir_root, "usage")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "usage.jsonl")


def record_event(event: str, **fields: Any) -> None:
    """Append one usage record; never raises into the caller."""
    if not usage_stats_enabled():
        return
    try:
        from ray_tpu_torch._version import __version__
    except Exception:  # noqa: BLE001
        __version__ = "unknown"
    rec: Dict[str, Any] = {
        "ts": time.time(),
        "event": event,
        "version": __version__,
        "pid": os.getpid(),
        **fields,
    }
    try:
        with open(_usage_path(), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass
