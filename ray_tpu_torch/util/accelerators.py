"""Accelerator-type constants and helpers: the port of
ray_tpu/util/accelerators.py.

Reference: python/ray/util/accelerators/ — string constants tasks pass as
`accelerator_type=` plus TPU pod helpers (`ray.util.accelerators.tpu`
get_current_pod_name / get_current_pod_worker_count). The TPU constants
and the pod helpers (read from the TPU runtime's env vars) are the JAX
package's; the NVIDIA constants are Ray's own spelling (``NVIDIA_H100 =
"H100"``), and the current-device probe reads
``torch.cuda.get_device_name(0)`` where the reference reads jax's
device_kind.

Scheduling integration: `accelerator_resource(t)` converts a type
constant into the custom-resource dict understood by
`@ray_tpu_torch.remote(resources=...)` — nodes advertise the matching
resource (e.g. {"H100": 1}) when they are given it, and the scheduler's
masked feasibility does the rest; no special-cased accelerator pathway
exists or is needed.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

# TPU types (the JAX package's; values match the device_kind prefixes jax
# reports)
TPU_V2 = "TPU-v2"
TPU_V3 = "TPU-v3"
TPU_V4 = "TPU-v4"
TPU_V5E = "TPU-v5e"
TPU_V5P = "TPU-v5p"
TPU_V6E = "TPU-v6e"

# NVIDIA types (reference: python/ray/util/accelerators/accelerators.py)
NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_P100 = "P100"
NVIDIA_TESLA_T4 = "T4"
NVIDIA_TESLA_P4 = "P4"
NVIDIA_TESLA_K80 = "K80"
NVIDIA_TESLA_A10G = "A10G"
NVIDIA_L4 = "L4"
NVIDIA_L40S = "L40S"
NVIDIA_A100 = "A100"
NVIDIA_H100 = "H100"
NVIDIA_H200 = "H200"

# the model in a CUDA device name, as Ray reads it: "NVIDIA H100 80GB HBM3"
# -> "H100", "Tesla V100-SXM2-16GB" -> "V100"
_NVIDIA_NAME = re.compile(r"\w+\s+([A-Z0-9]+)")


def current_accelerator_type() -> Optional[str]:
    """Type constant for this process's first card, or None on a host
    without one. Lazy: importing this module never touches CUDA; the call
    starts it (``torch.cuda.get_device_name(0)``)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - no driver / init failure
        return None
    m = _NVIDIA_NAME.match(name or "")
    return m.group(1) if m else (name or None)


def accelerator_resource(accelerator_type: str, n: float = 1.0) -> Dict[str, float]:
    """Resource dict for @remote(resources=...) demanding `n` chips of a
    type; nodes advertise the same key via --resources."""
    return {accelerator_type: float(n)}


# ---------------------------------------------------------------- tpu pods


def get_current_pod_name() -> Optional[str]:
    """The TPU pod-slice name this worker belongs to (reference:
    ray.util.accelerators.tpu.get_current_pod_name; from the TPU runtime's
    env)."""
    return (
        os.environ.get("TPU_NAME")
        or os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",")[0]
        or None
    )


def get_current_pod_worker_count() -> Optional[int]:
    """How many hosts form this pod slice, or None outside a pod."""
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES")
    if hosts:
        return len([h for h in hosts.split(",") if h])
    n = os.environ.get("TPU_NUM_WORKERS")
    return int(n) if n else None


def get_current_pod_worker_id() -> Optional[int]:
    """This host's index within its pod slice, or None outside a pod."""
    wid = os.environ.get("TPU_WORKER_ID")
    return int(wid) if wid is not None and wid != "" else None
