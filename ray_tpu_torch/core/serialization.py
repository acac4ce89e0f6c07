"""Serialization: cloudpickle for closures, out-of-band buffers for arrays.

Reference: python/ray/_private/serialization.py (cloudpickle + pickle5
buffer_callback for zero-copy numpy through plasma). Same structure: pickle
protocol 5 with out-of-band buffer extraction so large numpy/jax host arrays
are carried as raw bytes (and later, placed in the shm store without a copy).
"""

from __future__ import annotations

import io
import pickle
from typing import Any, List, Tuple

try:  # cloudpickle ships inside `torch`-less envs too; fall back to pickle
    import cloudpickle
except ImportError:  # pragma: no cover
    cloudpickle = None


def dumps_oob(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize with out-of-band buffers (protocol 5)."""
    buffers: List[pickle.PickleBuffer] = []
    if cloudpickle is not None:
        data = cloudpickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    else:
        data = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    return data, buffers


def loads_oob(data: bytes, buffers) -> Any:
    return pickle.loads(data, buffers=buffers)


def dumps(obj: Any) -> bytes:
    """Single-buffer serialize (buffers folded in-band)."""
    if cloudpickle is not None:
        return cloudpickle.dumps(obj)
    return pickle.dumps(obj)


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def pack(obj: Any) -> bytes:
    """Frame out-of-band buffers into one contiguous payload:
    [u32 npick][pickle][u32 nbuf][(u64 len, bytes)...] — the layout the shm
    object store stores verbatim, so numpy buffers deserialize as views."""
    data, buffers = dumps_oob(obj)
    out = io.BytesIO()
    out.write(len(data).to_bytes(8, "little"))
    out.write(data)
    out.write(len(buffers).to_bytes(4, "little"))
    for b in buffers:
        raw = b.raw()
        out.write(raw.nbytes.to_bytes(8, "little"))
        out.write(raw)
    return out.getvalue()


def unpack(payload) -> Any:
    """Inverse of pack(); accepts bytes or memoryview (zero-copy for arrays)."""
    mv = memoryview(payload)
    npick = int.from_bytes(mv[:8], "little")
    data = mv[8 : 8 + npick]
    off = 8 + npick
    nbuf = int.from_bytes(mv[off : off + 4], "little")
    off += 4
    buffers = []
    for _ in range(nbuf):
        ln = int.from_bytes(mv[off : off + 8], "little")
        off += 8
        buffers.append(mv[off : off + ln])
        off += ln
    return loads_oob(bytes(data), buffers)
