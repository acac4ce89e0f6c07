"""Replay buffer actor for off-policy algorithms.

Reference: rllib/utils/replay_buffers/replay_buffer.py (ReplayBuffer /
the buffer actor the DQN family samples from). A plain class the
Algorithm wraps with @remote, so the buffer lives in its own actor:
every add_batch/sample round trip ships transition arrays through the
object store — sustained producer/consumer load on the data plane, which
is exactly the role the reference's replay actors play in a cluster.

Storage is preallocated numpy rings (O(1) insert, uniform sampling), not
a deque of per-transition dicts — sampling a 128-batch is one fancy-index
gather per field.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._store: Optional[Dict[str, np.ndarray]] = None  # lazy: shapes
        self._next = 0
        self._size = 0
        self._added = 0

    def _ensure(self, batch: Dict[str, np.ndarray]):
        if self._store is not None:
            return
        self._store = {
            k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            for k, v in batch.items()
        }

    def add_batch(self, batch: Dict[str, np.ndarray]) -> int:
        """Ring-insert a batch of transitions; returns the current size."""
        self._ensure(batch)
        n = len(next(iter(batch.values())))
        i = self._next
        for k, v in batch.items():
            end = min(i + n, self.capacity)
            first = end - i
            self._store[k][i:end] = v[:first]
            if first < n:  # wrap
                self._store[k][: n - first] = v[first:]
        self._next = (i + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        self._added += n
        return self._size

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Uniform sample with replacement (reference default)."""
        if self._size == 0:
            raise ValueError("sampling from an empty replay buffer")
        idx = self._rng.integers(0, self._size, int(batch_size))
        return {k: v[idx] for k, v in self._store.items()}

    def size(self) -> int:
        return self._size

    def stats(self) -> Dict[str, int]:
        return {"size": self._size, "added": self._added,
                "capacity": self.capacity}
