"""Checkpoint: a directory abstraction passed between workers, trainers and
storage.

Reference: python/ray/train/_checkpoint.py (Checkpoint) — a handle to a
directory of files, movable to/from persistent storage, with dict helpers.
Port note: checkpoints of pytrees of arrays are written with
``ray_tpu_torch.train.save_pytree`` (numpy ``.npz`` in the JAX package's
leaf layout + a JSON structure file), so restore works host-side with no
device residency requirement.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional

_DICT_FILE = "_checkpoint_dict.pkl"
_METADATA_FILE = "_metadata.pkl"


class Checkpoint:
    """Handle to a checkpoint directory (reference: ray.train.Checkpoint)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        with open(os.path.join(d, _DICT_FILE), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    # ------------------------------------------------------------------ access
    def to_dict(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _DICT_FILE)
        if not os.path.exists(p):
            raise ValueError(f"checkpoint at {self.path} was not created from_dict")
        with open(p, "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy checkpoint contents into ``path`` (or a fresh temp dir)."""
        dest = path or tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Context manager yielding a local directory with the contents.
        Local checkpoints are yielded in place (no copy), mirroring the
        reference's local-path fast path."""
        yield self.path

    # --------------------------------------------------------------- metadata
    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "wb") as f:
            pickle.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p, "rb") as f:
            return pickle.load(f)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


def persist_checkpoint(ckpt: Checkpoint, dest_dir: str) -> Checkpoint:
    """Upload a (possibly ephemeral) checkpoint to run storage, returning the
    persisted handle (reference: train/_internal/storage.py
    StorageContext.persist_current_checkpoint)."""
    os.makedirs(os.path.dirname(dest_dir) or ".", exist_ok=True)
    if os.path.abspath(ckpt.path) == os.path.abspath(dest_dir):
        return ckpt
    tmp = dest_dir + "." + uuid.uuid4().hex[:8]
    shutil.copytree(ckpt.path, tmp)
    if os.path.isdir(dest_dir):
        shutil.rmtree(dest_dir)
    os.replace(tmp, dest_dir)
    return Checkpoint(dest_dir)
