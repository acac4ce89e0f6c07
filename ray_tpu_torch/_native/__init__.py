"""Native (C++) components of ray_tpu_torch: the host data plane.

The reference implements its data plane and runtime in C++
(src/ray/object_manager/plasma/, src/ray/raylet/). The sources here are
host code, compiled on first use with the system ``g++`` (no pip deps),
and are no CUDA kernel. They are built by ``ray_tpu_torch.util.cuda_build``
as the CUDA sources are: into ``build/torch_ext/`` at the root of the
checkout (listed in .gitignore), named by a hash of the source and the
flags, and published by an atomic rename, because a node daemon and its
worker processes can reach first use at the same moment.
"""

from __future__ import annotations

from pathlib import Path

from ray_tpu_torch.util.cuda_build import BUILD_DIR, CudaLibrary, gxx  # noqa: F401

_HERE = Path(__file__).resolve().parent
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LINK = ("-lpthread", "-lrt")
#: the shared-memory object store (object_store.cc); its symbols are typed
#: by object_store/store.py
OBJECT_STORE = CudaLibrary("object_store", _HERE / "object_store.cc", FLAGS, {},
                           compiler=gxx, link=LINK)
_LIBRARIES = {OBJECT_STORE.name: OBJECT_STORE}


def library_path(name: str) -> Path:
    """Where `<name>.cc`'s library is built."""
    return _LIBRARIES[name].library_path()


def load_library(name: str):
    """Compile (if not built yet) and dlopen `<name>.cc` from this
    directory."""
    return _LIBRARIES[name].load()
