"""Build and load the scheduler's CUDA kernels (csrc/sched_kernels.cu).

One ``nvcc`` call compiles the source into a shared library with a plain C
interface, loaded with ctypes: the source includes no PyTorch header, so
the build takes seconds instead of the minutes a ``torch.utils.
cpp_extension`` build of PyTorch's headers costs. The library goes into
``build/torch_ext/`` at the root of the checkout (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.

Nothing here runs at import: the build happens on the first CUDA use
(``load()``), so importing the package on a machine without ``nvcc`` or a
card never touches the compiler.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a`` and ``--fmad=false``.
Never ``--use_fast_math``: the kernels must stay bit-identical to the
NumPy reference (IEEE division, no contraction of a product into a sum).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "--fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_lib = None
_lib_flags: tuple = ()
#: wall seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# name -> (argument types, result type); pointers and the stream are c_void_p
_SIGNATURES = {
    "sched_schedule_classes": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P], _I),
    "sched_k1_scratch_words": ([_I], _LL),
    "sched_scatter_rows": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "sched_delta_clip": ([_P, _P, _P, _P, _LL, _P], _I),
    "sched_nonzero_tiles": ([_LL], _I),
    "sched_compact_nonzero": (
        [_P, _LL, _I, _LL, _P, _I, _P, _I, _P, _I, _P, _P, _P], _I),
    "sched_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (torch.utils.cpp_extension.CUDA_HOME is "
        f"{CUDA_HOME!r}); the scheduler's CUDA kernels cannot be built"
    )


def library_path(extra_flags: tuple = ()) -> Path:
    flags = " ".join(NVCC_FLAGS + tuple(extra_flags))
    h = hashlib.sha256(_SRC.read_bytes() + flags.encode())
    return BUILD_DIR / f"libray_tpu_torch_sched_{h.hexdigest()[:16]}.so"


def load(extra_flags: tuple = None):
    """Build (if needed) and load the kernel library; raise on any failure.
    A process loads one library: the first call that passes `extra_flags`
    (e.g. ``("-DSCHED_K1_PROFILE",)`` for the K1 phase profile) picks its
    variant, and calls without flags use whatever is loaded."""
    global _lib, _lib_flags, build_seconds
    with _lock:
        if _lib is not None:
            if extra_flags is not None and tuple(extra_flags) != _lib_flags:
                raise RuntimeError(
                    f"kernel library already loaded with flags {_lib_flags}"
                )
            return _lib
        extra_flags = tuple(extra_flags or ())
        out = library_path(extra_flags)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            t0 = time.perf_counter()
            cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    "nvcc failed building the scheduler kernels:\n"
                    + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
                )
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib, _lib_flags = lib, extra_flags
        return _lib
