"""Build and load the scheduler's CUDA kernels (csrc/sched_kernels.cu).

The library is built by ``ray_tpu_torch.util.cuda_build`` (one ``nvcc``
call into a plain-C shared library loaded with ctypes, under
``build/torch_ext/``, at first CUDA use). This module names the source, its
flags and its symbols.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a`` and ``--fmad=false``.
Never ``--use_fast_math``: the kernels must stay bit-identical to the
NumPy reference (IEEE division, no contraction of a product into a sum).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ray_tpu_torch.util import cuda_build
from ray_tpu_torch.util.cuda_build import BUILD_DIR, nvcc as _nvcc  # noqa: F401

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_kernels.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ULL = ctypes.c_ulonglong
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
    "sched_schedule_rounds": (
        [_P, _P, _P, _P, _P, _ULL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "sched_error_string": ([_I], ctypes.c_char_p),
}

LIBRARY = cuda_build.CudaLibrary("sched", _SRC, NVCC_FLAGS, _SIGNATURES)


def library_path(extra_flags: tuple = ()) -> Path:
    return LIBRARY.library_path(extra_flags)


def load(extra_flags: tuple = None):
    """Build (if needed) and load the kernel library; raise on any failure.
    A process loads one library: the first call that passes `extra_flags`
    (e.g. ``("-DSCHED_K1_PROFILE",)`` for the K1 phase profile) picks its
    variant, and calls without flags use whatever is loaded."""
    return LIBRARY.load(extra_flags)


def __getattr__(name):
    if name == "build_seconds":  # wall seconds of the last build (0.0: none)
        return LIBRARY.build_seconds
    raise AttributeError(name)
