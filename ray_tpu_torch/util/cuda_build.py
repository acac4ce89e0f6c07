"""Build and load the port's hand-written CUDA sources, one library each.

Each source under a ``csrc/`` directory of the package is compiled by one
``nvcc`` call into a shared library with a plain C interface and loaded with
ctypes: the sources include no PyTorch header, so a build takes seconds
instead of the minutes a ``torch.utils.cpp_extension`` build of PyTorch's
headers costs. Libraries go into ``build/torch_ext/`` at the root of the
checkout (listed in .gitignore), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.

Nothing here runs at import: a library is built on its first CUDA use
(``CudaLibrary.load()``), so importing the package on a machine without
``nvcc`` or a card never touches the compiler. ``build_all`` starts one
``nvcc`` per library that is not built yet, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
BASE_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (torch.utils.cpp_extension.CUDA_HOME is "
        f"{CUDA_HOME!r}); the port's CUDA kernels cannot be built"
    )


class CudaLibrary:
    """One CUDA source, its nvcc flags and its C symbol table
    (name -> (argument types, result type); pointers and the stream are
    ``c_void_p``). A process loads one variant of each library: the first
    ``load`` that passes `extra_flags` picks it, and later calls without
    flags use whatever is loaded."""

    def __init__(self, name: str, src: Path, flags: Tuple[str, ...],
                 signatures: Dict[str, tuple]):
        self.name = name
        self.src = Path(src)
        self.flags = tuple(flags)
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib = None
        self._lib_flags: tuple = ()
        #: wall seconds the last build took (0.0 when it was already built)
        self.build_seconds = 0.0

    def library_path(self, extra_flags: tuple = ()) -> Path:
        flags = " ".join(self.flags + tuple(extra_flags))
        h = hashlib.sha256(self.src.read_bytes() + flags.encode())
        return BUILD_DIR / f"libray_tpu_torch_{self.name}_{h.hexdigest()[:16]}.so"

    def _command(self, out: Path, extra_flags: tuple) -> List[str]:
        return [nvcc(), *self.flags, *extra_flags, "-o", str(out), str(self.src)]

    def _start_build(self, extra_flags: tuple):
        """Start nvcc for this library if it is not built; returns
        (process, temporary output, final output, command, start time) or
        None when the library is already there."""
        out = self.library_path(extra_flags)
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = self._command(tmp, extra_flags)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp, out, cmd, time.perf_counter()

    def _finish_build(self, started) -> None:
        proc, tmp, out, cmd, t0 = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {self.src.name}:\n"
                + " ".join(cmd) + "\n" + stdout + stderr
            )
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0

    def load(self, extra_flags: tuple = None):
        """Build (if needed) and load the library; raise on any failure."""
        with self._lock:
            if self._lib is not None:
                if extra_flags is not None and tuple(extra_flags) != self._lib_flags:
                    raise RuntimeError(
                        f"{self.name} library already loaded with flags {self._lib_flags}"
                    )
                return self._lib
            extra_flags = tuple(extra_flags or ())
            started = self._start_build(extra_flags)
            if started is not None:
                self._finish_build(started)
            lib = ctypes.CDLL(str(self.library_path(extra_flags)))
            for fn_name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib, self._lib_flags = lib, extra_flags
            return self._lib


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build every library not built yet with one nvcc each, all started
    together, then load them all; raise if any build fails."""
    libraries = list(libraries)
    errors = []
    for lib in libraries:
        lib._lock.acquire()
    try:
        started = [(lib, lib._start_build(())) for lib in libraries
                   if lib._lib is None]
        for lib, st in started:
            if st is not None:
                try:
                    lib._finish_build(st)
                except RuntimeError as e:  # wait for every nvcc before raising
                    errors.append(str(e))
    finally:
        for lib in libraries:
            lib._lock.release()
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.load()
