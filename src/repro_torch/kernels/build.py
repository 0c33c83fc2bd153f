"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``kernels/build/lib<name>.so``, a shared library with a plain C
interface, at its first use in a process when it is missing or older
than a source, or ahead of time through :func:`build_all`, which
rebuilds every library, one ``nvcc`` per source at once. A failed build
raises: there is no fallback to the plain PyTorch versions.

Nothing here runs at import time, so the CPU tests import every module
of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return path


class CudaKernel:
    """One kernel library: its source, its build, its C entry point and
    its launch count.

    ``launches`` is incremented by the Python wrapper each time it calls
    the entry point, and by nothing else, so a caller can reset it,
    drive a path, and read how often the kernel ran.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = CSRC / f"{name}.cu"
        self.library = BUILD_DIR / f"lib{name}.so"
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None
        self._lib = None
        self._error_string = None
        # the serving gateway steps engines in an executor thread while
        # its event loop scores prompts: one build and load per library
        self._load_lock = threading.Lock()

    def _stale(self) -> bool:
        if not self.library.exists():
            return True
        built = self.library.stat().st_mtime
        return any(p.stat().st_mtime > built for p in CSRC.iterdir())

    def _start_build(self):
        """Start ``nvcc`` on the source; returns what _finish_build needs.
        The library is written under a temporary name and renamed when
        complete, so a reader never loads a half-written file."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish_build(self, started) -> None:
        proc, tmp, t0 = started
        log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.library)

    def function(self):
        """The C entry point, building the library first if needed (once,
        whichever thread asks first)."""
        if self._fn is None:
            with self._load_lock:
                if self._fn is None:
                    self._load()
        return self._fn

    def _load(self) -> None:
        if self._stale():
            self._finish_build(self._start_build())
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string, self._lib = err, lib
        self._fn = fn

    def extra(self, name: str, argtypes: Sequence, restype=ctypes.c_int):
        """Another C function of the same library (built as for
        :meth:`function`), such as a query the wrapper needs."""
        self.function()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def check(self, rc: int) -> None:
        """Raise if the entry point returned a CUDA error."""
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


def build_all(kernels: List[CudaKernel]) -> Dict[str, float]:
    """Build every library, up to date or not, in parallel, one ``nvcc``
    per source, then load each, so that each call leaves nvcc's ptxas
    report in every kernel's ``build_log``. Returns the build seconds per
    kernel name."""
    procs = {k.name: k._start_build() for k in kernels}
    errors = []
    for k in kernels:
        try:
            k._finish_build(procs[k.name])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.function()
    return {k.name: k.build_seconds for k in kernels}
