"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C entry points and may include the
shared ``csrc/*.cuh`` headers.  ``nvcc`` compiles it for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so``, keyed by the hash of the
source, the headers and the flags, at first use; the library is loaded
with ``ctypes``.  Nothing here runs at import time: this module is
imported on hosts without ``nvcc`` or a GPU, where only the kernels'
plain PyTorch versions run.

A build failure raises; there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the log
]

_lock = threading.Lock()
# name -> ptxas/nvcc output of the build made by this process
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin,
    then PATH.  Raises when none exists."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


def lib_path(name: str) -> Path:
    # the shared headers are part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel source that has no library yet, one
    ``nvcc`` process per source, all started together; returns
    name -> library path.  Raises RuntimeError naming each failure."""
    names = list(names)
    with _lock:
        out = {n: lib_path(n) for n in names}
        todo = [n for n in names if not out[n].exists()]
        if not todo:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = []
        for n in todo:
            tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        errors: List[str] = []
        for n, tmp, p in procs:
            log, _ = p.communicate()
            build_logs[n] = log
            if p.returncode != 0:
                errors.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
                continue
            os.replace(tmp, out[n])  # atomic: a reader never sees half a .so
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        return out


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` rises by one for every successful launch through
    :meth:`launch` and nowhere else, so a caller can show that a code
    path really went through the kernel."""

    def __init__(self, source: str, entry: str, argtypes: list):
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._load_lock = threading.Lock()

    def _bind(self):
        fn = self._fn
        if fn is not None:
            return fn
        with self._load_lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build([self.source])[self.source]))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; it enqueues the kernel on the given
        stream and returns ``cudaGetLastError()``.  Raises on non-zero."""
        rc = self._bind()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.source}.{self.entry}: CUDA launch failed (error {rc})"
            )
        self.launches += 1
