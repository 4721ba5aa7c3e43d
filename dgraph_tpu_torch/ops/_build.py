"""Build and bind the port's hand-written native code.

Each ``csrc/<name>.cu`` exports plain C entry points and may include the
shared ``csrc/*.cuh`` headers.  ``nvcc`` compiles it for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so``, keyed by the hash of the
source, the headers and the flags, at first use; the library is loaded
with ``ctypes``.  Host C++ sources (the N-Quad scanner,
``native/nquad_scan.cpp``) are compiled the same way with ``g++``
(:func:`host_lib`).  Nothing here runs at import time: this module is
imported on hosts without ``nvcc`` or a GPU, where only the kernels'
plain PyTorch versions run.  Every build this process makes is counted
(obs/device.py: ``dgraph_xla_compiles_total``, the port's counterpart of
a backend compilation, with its seconds).

Builds take an exclusive file lock on ``_build/.lock`` (parallel test
workers and a server subprocess beside its parent build once, the rest
find the library made; the lock dies with its holder) and move the
finished library into place by an atomic rename.  A build failure
raises; there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
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

GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
# name -> ptxas/nvcc output of the build made by this process
build_logs: Dict[str, str] = {}
# every library this process built, in build order (CUDA and host)
built: List[str] = []


@contextmanager
def _build_lock():
    """Exclusive across this process's threads and across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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
    out = {n: lib_path(n) for n in names}
    if all(p.exists() for p in out.values()):
        return out
    with _build_lock():
        todo = [n for n in names if not out[n].exists()]
        if not todo:
            return out
        exe = nvcc()
        t0 = time.perf_counter()
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
            # a build artefact remade from source on a miss, not durable
            # data: the rename only keeps readers from a half-written .so
            os.replace(tmp, out[n])  # graftlint: ignore[naked-atomic-write]
            _note_build(n, time.perf_counter() - t0)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        return out


def host_lib(src: Path) -> Path:
    """Compile the host C++ source ``src`` (plain C entry points) with
    ``g++`` into ``_build/<stem>-<hash>.so``, keyed by the hash of the
    source and the flags, unless that library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build
    fails."""
    h = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    with _build_lock():
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: cannot build {src.name}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {src.name} (exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        # a build artefact remade from source on a miss, not durable
        # data: the rename only keeps readers from a half-written .so
        os.replace(tmp, out)  # graftlint: ignore[naked-atomic-write]
        _note_build(src.stem, time.perf_counter() - t0)
    return out


def _note_build(name: str, secs: float) -> None:
    from dgraph_tpu_torch.obs import device

    built.append(name)
    device.note_build(secs)


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a CUDA error code (``code``, a
    ``cudaError_t``).  Its own type, so the device guard
    (utils/devguard.py) tells a failed launch from a shape bug's
    ``RuntimeError``: code 2 (``cudaErrorMemoryAllocation``) is an OOM,
    any other code a transient device fault."""

    def __init__(self, where: str, code: int):
        self.code = int(code)
        super().__init__(f"{where}: CUDA launch failed (error {self.code})")


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` rises by one for every successful launch through
    :meth:`launch` and nowhere else, so a caller can show that a code
    path really went through the kernel.  The count is taken under a
    lock: the cohort scheduler's member threads launch concurrently,
    and a bare ``+= 1`` may lose an increment between threads."""

    def __init__(self, source: str, entry: str, argtypes: list):
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._load_lock = threading.Lock()
        self._count_lock = threading.Lock()

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
        stream and returns ``cudaGetLastError()``.  Raises
        :class:`KernelLaunchError` on non-zero."""
        rc = self._bind()(*args)
        if rc != 0:
            raise KernelLaunchError(f"{self.source}.{self.entry}", rc)
        with self._count_lock:
            self.launches += 1
