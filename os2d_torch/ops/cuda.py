"""Build and bind the port's hand-written CUDA kernels.

Each source in `os2d_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into its own shared library with a plain C interface, under
`build/os2d_torch/` at the root of the checkout, and bound with `ctypes`.
The library's file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built when a module is
imported: the first launch (or `build_all`) builds. Building and loading
hold one lock of the module, so threads that launch a kernel for the first
time at once (a server's request threads) build and load each library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "os2d_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# held while nvcc writes a library and while a kernel loads one; reentrant,
# since a kernel's first launch builds through build_all
_BUILD_LOCK = threading.RLock()


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "os2d_torch are built from source at first use")


def library_path(source: str) -> Path:
    # the headers in csrc/ count too: an edit of the shared skeleton rebuilds
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / source, *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes
    started together, and wait for each. Returns {source: compiler output}
    (ptxas register and shared-memory report). Raises on any failure."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for source in sources:
            target = library_path(source)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            procs[source] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, target)
        logs, failed = {}, []
        for source, (proc, tmp, target) in procs.items():
            logs[source] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{source} (exit {proc.returncode}):\n{logs[source]}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


class CudaKernel:
    """One C entry point of one CUDA source, loaded at first launch.

    `launches` counts the launches this object made, from any thread; a
    caller may reset and read it to show which kernels a run went through."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib = None
        self._fn = None

    def _function(self):
        if self._fn is None:
            with _BUILD_LOCK:
                if self._fn is None:
                    build_all([self.source])
                    lib = ctypes.CDLL(str(library_path(self.source)))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    lib.os2d_cuda_error_string.argtypes = [ctypes.c_int]
                    lib.os2d_cuda_error_string.restype = ctypes.c_char_p
                    self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise if it reports a CUDA error."""
        code = self._function()(*args)
        if code != 0:
            message = self._lib.os2d_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({message})")
        with self._count_lock:
            self.launches += 1
