"""Build the hand-written CUDA kernels and bind them with ctypes.

``csrc/lut_kernels.cu`` has a plain C interface, so it compiles in seconds
with ``nvcc`` straight into a shared library (no PyTorch headers) and loads
with ``ctypes``.  The library is built at first use into ``build/repro_torch``
at the repository root, named by a hash of the source and flags, so an
edited source is rebuilt and an unchanged one is reused.  A build failure
raises; nothing falls back to the plain versions.

Each kernel wrapper owns a :class:`LaunchCounter`, incremented where (and
only where) it launches its kernel, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "lut_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """A plain count of one kernel's launches."""

    def __init__(self, name: str):
        """Register a counter under the kernel's ``name``."""
        self.name = name
        self.count = 0

    def add(self) -> None:
        """Count one launch."""
        self.count += 1


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The launch counter of kernel ``name`` (created on first use)."""
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters() -> None:
    """Set every launch count to 0."""
    for c in COUNTERS.values():
        c.count = 0


def launch_counts() -> Dict[str, int]:
    """Current launch count of every kernel."""
    return {name: c.count for name, c in COUNTERS.items()}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME``, /usr/local/cuda, PATH)."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def build() -> Tuple[Path, float, str]:
    """Compile the kernels if needed; returns (library path, build seconds
    (0.0 when reused), the compiler's register/shared-memory report)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"liblut_kernels_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds, proc.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "lut_lookup_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lut_cascade_resident_launch": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _L, _L, _I, _P, _P),
    "lut_cascade_streamed_launch": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P, _P),
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
