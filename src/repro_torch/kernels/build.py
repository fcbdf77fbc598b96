"""Build the hand-written CUDA kernels and bind them with ctypes.

Each source under ``csrc/`` (``lut_kernels.cu``: K1-K3, ``subnet_mlp.cu``:
K4's routes and its reference kernel, ``flash_attention.cu`` and
``flash_attention_wgmma.cu``: the two K5 kernels) has a plain C interface,
so it compiles in seconds with ``nvcc`` straight into its own shared
library (no PyTorch headers) and loads with ``ctypes``.
The libraries are built at first use into ``build/repro_torch`` at the
repository root, each named by a hash of its source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Missing libraries
are compiled together, one ``nvcc`` per source started at once.  A build
failure raises; nothing falls back to the plain versions.

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
SOURCES = {"lut_kernels": CSRC / "lut_kernels.cu",
           "subnet_mlp": CSRC / "subnet_mlp.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_wgmma": CSRC / "flash_attention_wgmma.cu"}
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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build() -> Dict[str, Tuple[Path, float, str]]:
    """Compile every source whose library is missing, all at once; returns
    ``{name: (library path, build seconds (0.0 when reused), the compiler's
    register/shared-memory report)}``."""
    out: Dict[str, Tuple[Path, float, str]] = {}
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        lib = _lib_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (lib, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) on "
                          f"{SOURCES[name]}:\n{stdout}\n{stderr}")
            continue
        lib.with_suffix(".log").write_text(stderr)
        os.replace(tmp, lib)
        out[name] = (lib, seconds, stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "lut_kernels": {
        "lut_lookup_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "lut_cascade_resident_launch": (_P, _P, _I, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _L, _L, _I, _P, _P),
        "lut_cascade_streamed_launch": (_P, _P, _I, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P, _P),
    },
    "subnet_mlp": {
        "unit_affine_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                               _L, _L, _L, _I, _I, _P),
        "unit_affine_dx_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                                  _L, _L, _L, _I, _P),
        "unit_affine_dx_chunks": (_I,),
        "unit_affine_reference_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _L,
                                         _L, _L, _L, _L, _L, _I, _I, _P),
    },
    "flash_attention": {
        "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _I,
                                   _I, _I, _F, _I, _P),
    },
    "flash_attention_wgmma": {
        "flash_attention_wgmma_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _L, _L, _L, _L, _L, _L, _L, _L,
                                         _L, _I, _I, _I, _F, _I, _P),
    },
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first call."""
    path, _, _ = build()[name]
    lib = ctypes.CDLL(str(path))
    for fname, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fname)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
