"""Build the port's CUDA kernels with nvcc at first use and bind them with
ctypes.

The source is compiled into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), cached under
``build/repro_torch_kernels/`` at the repository root and keyed by the hash
of the source and the flags.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "pe_array.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the cache answered
    log: str              # nvcc's output (ptxas registers/spills)


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> Build:
    """Compile ``SOURCE`` unless a library of the same hash is cached."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"pe_array-{digest[:16]}.so"
    if lib.is_file():
        return Build(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    t0 = time.monotonic()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.monotonic() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{log}")
    os.replace(tmp, lib)
    return Build(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with its C entry points typed."""
    lib = ctypes.CDLL(str(build().path))
    lib.pe_cycle_step.argtypes = ([ctypes.c_void_p] * 16
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.pe_run_cycles.argtypes = ([ctypes.c_void_p] * 17
                                  + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    for fn in (lib.pe_cycle_step, lib.pe_run_cycles):
        fn.restype = ctypes.c_int
    return lib
