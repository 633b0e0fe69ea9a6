"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

The sources have a plain C interface, so ``nvcc`` builds them in seconds
without PyTorch's headers.  The shared library goes to
``build/kccotgan_tpu_torch/`` at the repository root, named by a hash of
the sources and flags: an edited ``.cu`` is rebuilt at first use, never
served stale.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kccotgan_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libkccot_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    # Every pointer and the stream are c_void_p: ctypes' default int is
    # 32 bits and would cut a device pointer.
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kccot_convlstm_fwd_step.argtypes = [
        i, p, ll, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, p,
    ]
    lib.kccot_convlstm_fwd_step.restype = i
    f = ctypes.c_float
    lib.kccot_sinkhorn_fwd.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.kccot_sinkhorn_fwd.restype = i
    lib.kccot_sinkhorn_bwd.argtypes = [p, p, p, p, p, i, i, i, f, p]
    lib.kccot_sinkhorn_bwd.restype = i
    for name in ("kccot_sinkhorn_fwd_max_batch", "kccot_sinkhorn_bwd_max_batch"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.kccot_error_string.argtypes = [i]
    lib.kccot_error_string.restype = ctypes.c_char_p
    return lib
