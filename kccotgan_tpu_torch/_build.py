"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

The sources have a plain C interface, so ``nvcc`` builds them in seconds
without PyTorch's headers: one ``nvcc`` per ``.cu``, all started
together, then one link.  The shared library goes to
``build/kccotgan_tpu_torch/`` at the repository root, named by a hash of
the sources (headers included) and flags: an edited source is rebuilt at
first use, never served stale.  Nothing here runs at import time.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libkccot_{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"{tag}.{os.getpid()}"
        objects = [BUILD_DIR / f"{src.stem}.{suffix}.o" for src in sources]
        nvcc = _nvcc()
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for cmd in (
                [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
            )
        ]
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        for cmd, proc in [*procs, (link, None)]:
            if proc is None:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            _, err = proc.communicate()
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        os.replace(tmp, lib_path)
        for obj in objects:
            obj.unlink()
    lib = ctypes.CDLL(str(lib_path))
    # Every pointer and the stream are c_void_p: ctypes' default int is
    # 32 bits and would cut a device pointer.
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = {
        "kccot_convlstm_fwd_step": [i, p, ll, p, p, p, p, p, p, p, ll, p, ll, i, i, i, i, i, i, p],
        "kccot_convlstm_bwd_step": [
            i, p, ll, p, ll, p, ll, p, p, p, ll, p, p, p, ll, p, i, i, i, i, i, i, p,
        ],
        "kccot_convlstm_bwd_dh": [i, p, ll, p, p, i, i, i, i, i, i, p],
        "kccot_convlstm_bwd_rows": [i, i, i, i],
        "kccot_recurrent_wgrad": [i, p, p, p, p, i, ll, p, i, p, p, i, i, i, i, i, i, i, p],
        "kccot_lstm_fwd": [i, i, p, p, p, p, p, p, p, p, p, i, i, i, p],
        "kccot_lstm_bwd": [i, i, p, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, p],
    }
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = i
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
