"""Build and load the port's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

The library is compiled at first use into ``build/kernels/`` at the root
of the checkout (listed in .gitignore), named by a hash of the source and
flags so an edited source is rebuilt. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCE = CSRC / "lane_aggregates.cu"

# -fmad=false and -ftz=true are part of the kernel's contract with the
# reference's f32 arithmetic (see the note at the top of the source)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-ftz=true", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output (ptxas register/spill report) of the last build


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lane_aggregates_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.m3_lane_aggregates
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # windows, lanes, flags
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # npad, cw, mask, k
                ctypes.c_int64,  # tile_lanes
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_f, out_cnt, out_err
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
