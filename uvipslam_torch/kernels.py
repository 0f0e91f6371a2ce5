"""Build and bind the port's hand-written CUDA kernels.

The sources are `uvipslam_torch/csrc/*.cu`, each exporting a plain C
function. At first use they are compiled with nvcc for sm_90a into one
shared library under `uvipslam_torch/_build/` (not committed), named by a
hash of the sources so an edited kernel is rebuilt, and loaded with
ctypes. Pointers and the stream go in as `c_void_p`; each C function
launches on the given stream and returns `cudaGetLastError()`.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
build_seconds = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME, $CUDA_PATH, nvcc on $PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libuvip_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed shared library (if missing) and
    return its path. The library is written to a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, *_sources()]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, path)
    build_seconds = time.time() - t0
    return path


def load():
    """The loaded kernel library (built and bound on first call; later
    calls return the cached handle without taking the lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.uvip_extract_patches
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
    return _lib
