"""Build and bind the port's hand-written CUDA kernels.

The sources are `uvipslam_torch/csrc/*.cu`, each exporting a plain C
function, and the headers they share (`csrc/*.cuh`). At first use the
sources are compiled with nvcc for sm_90a into one shared library under
`uvipslam_torch/_build/` (not committed), named by a hash of the sources,
the headers and the flags, so an edited kernel or header is rebuilt, and
loaded with ctypes. `-fmad=false` keeps nvcc from contracting a product
and a sum into one FMA: the kernels write their FMAs out where the plain
torch versions' matrix products make them, and round every other
operation as its own torch op does. Pointers and the stream go in as
`c_void_p`, floats as `c_float`; each C function launches on the given
stream and returns `cudaGetLastError()`.

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
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false"]

_lock = threading.Lock()
_lib = None
build_seconds = None
build_log = ""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME, $CUDA_PATH, nvcc on $PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libuvip_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed shared library (if missing) and
    return its path: one nvcc per source, all started together, then one
    link. The library is written to a temporary name and renamed, so
    concurrent builds never load a half-written file. The compilers'
    resource reports (`-Xptxas -v`: registers, shared memory, spills) are
    kept in `build_log`."""
    global build_seconds, build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC",
                                   "-c", "-o", o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log in zip(_sources(), procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)} ({rc}):\n{log}" for s, rc, log in failed))
        tmp = os.path.join(work, "lib.so")
        r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)
    build_log = "\n".join(logs)
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
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # img, H, W, pts, n, psize, out, local, stream
            lib.uvip_extract_patches.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, ptr, ptr]
            # img, H, W, T, Tx, Ty, pts, valid, n, win, iters, max_correction,
            # max_residual, out, accept, stream
            lib.uvip_anchor_refine.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, i32,
                                               i32, i32, f32, f32, ptr, ptr, ptr]
            for fn in (lib.uvip_extract_patches, lib.uvip_anchor_refine):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
