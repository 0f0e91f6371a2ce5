"""rosbag -> packed host arrays via the repo's native C++ decoder.

Counterpart of `uvipslam_tpu/io/bag.py`: the ctypes binding of
`native/bagreader.cpp` (a one-shot offline decode into numpy arrays) and
the per-frame sensor bundles, with the same semantics: IMU samples in
(t_{k-1}, t_k] with a boundary sample interpolated at the interval start,
depth = mean of the pressure samples in the interval, clamped to
+-depth_outlier_clamp of the previous value.

The decoder is the repo's `native/libbagreader.so`. Where that library is
missing or does not load on this machine, `native/bagreader.cpp` is
compiled with g++ at first use, with the flags of
`scripts/build_native.sh`, into `uvipslam_torch/_build/` (never into
`native/`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "_build")
_LIB = None
_lock = threading.Lock()


def _bz2_flags() -> list[str]:
    """bz2 support as `scripts/build_native.sh` links it: the development
    header when present, else the runtime library's versioned soname."""
    if os.path.exists("/usr/include/bzlib.h"):
        return ["-DHAVE_BZ2", "-DHAVE_BZLIB_H", "-lbz2"]
    for lib in ("/lib/x86_64-linux-gnu/libbz2.so.1.0", "/usr/lib/x86_64-linux-gnu/libbz2.so.1.0"):
        if os.path.exists(lib):
            return ["-DHAVE_BZ2", "-l:libbz2.so.1.0"]
    return []


def build_reader() -> str:
    """Compile `native/bagreader.cpp` into `_build/` (named by a hash of
    the source and the flags; written under a temporary name and renamed)
    and return the library's path."""
    src = os.path.join(_NATIVE, "bagreader.cpp")
    flags = ["-O2", "-shared", "-fPIC", "-std=c++17"]
    extra = _bz2_flags()
    with open(src, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(flags + extra).encode())
    path = os.path.join(BUILD_DIR, f"libbagreader_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        r = subprocess.run(["g++", *flags, src, "-o", tmp, *extra], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build the bag reader ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)
    return path


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.bag_open.restype = ctypes.c_void_p
    lib.bag_open.argtypes = [ctypes.c_char_p] * 4
    lib.bag_error.restype = ctypes.c_char_p
    lib.bag_error.argtypes = [ctypes.c_void_p]
    for name in ["bag_n_imu", "bag_n_pressure", "bag_n_images", "bag_image_data_size"]:
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ["bag_copy_imu", "bag_copy_pressure", "bag_copy_image_meta"]:
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.bag_copy_image_data.restype = None
    lib.bag_copy_image_data.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.bag_close.restype = None
    lib.bag_close.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    """The decoder library: the repo's prebuilt one, else built here."""
    global _LIB
    if _LIB is None:
        with _lock:
            if _LIB is None:
                try:
                    _LIB = _bind(os.path.join(_NATIVE, "libbagreader.so"))
                except OSError:
                    _LIB = _bind(build_reader())
    return _LIB


@dataclasses.dataclass
class BagTensors:
    imu: np.ndarray          # [M, 7]: t, wx, wy, wz, ax, ay, az
    pressure: np.ndarray     # [P, 3]: t, pressure, variance
    image_times: np.ndarray  # [T]
    images: np.ndarray       # [T, H, W] u8 (uniform size assumed)


def read_bag(path: str, image_topic: str, imu_topic: str,
             pressure_topic: str) -> BagTensors:
    lib = _lib()
    h = lib.bag_open(path.encode(), image_topic.encode(), imu_topic.encode(),
                     pressure_topic.encode())
    try:
        err = lib.bag_error(h)
        if err:
            raise ValueError(f"bag decode failed: {err.decode()}")
        n_imu = lib.bag_n_imu(h)
        n_pr = lib.bag_n_pressure(h)
        n_img = lib.bag_n_images(h)
        imu = np.zeros((n_imu, 7))
        pr = np.zeros((n_pr, 3))
        meta = np.zeros((n_img, 4))
        if n_imu:
            lib.bag_copy_imu(h, imu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if n_pr:
            lib.bag_copy_pressure(h, pr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if n_img:
            lib.bag_copy_image_meta(h, meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        blob = np.zeros((lib.bag_image_data_size(h),), np.uint8)
        if blob.size:
            lib.bag_copy_image_data(h, blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

        imgs = []
        times = []
        for t, hh, ww, off in meta:
            hh, ww, off = int(hh), int(ww), int(off)
            imgs.append(blob[off:off + hh * ww].reshape(hh, ww))
            times.append(t)
        images = np.stack(imgs) if imgs else np.zeros((0, 0, 0), np.uint8)
        return BagTensors(imu=imu, pressure=pr, image_times=np.asarray(times), images=images)
    finally:
        lib.bag_close(h)


def make_frame_bundles(
    bag: BagTensors,
    delay_to_imu: float = 0.0,
    imu_per_frame_cap: int = 64,
    depth_outlier_clamp: float = 2.0,
    pressure_is_depth: bool = True,
):
    """Per-frame sensor bundles with the decoder's buffer semantics:

      * image timestamp shifted by Camera.delaytoimu,
      * IMU samples strictly within (t_{k-1}, t_k], with a boundary sample
        interpolated at the interval start,
      * depth = mean of pressure samples in the interval, outliers
        clamped to +-depth_outlier_clamp of the previous value.

    Returns a dict of padded host arrays ready for device upload
    (`pressure_is_depth` is kept for the signature: the caller converts
    pressure to depth either way).
    """
    t_img = bag.image_times + delay_to_imu
    T = len(t_img)
    S = imu_per_frame_cap
    omg = np.zeros((T, S, 3), np.float32)
    acc = np.zeros((T, S, 3), np.float32)
    dts = np.zeros((T, S), np.float32)
    msk = np.zeros((T, S), np.float32)
    depth = np.zeros((T,), np.float32)
    depth_ok = np.zeros((T,), bool)

    imu_t = bag.imu[:, 0]
    prev_depth = None
    for k in range(1, T):
        t0, t1 = t_img[k - 1], t_img[k]
        sel = (imu_t > t0) & (imu_t <= t1)
        rows = bag.imu[sel]
        # boundary interpolation at t0: the first sample moves to the
        # exact interval start
        i0 = np.searchsorted(imu_t, t0, side="right") - 1
        if i0 >= 0 and len(rows) and imu_t[i0] < t0:
            a = bag.imu[i0]
            b = rows[0]
            w = (t0 - a[0]) / max(b[0] - a[0], 1e-9)
            interp = a + w * (b - a)
            interp[0] = t0
            rows = np.vstack([interp, rows])
        n = min(len(rows), S)
        if n >= 2:
            ts = rows[:n, 0]
            d = np.diff(np.concatenate([[t0], ts]))
            omg[k, :n] = rows[:n, 1:4]
            acc[k, :n] = rows[:n, 4:7]
            dts[k, :n] = d
            msk[k, :n] = 1.0

        if len(bag.pressure):
            pt = bag.pressure[:, 0]
            psel = (pt > t0) & (pt <= t1)
            if psel.any():
                d_meas = float(np.mean(bag.pressure[psel, 1]))
                if prev_depth is not None:
                    d_meas = float(np.clip(d_meas, prev_depth - depth_outlier_clamp,
                                           prev_depth + depth_outlier_clamp))
                depth[k] = d_meas
                depth_ok[k] = True
                prev_depth = d_meas

    return dict(
        images=bag.images.astype(np.float32),
        timestamps=t_img.astype(np.float64),
        imu_omg=omg, imu_acc=acc, imu_dt=dts, imu_mask=msk,
        depth=depth, depth_valid=depth_ok,
    )
