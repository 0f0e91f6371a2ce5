"""YAML settings loader of the reference schema.

Counterpart of `uvipslam_tpu/io/config.py`, a copy (host only): one typed
dataclass covering the whole `Data/Settings_*.yaml` schema (camera
intrinsics, distortion and fisheye flag, IMU and depth noise, the Tbc
extrinsics, ORB extractor parameters, the MONO/VI/VIP mode switch,
enhancement, KLT parameters, loop-closure flags, VIO init time). The
parser handles OpenCV's "%YAML:1.0" dialect (including the
`!!opencv-matrix` form of `Camera.Tbc`) and plain YAML scalar and
flow-sequence syntax without external dependencies.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

MONO, VI, VIP = 0, 1, 2


@dataclasses.dataclass
class Settings:
    # camera (Camera.*)
    fx: float = 413.32595366596017
    fy: float = 413.70198739483686
    cx: float = 305.9507483284928
    cy: float = 259.4439948946375
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    fps: float = 20.0
    rgb: int = 1
    width: int = 640
    height: int = 512
    fisheye: int = 0
    delay_to_imu: float = 0.0
    # IMU noise (SD convention)
    gyr_noise: float = 0.01414213562373
    acc_noise: float = 0.28284271247462
    gyr_rw: float = 5.0e-5
    acc_rw: float = 1.0e-3
    multiply_g: int = 0
    # pressure
    depth_noise: float = 0.5
    # extrinsics body<-camera (4x4)
    Tbc: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4))
    # ORB
    n_features: int = 400
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    score_type: int = 0
    # pipeline
    mode: int = VIP
    enhance: int = 1
    px_distance: int = 20
    loop_closing: int = 0
    loop_haloc: int = 0
    loop_bow: int = 0
    # Sim3 acceptance gates (extension keys, not in the original schema)
    loop_min_sim3_inliers: int = 20
    loop_min_total_matches: int = -1   # -1 = auto (10% of feature budget)
    init_time: float = 22.0
    init_mode: int = 2
    klt_levels: int = 5
    klt_window: int = 21
    local_window_size: int = 10
    # io
    bagfile: str = ""
    imu_topic: str = ""
    image_topic: str = ""
    depth_topic: str = ""


_KEYMAP = {
    "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx", "Camera.cy": "cy",
    "Camera.k1": "k1", "Camera.k2": "k2", "Camera.p1": "p1", "Camera.p2": "p2",
    "Camera.fps": "fps", "Camera.RGB": "rgb",
    "Camera.col": "width", "Camera.row": "height",
    "Camera.Fisheye": "fisheye", "Camera.delaytoimu": "delay_to_imu",
    "gyr.noise": "gyr_noise", "acc.noise": "acc_noise",
    "gyr.rw": "gyr_rw", "acc.rw": "acc_rw",
    "IMU.multiplyG": "multiply_g",
    "depth.noise": "depth_noise",
    "ORBextractor.nFeatures": "n_features",
    "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.nLevels": "n_levels",
    "ORBextractor.fastTh": "fast_th",
    "ORBextractor.nScoreType": "score_type",
    "Mode": "mode", "Enhance": "enhance", "Px_distance": "px_distance",
    "LoopC": "loop_closing", "LoopCHALOC": "loop_haloc", "LoopCBOF": "loop_bow",
    "LoopC.minSim3Inliers": "loop_min_sim3_inliers",
    "LoopC.minTotalMatches": "loop_min_total_matches",
    "time.Init": "init_time", "Init_mode": "init_mode",
    "Pyramid.Level": "klt_levels", "Window.Size": "klt_window",
    "LocalMapping.LocalWindowSize": "local_window_size",
    "bagfile": "bagfile", "imutopic": "imu_topic",
    "imagetopic": "image_topic", "depthtopic": "depth_topic",
}

_INT_FIELDS = {
    "rgb", "width", "height", "fisheye", "multiply_g", "n_features",
    "n_levels", "fast_th", "score_type", "mode", "enhance", "px_distance",
    "loop_closing", "loop_haloc", "loop_bow", "klt_levels", "klt_window",
    "loop_min_sim3_inliers", "loop_min_total_matches",
    "init_mode",
    "local_window_size",
}


def load_settings(path: str) -> Settings:
    text = open(path).read()
    s = Settings()

    # Tbc matrix: "Camera.Tbc:\n [a, b, c, ...]" (opencv-matrix or flow seq)
    m = re.search(r"Camera\.Tbc\s*:\s*(?:!!opencv-matrix.*?data\s*:)?\s*\[([^\]]*)\]",
                  text, re.S)
    if m:
        vals = [float(v) for v in re.split(r"[,\s]+", m.group(1).strip()) if v]
        if len(vals) == 16:
            s.Tbc = np.asarray(vals).reshape(4, 4)

    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line or line.startswith("%"):
            continue
        key, _, val = line.partition(":")
        key = key.strip()
        val = val.strip()
        if key not in _KEYMAP or not val or val.startswith("["):
            continue
        field = _KEYMAP[key]
        if field in ("bagfile", "imu_topic", "image_topic", "depth_topic"):
            setattr(s, field, val.strip('"'))
        elif field in _INT_FIELDS:
            setattr(s, field, int(float(val)))
        else:
            setattr(s, field, float(val))
    return s
