"""TUM-format trajectory export for external evaluation.

Counterpart of `uvipslam_tpu/io/trajectory.py`, a copy (host numpy only):
the end-of-run trajectory dump `stamped_traj_estimate.txt` with lines
`timestamp tx ty tz qx qy qz qw`, as rpg_trajectory_evaluation reads it.
"""

from __future__ import annotations

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion from rotation matrix (TUM order)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.asarray([x, y, z, w])


def save_tum_trajectory(path: str, timestamps, R_cw_list, t_cw_list) -> None:
    """Write `timestamp tx ty tz qx qy qz qw` lines; poses given as
    world->camera (Tcw) like the tracker's outputs, exported as
    camera-in-world (Twc)."""
    with open(path, "w") as f:
        for ts, Rcw, tcw in zip(timestamps, R_cw_list, t_cw_list):
            Rcw = np.asarray(Rcw, np.float64)
            tcw = np.asarray(tcw, np.float64)
            Rwc = Rcw.T
            C = -Rwc @ tcw
            q = _quat_from_R(Rwc)
            f.write(f"{ts:.9f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def load_tum_trajectory(path: str):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
