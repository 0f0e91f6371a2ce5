"""Trajectory evaluation: the rpg_trajectory_evaluation ATE protocol.

Counterpart of `uvipslam_tpu/io/evaluate.py`, a copy (host numpy only):

  1. associate estimate and groundtruth stamps by nearest neighbour
     within a tolerance,
  2. align the matched position sets with a closed-form Umeyama solve:
     `sim3` (mono: scale is unobservable), `se3` (metric scale), or
     `posyaw` (gravity-aligned VIO: only yaw and translation are
     unobservable, rpg's recommended mode for visual-inertial runs),
  3. report translation RMSE (ATE) plus median and max.

Usage: `evaluate_ate("stamped_traj_estimate.txt", "stamped_groundtruth.txt",
align="posyaw")`.
"""

from __future__ import annotations

import numpy as np

from uvipslam_torch.io.trajectory import load_tum_trajectory


def associate(ts_est: np.ndarray, ts_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-stamp association. Returns (idx_est, idx_gt) index arrays
    of the matched pairs (each estimate stamp matched to its nearest
    groundtruth stamp, kept when |dt| <= max_dt). One-to-one like the
    rpg/TUM protocol: when several estimate stamps hit the same
    groundtruth stamp only the smallest-|dt| pair is kept, so a sparse
    groundtruth never double-counts in the RMSE."""
    ts_est = np.asarray(ts_est, np.float64)
    ts_gt = np.asarray(ts_gt, np.float64)
    order = np.argsort(ts_gt)
    tg = ts_gt[order]
    pos = np.searchsorted(tg, ts_est)
    pos = np.clip(pos, 1, len(tg) - 1)
    left, right = tg[pos - 1], tg[pos]
    take_right = np.abs(right - ts_est) < np.abs(ts_est - left)
    nearest = np.where(take_right, pos, pos - 1)
    dt = np.abs(tg[nearest] - ts_est)
    keep = dt <= max_dt
    idx_est = np.nonzero(keep)[0]
    idx_gt = nearest[keep]
    # dedup: keep the best estimate per groundtruth stamp (stable argsort
    # by |dt| -> first occurrence of each gt index wins)
    by_dt = np.argsort(dt[keep], kind="stable")
    _, first = np.unique(idx_gt[by_dt], return_index=True)
    sel = np.sort(by_dt[first])
    return idx_est[sel], order[idx_gt[sel]]


def umeyama_alignment(est: np.ndarray, gt: np.ndarray,
                      with_scale: bool = True):
    """Closed-form similarity alignment gt ~= s * R @ est + t
    (Umeyama 1991). Returns (s, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (E ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def posyaw_alignment(est: np.ndarray, gt: np.ndarray):
    """Yaw-and-position-only alignment (rpg's recommended VIO mode:
    pitch/roll and scale are observable through gravity + IMU, so only
    a z-rotation and a translation may be removed)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    # best yaw: maximize trace(Rz(th) E^T G) over xy
    a = float((E[:, 0] * G[:, 0] + E[:, 1] * G[:, 1]).sum())
    b = float((E[:, 0] * G[:, 1] - E[:, 1] * G[:, 0]).sum())
    th = np.arctan2(b, a)
    c, s = np.cos(th), np.sin(th)
    R = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = mu_g - R @ mu_e
    return 1.0, R, t


def evaluate_ate(est_path: str, gt_path: str, align: str = "sim3",
                 max_dt: float = 0.02) -> dict:
    """Full protocol: load both TUM files, associate, align, report.

    align: 'sim3' (mono), 'se3' (metric), 'posyaw' (gravity-aligned VIO),
    or 'none'. Returns a dict with ate_rmse_m and diagnostics."""
    ts_e, p_e, _ = load_tum_trajectory(est_path)
    ts_g, p_g, _ = load_tum_trajectory(gt_path)
    ie, ig = associate(ts_e, ts_g, max_dt=max_dt)
    if len(ie) < 3:
        return {"ate_rmse_m": float("inf"), "n_matched": int(len(ie)),
                "error": "fewer than 3 associated stamps"}
    E, G = p_e[ie], p_g[ig]
    if align == "sim3":
        s, R, t = umeyama_alignment(E, G, with_scale=True)
    elif align == "se3":
        s, R, t = umeyama_alignment(E, G, with_scale=False)
    elif align == "posyaw":
        s, R, t = posyaw_alignment(E, G)
    elif align == "none":
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    else:
        raise ValueError(f"unknown align mode {align!r}")
    err = np.linalg.norm(s * (R @ E.T).T + t - G, axis=1)
    span = float(np.linalg.norm(G.max(0) - G.min(0)))
    return {
        "ate_rmse_m": float(np.sqrt(np.mean(err ** 2))),
        "ate_median_m": float(np.median(err)),
        "ate_max_m": float(err.max()),
        "n_matched": int(len(ie)),
        "n_est": int(len(ts_e)),
        "n_gt": int(len(ts_g)),
        "align": align,
        "scale": float(s),
        "gt_span_m": span,
    }


def save_tum_groundtruth(path: str, timestamps, positions,
                         quats_xyzw=None) -> None:
    """Write a stamped_groundtruth.txt in the same TUM format
    (quaternions default to identity)."""
    positions = np.asarray(positions, np.float64)
    if quats_xyzw is None:
        quats_xyzw = np.tile([0.0, 0.0, 0.0, 1.0], (len(positions), 1))
    with open(path, "w") as f:
        for ts, p, q in zip(timestamps, positions, quats_xyzw):
            f.write(f"{ts:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
