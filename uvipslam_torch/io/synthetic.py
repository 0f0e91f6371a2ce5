"""Synthetic sensor sequences for driving the port (host-side numpy).

Counterpart of `uvipslam_tpu/io/synthetic.py`: `make_sequence` renders
the same sprite field along the same trajectory and draws the same IMU
and pressure streams from the same `np.random.RandomState` draws, so for
equal arguments every field equals the reference's bit for bit, and
`ate_rmse` is the same Umeyama-aligned ATE.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticSequence:
    images: np.ndarray        # [T, H, W] f32 in [0, 255]
    timestamps: np.ndarray    # [T]
    R_cw: np.ndarray          # [T, 3, 3] world->camera
    t_cw: np.ndarray          # [T, 3]
    K: np.ndarray             # [3, 3]
    points: np.ndarray        # [P, 3] world sprite centers
    imu_omg: np.ndarray       # [T, S, 3] gyro samples in (t_{k-1}, t_k]
    imu_acc: np.ndarray       # [T, S, 3]
    imu_dt: np.ndarray        # [T, S]
    imu_mask: np.ndarray      # [T, S]
    depth: np.ndarray         # [T] pressure depth (world z of the body)
    depth_valid: np.ndarray   # [T]
    gravity_w: np.ndarray     # [3]

    @property
    def positions_w(self) -> np.ndarray:
        """Ground-truth camera centers in the world frame [T, 3]."""
        return -np.einsum("tij,ti->tj", self.R_cw, self.t_cw)


def _yaw_rotation(yaw: float) -> np.ndarray:
    """Rotation by `yaw` about the camera's y axis (SO3 exp of [0, yaw, 0]
    by Rodrigues' formula)."""
    w = np.array([0.0, yaw, 0.0])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _center_yaw(motion: str, t: float, t_end: float, speed: float, z_amp: float):
    """Camera center in the world and yaw at time t for each motion."""
    if motion == "arc":
        return [speed * t, 0.15 * np.sin(0.7 * t), z_amp * np.sin(0.5 * t)], \
            0.12 * np.sin(0.4 * t)
    if motion == "excited":
        return [speed * t + 0.25 * np.sin(2.0 * t), 0.20 * np.sin(1.3 * t + 1.0),
                z_amp * np.sin(0.9 * t)], 0.12 * np.sin(0.4 * t)
    if motion == "loop":
        amp = speed * t_end / np.pi
        return [2.0 * amp * np.sin(np.pi * t / t_end) ** 2,
                0.1 * np.sin(2 * np.pi * t / t_end), z_amp * np.sin(0.5 * t)], 0.0
    if motion == "circuit":
        r = speed * t_end / (2 * np.pi * 1.1)
        th = 2 * np.pi * 1.1 * t / t_end
        return [r * np.sin(th), r * (np.cos(th) - 1.0), z_amp * np.sin(th)], 0.0
    return [0.0, 0.0, speed * t], 0.0     # forward


def _so3_exp_np(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _so3_log_np(R):
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-9:
        return v / 2
    return th / (2 * np.sin(th)) * v


def make_sequence(n_frames: int = 60, fps: float = 20.0, imu_rate: float = 200.0,
                  H: int = 240, W: int = 320, n_points: int = 1500, seed: int = 0,
                  motion: str = "arc", speed: float = 0.35, gyr_noise: float = 0.003,
                  acc_noise: float = 0.02, gyr_bias: tuple = (0.002, -0.003, 0.001),
                  acc_bias: tuple = (0.03, -0.02, 0.04), depth_noise: float = 0.05,
                  sprite: int = 9, z_amp: float = 0.1, image_noise_seed: int | None = None,
                  Tbc: np.ndarray | None = None) -> SyntheticSequence:
    """Render `n_frames` [H, W] images of a multi-scale textured sprite
    field seen from a camera moving along `motion`, with per-pixel sensor
    noise from a second stream (`image_noise_seed`, default `seed`); then
    the IMU samples between frames (body frame; `Tbc` is the optional 4x4
    camera-in-body extrinsic, x_b = Rbc x_c + tbc) and the pressure depth
    (the body's world z), drawn after the images from the first stream."""
    rs = np.random.RandomState(seed)
    rs_img = np.random.RandomState(seed if image_noise_seed is None else image_noise_seed)
    fx = fy = 0.65 * W
    cx, cy = W / 2.0, H / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    ts = np.arange(n_frames) * (1.0 / fps)
    t_end = (n_frames - 1) * (1.0 / fps)
    R_cw, t_cw = [], []
    for t in ts:
        c, yaw = _center_yaw(motion, t, t_end, speed, z_amp)
        Rcw = _yaw_rotation(yaw).T
        R_cw.append(Rcw)
        t_cw.append(-Rcw @ np.asarray(c))
    R_cw = np.asarray(R_cw)
    t_cw = np.asarray(t_cw)

    # three sprite size classes give multi-frequency texture
    span_x = speed * ts[-1] + 6.0
    sizes = np.array([sprite, sprite * 2 + 1, sprite * 4 + 1])
    cls = rs.choice(3, n_points, p=[0.6, 0.3, 0.1])
    if motion == "circuit":
        r_c = speed * ts[-1] / (2 * np.pi * 1.1)
        lo_x, hi_x, lo_y, hi_y = -r_c - 3.0, r_c + 3.0, -2.0 * r_c - 2.2, 2.2
    else:
        lo_x, hi_x, lo_y, hi_y = -3.0, span_x, -2.2, 2.2
    pts = np.stack([rs.uniform(lo_x, hi_x, n_points), rs.uniform(lo_y, hi_y, n_points),
                    rs.uniform(2.5, 7.0, n_points)], axis=-1)

    # spatially correlated textures: random at ~1/3 resolution, bilinearly
    # upsampled, so binary descriptors survive sub-pixel shifts
    def make_texture(sz):
        lo = max(3, sz // 3)
        base = rs.uniform(20, 235, (lo, lo)).astype(np.float32)
        yi = np.linspace(0, lo - 1, sz)
        xi = np.linspace(0, lo - 1, sz)
        y0 = np.clip(yi.astype(int), 0, lo - 2)
        x0 = np.clip(xi.astype(int), 0, lo - 2)
        wy = (yi - y0)[:, None]
        wx = (xi - x0)[None, :]
        return ((1 - wy) * (1 - wx) * base[y0][:, x0]
                + (1 - wy) * wx * base[y0][:, x0 + 1]
                + wy * (1 - wx) * base[y0 + 1][:, x0]
                + wy * wx * base[y0 + 1][:, x0 + 1]).astype(np.float32)

    sprites = [make_texture(int(sizes[c])) for c in cls]

    # painter's algorithm: far sprites first, sub-pixel placement
    images = np.zeros((n_frames, H, W), np.float32)
    max_s = int(sizes.max())
    for f in range(n_frames):
        img = np.full((H, W), 60.0, np.float32)
        pc = pts @ R_cw[f].T + t_cw[f]
        z = pc[:, 2]
        vis = z > 0.5
        u = fx * pc[:, 0] / np.where(vis, z, 1.0) + cx
        v = fy * pc[:, 1] / np.where(vis, z, 1.0) + cy
        vis &= (u > -max_s) & (u < W + max_s) & (v > -max_s) & (v < H + max_s)
        for p in np.argsort(-z):
            if not vis[p]:
                continue
            sp = sprites[p]
            sz = sp.shape[0]
            u0 = u[p] - sz // 2
            v0 = v[p] - sz // 2
            iu, iv = int(np.floor(u0)), int(np.floor(v0))
            au, av = u0 - iu, v0 - iv
            s_pad = np.pad(sp, 1)
            s_shift = (s_pad[1:-1, 1:-1] * (1 - au) * (1 - av)
                       + s_pad[1:-1, 0:-2] * au * (1 - av)
                       + s_pad[0:-2, 1:-1] * (1 - au) * av
                       + s_pad[0:-2, 0:-2] * au * av)
            y0, y1 = max(0, iv), min(H, iv + sz)
            x0, x1 = max(0, iu), min(W, iu + sz)
            if y1 <= y0 or x1 <= x0:
                continue
            img[y0:y1, x0:x1] = s_shift[y0 - iv:y1 - iv, x0 - iu:x1 - iu]
        images[f] = img + rs_img.randn(H, W).astype(np.float32) * 1.0

    # ---- IMU: S samples per frame interval, in (t_{f-1}, t_f] ----
    Tbc = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64)
    Rcb = Tbc[:3, :3].T
    tcb = -Tbc[:3, :3].T @ Tbc[:3, 3]
    dt_img = 1.0 / fps
    S = max(1, int(round(imu_rate / fps)))
    dt_imu = dt_img / S
    imu_omg = np.zeros((n_frames, S, 3), np.float32)
    imu_acc = np.zeros((n_frames, S, 3), np.float32)
    imu_dt = np.zeros((n_frames, S), np.float32)
    imu_mask = np.zeros((n_frames, S), np.float32)
    g_w = np.array([0.0, 0.0, -9.81])

    def Rwb_at(t):
        return _so3_exp_np(np.array([0.0, _center_yaw(motion, t, t_end, speed, z_amp)[1], 0.0])) \
            @ Rcb

    def body_center_at(t):
        # Twb = Twc Tbc^-1: the body origin is C + Rwc tcb
        c, yaw = _center_yaw(motion, t, t_end, speed, z_amp)
        return np.array(c) + _so3_exp_np(np.array([0.0, yaw, 0.0])) @ tcb

    for f in range(1, n_frames):
        for s in range(S):
            t_a = (f - 1) * dt_img + s * dt_imu
            t_b = t_a + dt_imu
            Rwa, Rwb = Rwb_at(t_a), Rwb_at(t_b)
            w_body = _so3_log_np(Rwa.T @ Rwb) / dt_imu
            # world acceleration of the body origin by central difference
            a_w = (body_center_at(t_b + dt_imu) - 2 * body_center_at(t_b)
                   + body_center_at(t_b - dt_imu)) / dt_imu**2
            imu_omg[f, s] = w_body + np.asarray(gyr_bias) + rs.randn(3) * gyr_noise
            imu_acc[f, s] = Rwb.T @ (a_w - g_w) + np.asarray(acc_bias) + rs.randn(3) * acc_noise
            imu_dt[f, s] = dt_imu
            imu_mask[f, s] = 1.0

    depth = np.array([body_center_at(t)[2] for t in ts]) + rs.randn(n_frames) * depth_noise
    return SyntheticSequence(images=images, timestamps=ts, R_cw=R_cw, t_cw=t_cw, K=K,
                             points=pts, imu_omg=imu_omg, imu_acc=imu_acc, imu_dt=imu_dt,
                             imu_mask=imu_mask, depth=depth.astype(np.float32),
                             depth_valid=np.ones(n_frames, bool), gravity_w=g_w)


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, align_scale: bool = True):
    """Absolute trajectory error after Umeyama (Sim3, or SE3 without
    `align_scale`) alignment of `est_pos` [T, 3] onto `gt_pos` [T, 3].
    Returns (rmse, aligned estimate)."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((E * E).sum() / len(est), 1e-12)) \
        if align_scale else 1.0
    t = mu_g - s * R @ mu_e
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean())), aligned
