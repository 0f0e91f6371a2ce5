"""Visual-inertial(-pressure) initialization.

Counterpart of `uvipslam_tpu/vio/init.py` (the reference's TryInitVIO
and its optimizer helpers): the gyro bias by Gauss-Newton over keyframe
pairs, the gravity direction from the accelerometer average, the metric
scale from the pressure channel, the linear [scale, gravity] solve over
keyframe triplets and its |g|-constrained refinements, velocity recovery
and the strided virtual keyframes of the init solves. Every solve is a
masked fixed-shape least squares; the small systems go through
`torch.linalg.solve_ex`, whose error flag stays on the device (no host
synchronization). The gyro bias's iterations, the reference's `lax.scan`,
run through a `scan` argument (`utils.graphs.Segments.scan`; by default
the plain loop).
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.solver.factors import gyro_bias_edge
from uvipslam_torch.utils.graphs import plain_scan

GRAVITY = 9.810


def _solve(H, b):
    return torch.linalg.solve_ex(H, b[..., None])[0][..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _vec(like, *vals):
    """A constant vector filled on the device (no host-to-device copy)."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device) for v in vals])


def _gyro_bias_body(bg, _, R_i, kf_R_wb, pre_dR, pre_J_R_bg, w):
    """One Gauss-Newton iteration of the gyro bias."""
    r, J = gyro_bias_edge(R_i, kf_R_wb, pre_dR, pre_J_R_bg, bg)
    Jw = J * w[:, None, None]
    H = torch.einsum("kmi,kmj->ij", Jw, J)
    g = torch.einsum("kmi,km->i", Jw, r)
    return bg + _solve(H + 1e-8 * _eye(3, bg), -g)


def estimate_gyro_bias(kf_R_wb, pre_dR, pre_J_R_bg, pair_mask, n_iters: int = 5, scan=None):
    """Gauss-Newton for the 3-dof gyro bias over consecutive keyframe
    pairs; slot k holds the preintegration from keyframe k-1 to k. `scan`
    runs the iterations (`utils.graphs.Segments.scan`; the plain loop when
    None)."""
    R_i = torch.roll(kf_R_wb, 1, dims=0)
    # zero-dt preintegrations (the two bootstrap keyframes) carry nothing
    tr = torch.diagonal(pre_dR, dim1=-2, dim2=-1).sum(-1)
    w = (pair_mask & (torch.abs(tr - 3.0) + torch.sum(torch.abs(pre_J_R_bg), (-2, -1)) > 1e-9)
         ).to(kf_R_wb.dtype)
    bg = torch.zeros(3, dtype=kf_R_wb.dtype, device=kf_R_wb.device)
    return (scan or plain_scan)(("gyro_bias",), _gyro_bias_body, bg, length=n_iters,
                                consts=(R_i, kf_R_wb, pre_dR, pre_J_R_bg, w))


def gravity_from_accel_average(acc_samples, mask):
    """Gravity direction = the mean specific force while quasi-static."""
    w = mask.to(acc_samples.dtype)[:, None]
    mean = torch.sum(acc_samples * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    return mean / torch.clamp(torch.linalg.vector_norm(mean), min=1e-9)


def rotation_to_gravity(g_dir_w):
    """R taking +z onto the gravity direction `g_dir_w`."""
    gI = _vec(g_dir_w, 0.0, 0.0, 1.0)
    v = torch.linalg.cross(gI, g_dir_w)
    s = torch.linalg.vector_norm(v)
    ang = torch.atan2(s, torch.dot(gI, g_dir_w))
    axis = v / torch.where(s < 1e-9, torch.ones_like(s), s)
    return lie.so3_exp(axis * ang)


def estimate_scale_from_pressure(kf_z_map, kf_depth, kf_mask):
    """The paper's pressure-scale solve: least squares of |d_j - d_i| =
    s |z_j - z_i| over 1- and 2-hop keyframe pairs (closed form, the
    reference's one-iteration GN). Returns (scale_gn, scale_naive), the
    latter the average per-pair ratio."""
    dtype = kf_z_map.dtype
    idx = torch.arange(kf_z_map.shape[0], device=kf_z_map.device)

    def pairs(hop):
        dz = torch.abs(kf_z_map - torch.roll(kf_z_map, hop))
        dd = torch.abs(kf_depth - torch.roll(kf_depth, hop))
        m = (kf_mask & torch.roll(kf_mask, hop)).to(dtype) * (idx >= hop)   # no wrapped pairs
        return dz, dd, m

    dz1, dd1, m1 = pairs(1)
    dz2, dd2, m2 = pairs(2)
    dz = torch.cat([dz1, dz2])
    dd = torch.cat([dd1, dd2])
    m = torch.cat([m1, m2])
    s_gn = torch.sum(m * dd * dz) / torch.clamp(torch.sum(m * dz * dz), min=1e-12)
    good = m * (dz > 1e-6)
    ratios = torch.where(dz > 1e-6, dd / torch.clamp(dz, min=1e-6), torch.zeros_like(dz))
    s_naive = torch.sum(good * ratios) / torch.clamp(torch.sum(good), min=1.0)
    return s_gn, s_naive


def _triplets(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, pcb, J_P_ba=None, J_V_ba=None):
    """The triplet terms shared by the linear init solves: lam [K, 3],
    beta_coef [K, 1], gamma0 [K, 3], and psi [K, 3, 3] (the acc-bias
    columns) when the bias Jacobians are given."""
    c1, c2, c3 = torch.roll(kf_p_c, 2, 0), torch.roll(kf_p_c, 1, 0), kf_p_c
    Rb1, Rb2, Rb3 = torch.roll(kf_R_wb, 2, 0), torch.roll(kf_R_wb, 1, 0), kf_R_wb
    dp12, dv12, dp23 = torch.roll(pre_dP, 1, 0), torch.roll(pre_dV, 1, 0), pre_dP
    T12 = torch.roll(pre_dt, 1, 0)[:, None]
    T23 = pre_dt[:, None]
    lam = (c3 - c2) * T12 - (c2 - c1) * T23
    beta_coef = -0.5 * (T12 * T12 * T23 + T12 * T23 * T23)
    gamma0 = (mv(Rb2, dp23) * T12 - mv(Rb1, dp12) * T23 + mv(Rb1, dv12) * (T12 * T23)
              - (mv(Rb3 - Rb2, pcb) * T12 - mv(Rb2 - Rb1, pcb) * T23))
    psi = None
    if J_P_ba is not None:
        Jp12, Jv12 = torch.roll(J_P_ba, 1, 0), torch.roll(J_V_ba, 1, 0)
        psi = (mm(Rb2, J_P_ba) * T12[..., None] - mm(Rb1, Jp12) * T23[..., None]
               + mm(Rb1, Jv12) * (T12 * T23)[..., None])
    return lam, beta_coef, gamma0, psi


def _triplet_weight(triple_mask, like):
    idx = torch.arange(triple_mask.shape[0], device=triple_mask.device)
    return (triple_mask & (idx >= 2)).to(like.dtype)


def estimate_scale_gravity_linear(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, pcb, triple_mask):
    """VI-ORB's linear [scale, gravity] solve over keyframe triplets:
    lam s + beta g_w = gamma per triplet. Returns (s, g_w)."""
    K = kf_p_c.shape[0]
    lam, beta_coef, gamma, _ = _triplets(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, pcb)
    beta = _eye(3, kf_p_c).expand(K, 3, 3) * beta_coef[..., None]
    w = _triplet_weight(triple_mask, kf_p_c)
    A2 = (torch.cat([lam[..., None], beta], dim=-1) * w[:, None, None]).reshape(-1, 4)
    b2 = (gamma * w[:, None]).reshape(-1)
    x = _solve(A2.T @ A2 + 1e-9 * _eye(4, kf_p_c), A2.T @ b2)
    return x[0], x[1:4]


def _gravity_frame(g0, g_mag):
    """Rwi with Rwi (0, 0, -1) along g0, gI = (0, 0, -g_mag), Rwi gI, and
    d g_w / d dtheta_xy = -Rwi hat(gI)[:, :2]."""
    gI = _vec(g0, 0.0, 0.0, -g_mag)
    Rwi = rotation_to_gravity(-(g0 / torch.clamp(torch.linalg.vector_norm(g0), min=1e-9)))
    dG = -mm(Rwi, lie.hat(gI))[:, :2]
    return gI, Rwi, mv(Rwi, gI), dG


def _tilted_gravity(Rwi, dth, gI):
    z = torch.zeros((), dtype=dth.dtype, device=dth.device)
    return mv(mm(Rwi, lie.so3_exp(torch.stack([dth[0], dth[1], z]))), gI)


def refine_scale_gravity_accbias(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, J_P_ba, J_V_ba, g0,
                                 pcb, triple_mask, g_mag: float = GRAVITY,
                                 sigma_dth: float = 0.3, sigma_ba: float = 0.2):
    """VI-ORB's second solve: [s, dtheta_xy, ba] with |g| fixed, g_w =
    Rwi Exp([dthx, dthy, 0]) gI, under zero-mean priors on [dtheta, ba].
    Returns (s, g_w, ba)."""
    K = kf_p_c.shape[0]
    lam, beta_coef, gamma0, psi = _triplets(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, pcb,
                                            J_P_ba, J_V_ba)
    gI, Rwi, gw0, dG = _gravity_frame(g0, g_mag)
    beta_th = beta_coef[..., None] * dG.expand(K, 3, 2)
    b = gamma0 - beta_coef * gw0
    w = _triplet_weight(triple_mask, kf_p_c)
    A2 = (torch.cat([lam[..., None], beta_th, -psi], dim=-1) * w[:, None, None]).reshape(-1, 6)
    bb = (b * w[:, None]).reshape(-1)
    prior = _vec(kf_p_c, 0.0, 1.0 / sigma_dth**2, 1.0 / sigma_dth**2, 1.0 / sigma_ba**2,
                 1.0 / sigma_ba**2, 1.0 / sigma_ba**2)
    x = _solve(A2.T @ A2 + torch.diag(prior) + 1e-9 * _eye(6, kf_p_c), A2.T @ bb)
    return x[0], _tilted_gravity(Rwi, x[1:3], gI), x[3:6]


def refine_gravity_accbias_fixed_scale(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, J_P_ba,
                                       J_V_ba, g0, pcb, s_fixed, triple_mask,
                                       g_mag: float = GRAVITY, sigma_dth: float = 0.3,
                                       sigma_ba: float = 0.2):
    """The pressure mode's second solve: [dtheta_xy, ba] with the scale
    fixed from the pressure channel. Returns (g_w, ba)."""
    K = kf_p_c.shape[0]
    lam, beta_coef, gamma0, psi = _triplets(kf_p_c, kf_R_wb, pre_dP, pre_dV, pre_dt, pcb,
                                            J_P_ba, J_V_ba)
    gI, Rwi, gw0, dG = _gravity_frame(g0, g_mag)
    beta_th = beta_coef[..., None] * dG.expand(K, 3, 2)
    b = gamma0 - beta_coef * gw0 - lam * s_fixed
    w = _triplet_weight(triple_mask, kf_p_c)
    A2 = (torch.cat([beta_th, -psi], dim=-1) * w[:, None, None]).reshape(-1, 5)
    bb = (b * w[:, None]).reshape(-1)
    prior = _vec(kf_p_c, 1.0 / sigma_dth**2, 1.0 / sigma_dth**2, 1.0 / sigma_ba**2,
                 1.0 / sigma_ba**2, 1.0 / sigma_ba**2)
    x = _solve(A2.T @ A2 + torch.diag(prior) + 1e-9 * _eye(5, kf_p_c), A2.T @ bb)
    return _tilted_gravity(Rwi, x[0:2], gI), x[2:5]


def velocities_from_positions(kf_p_wb, kf_R_wb, pre_dP, pre_dt, gravity_w, pair_mask):
    """v_i from p_j = p_i + v_i dt + g dt^2 / 2 + R_i dP (0 where the
    next slot's pair is missing)."""
    p_j = torch.roll(kf_p_wb, -1, 0)
    dt = torch.roll(pre_dt, -1, 0)[:, None]
    v = (p_j - kf_p_wb - 0.5 * gravity_w * dt * dt - mv(kf_R_wb, torch.roll(pre_dP, -1, 0))
         ) / torch.clamp(dt, min=1e-6)
    nxt_ok = torch.roll(pair_mask, -1, 0) & (dt[:, 0] > 1e-6)
    return torch.where(nxt_ok[:, None], v, torch.zeros_like(v))


def build_strided_inertial(kf_valid, imu_omg, imu_acc, imu_dt, imu_mask, stride: int,
                           base: int = 1):
    """Virtual keyframes at slots base, base+J, ... (J = stride) with the
    raw IMU windows of the intervening slots concatenated, so the init
    solves' triplet identities span long baselines. Returns (sel [KV],
    vvalid [KV], omg/acc [KV, J*S, 3], dt/mask [KV, J*S]); row v covers
    (virtual v-1, virtual v]."""
    K, S = imu_dt.shape
    J = stride
    KV = max((K - base) // J, 2)
    dev = imu_dt.device
    v = torch.arange(KV, device=dev)
    sel = base + v * J
    sel_c = sel.clamp(0, K - 1)
    rows = (base + (v[:, None] - 1) * J) + 1 + torch.arange(J, device=dev)[None, :]
    rows_ok = (v[:, None] >= 1) & (rows >= 0) & (rows < K)
    rows_c = rows.clamp(0, K - 1)
    omg = imu_omg[rows_c].reshape(KV, J * S, 3)
    acc = imu_acc[rows_c].reshape(KV, J * S, 3)
    dt = (imu_dt[rows_c] * rows_ok[..., None]).reshape(KV, J * S)
    mask = (imu_mask[rows_c] * rows_ok[..., None]).reshape(KV, J * S)
    interval_valid = torch.all(torch.where(rows_ok, kf_valid[rows_c], (v[:, None] >= 1)), dim=1)
    vvalid = (sel < K) & kf_valid[sel_c] & ((v == 0) | interval_valid)
    return sel_c, vvalid, omg, acc, dt, mask
