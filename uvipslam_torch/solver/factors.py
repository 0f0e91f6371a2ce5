"""Residuals and analytic Jacobians of the factor types.

Counterpart of `uvipslam_tpu/solver/factors.py`: the visual (SE3 and
NavState) reprojection factors, the inertial factors (preintegration,
bias random walk, marginal prior), the pressure factors (unary depth and
the paper's depth-projected ternary) and the two VIO-init edges. The
Sim3 factors of loop closing belong to a later slice.

Conventions: NavState PVR increments P <- P + R dP, V <- V + dV,
R <- R Exp(dPhi) with error order [rP, rV, rPhi]; bias increments
[d(dbg), d(dba)]; SE3 camera pose Tcw increments are left-multiplicative,
Tcw <- Exp([rho, phi]) Tcw; residual = observed_uv - projected_uv.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv


def reproj_se3(Rcw, tcw, pw, uv, fx, fy, cx, cy):
    """Visual reprojection w.r.t. an SE3 camera pose and a world point,
    batched over leading dims of (pw, uv). Returns (r [.., 2],
    J_pose [.., 2, 6] for [rho, phi], J_point [.., 2, 3])."""
    pc = mv(Rcw, pw) + tcw
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = uv - torch.stack([u, v], dim=-1)

    zero = torch.zeros_like(x)
    J_uv_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    J_pc_pose = torch.cat([eye, -lie.hat(pc)], dim=-1)

    J_pose = -mm(J_uv_pc, J_pc_pose)
    J_point = -mm(J_uv_pc, Rcw.expand(pc.shape[:-1] + (3, 3)))
    return r, J_pose, J_point


def _proj_jac(pc, uv, fx, fy, cx, cy):
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    r = uv - torch.stack([fx * x * iz + cx, fy * y * iz + cy], dim=-1)
    zero = torch.zeros_like(x)
    J_uv_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)
    return r, J_uv_pc


def _eye(like, batch, n=3):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(tuple(batch) + (n, n))


def reproj_navstate(p_wb, R_wb, pw, uv, Rcb, tcb, fx, fy, cx, cy):
    """Visual reprojection through a body NavState and the camera-in-body
    extrinsics: pc = Rcb Rwb^T (pw - pwb) + tcb. PVR increment:
    P <- P + Rwb dP, R <- Rwb Exp(dphi). Returns (r [.., 2],
    J_pvr [.., 2, 9], J_point [.., 2, 3])."""
    Rbw = R_wb.transpose(-1, -2)
    pb = mv(Rbw, pw - p_wb)
    pc = mv(Rcb, pb) + tcb
    r, J_uv_pc = _proj_jac(pc, uv, fx, fy, cx, cy)
    batch = pc.shape[:-1]
    Rcb_b = Rcb.expand(batch + (3, 3))
    J_pc_pw = mm(Rcb_b, Rbw.expand(batch + (3, 3)))
    J_pc_pvr = torch.cat([-Rcb_b, torch.zeros(batch + (3, 3), dtype=pc.dtype, device=pc.device),
                          mm(Rcb_b, lie.hat(pb))], dim=-1)
    return r, -mm(J_uv_pc, J_pc_pvr), -mm(J_uv_pc, J_pc_pw)


def _rows3(*rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def preint_pvr(ns_i_p, ns_i_v, ns_i_R, ns_j_p, ns_j_v, ns_j_R, dbg_i, dba_i,
               M_dP, M_dV, M_dR, M_J_P_bg, M_J_P_ba, M_J_V_bg, M_J_V_ba, M_J_R_bg,
               dTij, gravity):
    """The 9-dof preintegration edge between PVR_i, PVR_j and Bias_i.
    Returns (r [.., 9] as [rP, rV, rPhi], J_pvr_i [.., 9, 9],
    J_pvr_j [.., 9, 9], J_bias_i [.., 9, 6])."""
    dT2 = dTij * dTij
    RiT = ns_i_R.transpose(-1, -2)
    dp_corr = M_dP + mv(M_J_P_bg, dbg_i) + mv(M_J_P_ba, dba_i)
    dv_corr = M_dV + mv(M_J_V_bg, dbg_i) + mv(M_J_V_ba, dba_i)
    pj_pi = ns_j_p - ns_i_p - ns_i_v * dTij[..., None] - 0.5 * gravity * dT2[..., None]
    rP = mv(RiT, pj_pi) - dp_corr
    vj_vi = ns_j_v - ns_i_v - gravity * dTij[..., None]
    rV = mv(RiT, vj_vi) - dv_corr
    dR_bg = lie.so3_exp(mv(M_J_R_bg, dbg_i))
    rPhi = lie.so3_log(mm(mm(M_dR, dR_bg).transpose(-1, -2), mm(RiT, ns_j_R)))
    r = torch.cat([rP, rV, rPhi], dim=-1)

    batch = rP.shape[:-1]
    O = torch.zeros(batch + (3, 3), dtype=rP.dtype, device=rP.device)
    I = _eye(rP, batch)
    JrInv = lie.so3_right_jacobian_inv(rPhi)
    RjT_Ri = mm(ns_j_R.transpose(-1, -2), ns_i_R)
    J_i = _rows3([-I, -RiT * dTij[..., None, None], lie.hat(mv(RiT, pj_pi))],
                 [O, -RiT.expand(batch + (3, 3)), lie.hat(mv(RiT, vj_vi))],
                 [O, O, -mm(JrInv, RjT_Ri)])
    J_j = _rows3([mm(RiT, ns_j_R), O, O], [O, RiT.expand(batch + (3, 3)), O], [O, O, JrInv])
    ExpRPhiT = lie.so3_exp(rPhi).transpose(-1, -2)
    JrBiasCorr = lie.so3_right_jacobian(mv(M_J_R_bg, dbg_i))
    J_rPhi_dbg = -mm(mm(mm(JrInv, ExpRPhiT), JrBiasCorr), M_J_R_bg)
    J_b = _rows3([-M_J_P_bg.expand(batch + (3, 3)), -M_J_P_ba.expand(batch + (3, 3))],
                 [-M_J_V_bg.expand(batch + (3, 3)), -M_J_V_ba.expand(batch + (3, 3))],
                 [J_rPhi_dbg, O])
    return r, J_i, J_j, J_b


def bias_walk(dbg_i, dba_i, dbg_j, dba_j, bg_i, ba_i, bg_j, ba_j):
    """Bias random walk r = (b_j + db_j) - (b_i + db_i). Returns (r [.., 6],
    J_i = -I6, J_j = I6)."""
    rG = (bg_j + dbg_j) - (bg_i + dbg_i)
    rA = (ba_j + dba_j) - (ba_i + dba_i)
    r = torch.cat([rG, rA], dim=-1)
    I6 = _eye(r, r.shape[:-1], 6)
    return r, -I6, I6


def depth_prior(ns_p, depth_meas):
    """Unary pressure-depth prior on z, the signed residual depth - z.
    Returns (r [.., 1], J_pvr [.., 1, 9])."""
    r = (depth_meas - ns_p[..., 2])[..., None]
    J = torch.zeros(r.shape[:-1] + (1, 9), dtype=ns_p.dtype, device=ns_p.device)
    J[..., 0, 2].fill_(-1.0)
    return r, J


def depth_projected(ns_i_p, ns_i_v, ns_i_R, ns_j_p, dbg_i, dba_i, M_dP, M_J_P_bg,
                    M_J_P_ba, dTij, depth_meas, shi, gravity_z=9.81):
    """The paper's ternary pressure factor: the depth measurement
    time-interpolated between states i and j by `shi`, held against state
    j's z and the IMU-propagated z from state i,
      projected = shi (d - z_i) + z_i,
      r = (projected - z_j) + (projected - z_pred).
    Returns (r [.., 1], J_pvr_i [.., 1, 9], J_pvr_j [.., 1, 9],
    J_bias_i [.., 1, 6])."""
    dtype, dev = ns_i_p.dtype, ns_i_p.device
    dT2 = dTij * dTij
    z_i = ns_i_p[..., 2]
    projected = shi * (depth_meas - z_i) + z_i
    dp_corr = M_dP + mv(M_J_P_bg, dbg_i) + mv(M_J_P_ba, dba_i)
    gvec = torch.zeros_like(ns_i_p)
    gvec[..., 2].fill_(gravity_z)
    p_pred = ns_i_p + ns_i_v * dTij[..., None] + gvec * dT2[..., None] + mv(ns_i_R, dp_corr)
    r = ((projected - ns_j_p[..., 2]) + (projected - p_pred[..., 2]))[..., None]

    batch = r.shape[:-1]
    e3 = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    e3[..., 2].fill_(1.0)
    J_i = torch.zeros(batch + (1, 9), dtype=dtype, device=dev)
    J_i[..., 0, 2] = 2.0 * (1.0 - shi) - 1.0
    J_i[..., 0, 5] = -dTij
    J_i[..., 0, 6:9] = mv(lie.hat(mv(ns_i_R, dp_corr)).transpose(-1, -2), e3)
    J_j = torch.zeros(batch + (1, 9), dtype=dtype, device=dev)
    J_j[..., 0, 2].fill_(-1.0)
    Rig = -mm(ns_i_R, M_J_P_bg)
    Ria = -mm(ns_i_R, M_J_P_ba)
    J_b = torch.cat([mv(Rig.transpose(-1, -2), e3), mv(Ria.transpose(-1, -2), e3)],
                    dim=-1)[..., None, :]
    return r, J_i, J_j, J_b


def prior_pvr_bias(ns_p, ns_v, ns_R, dbg, dba, prior_p, prior_v, prior_R, prior_dbg,
                   prior_dba):
    """15-dof marginal prior on [PVR, Bias]: rP = Rp^T (p - p_prior),
    rV = v - v_prior, rPhi = Log(Rp^T R), rb = db - db_prior. Returns
    (r [.., 15], J_pvr [.., 15, 9], J_bias [.., 15, 6])."""
    RpT = prior_R.transpose(-1, -2)
    rPhi = lie.so3_log(mm(RpT, ns_R))
    r = torch.cat([mv(RpT, ns_p - prior_p), ns_v - prior_v, rPhi, dbg - prior_dbg,
                   dba - prior_dba], dim=-1)
    batch = rPhi.shape[:-1]
    O = torch.zeros(batch + (3, 3), dtype=r.dtype, device=r.device)
    RpTR = mm(RpT.expand(batch + (3, 3)), ns_R)
    J_pvr = _rows3([RpTR, O, O], [O, _eye(r, batch), O],
                   [O, O, lie.so3_right_jacobian_inv(rPhi)], [O, O, O], [O, O, O])
    J_bias = torch.cat([torch.zeros(batch + (9, 6), dtype=r.dtype, device=r.device),
                        _eye(r, batch, 6)], dim=-2)
    return r, J_pvr, J_bias


def gyro_bias_edge(R_i, R_j, dR_meas, J_R_bg, bg):
    """Gyro-bias edge of VIO init: r = Log((dR Exp(J bg))^T R_i^T R_j).
    Returns (r [.., 3], J_bg [.., 3, 3])."""
    corr = lie.so3_exp(mv(J_R_bg, bg))
    rmat = mm(mm(dR_meas, corr).transpose(-1, -2), mm(R_i.transpose(-1, -2), R_j))
    r = lie.so3_log(rmat)
    JrInv = lie.so3_right_jacobian_inv(r)
    ExpT = lie.so3_exp(r).transpose(-1, -2)
    Jr_corr = lie.so3_right_jacobian(mv(J_R_bg, bg))
    return r, -mm(mm(mm(JrInv, ExpT), Jr_corr), J_R_bg)


def scale_depth_edge(scale, dz_map, dz_meas):
    """Scale-vs-depth edge of the pressure-scale init:
    r = |dz_meas| - s |dz_map|. Returns (r [.., 1], J_s [.., 1, 1])."""
    r = (torch.abs(dz_meas) - scale * torch.abs(dz_map))[..., None]
    return r, (-torch.abs(dz_map))[..., None, None]
