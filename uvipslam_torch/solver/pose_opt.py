"""Pose-only optimizations of the tracking solves.

Counterpart of `uvipslam_tpu/solver/pose_opt.py`:
`pose_optimization_se3` (motion-only BA: LM rounds with an annealed
Huber kernel and chi2 re-gating between rounds), `pose_optimization_vi`
(the 15-dof VI(P) solve against a fixed reference state) and
`pose_optimization_vi2` (the 30-dof two-state solve whose Schur marginal
is the next frame's prior). The round schedule is host-side, so the
reference's scans over rounds are Python loops here.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.state import NavState
from uvipslam_torch.solver import factors
from uvipslam_torch.solver.gn import (accumulate_normal_eqs, huber_cost, huber_weight,
                                      inv_spd_scaled, lm_solve, robust_weight)

CHI2_MONO = 5.991
HUBER2_MONO = 5.991
HUBER2_PVR = 21.666
HUBER2_BIAS = 16.812
HUBER2_PRIOR = 30.5779
HUBER2_DEPTH = 16.812


def pose_optimization_se3(Rcw0, tcw0, pts_w, uvs, valid, inv_sigma2,
                          fx, fy, cx, cy, rounds: int = 4, iters: int = 10):
    """Motion-only BA of one camera pose against fixed map points.
    Returns (Rcw, tcw, inlier [N] bool, n_inliers). Early rounds use a
    widened kernel and a loose 4x gate; the last round tightens both to
    the reference's values."""
    dtype = tcw0.dtype
    inlier = valid

    def make_residual_fn(inlier_mask, delta2):
        def residual_fn(x):
            Rcw, tcw = x
            r, Jp, _ = factors.reproj_se3(Rcw, tcw, pts_w, uvs, fx, fy, cx, cy)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = huber_weight(chi2, delta2)
            w = w * inv_sigma2 * inlier_mask.to(dtype)
            H, g = accumulate_normal_eqs(Jp, r, w)
            total = torch.sum(torch.where(inlier_mask, huber_cost(chi2, delta2),
                                          torch.zeros_like(chi2)))
            return H, g, total
        return residual_fn

    def retract(x, dx):
        Rcw, tcw = x
        dR, dt = lie.se3_exp(dx)
        return lie.normalize_rotation(mm(dR, Rcw)), mv(dR, tcw) + dt

    delta_scale = (16.0, 4.0, 1.0, 1.0)
    x = (Rcw0, tcw0)
    for rd in range(rounds):
        last = rd == rounds - 1
        d2 = float(torch.tensor(
            HUBER2_MONO * (1.0 if last else delta_scale[min(rd, len(delta_scale) - 1)]),
            dtype=dtype))
        gate = float(torch.tensor(CHI2_MONO if last else 4.0 * CHI2_MONO, dtype=dtype))
        x, _ = lm_solve(x, make_residual_fn(inlier, d2), retract, n_iters=iters)
        Rcw, tcw = x
        r, _, _ = factors.reproj_se3(Rcw, tcw, pts_w, uvs, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        pc_z = (mv(Rcw, pts_w) + tcw)[..., 2]
        inlier = valid & (chi2 <= gate) & (pc_z > 0)
    return x[0], x[1], inlier, torch.sum(inlier)


def _bias_info(dTij, gyr_bias_rw2, acc_bias_rw2):
    """Diagonal information of the bias random walk over dTij."""
    g = torch.clamp(gyr_bias_rw2 * dTij, min=1e-12).reshape(1).expand(3)
    a = torch.clamp(acc_bias_rw2 * dTij, min=1e-12).reshape(1).expand(3)
    return torch.diag(torch.cat([1.0 / g, 1.0 / a]))


def _place(J, n, off):
    """[m, k] block as columns off:off+k of an [m, n] Jacobian."""
    return torch.nn.functional.pad(J, (off, n - off - J.shape[-1]))


def _dense_edge(J, r, info, w):
    """(J^T w info J, J^T w info r) of one dense edge."""
    JW = (J.T * w) @ info
    return JW @ J, JW @ r


def _reproj_inliers_ns(ns, pts_w, uvs, valid, inv_sigma2, Rcb, tcb, fx, fy, cx, cy):
    r, _, _ = factors.reproj_navstate(ns.p, ns.R, pts_w, uvs, Rcb, tcb, fx, fy, cx, cy)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    pc_z = (mv(Rcb, mv(ns.R.transpose(-1, -2), pts_w - ns.p)) + tcb)[..., 2]
    return valid & (chi2 <= CHI2_MONO) & (pc_z > 0)


def _reproj_eqs(ns, pts_w, uvs, inlier_mask, inv_sigma2, robust, Rcb, tcb, fx, fy, cx, cy):
    r, Jp, _ = factors.reproj_navstate(ns.p, ns.R, pts_w, uvs, Rcb, tcb, fx, fy, cx, cy)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w = robust_weight(chi2, HUBER2_MONO, robust) * inv_sigma2 * inlier_mask.to(r.dtype)
    H, g = accumulate_normal_eqs(Jp, r, w)
    total = torch.sum(torch.where(inlier_mask, huber_cost(chi2, HUBER2_MONO),
                                  torch.zeros_like(chi2)))
    return H, g, total


def pose_optimization_vi(ns0: NavState, ns_ref: NavState, preint, pts_w, uvs, valid,
                         inv_sigma2, gravity, Rcb, tcb, fx, fy, cx, cy, gyr_bias_rw2,
                         acc_bias_rw2, prior_ns: NavState | None = None, prior_info=None,
                         depth_meas=None, depth_info=None, rounds: int = 4, iters: int = 10,
                         use_prior: bool = False, use_depth: bool = False):
    """15-dof VI(P) tracking solve of the current frame's [PVR, Bias]
    against a fixed reference state: N reprojections, the preintegration
    edge, the bias random walk, an optional 15-dof marginal prior and an
    optional pressure-depth prior. Returns (ns_opt, inlier [N],
    n_inliers, H_post [15, 15] the posterior information)."""
    dtype, dev = ns0.p.dtype, ns0.p.device
    dTij = preint.dt
    info_pvr = inv_spd_scaled(preint.cov + torch.eye(9, dtype=dtype, device=dev) * 1e-8)
    info_bias = _bias_info(dTij, gyr_bias_rw2, acc_bias_rw2)

    def unpack(x):
        return NavState(p=x[0], v=x[1], R=x[2], bg=ns0.bg, ba=ns0.ba, dbg=x[3], dba=x[4])

    def pack(ns):
        return (ns.p, ns.v, ns.R, ns.dbg, ns.dba)

    def residual_fn_builder(inlier_mask, robust):
        def residual_fn(x):
            ns = unpack(x)
            Hv, gv, total = _reproj_eqs(ns, pts_w, uvs, inlier_mask, inv_sigma2, robust,
                                        Rcb, tcb, fx, fy, cx, cy)
            H = torch.nn.functional.pad(Hv, (0, 6, 0, 6))
            g = torch.nn.functional.pad(gv, (0, 6))
            # preintegration edge to the fixed reference state: only the
            # current PVR moves
            rp, _, J_j, _ = factors.preint_pvr(
                ns_ref.p, ns_ref.v, ns_ref.R, ns.p, ns.v, ns.R, ns_ref.dbg, ns_ref.dba,
                preint.dP, preint.dV, preint.dR, preint.J_P_bg, preint.J_P_ba, preint.J_V_bg,
                preint.J_V_ba, preint.J_R_bg, dTij, gravity)
            chi2_p = rp @ info_pvr @ rp
            Hp, gp = _dense_edge(_place(J_j, 15, 0), rp, info_pvr,
                                 robust_weight(chi2_p, HUBER2_PVR, robust))
            H, g, total = H + Hp, g + gp, total + huber_cost(chi2_p, HUBER2_PVR)

            rb, _, J_bj = factors.bias_walk(ns_ref.dbg, ns_ref.dba, ns.dbg, ns.dba,
                                            ns_ref.bg, ns_ref.ba, ns.bg, ns.ba)
            chi2_b = rb @ info_bias @ rb
            Hb, gb = _dense_edge(_place(J_bj, 15, 9), rb, info_bias,
                                 robust_weight(chi2_b, HUBER2_BIAS, robust))
            H, g, total = H + Hb, g + gb, total + huber_cost(chi2_b, HUBER2_BIAS)

            if use_prior:
                rpr, J_pvr, J_bias = factors.prior_pvr_bias(
                    ns.p, ns.v, ns.R, ns.dbg, ns.dba, prior_ns.p, prior_ns.v, prior_ns.R,
                    prior_ns.dbg, prior_ns.dba)
                chi2_pr = rpr @ prior_info @ rpr
                Hr, gr = _dense_edge(torch.cat([J_pvr, J_bias], -1), rpr, prior_info,
                                     robust_weight(chi2_pr, HUBER2_PRIOR, robust))
                H, g, total = H + Hr, g + gr, total + huber_cost(chi2_pr, HUBER2_PRIOR)

            if use_depth:
                rd, Jd = factors.depth_prior(ns.p, depth_meas)
                chi2_d = (rd[0] ** 2) * depth_info
                wd = robust_weight(chi2_d, HUBER2_DEPTH, robust) * depth_info
                Jdf = _place(Jd, 15, 0)
                H = H + (Jdf.T * wd) @ Jdf
                g = g + (Jdf.T * wd) @ rd
                total = total + huber_cost(chi2_d, HUBER2_DEPTH)
            return H, g, total
        return residual_fn

    def retract(x, dx):
        return pack(unpack(x).inc_small_pvr(dx[0:9]).inc_small_bias(dx[9:15]))

    x, inlier = pack(ns0), valid
    for rd in range(rounds):
        robust = 1.0 if rd < rounds - 1 else 0.0
        x, _ = lm_solve(x, residual_fn_builder(inlier, robust), retract, n_iters=iters)
        inlier = _reproj_inliers_ns(unpack(x), pts_w, uvs, valid, inv_sigma2, Rcb, tcb,
                                    fx, fy, cx, cy)
    H_post, _, _ = residual_fn_builder(inlier, 0.0)(x)
    return unpack(x), inlier, torch.sum(inlier), H_post


def pose_optimization_vi2(ns_prev: NavState, ns_cur: NavState, prior_info, preint, pts_w,
                          uvs, valid, inv_sigma2, gravity, Rcb, tcb, fx, fy, cx, cy,
                          gyr_bias_rw2, acc_bias_rw2, depth_meas=None, depth_info=None,
                          depth_shi=None, rounds: int = 3, iters: int = 8,
                          use_depth: bool = False):
    """Frame-to-frame marginalized VI(P) solve over both the previous and
    the current [PVR, Bias] (30 dof): the previous state's 15-dof marginal
    prior (its only vision information), the current frame's
    reprojections, the preintegration and bias edges between the two, and
    the paper's depth-projected ternary. Returns (ns_cur_opt, inlier [N],
    n_inliers, H_marg [15, 15]), H_marg being the Schur marginal of the
    current state, the next frame's prior."""
    dtype, dev = ns_cur.p.dtype, ns_cur.p.device
    dTij = preint.dt
    info_pvr = inv_spd_scaled(preint.cov + torch.eye(9, dtype=dtype, device=dev) * 1e-8)
    info_bias = _bias_info(dTij, gyr_bias_rw2, acc_bias_rw2)
    shi = torch.ones((), dtype=dtype, device=dev) if depth_shi is None else depth_shi

    # layout: prev PVR 0:9, prev bias 9:15, cur PVR 15:24, cur bias 24:30
    def unpack(x):
        pp, pv, pR, pdbg, pdba, cp, cv, cR, cdbg, cdba = x
        return (NavState(p=pp, v=pv, R=pR, bg=ns_prev.bg, ba=ns_prev.ba, dbg=pdbg, dba=pdba),
                NavState(p=cp, v=cv, R=cR, bg=ns_cur.bg, ba=ns_cur.ba, dbg=cdbg, dba=cdba))

    def pack(nsp, nsc):
        return (nsp.p, nsp.v, nsp.R, nsp.dbg, nsp.dba, nsc.p, nsc.v, nsc.R, nsc.dbg, nsc.dba)

    def residual_fn_builder(inl_cur, robust):
        def residual_fn(x):
            nsp, nsc = unpack(x)
            Hv, gv, total = _reproj_eqs(nsc, pts_w, uvs, inl_cur, inv_sigma2, robust,
                                        Rcb, tcb, fx, fy, cx, cy)
            H = torch.nn.functional.pad(Hv, (15, 6, 15, 6))
            g = torch.nn.functional.pad(gv, (15, 6))

            rpre, J_i, J_j, J_b = factors.preint_pvr(
                nsp.p, nsp.v, nsp.R, nsc.p, nsc.v, nsc.R, nsp.dbg, nsp.dba,
                preint.dP, preint.dV, preint.dR, preint.J_P_bg, preint.J_P_ba, preint.J_V_bg,
                preint.J_V_ba, preint.J_R_bg, dTij, gravity)
            chi2_pre = rpre @ info_pvr @ rpre
            Jfull = torch.cat([J_i, J_b, J_j, torch.zeros((9, 6), dtype=dtype, device=dev)], -1)
            Hp, gp = _dense_edge(Jfull, rpre, info_pvr,
                                 robust_weight(chi2_pre, HUBER2_PVR, robust))
            H, g, total = H + Hp, g + gp, total + huber_cost(chi2_pre, HUBER2_PVR)

            rb, J_bi, J_bj = factors.bias_walk(nsp.dbg, nsp.dba, nsc.dbg, nsc.dba,
                                               nsp.bg, nsp.ba, nsc.bg, nsc.ba)
            chi2_b = rb @ info_bias @ rb
            Jbf = _place(J_bi, 30, 9) + _place(J_bj, 30, 24)
            Hb, gb = _dense_edge(Jbf, rb, info_bias, robust_weight(chi2_b, HUBER2_BIAS, robust))
            H, g, total = H + Hb, g + gb, total + huber_cost(chi2_b, HUBER2_BIAS)

            rpr, J_pvr, J_bias = factors.prior_pvr_bias(
                nsp.p, nsp.v, nsp.R, nsp.dbg, nsp.dba, ns_prev.p, ns_prev.v, ns_prev.R,
                ns_prev.dbg, ns_prev.dba)
            chi2_pr = rpr @ prior_info @ rpr
            Hr, gr = _dense_edge(_place(torch.cat([J_pvr, J_bias], -1), 30, 0), rpr, prior_info,
                                 robust_weight(chi2_pr, HUBER2_PRIOR, robust))
            H, g, total = H + Hr, g + gr, total + huber_cost(chi2_pr, HUBER2_PRIOR)

            if use_depth:
                rd, Jd_i, Jd_j, Jd_b = factors.depth_projected(
                    nsp.p, nsp.v, nsp.R, nsc.p, nsp.dbg, nsp.dba, preint.dP, preint.J_P_bg,
                    preint.J_P_ba, dTij, depth_meas, shi, gravity_z=gravity[2])
                chi2_d = (rd[0] ** 2) * depth_info
                wd = robust_weight(chi2_d, HUBER2_DEPTH, robust) * depth_info
                Jdf = torch.cat([Jd_i, Jd_b, Jd_j, torch.zeros((1, 6), dtype=dtype, device=dev)],
                                -1)
                H = H + (Jdf.T * wd) @ Jdf
                g = g + (Jdf.T * wd) @ rd
                total = total + huber_cost(chi2_d, HUBER2_DEPTH)
            return H, g, total
        return residual_fn

    def retract(x, dx):
        nsp, nsc = unpack(x)
        return pack(nsp.inc_small_pvr(dx[0:9]).inc_small_bias(dx[9:15]),
                    nsc.inc_small_pvr(dx[15:24]).inc_small_bias(dx[24:30]))

    x, inlier = pack(ns_prev, ns_cur), valid
    for rd in range(rounds):
        robust = 1.0 if rd < rounds - 1 else 0.0
        x, _ = lm_solve(x, residual_fn_builder(inlier, robust), retract, n_iters=iters)
        inlier = _reproj_inliers_ns(unpack(x)[1], pts_w, uvs, valid, inv_sigma2, Rcb, tcb,
                                    fx, fy, cx, cy)
    _, nsc = unpack(x)
    # Schur marginal of the current state: H_cc - H_cp H_pp^-1 H_pc
    H_full, _, _ = residual_fn_builder(inlier, 0.0)(x)
    Hpp = H_full[0:15, 0:15] + torch.eye(15, dtype=dtype, device=dev) * 1e-6
    Hcp = H_full[15:30, 0:15]
    H_marg = H_full[15:30, 15:30] - Hcp @ inv_spd_scaled(Hpp) @ Hcp.T
    return nsc, inlier, torch.sum(inlier), 0.5 * (H_marg + H_marg.T)
