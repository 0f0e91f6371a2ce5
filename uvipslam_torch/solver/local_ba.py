"""Windowed visual bundle adjustment with a Schur complement on landmarks.

Counterpart of `uvipslam_tpu/solver/local_ba.py::local_ba_se3` and its
helpers: a dense pose Hessian over the window's SE3 poses, landmark
blocks eliminated by Schur complement, the landmark axis compacted to
the observed set, normal equations assembled by one-hot matmuls (dense,
deterministic, the reference's scatter-free layout), and fixed LM
iterations whose accept/reject is a `torch.where`. The VI(P) window BA
(`local_ba_navstate`) belongs to the VIP slice.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.solver import factors
from uvipslam_torch.solver.gn import huber_cost, robust_weight, solve_spd

CHI2_MONO = 5.991
HUBER2_MONO = 5.991


def _schur_step(Hcc, gc, Hpp, gp, W, lam, pt_free):
    """One damped Schur-complement solve. Hcc [C, C], gc [C],
    Hpp [P, 3, 3], gp [P, 3], W [P, C, 3]. Returns (dc [C], dp [P, 3])."""
    dtype, dev = gc.dtype, gc.device
    C = gc.shape[0]
    eyeC = torch.eye(C, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc_d = Hcc + lam * eyeC * torch.clamp(torch.diagonal(Hcc), min=1e-6)[None, :]
    dHpp = eye3[None] * (lam * torch.clamp(
        torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)[..., None])
    Hpp_d = Hpp + dHpp + eye3[None] * 1e-8

    Hpp_inv = lie.inv3x3(Hpp_d)
    Hpp_inv = torch.where(pt_free[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))

    Y = torch.sum(W[..., :, :, None] * Hpp_inv[..., None, :, :], dim=-2)   # [P, C, 3]
    S = Hcc_d - torch.einsum("pck,pdk->cd", Y, W)
    rhs = gc - torch.einsum("pck,pk->c", Y, gp)
    dc = solve_spd(S, -rhs)
    Wdc = torch.sum(W * dc[None, :, None], dim=-2)
    dp = -torch.sum(Hpp_inv * (gp + Wdc)[..., None, :], dim=-1)
    return dc, dp


def _compact_points(obs_pt, obs_mask, pts_w, pt_valid, p_active: int):
    """Shrink the landmark axis to the points actually observed: the
    sorted unique observed slots padded with P to `p_active` entries
    (jnp.unique(..., size, fill_value) without a host sync).

    Returns (ids_c [A], act_ok [A], obs_ptl local obs indices, keep_ok
    extra obs mask, pts_loc [A, 3], ptv_loc [A])."""
    P = pts_w.shape[0]
    dev = pts_w.device
    flat = torch.where(obs_mask, obs_pt, torch.full_like(obs_pt, P)).reshape(-1).long()
    s = torch.sort(flat).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.long(), 0) - 1
    keep = first & (pos < p_active)
    ids = torch.full((p_active + 1,), P, dtype=torch.long, device=dev)
    ids = ids.scatter(0, torch.where(keep, pos, torch.full_like(pos, p_active)), s)[:p_active]
    ids_c = ids.clamp(0, P - 1)
    act_ok = ids < P
    inv = torch.full((P + 1,), p_active - 1, dtype=torch.long, device=dev)
    inv = inv.scatter(0, torch.where(act_ok, ids, torch.full_like(ids, P)),
                      torch.arange(p_active, device=dev))
    obs_ptl = inv[obs_pt.long().clamp(0, P)]
    keep_ok = (ids_c[obs_ptl] == obs_pt.long()) & act_ok[obs_ptl]
    return ids_c, act_ok, obs_ptl, keep_ok, pts_w[ids_c], pt_valid[ids_c] & act_ok


def _assemble_reproj(J_pose, J_pt, r, w, obs_kf, obs_pt, K: int, P: int, oh=None):
    """Reprojection normal-equation blocks. Grid layout: J_pose
    [K, F, 2, D], obs_pt [K, F] (row k = keyframe slot k's observations);
    flat layout: [O, ...]. Invalid observations carry w == 0.
    Returns (Hk [K, D, D], gk [K, D], Hpp [P, 3, 3], gp [P, 3],
    Wp [P, K, D, 3])."""
    dtype = r.dtype
    JW = J_pose * w[..., None, None]
    JptW = J_pt * w[..., None, None]
    D = J_pose.shape[-1]
    Hpb = torch.sum(JptW[..., :, :, None] * J_pt[..., :, None, :], dim=-3)
    gpb = torch.sum(JptW * r[..., None], dim=-2)
    Wb = torch.sum(JW[..., :, :, None] * J_pt[..., :, None, :], dim=-3)
    if obs_pt.dim() == 2:
        K_, F_ = obs_pt.shape
        Hk = torch.einsum("kfmi,kfmj->kij", JW, J_pose)
        gk = torch.einsum("kfmi,kfm->ki", JW, r)
        if oh is None:
            oh = (obs_pt[..., None] == torch.arange(P, device=r.device)).to(dtype)
        vals = torch.cat([Hpb.reshape(K_, F_, 9), gpb, Wb.reshape(K_, F_, D * 3)], -1)
        out = torch.bmm(oh.transpose(1, 2), vals).permute(1, 0, 2)   # [P, K, c]
        Hpp = out[..., :9].sum(1).reshape(P, 3, 3)
        gp = out[..., 9:12].sum(1)
        Wp = out[..., 12:].reshape(P, K_, D, 3)
    else:
        ar_k = torch.arange(K, device=r.device)
        ar_p = torch.arange(P, device=r.device)
        oh_k = (obs_kf[:, None] == ar_k).to(dtype)
        oh_p = (obs_pt[:, None] == ar_p).to(dtype)
        Hb = torch.sum(JW[..., :, :, None] * J_pose[..., :, None, :], dim=-3)
        gb = torch.sum(JW * r[..., None], dim=-2)
        Hk = torch.einsum("ok,oij->kij", oh_k, Hb)
        gk = torch.einsum("ok,oi->ki", oh_k, gb)
        Hpp = torch.einsum("op,oij->pij", oh_p, Hpb)
        gp = torch.einsum("op,oi->pi", oh_p, gpb)
        Wk = torch.einsum("ok,oij->okij", oh_k, Wb)
        Wp = torch.einsum("op,okij->pkij", oh_p, Wk)
    return Hk, gk, Hpp, gp, Wp


def _block_diag_embed(Hk, K: int, S: int, off: int = 0):
    """Per-KF blocks [K, D, D] -> [K*S, K*S] block diagonal at offset
    `off` inside each S-wide pose slot."""
    D = Hk.shape[-1]
    eyeK = torch.eye(K, dtype=Hk.dtype, device=Hk.device)
    H4 = Hk[:, :, None, :] * eyeK[:, None, :, None]
    H4 = torch.nn.functional.pad(H4, (off, S - D - off, 0, 0, off, S - D - off, 0, 0))
    return H4.reshape(K * S, K * S)


def local_ba_se3(kf_R, kf_t, kf_fixed, kf_valid, pts_w, pt_valid, obs_kf,
                 obs_pt, obs_uv, obs_inv_sigma2, obs_mask, fx, fy, cx, cy,
                 n_iters: int = 5, rounds: int = 2, p_active: int = 2048):
    """Visual-only window BA over SE3 camera poses Tcw.
    Returns (kf_R', kf_t', pts_w', obs_inlier)."""
    dtype, dev = pts_w.dtype, pts_w.device
    K = kf_R.shape[0]
    P_full = pts_w.shape[0]
    C = K * 6
    free_kf = kf_valid & ~kf_fixed
    obs_in = obs_mask

    P = min(P_full, p_active if p_active else obs_pt.numel())
    pts_full = pts_w
    ids_c, act_ok, obs_pt, keep_ok, pts_w, pt_valid = _compact_points(
        obs_pt, obs_mask, pts_w, pt_valid, P)
    obs_in = obs_in & keep_ok
    obs_mask = obs_mask & keep_ok
    obs_kf = obs_kf.long()
    oh_grid = None
    if obs_pt.dim() == 2:
        oh_grid = (obs_pt[..., None] == torch.arange(P, device=dev)).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def build(state, obs_inlier, robust, pt_free):
        R, t, pts = state
        r, J_pose, J_pt = factors.reproj_se3(
            R[obs_kf], t[obs_kf], pts[obs_pt], obs_uv, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        wo = robust_weight(chi2, HUBER2_MONO, robust)
        wo = wo * obs_inv_sigma2 * obs_inlier.to(dtype)
        J_pose = J_pose * free_kf[obs_kf].to(dtype)[..., None, None]
        J_pt = J_pt * pt_free[obs_pt].to(dtype)[..., None, None]

        Hk, gk, Hpp, gp, Wp = _assemble_reproj(
            J_pose, J_pt, r, wo, obs_kf, obs_pt, K, P, oh=oh_grid)
        Hcc = _block_diag_embed(Hk, K, 6)
        gc = gk.reshape(C)
        W = Wp.reshape(P, C, 3)
        Hcc = Hcc + torch.diag(torch.repeat_interleave(~free_kf, 6).to(dtype))
        Hpp = Hpp + eye3[None] * (~pt_free).to(dtype)[:, None, None]
        total = torch.sum(torch.where(obs_inlier, huber_cost(chi2, HUBER2_MONO),
                                      torch.zeros_like(chi2)))
        return (Hcc, gc, Hpp, gp, W), total

    def retract(state, dc, dp):
        R, t, pts = state
        dR, dt = lie.se3_exp(dc.reshape(K, 6))
        return (lie.normalize_rotation(mm(dR, R)), mv(dR, t) + dt, pts + dp)

    def lm_rounds(state, obs_inlier, robust, iters, pt_free):
        eqs, chi2 = build(state, obs_inlier, robust, pt_free)
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        st = state
        for _ in range(iters):
            dc, dp = _schur_step(*eqs, lam, pt_free)
            st_new = retract(st, dc, dp)
            eqs_new, chi2_new = build(st_new, obs_inlier, robust, pt_free)
            accept = chi2_new < chi2

            def sel(a, b):
                return torch.where(accept, b, a)

            st = tree_map(sel, st, st_new)
            eqs = tree_map(sel, eqs, eqs_new)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            chi2 = torch.where(accept, chi2_new, chi2)
        return st

    state = (kf_R, kf_t, pts_w)
    for rd in range(rounds):
        robust = 1.0 if rd < rounds - 1 else 0.0
        n_obs = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
            0, obs_pt.reshape(-1), obs_in.reshape(-1).to(torch.int32))
        pt_free = pt_valid & (n_obs >= 2)
        state = lm_rounds(state, obs_in, robust, n_iters, pt_free)
        R, t, pts = state
        r, _, _ = factors.reproj_se3(R[obs_kf], t[obs_kf], pts[obs_pt], obs_uv,
                                     fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        pc_z = (mv(R[obs_kf], pts[obs_pt]) + t[obs_kf])[..., 2]
        obs_in = obs_mask & (chi2 <= CHI2_MONO) & (pc_z > 0)

    R, t, pts = state
    # scatter the optimized active points back into the full table; the
    # padding slots write to a spare row that is dropped
    pts_out = torch.cat([pts_full, pts_full[:1]], dim=0)
    pts_out[torch.where(act_ok, ids_c, torch.full_like(ids_c, P_full))] = pts
    return R, t, pts_out[:P_full], obs_in
