"""Windowed bundle adjustment with a Schur complement on landmarks.

Counterpart of `uvipslam_tpu/solver/local_ba.py`: `local_ba_se3` (the
visual window BA over SE3 camera poses) and `local_ba_navstate` (the
VI(P) window BA over 15-dof keyframe states with preintegration, bias
and pressure edges). Both keep a dense pose Hessian, eliminate the
landmark blocks by Schur complement over the landmark axis compacted to
the observed set, assemble the normal equations by one-hot matmuls
(dense and deterministic, the reference's scatter-free layout), and run
fixed LM iterations whose accept/reject is a `torch.where`: the
reference's `lax.scan`, here a `scan` argument (`utils.graphs.Segments.
scan`, one captured graph per iteration on the card; by default the plain
loop). The rounds stay a Python loop (their `robust` is a key value).
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.solver import factors
from uvipslam_torch.solver.gn import huber_cost, inv_spd_scaled, robust_weight, solve_spd
from uvipslam_torch.utils.graphs import plain_scan

CHI2_MONO = 5.991
HUBER2_MONO = 5.991
HUBER2_PVR = 21.666
HUBER2_BIAS = 16.812
HUBER2_DEPTH = 16.812


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


def _lm(scan, key: tuple, make, c: dict, state, obs_inlier, robust: float, iters: int,
        pt_free, dtype):
    """`iters` Levenberg-Marquardt iterations of a window BA from `state`,
    whose (build, retract) = make(c) read the problem's tensors from `c`:
    the accept/reject of each step is a `torch.where`, so the iterations
    are the reference's `lax.scan` and run through `scan` (the plain loop
    when None), `robust` joining the key. Returns (state, the objective
    at the start, at the end)."""
    build, _ = make(c)
    eqs, chi2 = build(state, obs_inlier, robust, pt_free)
    lam = torch.full((), 1e-4, dtype=dtype, device=chi2.device)

    def body(carry, _, c, obs_inlier, pt_free):
        build, retract = make(c)
        st, eqs, lam, chi2 = carry
        dc, dp = _schur_step(*eqs, lam, pt_free)
        st_new = retract(st, dc, dp)
        eqs_new, chi2_new = build(st_new, obs_inlier, robust, pt_free)
        accept = chi2_new < chi2

        def sel(a, b):
            return torch.where(accept, b, a)

        return (tree_map(sel, st, st_new), tree_map(sel, eqs, eqs_new),
                torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6),
                torch.where(accept, chi2_new, chi2))

    st, _, _, chi2_end = (scan or plain_scan)(key + (robust,), body, (state, eqs, lam, chi2),
                                              length=iters, consts=(c, obs_inlier, pt_free))
    return st, chi2, chi2_end


def _se3_problem(c: dict, fx, fy, cx, cy):
    """The SE3 window BA's normal equations (`build`) and retraction over
    the tensors of `c`."""
    obs_kf, obs_pt, obs_uv = c["obs_kf"], c["obs_pt"], c["obs_uv"]
    obs_inv_sigma2, free_kf, eye3 = c["obs_inv_sigma2"], c["free_kf"], c["eye3"]
    dtype = eye3.dtype
    K = free_kf.shape[0]
    C = K * 6

    def build(state, obs_inlier, robust, pt_free):
        R, t, pts = state
        P = pts.shape[0]
        r, J_pose, J_pt = factors.reproj_se3(
            R[obs_kf], t[obs_kf], pts[obs_pt], obs_uv, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        wo = robust_weight(chi2, HUBER2_MONO, robust)
        wo = wo * obs_inv_sigma2 * obs_inlier.to(dtype)
        J_pose = J_pose * free_kf[obs_kf].to(dtype)[..., None, None]
        J_pt = J_pt * pt_free[obs_pt].to(dtype)[..., None, None]

        Hk, gk, Hpp, gp, Wp = _assemble_reproj(
            J_pose, J_pt, r, wo, obs_kf, obs_pt, K, P, oh=c["oh_grid"])
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

    return build, retract


def local_ba_se3(kf_R, kf_t, kf_fixed, kf_valid, pts_w, pt_valid, obs_kf,
                 obs_pt, obs_uv, obs_inv_sigma2, obs_mask, fx, fy, cx, cy,
                 n_iters: int = 5, rounds: int = 2, p_active: int = 2048, scan=None):
    """Visual-only window BA over SE3 camera poses Tcw. `scan` runs each
    round's LM iterations (the plain loop when None).
    Returns (kf_R', kf_t', pts_w', obs_inlier)."""
    dtype, dev = pts_w.dtype, pts_w.device
    P_full = pts_w.shape[0]
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
    c = dict(obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=obs_uv, obs_inv_sigma2=obs_inv_sigma2,
             free_kf=free_kf, oh_grid=oh_grid, eye3=torch.eye(3, dtype=dtype, device=dev))

    def make(c):
        return _se3_problem(c, fx, fy, cx, cy)

    state = (kf_R, kf_t, pts_w)
    for rd in range(rounds):
        robust = 1.0 if rd < rounds - 1 else 0.0
        n_obs = torch.zeros((P,), dtype=torch.int32, device=dev).index_add(
            0, obs_pt.reshape(-1), obs_in.reshape(-1).to(torch.int32))
        pt_free = pt_valid & (n_obs >= 2)
        state, _, _ = _lm(scan, ("ba_se3", fx, fy, cx, cy), make, c, state, obs_in, robust,
                          n_iters, pt_free, dtype)
        R, t, pts = state
        r, _, _ = factors.reproj_se3(R[obs_kf], t[obs_kf], pts[obs_pt], obs_uv,
                                     fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        pc_z = (mv(R[obs_kf], pts[obs_pt]) + t[obs_kf])[..., 2]
        obs_in = obs_mask & (chi2 <= CHI2_MONO) & (pc_z > 0)

    R, t, pts = state
    return R, t, _scatter_points(pts_full, pts, ids_c, act_ok), obs_in


def _scatter_points(pts_full, pts, ids_c, act_ok):
    """Write the optimized active points back into the full table; the
    padding slots write to a spare row that is dropped."""
    P_full = pts_full.shape[0]
    out = torch.cat([pts_full, pts_full[:1]], dim=0)
    out[torch.where(act_ok, ids_c, torch.full_like(ids_c, P_full))] = pts
    return out[:P_full]


def _reproj_blocks_navstate(kf_ns, pts_w, obs_kf, obs_pt, obs_uv, Rcb, tcb, fx, fy, cx, cy):
    """Per-observation residuals and Jacobians through the gathered
    keyframe states."""
    return factors.reproj_navstate(kf_ns.p[obs_kf], kf_ns.R[obs_kf], pts_w[obs_pt], obs_uv,
                                   Rcb, tcb, fx, fy, cx, cy)


def _navstate_problem(c: dict, fx, fy, cx, cy):
    """The VI(P) window BA's normal equations (`build`) and retraction
    over the tensors of `c`."""
    obs_kf, obs_pt, obs_uv, obs_inv_sigma2 = c["obs_kf"], c["obs_pt"], c["obs_uv"], \
        c["obs_inv_sigma2"]
    pre, pre_i, pre_j, pre_mask = c["pre"], c["pre_i"], c["pre_j"], c["pre_mask"]
    free_kf, fk, eyeK, oh_i, oh_j = c["free_kf"], c["fk"], c["eyeK"], c["oh_i"], c["oh_j"]
    info_pvr, rw_diag, pre_mf = c["info_pvr"], c["rw_diag"], c["pre_mf"]
    gravity, Rcb, tcb = c["gravity"], c["Rcb"], c["tcb"]
    depth_meas, depth_info = c["depth_meas"], c["depth_info"]
    dtype, dev = eyeK.dtype, eyeK.device
    K = eyeK.shape[0]
    C = K * 15
    dT = pre.dt

    def add_cross(Hcc4, oha, blk, ohb, offa, offb):
        da, db = blk.shape[-2], blk.shape[-1]
        Hcc4[:, offa:offa + da, :, offb:offb + db] += torch.einsum("ea,eij,eb->aibj", oha,
                                                                   blk, ohb)

    def edge_terms(kf, robust):
        nsi = tree_map(lambda a: a[pre_i], kf)
        nsj = tree_map(lambda a: a[pre_j], kf)
        rp, J_i, J_j, J_b = factors.preint_pvr(
            nsi.p, nsi.v, nsi.R, nsj.p, nsj.v, nsj.R, nsi.dbg, nsi.dba, pre.dP, pre.dV,
            pre.dR, pre.J_P_bg, pre.J_P_ba, pre.J_V_bg, pre.J_V_ba, pre.J_R_bg, dT, gravity)
        chi2p = torch.einsum("ei,eij,ej->e", rp, info_pvr, rp)
        wp = robust_weight(chi2p, HUBER2_PVR, robust) * pre_mf

        rb, J_bi, J_bj = factors.bias_walk(nsi.dbg, nsi.dba, nsj.dbg, nsj.dba, nsi.bg, nsi.ba,
                                           nsj.bg, nsj.ba)
        chi2b = torch.sum(rb * rb * rw_diag, dim=-1)
        wb = robust_weight(chi2b, HUBER2_BIAS, robust) * pre_mf

        # the paper's pressure ternary along the preintegration pairs, the
        # sample taken at keyframe j's time (shi = 1)
        rdp, Jdp_i, Jdp_j, Jdp_b = factors.depth_projected(
            nsi.p, nsi.v, nsi.R, nsj.p, nsi.dbg, nsi.dba, pre.dP, pre.J_P_bg, pre.J_P_ba, dT,
            depth_meas[pre_j], torch.ones_like(dT), gravity_z=gravity[2])
        dp_info = depth_info[pre_j]
        dp_mask = pre_mask & (dp_info > 0)
        chi2dp = rdp[:, 0] ** 2 * dp_info
        wdp = robust_weight(chi2dp, HUBER2_DEPTH, robust) * dp_info * dp_mask.to(dtype)

        # unary z prior only where no active ternary covers the keyframe
        covered = torch.zeros(K, dtype=torch.uint8, device=dev).scatter_reduce(
            0, pre_j, dp_mask.to(torch.uint8), reduce="amax").bool()
        rd, Jd = factors.depth_prior(kf.p, depth_meas)
        chi2d = rd[:, 0] ** 2 * depth_info
        wd = robust_weight(chi2d, HUBER2_DEPTH, robust) * depth_info * (
            free_kf & ~covered).to(dtype)
        return ((rp, J_i, J_j, J_b, chi2p, wp), (rb, J_bi, J_bj, chi2b, wb),
                (rd, Jd, chi2d, wd), (rdp, Jdp_i, Jdp_j, Jdp_b, chi2dp, wdp, dp_mask))

    def zero_where(mask, x):
        return torch.where(mask, x, torch.zeros_like(x))

    def build(state, obs_inlier, robust, pt_free):
        kf, pts = state
        P = pts.shape[0]
        r, J_pvr, J_pt = _reproj_blocks_navstate(kf, pts, obs_kf, obs_pt, obs_uv, Rcb, tcb,
                                                 fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        wo = robust_weight(chi2, HUBER2_MONO, robust) * obs_inv_sigma2 * obs_inlier.to(dtype)
        J_pvr = J_pvr * fk[obs_kf][..., None, None]
        J_pt = J_pt * pt_free[obs_pt].to(dtype)[..., None, None]
        Hk, gk, Hpp, gp, Wp = _assemble_reproj(J_pvr, J_pt, r, wo, obs_kf, obs_pt, K, P,
                                               oh=c["oh_grid"])
        Hcc4 = (torch.nn.functional.pad(Hk, (0, 6, 0, 6))[:, :, None, :]
                * eyeK[:, None, :, None])                                   # [K, 15, K, 15]
        gc4 = torch.nn.functional.pad(gk, (0, 6))                            # [K, 15]
        W = torch.nn.functional.pad(Wp, (0, 0, 0, 6)).reshape(P, C, 3)
        total = torch.sum(zero_where(obs_inlier, huber_cost(chi2, HUBER2_MONO)))

        (rp, J_i, J_j, J_b, chi2p, wp), (rb, J_bi, J_bj, chi2b, wb), (rd, Jd, chi2d, wd), \
            (rdp, Jdp_i, Jdp_j, Jdp_b, chi2dp, wdp, dp_mask) = edge_terms(kf, robust)

        fi = fk[pre_i][:, None, None]
        fj = fk[pre_j][:, None, None]
        WJ = info_pvr * wp[:, None, None]
        blocks = ((J_i * fi, oh_i, 0), (J_j * fj, oh_j, 0), (J_b * fi, oh_i, 9))
        for Ja, oha, offa in blocks:
            for Jb_, ohb, offb in blocks:
                add_cross(Hcc4, oha, torch.einsum("emi,emn,enj->eij", Ja, WJ, Jb_), ohb,
                          offa, offb)
            gblk = torch.einsum("emi,emn,en->ei", Ja, WJ, rp)
            gc4[:, offa:offa + Ja.shape[-1]] += oha.T @ gblk

        WJb = rw_diag * wb[:, None]
        bias_blocks = ((J_bi * fi, oh_i), (J_bj * fj, oh_j))
        for Ja, oha in bias_blocks:
            for Jb_, ohb in bias_blocks:
                add_cross(Hcc4, oha, torch.einsum("emi,em,emj->eij", Ja, WJb, Jb_), ohb, 9, 9)
            gc4[:, 9:15] += oha.T @ torch.einsum("emi,em,em->ei", Ja, WJb, rb)

        dp_blocks = ((Jdp_i * fi, oh_i, 0), (Jdp_j * fj, oh_j, 0), (Jdp_b * fi, oh_i, 9))
        for Ja, oha, offa in dp_blocks:
            for Jb_, ohb, offb in dp_blocks:
                add_cross(Hcc4, oha, torch.einsum("emi,e,emj->eij", Ja, wdp, Jb_), ohb,
                          offa, offb)
            gblk = torch.einsum("emi,e,em->ei", Ja, wdp, rdp)
            gc4[:, offa:offa + Ja.shape[-1]] += oha.T @ gblk

        blk = torch.einsum("kmi,k,kmj->kij", Jd, wd, Jd)
        Hcc4[:, :9, :, :9] += blk[:, :, None, :] * eyeK[:, None, :, None]
        gc4[:, :9] += torch.einsum("kmi,k,km->ki", Jd, wd, rd)

        total = total + (
            torch.sum(zero_where(pre_mask, huber_cost(chi2p, HUBER2_PVR)))
            + torch.sum(zero_where(pre_mask, huber_cost(chi2b, HUBER2_BIAS)))
            + torch.sum(zero_where((depth_info > 0) & (wd > 0), huber_cost(chi2d, HUBER2_DEPTH)))
            + torch.sum(zero_where(dp_mask, huber_cost(chi2dp, HUBER2_DEPTH))))

        # gauge: identity on fixed / invalid keyframe slots
        Hcc = Hcc4.reshape(C, C) + torch.diag(torch.repeat_interleave(~free_kf, 15).to(dtype))
        Hpp = Hpp + torch.eye(3, dtype=dtype, device=dev)[None] * (
            ~pt_free).to(dtype)[:, None, None]
        return (Hcc, gc4.reshape(C), Hpp, gp, W), total

    def retract(state, dc, dp):
        kf, pts = state
        d = dc.reshape(K, 15)
        return kf.inc_small_pvr(d[:, :9]).inc_small_bias(d[:, 9:15]), pts + dp

    return build, retract


def local_ba_navstate(kf_ns, kf_fixed, kf_valid, pts_w, pt_valid, obs_kf, obs_pt, obs_uv,
                      obs_inv_sigma2, obs_mask, pre_i, pre_j, pre, pre_mask, gravity, Rcb, tcb,
                      fx, fy, cx, cy, gyr_bias_rw2, acc_bias_rw2, depth_meas, depth_info,
                      n_iters: int = 5, rounds: int = 2, p_active: int = 2048,
                      cost_out: list | None = None, scan=None):
    """VI(P) window BA over [K, 15] keyframe states (PVR + bias) and the
    observed landmarks: reprojection edges, preintegration and bias
    random-walk edges along the (pre_i, pre_j) pairs, the depth-projected
    pressure ternary along the same pairs, and a unary depth prior on
    keyframes no active ternary covers. Returns (kf_ns', pts_w',
    obs_inlier). A list given as `cost_out` receives, per round, the
    objective at the round's start and end (device scalars). `scan` runs
    each round's LM iterations (the plain loop when None)."""
    dtype, dev = pts_w.dtype, pts_w.device
    K = kf_ns.p.shape[0]
    free_kf = kf_valid & ~kf_fixed

    P = min(pts_w.shape[0], p_active if p_active else obs_pt.numel())
    pts_full = pts_w
    ids_c, act_ok, obs_pt, keep_ok, pts_w, pt_valid = _compact_points(
        obs_pt, obs_mask, pts_w, pt_valid, P)
    obs_mask = obs_mask & keep_ok
    obs_kf = obs_kf.long()
    pre_i, pre_j = pre_i.long(), pre_j.long()
    oh_grid = None
    if obs_pt.dim() == 2:
        oh_grid = (obs_pt[..., None] == torch.arange(P, device=dev)).to(dtype)

    info_pvr = inv_spd_scaled(pre.cov + torch.eye(9, dtype=dtype, device=dev)[None] * 1e-8)
    dT = pre.dt
    rw_diag = torch.cat([
        (1.0 / torch.clamp(gyr_bias_rw2 * dT[:, None], min=1e-12)).repeat(1, 3),
        (1.0 / torch.clamp(acc_bias_rw2 * dT[:, None], min=1e-12)).repeat(1, 3)], dim=1)
    ar_k = torch.arange(K, device=dev)
    c = dict(obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=obs_uv, obs_inv_sigma2=obs_inv_sigma2,
             oh_grid=oh_grid, pre=pre, pre_i=pre_i, pre_j=pre_j, pre_mask=pre_mask,
             free_kf=free_kf, fk=free_kf.to(dtype), eyeK=torch.eye(K, dtype=dtype, device=dev),
             oh_i=(pre_i[:, None] == ar_k).to(dtype), oh_j=(pre_j[:, None] == ar_k).to(dtype),
             info_pvr=info_pvr, rw_diag=rw_diag, pre_mf=pre_mask.to(dtype), gravity=gravity,
             Rcb=Rcb, tcb=tcb, depth_meas=depth_meas, depth_info=depth_info)

    def make(c):
        return _navstate_problem(c, fx, fy, cx, cy)

    state, obs_in = (kf_ns, pts_w), obs_mask
    for rd in range(rounds):
        robust = 1.0 if rd < rounds - 1 else 0.0
        # a landmark moves only with >= 2 live observations
        n_obs = torch.zeros((P,), dtype=torch.int32, device=dev).index_add(
            0, obs_pt.reshape(-1), obs_in.reshape(-1).to(torch.int32))
        state, chi2_start, chi2_end = _lm(scan, ("ba_navstate", fx, fy, cx, cy), make, c, state,
                                          obs_in, robust, n_iters, pt_valid & (n_obs >= 2),
                                          dtype)
        if cost_out is not None:
            cost_out.append((chi2_start, chi2_end))
        kf, pts = state
        r, _, _ = _reproj_blocks_navstate(kf, pts, obs_kf, obs_pt, obs_uv, Rcb, tcb,
                                          fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * obs_inv_sigma2
        Rbw = kf.R[obs_kf].transpose(-1, -2)
        pc_z = (mv(Rcb, mv(Rbw, pts[obs_pt] - kf.p[obs_kf])) + tcb)[..., 2]
        obs_in = obs_mask & (chi2 <= CHI2_MONO) & (pc_z > 0)
    kf, pts = state
    return kf, _scatter_points(pts_full, pts, ids_c, act_ok), obs_in
