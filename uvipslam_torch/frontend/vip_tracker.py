"""Visual-inertial-pressure configuration and the two VI device phases.

Counterpart of the parts of `uvipslam_tpu/frontend/vip_tracker.py` that
the device VIP step runs: `VipConfig`, `_vi_track` (the VI pose solve,
local-map re-association and the marginalized two-state solve with the
pressure factor) and `_vi_ba` (the VI(P) window BA over the last
`W_KF_BA` keyframe slots). The host-orchestrated `VipTracker` class
belongs to a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core.lie import mv
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.frontend.tracker import TrackerConfig, _inv_sigma, _ns_to_cam_pose_ext
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.ops import hamming
from uvipslam_torch.solver.local_ba import local_ba_navstate
from uvipslam_torch.solver.pose_opt import pose_optimization_vi, pose_optimization_vi2


@dataclasses.dataclass
class VipConfig(TrackerConfig):
    gyr_noise_sd: float = 0.01414
    acc_noise_sd: float = 0.28284
    gyr_bias_rw2: float = 2.5e-9     # (5e-5)^2
    acc_bias_rw2: float = 1e-6       # (1e-3)^2
    depth_noise_sd: float = 0.5
    gravity: tuple = (0.0, 0.0, -9.81)
    vio_init_min_kfs: int = 5
    vio_init_min_time: float = 3.0   # seconds of keyframe span
    imu_cap_per_kf: int = 256
    # 1 = VI (linear [s, g_w] solve); 2/3 = VIP (gravity from the
    # accelerometer average, scale from pressure: the paper's method)
    init_mode: int = 2
    vio_init_baseline_s: float = 0.6
    # first relocalization tier: one projection search against the last
    # keyframe at the IMU-predicted pose before sustained recovery
    reloc_first_try: bool = True
    # sustained-failure recovery (IMU dead-reckoning + sub-map re-anchor)
    recovery_min_baseline: float = 0.04   # metres of IMU translation
    recovery_min_frames: int = 3
    recovery_max_frames: int = 45
    # camera-in-body extrinsics, x_body = Rbc x_cam + tbc
    Tbc: tuple = ((1.0, 0.0, 0.0, 0.0),
                  (0.0, 1.0, 0.0, 0.0),
                  (0.0, 0.0, 1.0, 0.0),
                  (0.0, 0.0, 0.0, 1.0))


def _project(pc, fx, fy, cx, cy):
    z = torch.where(torch.abs(pc[..., 2]) < 1e-6, torch.full_like(pc[..., 2], 1e-6), pc[..., 2])
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)


def _vi_track(tracks, m: MapState, ns_pred, ns_ref, pre_frame, gravity, fx, fy, cx, cy,
              scale_sigmas, gyr_rw2, acc_rw2, depth, depth_info, H_prior, Rcb, tcb):
    """VI pose solve, local-map re-association at the refined pose, then
    the two-state marginalized solve (x_c = Rcb x_b + tcb). Returns
    (ns, inlier [N], n_inliers, tracks with severed hopeless
    associations, H_post the next frame's prior)."""
    dtype = tcb.dtype
    has_pt = tracks.valid & (tracks.pt_id >= 0)
    pid = tracks.pt_id.clamp(0, m.pt_cap - 1).long()
    # seed solve: a robust round, a chi2 re-gate, a clean round
    ns1, _, _, _ = pose_optimization_vi(
        ns_pred, ns_ref, pre_frame, m.pt_xyz[pid], tracks.xy_und, has_pt & m.pt_valid[pid],
        _inv_sigma(scale_sigmas, tracks.level), gravity, Rcb, tcb, fx, fy, cx, cy, gyr_rw2,
        acc_rw2, depth_meas=depth, depth_info=depth_info, use_depth=True, rounds=2, iters=2)

    # local-map re-association at the refined pose (scatter-min: the best
    # track per landmark keeps it)
    Rcw, tcw = _ns_to_cam_pose_ext(ns1, Rcb, tcb)
    pc = mv(Rcw, m.pt_xyz) + tcw
    vis = m.pt_valid & (pc[:, 2] > 0.1)
    free = tracks.valid & (tracks.pt_id < 0)
    pair = hamming.window_mask(tracks.xy_und, _project(pc, fx, fy, cx, cy), 9.0)
    idx, dist, ok = hamming.match_best(tracks.desc, m.pt_desc, free, vis, pair_mask=pair,
                                       max_dist=hamming.TH_HIGH, ratio=0.9)
    INF = 1e9
    tgt = torch.where(ok, idx, torch.full_like(idx, m.pt_cap - 1)).long()
    best_per_pt = torch.full((m.pt_cap,), INF, dtype=dtype, device=tcb.device).scatter_reduce(
        0, tgt, torch.where(ok, dist, torch.full_like(dist, INF)), reduce="amin",
        include_self=True)
    keep = ok & (dist <= best_per_pt[idx.long()])
    tracks2 = dataclasses.replace(tracks, pt_id=torch.where(keep, idx, tracks.pt_id).to(
        torch.int32))

    has2 = tracks2.valid & (tracks2.pt_id >= 0)
    pid2 = tracks2.pt_id.clamp(0, m.pt_cap - 1).long()
    pw2 = m.pt_xyz[pid2]
    ns2, inl2, n2, H_post = pose_optimization_vi2(
        ns_ref, ns1, H_prior, pre_frame, pw2, tracks2.xy_und, has2 & m.pt_valid[pid2],
        _inv_sigma(scale_sigmas, tracks2.level), gravity, Rcb, tcb, fx, fy, cx, cy, gyr_rw2,
        acc_rw2, depth_meas=depth, depth_info=depth_info, use_depth=True, rounds=2, iters=3)

    # sever hopeless associations only
    Rcw2, tcw2 = _ns_to_cam_pose_ext(ns2, Rcb, tcb)
    pc2 = mv(Rcw2, pw2) + tcw2
    err2 = torch.sum((_project(pc2, fx, fy, cx, cy) - tracks2.xy_und) ** 2, -1)
    hopeless = has2 & ((err2 > 100.0) | (pc2[..., 2] <= 0))
    tracks3 = dataclasses.replace(
        tracks2, pt_id=torch.where(hopeless, torch.full_like(tracks2.pt_id, -1), tracks2.pt_id))
    return ns2, inl2, n2, tracks3, H_post


W_KF_BA = 12  # window slots: 10 keyframes + the boundary, rounded up


def _vi_ba(m: MapState, gravity, fx, fy, cx, cy, scale_sigmas, gyr_rw2, acc_rw2, depth_inv_var,
           Rcb, tcb) -> MapState:
    """VI(P) window BA over the last `W_KF_BA` keyframe slots, read and
    written back by index (the reference's dynamic slice at a device
    offset). The first window slot is the fixed boundary keyframe; its
    preintegration edge points outside the window and is masked."""
    W = min(W_KF_BA, m.kf_cap)
    dev = m.pt_xyz.device
    lo = torch.clamp(m.n_kf - W, 0, m.kf_cap - W).long()
    win = lo + torch.arange(W, device=dev)

    def sl(a):
        return a.index_select(0, win)

    kf_ns_w = tree_map(sl, m.kf_ns)
    kf_valid_w = sl(m.kf_valid)
    pre_w = tree_map(sl, m.kf_preint)
    feat_pt_w = sl(m.kf_feat_pt)
    F = feat_pt_w.shape[1]
    obs_kf = torch.arange(W, device=dev)[:, None].expand(W, F)
    obs_ok = (feat_pt_w >= 0) & sl(m.kf_feat_valid)
    obs_pt = feat_pt_w.clamp(0, m.pt_cap - 1).long()
    obs_ok = obs_ok & m.pt_valid[obs_pt]
    idx = torch.arange(W, device=dev)
    fixed = kf_valid_w & (idx == 0)
    pre_mask = kf_valid_w & (idx > 0) & (pre_w.dt > 1e-6)
    depth_info = torch.where(sl(m.kf_depth_valid) & kf_valid_w,
                             torch.full_like(pre_w.dt, depth_inv_var), torch.zeros_like(pre_w.dt))
    kf2, pts2, obs_in = local_ba_navstate(
        kf_ns_w, fixed, kf_valid_w, m.pt_xyz, m.pt_valid, obs_kf, obs_pt, sl(m.kf_feat_xy),
        _inv_sigma(scale_sigmas, sl(m.kf_feat_level)), obs_ok, (idx - 1).clamp(0, W - 1), idx,
        pre_w, pre_mask, gravity, Rcb, tcb, fx, fy, cx, cy, gyr_rw2, acc_rw2, sl(m.kf_depth),
        depth_info, n_iters=3, rounds=2)
    feat_pt2 = torch.where(obs_in | ~obs_ok, feat_pt_w, torch.full_like(feat_pt_w, -1))
    return dataclasses.replace(
        m, kf_ns=tree_map(lambda tbl, w: tbl.index_copy(0, win, w), m.kf_ns, kf2), pt_xyz=pts2,
        kf_feat_pt=m.kf_feat_pt.index_copy(0, win, feat_pt2))
