"""Full-map bundle adjustment, visual and visual-inertial-pressure.

Counterpart of `uvipslam_tpu/solver/global_ba.py`: the window BA
machinery of `solver/local_ba.py` applied to the whole keyframe table
(or its first `kf_window` slots) with the lowest valid slot fixed as the
gauge. VIO init runs the visual form before its solves; loop closing
polishes the corrected map with either form. The NavState form first
re-integrates every keyframe's stored raw IMU window at the bias of its
previous keyframe.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.frontend.tracker import _cam_pose_to_ns, _ns_to_cam_pose
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.core.preintegration import preintegrate
from uvipslam_torch.solver.local_ba import local_ba_navstate, local_ba_se3


def _all_observations(m: MapState, scale_sigmas: torch.Tensor, W: int | None = None):
    """[W, F] grid of every keyframe observation of the first W slots:
    (obs_kf, obs_pt clamped, obs_uv, inverse sigma^2, valid)."""
    W = m.kf_cap if W is None else W
    F = m.n_feat
    dev = m.pt_xyz.device
    obs_kf = torch.arange(W, device=dev)[:, None].expand(W, F)
    obs_pt = m.kf_feat_pt[:W]
    ok = (obs_pt >= 0) & m.kf_feat_valid[:W] & m.kf_valid[:W, None]
    obs_pt = obs_pt.clamp(0, m.pt_cap - 1).long()
    ok = ok & m.pt_valid[obs_pt]
    lvl = m.kf_feat_level[:W].clamp(0, scale_sigmas.shape[0] - 1).long()
    return obs_kf, obs_pt, m.kf_feat_xy[:W], 1.0 / scale_sigmas[lvl], ok


def _writeback(m: MapState, kf_ns2, pts2, obs_in, obs_ok) -> MapState:
    keep = obs_in | ~obs_ok
    W = keep.shape[0]
    old = m.kf_feat_pt[:W]
    feat_pt = torch.cat([torch.where(keep, old, torch.full_like(old, -1)), m.kf_feat_pt[W:]])
    return dataclasses.replace(m, kf_ns=kf_ns2, pt_xyz=pts2, kf_feat_pt=feat_pt)


def global_ba_visual(m: MapState, fx, fy, cx, cy, scale_sigmas: torch.Tensor,
                     kf_window: int | None = None, n_iters: int = 8, rounds: int = 2,
                     p_active: int = 4096) -> MapState:
    """Visual-only BA over the first `kf_window` keyframe slots (all when
    None) and their landmarks, the lowest valid slot fixed. Keyframes fill
    slots in insertion order, so an init-time caller bounds the dense pose
    block at kf_window*6. Velocities and biases are kept."""
    W = m.kf_cap if kf_window is None else min(kf_window, m.kf_cap)
    obs_kf, obs_pt, obs_uv, inv_sig, ok = _all_observations(m, scale_sigmas, W)
    kf_valid_w = m.kf_valid[:W]
    ns_w = dataclasses.replace(m.kf_ns, p=m.kf_ns.p[:W], R=m.kf_ns.R[:W])
    kf_R, kf_t = _ns_to_cam_pose(ns_w)
    first = torch.argmax(kf_valid_w.to(torch.int32))   # lowest valid slot
    fixed = torch.arange(W, device=first.device) == first
    Rn, tn, pts, inl = local_ba_se3(kf_R, kf_t, fixed, kf_valid_w, m.pt_xyz, m.pt_valid,
                                    obs_kf, obs_pt, obs_uv, inv_sig, ok, fx, fy, cx, cy,
                                    n_iters=n_iters, rounds=rounds, p_active=p_active)
    ns2_w = _cam_pose_to_ns(Rn, tn)
    ns2 = dataclasses.replace(m.kf_ns, p=torch.cat([ns2_w.p, m.kf_ns.p[W:]]),
                              R=torch.cat([ns2_w.R, m.kf_ns.R[W:]]))
    return _writeback(m, ns2, pts, inl, ok)


def global_ba_navstate(m: MapState, gravity, Rcb, tcb, fx, fy, cx, cy, gyr_noise_sd,
                       acc_noise_sd, gyr_bias_rw2, acc_bias_rw2, depth_inv_var,
                       scale_sigmas: torch.Tensor, cost_out: list | None = None) -> MapState:
    """Full-map visual-inertial-pressure BA over the keyframe NavStates:
    reprojection edges, preintegration and bias random-walk edges along
    the kf_prev chain, and the pressure depth factors. The preintegrated
    terms are rebuilt from each keyframe's raw IMU window (one batched
    pass over all K windows). `cost_out` as in `local_ba_navstate`."""
    K = m.kf_cap
    dev = m.pt_xyz.device
    obs_kf, obs_pt, obs_uv, inv_sig, ok = _all_observations(m, scale_sigmas)

    prev = m.kf_prev.clamp(0, K - 1).long()
    pre = preintegrate(m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask,
                       m.kf_ns.bg[prev], m.kf_ns.ba[prev], gyr_noise_sd, acc_noise_sd)
    pre_j = torch.arange(K, device=dev)
    pre_mask = (m.kf_prev >= 0) & m.kf_valid & (pre.dt > 1e-6) & m.kf_valid[prev]

    first = torch.argmax(m.kf_valid.to(torch.int32))   # lowest valid slot
    fixed = pre_j == first
    depth_info = torch.where(m.kf_depth_valid & m.kf_valid,
                             torch.full_like(m.kf_depth, depth_inv_var),
                             torch.zeros_like(m.kf_depth))
    ns2, pts2, inl = local_ba_navstate(
        m.kf_ns, fixed, m.kf_valid, m.pt_xyz, m.pt_valid, obs_kf, obs_pt, obs_uv, inv_sig, ok,
        prev, pre_j, pre, pre_mask, gravity, Rcb, tcb, fx, fy, cx, cy, gyr_bias_rw2,
        acc_bias_rw2, m.kf_depth, depth_info, n_iters=8, rounds=2, p_active=4096,
        cost_out=cost_out)
    return _writeback(m, ns2, pts2, inl, ok)
