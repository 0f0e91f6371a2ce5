"""Tracker configuration, states and the device phases of the mono step.

Counterpart of `uvipslam_tpu/frontend/tracker.py`: `TrackerConfig`, the
tracking states, the camera-pose <-> NavState converters (camera as
body, and through the camera-in-body extrinsics) and the four phases the
device steps run (`_motion_guess`, `_pose_and_localmap`,
`_triangulate_new`, `_local_ba`). The host-orchestrated `MonoTracker`
class of the reference belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.state import NavState
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.frontend.frame import Tracks
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.ops import hamming
from uvipslam_torch.ops.twoview import triangulate_linear
from uvipslam_torch.solver.local_ba import local_ba_se3
from uvipslam_torch.solver.pose_opt import pose_optimization_se3

NOT_INITIALIZED = 0
INITIALIZING = 1
WORKING = 2
LOST = 3
IMU_RELOC = 4


@dataclasses.dataclass
class TrackerConfig:
    n_tracks: int = 400
    n_levels_klt: int = 5
    klt_win: int = 21
    klt_iters: int = 10
    px_distance: int = 20
    min_init_tracks: int = 100
    min_tracked: int = 20
    kf_min_interval: int = 4
    kf_max_interval: int = 15
    kf_track_ratio: float = 0.9
    local_window: int = 8
    ba_obs_cap: int = 8192
    scale_sigmas: tuple = tuple((1.2 ** (2 * i)) for i in range(8))
    enhance: bool = False
    map_hygiene: bool = True
    loop_closing: bool = False
    loop_min_sim3_inliers: int = 20
    loop_min_total_matches: int = -1


def _cam_pose_to_ns(Rcw, tcw) -> NavState:
    """Camera pose in the NavState slot (MONO: R = Rwc, p = center)."""
    Rwc = Rcw.transpose(-1, -2)
    ns = NavState.identity(tuple(tcw.shape[:-1]), tcw.dtype, tcw.device)
    return dataclasses.replace(ns, p=-mv(Rwc, tcw), R=Rwc)


def _ns_to_cam_pose(ns: NavState):
    Rcw = ns.R.transpose(-1, -2)
    return Rcw, -mv(Rcw, ns.p)


def _ns_to_cam_pose_ext(ns: NavState, Rcb, tcb):
    """Camera extrinsic of a BODY NavState through the camera-in-body
    transform x_c = Rcb x_b + tcb."""
    Rcw = mm(Rcb, ns.R.transpose(-1, -2))
    return Rcw, -mv(Rcw, ns.p) + tcb


def _cam_pose_to_ns_ext(Rcw, tcw, Rbc, tbc) -> NavState:
    """BODY NavState pose of a camera extrinsic (x_b = Rbc x_c + tbc); the
    inverse of `_ns_to_cam_pose_ext`."""
    Rwb = mm(Rbc, Rcw).transpose(-1, -2)
    ns = NavState.identity(tuple(tcw.shape[:-1]), tcw.dtype, tcw.device)
    return dataclasses.replace(ns, p=-mv(Rwb, mv(Rbc, tcw) + tbc), R=Rwb)


def _project(pc, fx, fy, cx, cy, eps=1e-6):
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    return torch.stack([fx * pc[..., 0] / zs + cx, fy * pc[..., 1] / zs + cy], -1)


def _inv_sigma(scale_sigmas: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    return 1.0 / scale_sigmas[level.clamp(0, scale_sigmas.shape[0] - 1).long()]


def _motion_guess(tracks: Tracks, m: MapState, Rp, tp, fx, fy, cx, cy):
    """Project associated landmarks with the motion-model pose."""
    has_pt = tracks.valid & (tracks.pt_id >= 0)
    pid = tracks.pt_id.clamp(0, m.pt_cap - 1).long()
    pc = mv(Rp, m.pt_xyz[pid]) + tp
    return _project(pc, fx, fy, cx, cy), has_pt & (pc[:, 2] > 0.1)


def _pose_and_localmap(tracks: Tracks, m: MapState, Rp, tp, fx, fy, cx, cy,
                       scale_sigmas: torch.Tensor):
    """Pose solve on current associations, then associate unmatched tracks
    with projected local-map landmarks by descriptor, then re-solve."""
    dtype = tp.dtype
    has_pt = tracks.valid & (tracks.pt_id >= 0)
    pid = tracks.pt_id.clamp(0, m.pt_cap - 1).long()
    pw = m.pt_xyz[pid]
    R1, t1, _, _ = pose_optimization_se3(
        Rp, tp, pw, tracks.xy_und, has_pt & m.pt_valid[pid],
        _inv_sigma(scale_sigmas, tracks.level), fx, fy, cx, cy, rounds=2, iters=4)

    pc = mv(R1, m.pt_xyz) + t1
    proj = _project(pc, fx, fy, cx, cy)
    vis = m.pt_valid & (pc[:, 2] > 0.1)

    free = tracks.valid & (tracks.pt_id < 0)
    pair = hamming.window_mask(tracks.xy_und, proj, 9.0)
    idx, dist, ok = hamming.match_best(tracks.desc, m.pt_desc, free, vis, pair_mask=pair,
                                       max_dist=hamming.TH_HIGH, ratio=0.9)
    # one-to-one: the best track per landmark keeps it (scatter-min)
    INF = 1e9
    tgt = torch.where(ok, idx, torch.full_like(idx, m.pt_cap - 1)).long()
    best_per_pt = torch.full((m.pt_cap,), INF, dtype=dtype, device=tp.device).scatter_reduce(
        0, tgt, torch.where(ok, dist, torch.full_like(dist, INF)), reduce="amin")
    keep = ok & (dist <= best_per_pt[idx.long()])
    tracks2 = dataclasses.replace(
        tracks, pt_id=torch.where(keep, idx, tracks.pt_id).to(torch.int32))

    has2 = tracks2.valid & (tracks2.pt_id >= 0)
    pid2 = tracks2.pt_id.clamp(0, m.pt_cap - 1).long()
    pw2 = m.pt_xyz[pid2]
    R2, t2, inl2, n2 = pose_optimization_se3(
        R1, t1, pw2, tracks2.xy_und, has2 & m.pt_valid[pid2],
        _inv_sigma(scale_sigmas, tracks2.level), fx, fy, cx, cy, rounds=2, iters=2)
    # per-frame outliers keep their associations; only hopeless
    # reprojections are severed
    pc2 = mv(R2, pw2) + t2
    uv2 = _project(pc2, fx, fy, cx, cy)
    err2 = torch.sum((uv2 - tracks2.xy_und) ** 2, -1)
    hopeless = has2 & ((err2 > 100.0) | (pc2[..., 2] <= 0))
    tracks3 = dataclasses.replace(
        tracks2, pt_id=torch.where(hopeless, torch.full_like(tracks2.pt_id, -1),
                                   tracks2.pt_id))
    return R2, t2, inl2, n2, tracks3


@functools.lru_cache(maxsize=8)
def _intrinsics(fx, fy, cx, cy, device) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32).to(device)


def _triangulate_new(m: MapState, t: Tracks, ring_R, ring_t, ring_frame, Rcw, tcw,
                     fx, fy, cx, cy, frame_id, ref_kf_slot):
    """Create landmarks from landmark-less tracks by triangulating their
    birth observation (pose from the recent-pose ring) against the
    current frame, behind cheirality, reprojection and parallax gates."""
    dev = tcw.device
    RING = ring_frame.shape[0]
    slot = torch.remainder(t.birth_frame, RING).long()
    ring_ok = ring_frame[slot] == t.birth_frame
    R1 = ring_R[slot]
    t1 = ring_t[slot]

    cand = (t.valid & (t.pt_id < 0) & ring_ok & (frame_id - t.birth_frame >= 3))
    K = _intrinsics(fx, fy, cx, cy, dev)
    P1 = torch.einsum("ij,njk->nik", K, torch.cat([R1, t1[:, :, None]], -1))
    P2 = mm(K, torch.cat([Rcw, tcw[:, None]], 1))
    X = triangulate_linear(P1, P2, t.birth_xy_und, t.xy_und)

    pc1 = mv(R1, X) + t1
    z1 = pc1[:, 2]
    reproj1 = torch.sum((_project(pc1, fx, fy, cx, cy) - t.birth_xy_und) ** 2, -1)
    pc2 = mv(Rcw, X) + tcw
    z2 = pc2[:, 2]
    reproj2 = torch.sum((_project(pc2, fx, fy, cx, cy) - t.xy_und) ** 2, -1)

    C1 = -mv(R1.transpose(-1, -2), t1)
    C2 = -mv(Rcw.transpose(-1, -2), tcw)
    r1 = X - C1
    r2 = X - C2
    cosp = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-9)
    good = (cand & torch.all(torch.isfinite(X), -1) & (z1 > 0.05) & (z2 > 0.05)
            & (reproj1 < 5.991) & (reproj2 < 5.991) & (cosp < 0.99995))

    dist = torch.linalg.vector_norm(X - C2, dim=-1)
    normal = (X - C2) / torch.clamp(dist[:, None], min=1e-9)
    m2, ids = m.add_points(X, t.desc, normal, dist / 2.0, dist * 2.0, ref_kf_slot,
                           frame_id, good)
    t2 = dataclasses.replace(t, pt_id=torch.where(good, ids, t.pt_id))
    return m2, t2


W_KF_BA = 12  # BA window slots (10 KFs + boundary, rounded up)


def _local_ba(m: MapState, kf_fixed, fx, fy, cx, cy, scale_sigmas: torch.Tensor) -> MapState:
    """Windowed visual BA over the last `W_KF_BA` keyframe slots, read and
    written back by index (the reference's dynamic_slice window)."""
    W = min(W_KF_BA, m.kf_cap)
    dev = m.pt_xyz.device
    lo = torch.clamp(m.n_kf - W, 0, m.kf_cap - W).long()
    win = lo + torch.arange(W, device=dev)

    def sl(a):
        return a.index_select(0, win)

    kf_ns_w = tree_map(sl, m.kf_ns)
    feat_pt_w = sl(m.kf_feat_pt)
    F = feat_pt_w.shape[1]
    obs_kf = torch.arange(W, device=dev)[:, None].expand(W, F)
    obs_ok = (feat_pt_w >= 0) & sl(m.kf_feat_valid)
    obs_ok = obs_ok & m.pt_valid[feat_pt_w.clamp(0, m.pt_cap - 1).long()]
    obs_pt = feat_pt_w.clamp(0, m.pt_cap - 1).long()
    inv_sig = _inv_sigma(scale_sigmas, sl(m.kf_feat_level))

    kf_R, kf_t = _ns_to_cam_pose(kf_ns_w)
    Rn, tn, pts, inl = local_ba_se3(
        kf_R, kf_t, sl(kf_fixed), sl(m.kf_valid), m.pt_xyz, m.pt_valid,
        obs_kf, obs_pt, sl(m.kf_feat_xy), inv_sig, obs_ok,
        fx, fy, cx, cy, n_iters=2, rounds=2)
    ns_new = _cam_pose_to_ns(Rn, tn)
    kf_ns2 = tree_map(lambda tbl, w: tbl.index_copy(0, win, w), m.kf_ns, ns_new)
    feat_pt2 = torch.where(inl | ~obs_ok, feat_pt_w, torch.full_like(feat_pt_w, -1))
    return dataclasses.replace(
        m, kf_ns=kf_ns2, pt_xyz=pts, kf_feat_pt=m.kf_feat_pt.index_copy(0, win, feat_pt2))
