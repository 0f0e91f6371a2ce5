"""Tracker configuration, states, the device phases of the mono step and
the host-orchestrated mono tracker.

Counterpart of `uvipslam_tpu/frontend/tracker.py`: `TrackerConfig`, the
tracking states, the camera-pose <-> NavState converters (camera as
body, and through the camera-in-body extrinsics), the four phases the
device steps run (`_motion_guess`, `_pose_and_localmap`,
`_triangulate_new`, `_local_ba`) and `MonoTracker`, the reference's host
state machine over those phases (`process_frame` per image).

`MonoTracker` keeps the reference's control flow and attributes: the
state machine, frame ids and keyframe bookkeeping are host ints, the
tracks, map, poses, motion model and pose ring are tensors on the
tracker's device. Each host decision reads device values once
(`host_syncs` counts the reads): the track count in NOT_INITIALIZED, the
candidate count and the reconstruction's flag in INITIALIZING (then the
keyframe slot and the reference track count together), the inlier count
in WORKING (and the slot and count of a new keyframe), the PnP count and
the candidate keyframes, then the seeds' inlier counts in LOST. A stored
trajectory pose stays on the device until `trajectory_positions`. One
`torch.Generator` seeded from `seed` takes the place of the reference's
PRNG key.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.state import NavState
from uvipslam_torch.core.tree import row, tree_map
from uvipslam_torch.frontend.frame import (Tracks, propagate_tracks, refill_tracks,
                                           refresh_descriptors)
from uvipslam_torch.loop.reloc import relocalize_frame
from uvipslam_torch.mapstate.hygiene import cull_points, fuse_duplicates_recent
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops import hamming
from uvipslam_torch.ops.clahe import clahe
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import draw_uniform, initialize_two_view, triangulate_linear
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


def _window_ba(m: MapState, cam: CameraModel, local_window: int,
               scale_sigmas: torch.Tensor) -> MapState:
    """Window BA over the last `local_window` keyframes, earlier ones
    fixed. Mono gauge: slot 0 always fixed, slot 1 fixed when valid (the
    window and the gauge are set on the device: an indexed write of a
    Python value would be a host-to-device copy that waits for the
    stream)."""
    kf_idx = torch.arange(m.kf_cap, device=m.pt_xyz.device)
    in_window = (kf_idx >= m.n_kf - local_window) & (kf_idx < m.n_kf)
    fixed = (m.kf_valid & ~in_window) | (kf_idx == 0)
    fixed = torch.where(kf_idx == 1, m.kf_valid[1], fixed)
    return _local_ba(m, fixed, cam.fx, cam.fy, cam.cx, cam.cy, scale_sigmas)


def step_device(device) -> torch.device:
    """The device a step's entry point runs on: the card unless the
    caller names another. Raises when a CUDA device is asked for and none
    is present, rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the step runs on the card unless the caller "
                           "passes device='cpu'")
    return device


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian: linear-interpolated 0.5 quantile of the non-NaN
    entries (the mean of the two middle values for an even count); NaN
    when every entry is NaN. No host sync."""
    n = torch.sum(~torch.isnan(x))
    s = torch.sort(x).values                      # NaNs sort last
    pos = 0.5 * (n - 1).clamp(min=0).to(x.dtype)
    lo = torch.floor(pos)
    w = pos - lo
    lo_i = lo.long().reshape(1)
    hi_i = torch.ceil(pos).long().reshape(1)
    med = s.index_select(0, lo_i)[0] * (1.0 - w) + s.index_select(0, hi_i)[0] * w
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _nav_row(ns, k):
    """Row k of a NavState table (device-scalar or host index)."""
    if not isinstance(k, torch.Tensor):
        return tree_map(lambda a: a[k], ns)
    return tree_map(lambda a: row(a, k), ns)


def _set_row(a: torch.Tensor, k: int, v) -> torch.Tensor:
    """a.at[k].set(v) for a host index k: a copy with row k replaced (a
    Python value is filled on the device, not copied from the host)."""
    a = a.clone()
    if isinstance(v, torch.Tensor):
        a[k] = v
    else:
        a[k].fill_(v)
    return a


class MonoTracker:
    """Host-side orchestration of the mono VO pipeline: `process_frame`
    per image, a status dict of host values back."""

    RING = 64

    def __init__(self, cam: CameraModel, cfg: TrackerConfig | None = None,
                 kf_cap: int = 128, pt_cap: int = 8192, seed: int = 0, device="cuda"):
        self.cam = cam
        self.cfg = cfg or TrackerConfig()
        self.device = dev = step_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.state = NOT_INITIALIZED
        self.tracks = Tracks.empty(self.cfg.n_tracks, device=dev)
        self.map = MapState.empty(kf_cap, pt_cap, self.cfg.n_tracks, device=dev)
        self.pyr_prev = None
        self.frame_id = -1
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        # current camera pose Tcw, and the motion model (last -> current)
        self.Rcw, self.tcw = torch.eye(3, **f32), torch.zeros(3, **f32)
        self.R_vel, self.t_vel = torch.eye(3, **f32), torch.zeros(3, **f32)
        self.init_frame_id = -1
        # recent camera poses, for the birth-pose triangulation of new landmarks
        self.ring_R = torch.eye(3, **f32).repeat(self.RING, 1, 1)
        self.ring_t = torch.zeros((self.RING, 3), **f32)
        self.ring_frame = torch.full((self.RING,), -1, dtype=torch.int32, device=dev)
        self.last_kf_slot = -1
        self.last_kf_frame = -1
        self.n_ref_tracked = 0
        self.n_init_cand = 0        # candidate tracks of the last two-view attempt
        self.trajectory = []        # (frame_id, Rcw, tcw) after each WORKING frame
        self.scale_sigmas = torch.tensor(self.cfg.scale_sigmas, dtype=torch.float32).to(dev)
        self.K = torch.as_tensor(cam.K).to(dev)
        self.zero_preint = PreintState.zero((), device=dev)
        self.host_syncs = 0
        self.loop_closer = None
        if self.cfg.loop_closing:
            from uvipslam_torch.loop.closer import LoopCloser
            mt = self.cfg.loop_min_total_matches
            self.loop_closer = LoopCloser(
                cam.fx, cam.fy, cam.cx, cam.cy,
                min_sim3_inliers=self.cfg.loop_min_sim3_inliers,
                min_total_matches=None if mt < 0 else mt, device=dev)
        self.loop_events = []       # (frame_id, loop_kf) for diagnostics

    # ------------------------------------------------------------------
    def _read(self, *xs: torch.Tensor) -> list:
        """One host read of device values (scalars or vectors) -> a flat
        list of Python ints."""
        self.host_syncs += 1
        return torch.cat([x.reshape(-1).to(torch.int64) for x in xs]).tolist()

    def process_frame(self, img) -> dict:
        """Feed one grayscale frame [H, W] (numpy or tensor). Returns a
        dict of host status values."""
        cfg = self.cfg
        self.frame_id += 1
        img = torch.as_tensor(img).to(device=self.device, dtype=torch.float32)
        if cfg.enhance:
            img = clahe(img)
        pyr = tuple(build_flow_pyramid(img, cfg.n_levels_klt))

        if self.pyr_prev is not None and self.state != NOT_INITIALIZED:
            guess, guess_ok = self._motion_guesses()
            u = draw_uniform(self.gen, 200, self.tracks.n_slots, self.device)
            self.tracks = propagate_tracks(
                self.tracks, self.pyr_prev, pyr, guess, guess_ok, None,
                win=cfg.klt_win, iters=cfg.klt_iters, levels=cfg.n_levels_klt, u=u)

        status = {}
        if self.state == NOT_INITIALIZED:
            self.tracks = self._undistort(self._refill(self.tracks, img))
            n = self._read(torch.sum(self.tracks.valid))[0]
            if n >= cfg.min_init_tracks:
                self.tracks = dataclasses.replace(
                    self.tracks,
                    birth_frame=torch.full_like(self.tracks.birth_frame, self.frame_id),
                    birth_xy_und=self.tracks.xy_und)
                self.init_frame_id = self.frame_id
                self.state = INITIALIZING
            status.update(state="NOT_INITIALIZED", n_tracks=n)

        elif self.state == INITIALIZING:
            self.tracks = self._undistort(self.tracks)
            ok = self._try_initialize()
            # top up and keep trying; restart when too few candidates
            # survive (the tracks are those the attempt counted)
            if not ok and (self.n_init_cand < cfg.min_init_tracks // 2
                           or self.frame_id - self.init_frame_id > 30):
                self.state = NOT_INITIALIZED
                self.tracks = Tracks.empty(cfg.n_tracks, device=self.device)
            status.update(state="INITIALIZING", initialized=ok)

        elif self.state == WORKING:
            self.tracks = self._undistort(self.tracks)
            n_in = self._track_frame()
            if n_in < cfg.min_tracked:
                self.state = LOST
                status.update(state="LOST", n_inliers=n_in)
            else:
                tracks = self._refill(self.tracks, img)
                tracks = self._undistort(refresh_descriptors(tracks, img))
                newborn = tracks.birth_frame == self.frame_id
                self.tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
                    newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
                if self._need_keyframe(n_in):
                    self._create_keyframe()
                status.update(state="WORKING", n_inliers=n_in)

        elif self.state == LOST:
            ok = self._relocalize(img)
            status.update(state="WORKING" if ok else "LOST", relocalized=ok)

        self.pyr_prev = pyr
        if self.state == WORKING:
            slot = self.frame_id % self.RING
            self.ring_R = _set_row(self.ring_R, slot, self.Rcw)
            self.ring_t = _set_row(self.ring_t, slot, self.tcw)
            self.ring_frame = _set_row(self.ring_frame, slot, self.frame_id)
            self.trajectory.append((self.frame_id, self.Rcw, self.tcw))
        return status

    # ------------------------------------------------------------------
    def _refill(self, tracks: Tracks, img) -> Tracks:
        return refill_tracks(tracks, img, self.frame_id, n_features=self.cfg.n_tracks,
                             px_distance=self.cfg.px_distance)

    def _undistort(self, tracks: Tracks) -> Tracks:
        return dataclasses.replace(tracks, xy_und=self.cam.undistort_pixels(tracks.xy))

    def _motion_guesses(self):
        """Landmarks projected with the motion-model pose: the KLT
        initial guesses."""
        cam = self.cam
        return _motion_guess(self.tracks, self.map, mm(self.R_vel, self.Rcw),
                             mv(self.R_vel, self.tcw) + self.t_vel,
                             cam.fx, cam.fy, cam.cx, cam.cy)

    # ------------------------------------------------------------------
    def _try_initialize(self) -> bool:
        """H/F two-view bootstrap: the initial map of two keyframes, the
        median depth normalized to 1, refined by the window BA."""
        cfg, dev, t = self.cfg, self.device, self.tracks
        cand = t.valid & (t.birth_frame == self.init_frame_id)
        self.n_init_cand = self._read(torch.sum(cand))[0]
        if self.n_init_cand < cfg.min_init_tracks // 2:
            return False
        rec = initialize_two_view(self.gen, t.birth_xy_und, t.xy_und, cand, self.K, sigma=1.0)
        if not self._read(rec["ok"])[0]:
            return False

        good = rec["good"]
        z = rec["points"][:, 2]
        med = torch.nan_to_num(_nanmedian(torch.where(good, z, torch.full_like(z, float("nan")))),
                               nan=1.0)
        scale = 1.0 / torch.clamp(med, min=1e-6)
        pts3 = rec["points"] * scale
        R, tvec = rec["R"], rec["t"] * scale

        eye = torch.eye(3, dtype=torch.float32, device=dev)
        zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
        dist = torch.linalg.vector_norm(pts3, dim=-1)
        normals = pts3 / torch.clamp(dist[:, None], min=1e-9)
        m, ids = self.map.add_points(pts3, t.desc, normals, dist / 2.0, dist * 2.0, 0,
                                     self.frame_id, good)
        feat_pt = torch.where(good, ids, torch.full_like(ids, -1))
        zp = self.zero_preint
        m, k0 = m.add_keyframe(_cam_pose_to_ns(eye, zero3), 0.0, self.init_frame_id,
                               t.birth_xy_und, t.desc, t.level, t.angle, cand, feat_pt, 0.0,
                               False, zp, -1)
        m, k1 = m.add_keyframe(_cam_pose_to_ns(R, tvec), 0.0, self.frame_id, t.xy_und, t.desc,
                               t.level, t.angle, cand, feat_pt, 0.0, False, zp, k0)
        m = self._run_local_ba(m)

        self.map = m
        self.tracks = dataclasses.replace(t, pt_id=feat_pt)
        self.Rcw, self.tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, 1))
        self.R_vel, self.t_vel = eye, zero3
        self.last_kf_slot, self.n_ref_tracked = self._read(k1, torch.sum(good))
        self.last_kf_frame = self.frame_id
        # the init frame's pose (identity), so that tracks born then can
        # triangulate against their birth pose
        slot0 = self.init_frame_id % self.RING
        self.ring_R = _set_row(self.ring_R, slot0, eye)
        self.ring_t = _set_row(self.ring_t, slot0, zero3)
        self.ring_frame = _set_row(self.ring_frame, slot0, self.init_frame_id)
        self.state = WORKING
        return True

    # ------------------------------------------------------------------
    def _track_frame(self) -> int:
        """Pose solve on the associated tracks, local-map search, second
        pose solve; the motion model follows the new pose."""
        cam = self.cam
        R1, t1, _, n1, tracks2 = _pose_and_localmap(
            self.tracks, self.map, mm(self.R_vel, self.Rcw), mv(self.R_vel, self.tcw) + self.t_vel,
            cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas)
        n1 = self._read(n1)[0]
        if n1 < self.cfg.min_tracked:
            return n1
        R_prev, t_prev = self.Rcw, self.tcw
        self.Rcw, self.tcw = lie.normalize_rotation(R1), t1
        Rinv, tinv = lie.se3_inverse(R_prev, t_prev)
        R_vel, self.t_vel = lie.se3_compose(R1, t1, Rinv, tinv)
        self.R_vel = lie.normalize_rotation(R_vel)
        self.tracks = tracks2
        return n1

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_in: int) -> bool:
        since = self.frame_id - self.last_kf_frame
        if since < self.cfg.kf_min_interval:
            return False
        if since >= self.cfg.kf_max_interval:
            return True
        return n_in < self.cfg.kf_track_ratio * max(self.n_ref_tracked, 1)

    def _create_keyframe(self):
        """Triangulate new landmarks against their birth poses, insert the
        keyframe, map hygiene, window BA; the pose follows the BA."""
        cam, t = self.cam, self.tracks
        m, t = _triangulate_new(self.map, t, self.ring_R, self.ring_t, self.ring_frame,
                                self.Rcw, self.tcw, cam.fx, cam.fy, cam.cx, cam.cy,
                                self.frame_id, self.last_kf_slot)
        m, k = m.add_keyframe(_cam_pose_to_ns(self.Rcw, self.tcw), float(self.frame_id),
                              self.frame_id, t.xy_und, t.desc, t.level, t.angle, t.valid,
                              t.pt_id, 0.0, False, self.zero_preint, self.last_kf_slot)
        m, t = self._run_hygiene(m, t)
        m = self._run_local_ba(m)
        self.map, self.tracks = m, t
        k, self.n_ref_tracked = self._read(k, torch.sum(t.valid & (t.pt_id >= 0)))
        self.Rcw, self.tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, k))
        self.last_kf_slot = k
        self.last_kf_frame = self.frame_id
        self._maybe_close_loop(k)

    # ------------------------------------------------------------------
    def _run_hygiene(self, m: MapState, t: Tracks):
        """Landmark culling and recent-duplicate fusion at each keyframe;
        tracks lose associations to landmarks that went."""
        if not self.cfg.map_hygiene:
            return m, t
        cam = self.cam
        m = cull_points(m, self.frame_id)
        m = fuse_duplicates_recent(m, self.frame_id, self.Rcw, self.tcw, cam.fx, cam.fy,
                                   cam.cx, cam.cy)
        pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
        alive = (t.pt_id >= 0) & m.pt_valid[pid]
        return m, dataclasses.replace(
            t, pt_id=torch.where(alive, t.pt_id, torch.full_like(t.pt_id, -1)))

    def _maybe_close_loop(self, kf_slot: int):
        """The loop closer's pass for the new keyframe (with
        `loop_closing`); a closure moves the pose and restarts the motion
        model."""
        if self.loop_closer is None:
            return
        self.map, st = self.loop_closer.process_keyframe(self.map, kf_slot)
        if st.get("loop"):
            self.Rcw, self.tcw = _ns_to_cam_pose(_nav_row(self.map.kf_ns, kf_slot))
            self.R_vel = torch.eye(3, dtype=torch.float32, device=self.device)
            self.t_vel = torch.zeros(3, dtype=torch.float32, device=self.device)
            self.loop_events.append((self.frame_id, st["loop_kf"]))

    # ------------------------------------------------------------------
    def _relocalize(self, img) -> bool:
        """BoW candidates + PnP RANSAC of a fresh detection; the PnP pose
        (when it holds 6 inliers) and each candidate keyframe's pose seed
        the pose + local-map solve; the best seed is taken back to
        WORKING when it holds max(min_tracked, 15) inliers."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        fresh = refill_tracks(Tracks.empty(cfg.n_tracks, device=dev), img, self.frame_id,
                              n_features=cfg.n_tracks, px_distance=cfg.px_distance)
        fresh = self._undistort(refresh_descriptors(fresh, img))
        R, t, pt_id, n_in, top_kfs = relocalize_frame(fresh, self.map, self.gen,
                                                      cam.fx, cam.fy, cam.cx, cam.cy)
        fresh = dataclasses.replace(
            fresh, pt_id=pt_id, birth_frame=torch.full_like(fresh.birth_frame, self.frame_id),
            birth_xy_und=fresh.xy_und)
        n_in, *kfs = self._read(n_in, top_kfs)
        seeds = [(lie.normalize_rotation(R), t)] if n_in >= 6 else []
        seeds += [_ns_to_cam_pose(_nav_row(self.map.kf_ns, k)) for k in kfs]
        solved = [_pose_and_localmap(fresh, self.map, R0, t0, cam.fx, cam.fy, cam.cx, cam.cy,
                                     self.scale_sigmas) for R0, t0 in seeds]
        counts = self._read(*(s[3] for s in solved))
        best = counts.index(max(counts))          # the first seed of the most inliers
        if counts[best] < max(cfg.min_tracked, 15):
            return False
        R2, t2, _, _, tracks2 = solved[best]
        self.tracks = tracks2
        self.Rcw, self.tcw = lie.normalize_rotation(R2), t2
        self.R_vel = torch.eye(3, dtype=torch.float32, device=dev)
        self.t_vel = torch.zeros(3, dtype=torch.float32, device=dev)
        self.state = WORKING
        return True

    # ------------------------------------------------------------------
    def _run_local_ba(self, m: MapState) -> MapState:
        """Window BA over the last `local_window` keyframes, earlier ones
        and the mono gauge fixed (`_window_ba`; the gauge fixes slot 0, so
        the reference's `fixed_slots=[0]` at initialization adds nothing)."""
        return _window_ba(m, self.cam, self.cfg.local_window, self.scale_sigmas)

    # ------------------------------------------------------------------
    def trajectory_positions(self) -> np.ndarray:
        """Camera centres (world) of the WORKING frames, for ATE
        evaluation (one host read of the stored poses)."""
        if not self.trajectory:
            return np.zeros((0, 3))
        R = torch.stack([r for _, r, _ in self.trajectory]).double().cpu().numpy()
        t = torch.stack([t for _, _, t in self.trajectory]).double().cpu().numpy()
        return -np.einsum("nji,nj->ni", R, t)
