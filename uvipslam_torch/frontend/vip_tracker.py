"""Visual-inertial-pressure tracking: the configuration, the two VI
device phases and the host-orchestrated VIP tracker.

Counterpart of `uvipslam_tpu/frontend/vip_tracker.py`: `VipConfig`,
`_vi_track` (the VI pose solve, local-map re-association and the
marginalized two-state solve with the pressure factor), `_vi_ba` (the
VI(P) window BA over the last `W_KF_BA` keyframe slots) and `VipTracker`,
the reference's host VIP pipeline over them (`process_frame_vip` per
frame bundle): per-frame IMU preintegration (frame to frame at the
current bias, since the last keyframe at zero bias) and the raw samples
stashed for the keyframe; the mono bootstrap of `MonoTracker` while the
quantities VIO init needs accumulate; the host TryInitVIO in both init
modes (mode 1: the strided linear [s, g_w] solve and its |g| refinement;
modes 2/3: gravity from the accelerometer average, scale from pressure,
the tilt refinement at fixed scale); after it NavState tracking with the
first-try relocalization tier, the VI window BA, IMU dead-reckoning and
a two-view sub-map re-anchor (IMU_RELOC), the post-recovery gyro-bias
recompute, and loop closing with the NavState global BA.

`VipTracker` keeps the reference's control flow and attributes, as
`MonoTracker` does: the state machine, frame ids, keyframe bookkeeping,
frame time and the depth flag are host values; tracks, map, NavStates,
the marginal prior, the IMU windows and the pose ring are tensors on the
tracker's device. Each host decision is one counted read (`host_syncs`);
the keyframe window's fill level stays on the device, so the sample
stash reads nothing. As in the reference, CLAHE (`enhance`) applies to
the frames of the mono bootstrap only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.preintegration import PreintState, preintegrate, preintegrate_continue
from uvipslam_torch.core.state import NavState
from uvipslam_torch.core.tree import row, tree_map
from uvipslam_torch.frontend.frame import Tracks, propagate_tracks, refresh_descriptors
from uvipslam_torch.frontend.tracker import (IMU_RELOC, WORKING, MonoTracker, TrackerConfig,
                                             _cam_pose_to_ns, _cam_pose_to_ns_ext, _inv_sigma,
                                             _motion_guess, _nav_row, _ns_to_cam_pose,
                                             _ns_to_cam_pose_ext, _set_row, _triangulate_new)
from uvipslam_torch.loop.reloc import first_try_associations
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.ops import hamming
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import draw_uniform, initialize_two_view
from uvipslam_torch.solver.global_ba import global_ba_navstate, global_ba_visual
from uvipslam_torch.solver.local_ba import local_ba_navstate
from uvipslam_torch.solver.pose_opt import pose_optimization_vi, pose_optimization_vi2
from uvipslam_torch.vio import init as vio_init


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


def predict_navstate(ns: NavState, pre: PreintState, gravity) -> NavState:
    """The NavState the IMU predicts over one frame's preintegration."""
    dt = pre.dt
    return dataclasses.replace(
        ns, p=ns.p + ns.v * dt + 0.5 * gravity * dt * dt + mv(ns.R, pre.dP),
        v=ns.v + gravity * dt + mv(ns.R, pre.dV), R=lie.normalize_rotation(mm(ns.R, pre.dR)))


def capped_prior(H_post: torch.Tensor) -> torch.Tensor:
    """The next frame's prior from the Schur marginal, its information
    capped so that the float32 filter cannot run away."""
    tr = torch.trace(H_post) / 15.0
    eye = torch.eye(15, dtype=H_post.dtype, device=H_post.device)
    return (H_post + eye * 1e-3) * torch.clamp(1e6 / torch.clamp(tr, min=1e-6), max=1.0)


def gravity_alignment(g_dir, g_cfg_dir):
    """The rotation taking the vision-world gravity direction onto the
    configured one."""
    v = torch.linalg.cross(g_dir, g_cfg_dir)
    sn = torch.linalg.vector_norm(v)
    axis = v / torch.where(sn < 1e-9, torch.ones_like(sn), sn)
    return lie.so3_exp(axis * torch.atan2(sn, torch.dot(g_dir, g_cfg_dir)))


class VipTracker(MonoTracker):
    """Host-orchestrated VIP pipeline: `process_frame_vip` per frame
    bundle, a status dict of host values back. On the card unless
    `device` names another."""

    def __init__(self, cam, cfg: VipConfig | None = None, kf_cap: int = 128,
                 pt_cap: int = 8192, seed: int = 0, device="cuda"):
        cfg = cfg or VipConfig()
        super().__init__(cam, cfg, kf_cap, pt_cap, seed, device)
        dev = self.device
        self.vio_ok = False
        self.gravity_w = torch.tensor(cfg.gravity, dtype=torch.float32).to(dev)
        # camera-in-body extrinsics, x_body = Rbc x_cam + tbc
        Tbc = np.asarray(cfg.Tbc, np.float32)
        self.Rbc = torch.from_numpy(Tbc[:3, :3].copy()).to(dev)
        self.tbc = torch.from_numpy(Tbc[:3, 3].copy()).to(dev)
        self.Rcb = torch.from_numpy(Tbc[:3, :3].T.copy()).to(dev)
        self.tcb = torch.from_numpy(-Tbc[:3, :3].T @ Tbc[:3, 3]).to(dev)
        self.has_extrinsics = not np.allclose(Tbc, np.eye(4))
        self.ns = NavState.identity((), device=dev)        # current body state
        self.ns_prev = NavState.identity((), device=dev)   # previous frame's
        # preintegration since the last keyframe and its raw window
        self._reset_kf_accumulators()
        # accelerometer sum in the vision world frame (the gravity estimate)
        self.accw_sum = torch.zeros(3, dtype=torch.float32, device=dev)
        self.cur_depth = torch.zeros((), dtype=torch.float32, device=dev)
        self.cur_depth_valid = False
        self.frame_time = 0.0
        self.dt_frame = 0.05
        self.depth_inv_var = 1.0 / cfg.depth_noise_sd ** 2
        self.ft_min = max(20, round(0.15 * cfg.n_tracks))      # first try: >= 60/400 matches
        self.ft_accept = max(10, round(0.0625 * cfg.n_tracks))  # and >= 25/400 inliers
        self._reloc_bias_after_kf = None
        # the frame-to-frame 15-dof marginal prior
        self._reset_marginal_prior()

    def _reset_marginal_prior(self):
        self.H_prior = torch.eye(15, dtype=torch.float32, device=self.device) * 1e2

    def _reset_kf_accumulators(self):
        S, dev = self.cfg.imu_cap_per_kf, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.preint_kf = PreintState.zero((), device=dev)
        self.kf_imu = dict(omg=torch.zeros((S, 3), **f32), acc=torch.zeros((S, 3), **f32),
                           dt=torch.zeros((S,), **f32), mask=torch.zeros((S,), **f32),
                           n=torch.zeros((), dtype=torch.int32, device=dev))

    def _readf(self, *xs: torch.Tensor) -> list:
        """One host read of device values -> a flat list of Python floats."""
        self.host_syncs += 1
        return torch.cat([x.reshape(-1).to(torch.float64) for x in xs]).tolist()

    def _cam_pose(self, ns: NavState):
        return _ns_to_cam_pose_ext(ns, self.Rcb, self.tcb)

    def _depth_override(self, ns: NavState) -> NavState:
        """Clamp the dead-reckoned z to the pressure depth (world z ==
        depth after the VIO init's anchoring)."""
        if not self.cur_depth_valid:
            return ns
        p = ns.p.clone()
        p[2] = self.cur_depth
        return dataclasses.replace(ns, p=p)

    def _stash(self, omg, acc, dt, mask):
        """The frame's first sum(mask) samples into the keyframe window at
        its fill level (the reference's `imu[:take]`: the valid samples
        are taken to come first), on the device."""
        w = self.kf_imu
        S, T = w["dt"].shape[0], dt.shape[0]
        n0 = w["n"]
        lane = torch.arange(T, dtype=torch.int32, device=self.device)
        nsamp = torch.sum(mask).to(torch.int32)
        pos = n0 + lane
        dst = torch.where((lane < nsamp) & (pos < S), pos, torch.full_like(pos, S)).long()

        def put(buf, vals):
            out = torch.cat([buf, buf[:1]])     # row S takes the samples not stashed
            out[dst] = vals.to(buf.dtype)
            return out[:S]

        take = torch.clamp(torch.minimum(nsamp, S - n0), min=0)
        self.kf_imu = dict(omg=put(w["omg"], omg), acc=put(w["acc"], acc), dt=put(w["dt"], dt),
                           mask=put(w["mask"], mask), n=(n0 + take).to(torch.int32))

    # ------------------------------------------------------------------
    def process_frame_vip(self, img, imu_omg, imu_acc, imu_dt, imu_mask, depth=0.0,
                          depth_valid=False, timestamp=None) -> dict:
        """Feed one frame bundle: the grayscale image and the IMU window
        since the previous frame ([T, 3], [T, 3], [T], [T]; numpy or
        tensors), the pressure depth, its flag and the timestamp (host
        values). Returns a dict of host status values."""
        cfg, dev = self.cfg, self.device

        def f32(a):
            return torch.as_tensor(a).to(device=dev, dtype=torch.float32)

        omg, acc, dt, mask = f32(imu_omg), f32(imu_acc), f32(imu_dt), f32(imu_mask)
        self.cur_depth = torch.full((), float(depth), dtype=torch.float32, device=dev)
        self.cur_depth_valid = bool(depth_valid)
        if timestamp is not None:
            self.frame_time = float(timestamp)
        else:
            self.frame_time += self.dt_frame

        # frame-to-frame preintegration at the current bias estimate
        pre_frame = preintegrate(omg, acc, dt, mask, self.ns.bg_total, self.ns.ba_total,
                                 cfg.gyr_noise_sd, cfg.acc_noise_sd)
        # since the last keyframe at zero bias (re-integrated at VIO init)
        z3 = torch.zeros(3, dtype=torch.float32, device=dev)
        self.preint_kf = preintegrate_continue(self.preint_kf, omg, acc, dt, mask, z3, z3,
                                               cfg.gyr_noise_sd, cfg.acc_noise_sd)
        self._stash(omg, acc, dt, mask)

        # world-frame specific force for the gravity estimate
        if not self.vio_ok and self.state == WORKING:
            Rwb = mm(self.Rcw.transpose(-1, -2), self.Rcb)
            mean_acc = torch.sum(acc * mask[:, None], 0) / torch.clamp(torch.sum(mask), min=1.0)
            self.accw_sum = self.accw_sum + mv(Rwb, mean_acc)

        if self.vio_ok and self.state == IMU_RELOC:
            return self._process_frame_recovery(img, pre_frame)
        if not self.vio_ok:
            status = self.process_frame(img)
            # the since-keyframe accumulators restart with the mono init
            # window and at the two bootstrap keyframes (whose preints stay
            # zero: zero-dt edges are masked everywhere)
            if status.get("state") == "NOT_INITIALIZED" or status.get("initialized"):
                self._reset_kf_accumulators()
            return status
        return self._process_frame_vi(img, pre_frame)

    # ------------------------------------------------------------------
    def _vi_solve(self, tracks: Tracks, ns_pred: NavState, pre_frame: PreintState):
        cam, cfg = self.cam, self.cfg
        info = torch.full((), self.depth_inv_var if self.cur_depth_valid else 0.0,
                          dtype=torch.float32, device=self.device)
        return _vi_track(tracks, self.map, ns_pred, self.ns, pre_frame, self.gravity_w, cam.fx,
                         cam.fy, cam.cx, cam.cy, self.scale_sigmas, cfg.gyr_bias_rw2,
                         cfg.acc_bias_rw2, self.cur_depth, info, self.H_prior, self.Rcb, self.tcb)

    def _process_frame_vi(self, img, pre_frame: PreintState) -> dict:
        """NavState tracking: the IMU prediction seeds the KLT guesses and
        the VI solve; on its failure the first-try tier (the last
        keyframe's landmarks projected at the predicted pose), and on that
        tier's failure IMU_RELOC."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        self.frame_id += 1
        img = torch.as_tensor(img).to(device=dev, dtype=torch.float32)
        pyr = tuple(build_flow_pyramid(img, cfg.n_levels_klt))

        ns_pred = predict_navstate(self.ns, pre_frame, self.gravity_w)
        Rcw_pred, tcw_pred = self._cam_pose(ns_pred)
        if self.pyr_prev is not None:
            guess, guess_ok = _motion_guess(self.tracks, self.map, Rcw_pred, tcw_pred, cam.fx,
                                            cam.fy, cam.cx, cam.cy)
            u = draw_uniform(self.gen, 200, self.tracks.n_slots, dev)
            self.tracks = propagate_tracks(self.tracks, self.pyr_prev, pyr, guess, guess_ok, None,
                                           win=cfg.klt_win, iters=cfg.klt_iters,
                                           levels=cfg.n_levels_klt, u=u)
        self.tracks = self._undistort(self.tracks)

        ns_opt, _, n_in, tracks2, H_post = self._vi_solve(self.tracks, ns_pred, pre_frame)
        n_in = self._read(n_in)[0]
        status = {}
        first_try_ok = False
        if n_in < cfg.min_tracked and cfg.reloc_first_try and self.last_kf_slot >= 0:
            # first relocalization tier: a 1-2 frame association loss must
            # not cost a re-anchor
            pid_ft, n_m = first_try_associations(
                self.tracks, self.map,
                torch.full((), self.last_kf_slot, dtype=torch.int32, device=dev), Rcw_pred,
                tcw_pred, cam.fx, cam.fy, cam.cx, cam.cy, min_matches=self.ft_min)
            if self._read(n_m)[0] >= self.ft_min:
                out = self._vi_solve(dataclasses.replace(self.tracks, pt_id=pid_ft), ns_pred,
                                     pre_frame)
                n2 = self._read(out[2])[0]
                if n2 >= self.ft_accept:
                    n_in, first_try_ok = n2, True
                    ns_opt, _, _, tracks2, H_post = out
        if n_in < cfg.min_tracked and not first_try_ok:
            # sustained failure: IMU dead-reckoning and a fresh sub-map
            self.ns_prev = self.ns
            self.ns = self._depth_override(ns_pred)
            self.Rcw, self.tcw = self._cam_pose(self.ns)
            self._enter_recovery(img, pyr)
            self._reset_marginal_prior()
            status.update(state="IMU_RELOC", n_inliers=n_in)
        else:
            self.tracks = tracks2
            self.ns_prev = self.ns
            self.ns = ns_opt
            self.Rcw, self.tcw = self._cam_pose(ns_opt)
            self.H_prior = capped_prior(H_post)
            tracks = self._refill(self.tracks, img)
            tracks = self._undistort(refresh_descriptors(tracks, img))
            newborn = tracks.birth_frame == self.frame_id
            self.tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
                newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
            if first_try_ok or self._need_keyframe(n_in):
                # a first-try relocalization forces a keyframe
                self._create_keyframe()
            status.update(state="WORKING", n_inliers=n_in, vio=True,
                          **({"first_try_reloc": True} if first_try_ok else {}))

        self.pyr_prev = pyr
        if self.state == WORKING:
            self._ring_write(self.frame_id, self.Rcw, self.tcw)
            self.trajectory.append((self.frame_id, self.Rcw, self.tcw))
        return status

    def _ring_write(self, frame: int, R, t):
        slot = frame % self.RING
        self.ring_R = _set_row(self.ring_R, slot, R)
        self.ring_t = _set_row(self.ring_t, slot, t)
        self.ring_frame = _set_row(self.ring_frame, slot, frame)

    # ------------------------------------------------------------------
    def _create_keyframe(self):
        """Triangulation, the keyframe with its IMU window, depth and
        preintegration, hygiene, the window BA of the inertial mode (after
        VIO init the window is re-integrated at the current bias first),
        the pending post-recovery bias recompute or the VIO-init attempt,
        and the loop closer's pass."""
        cam, cfg = self.cam, self.cfg
        ns = self.ns if self.vio_ok else _cam_pose_to_ns(self.Rcw, self.tcw)
        if self.vio_ok:
            w = self.kf_imu
            self.preint_kf = preintegrate(w["omg"], w["acc"], w["dt"], w["mask"], self.ns.bg,
                                          self.ns.ba, cfg.gyr_noise_sd, cfg.acc_noise_sd)
        m, t = _triangulate_new(self.map, self.tracks, self.ring_R, self.ring_t, self.ring_frame,
                                self.Rcw, self.tcw, cam.fx, cam.fy, cam.cx, cam.cy,
                                self.frame_id, self.last_kf_slot)
        w = self.kf_imu
        m, k = m.add_keyframe(ns, self.frame_time, self.frame_id, t.xy_und, t.desc, t.level,
                              t.angle, t.valid, t.pt_id, self.cur_depth, self.cur_depth_valid,
                              self.preint_kf, self.last_kf_slot, imu_omg=w["omg"],
                              imu_acc=w["acc"], imu_dt=w["dt"], imu_mask=w["mask"])
        m, t = self._run_hygiene(m, t)
        m = self._run_vi_ba(m) if self.vio_ok else self._run_local_ba(m)
        self.map, self.tracks = m, t
        k, self.n_ref_tracked, n_kf = self._read(k, torch.sum(t.valid & (t.pt_id >= 0)), m.n_kf)
        ns_k = _nav_row(m.kf_ns, k)
        if self.vio_ok:
            self.ns = ns_k
            self.Rcw, self.tcw = self._cam_pose(ns_k)
        else:
            self.Rcw, self.tcw = _ns_to_cam_pose(ns_k)
        self.last_kf_slot = k
        self.last_kf_frame = self.frame_id
        self._reset_kf_accumulators()
        if self.vio_ok:
            # the window BA re-anchors the state: the marginal restarts
            self._reset_marginal_prior()
            pending = self._reloc_bias_after_kf
            if pending is not None and n_kf >= pending:
                self._recompute_bias_after_recovery()
                self._reloc_bias_after_kf = None
        else:
            self._maybe_init_vio()
        # the loop closer sees every keyframe, VIP mode included
        self._maybe_close_loop(k)

    # ------------------------------------------------------------------
    def _maybe_close_loop(self, kf_slot: int):
        """The loop closer's pass: after VIO init the map holds BODY
        NavStates (the closer projects them through the extrinsics) and
        the polish is the NavState global BA; a closure re-adopts the
        corrected state into the VI filter."""
        lc = self.loop_closer
        if lc is None:
            return
        cam, cfg, dev = self.cam, self.cfg, self.device
        if self.vio_ok:
            lc.Rcb, lc.tcb, lc.Rbc, lc.tbc = self.Rcb, self.tcb, self.Rbc, self.tbc
            lc.post_ba = lambda m: global_ba_navstate(
                m, self.gravity_w, self.Rcb, self.tcb, cam.fx, cam.fy, cam.cx, cam.cy,
                cfg.gyr_noise_sd, cfg.acc_noise_sd, cfg.gyr_bias_rw2, cfg.acc_bias_rw2,
                self.depth_inv_var, self.scale_sigmas)
        else:
            # before VIO init the map stores camera-as-body states
            eye3 = torch.eye(3, dtype=torch.float32, device=dev)
            z3 = torch.zeros(3, dtype=torch.float32, device=dev)
            lc.Rcb, lc.tcb, lc.Rbc, lc.tbc = eye3, z3, eye3, z3
            lc.post_ba = lambda m: global_ba_visual(m, cam.fx, cam.fy, cam.cx, cam.cy,
                                                    self.scale_sigmas)
        self.map, st = lc.process_keyframe(self.map, kf_slot)
        if st.get("loop"):
            ns_k = _nav_row(self.map.kf_ns, kf_slot)
            if self.vio_ok:
                self.Rcw, self.tcw = self._cam_pose(ns_k)
            else:
                self.Rcw, self.tcw = _ns_to_cam_pose(ns_k)
            self.R_vel = torch.eye(3, dtype=torch.float32, device=dev)
            self.t_vel = torch.zeros(3, dtype=torch.float32, device=dev)
            if self.vio_ok:
                self.ns = ns_k
                self.ns_prev = ns_k
                self._reset_marginal_prior()
            self.loop_events.append((self.frame_id, st["loop_kf"]))

    # ------------------------------------------------------------------
    def _recompute_bias_after_recovery(self, window: int = 6):
        """Gyro-bias re-estimation over the recovery sub-map's fresh
        keyframe chain (the last `window` keyframes); adopted as the new
        linearization point, with every stored keyframe preintegration
        re-integrated at it, when finite and |bg| <= 0.5. The accelerometer
        bias stays at its random-walk estimate."""
        cfg, m = self.cfg, self.map
        z3 = torch.zeros(3, dtype=torch.float32, device=self.device)
        pre0 = preintegrate(m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, z3, z3,
                            cfg.gyr_noise_sd, cfg.acc_noise_sd)
        ks = torch.arange(m.kf_cap, device=self.device)
        pair = (m.kf_valid & (m.kf_prev >= 0) & (ks >= m.n_kf - window) & (ks < m.n_kf)
                & (pre0.dt > 1e-6))
        if self._read(torch.sum(pair))[0] < 2:
            return
        bg = vio_init.estimate_gyro_bias(m.kf_ns.R, pre0.dR, pre0.J_R_bg, pair)
        if not self._read(torch.all(torch.isfinite(bg))
                          & (torch.linalg.vector_norm(bg) <= 0.5))[0]:
            return
        pre2 = preintegrate(m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, bg,
                            self.ns.ba, cfg.gyr_noise_sd, cfg.acc_noise_sd)
        kf_ns = dataclasses.replace(m.kf_ns, bg=bg.expand(m.kf_cap, 3).clone(),
                                    dbg=torch.zeros_like(m.kf_ns.dbg))
        self.map = dataclasses.replace(m, kf_ns=kf_ns, kf_preint=pre2)
        self.ns = dataclasses.replace(self.ns, bg=bg, dbg=z3)

    # ------------------------------------------------------------------
    # sustained-failure recovery: IMU dead-reckoning and a fresh sub-map
    # ------------------------------------------------------------------
    def _enter_recovery(self, img, pyr):
        """IMU_RELOC: the current IMU state becomes the anchor (with its
        preintegration chain back to the last keyframe) and a fresh
        detection, every track born at the anchor."""
        cfg = self.cfg
        self.state = IMU_RELOC
        self.rec_anchor_ns = self.ns
        self.rec_anchor_frame = self.frame_id
        self.rec_anchor_time = self.frame_time
        self.rec_anchor_depth = (self.cur_depth, self.cur_depth_valid)
        self.rec_anchor_preint = self.preint_kf
        self.rec_anchor_imu = dict(self.kf_imu)
        self._reset_kf_accumulators()
        t = self._undistort(self._refill(Tracks.empty(cfg.n_tracks, device=self.device), img))
        self.tracks = dataclasses.replace(
            t, birth_frame=torch.full_like(t.birth_frame, self.frame_id), birth_xy_und=t.xy_und)
        self.pyr_prev = pyr

    def _process_frame_recovery(self, img, pre_frame: PreintState) -> dict:
        """One IMU_RELOC frame: dead-reckoning with the pressure-z
        override; a re-anchor when the sub-map goes stale; once the IMU
        baseline allows, the two-view bootstrap against the anchor at the
        IMU baseline's metric scale, two keyframes and the VI BA."""
        cfg, dev = self.cfg, self.device
        self.frame_id += 1
        img = torch.as_tensor(img).to(device=dev, dtype=torch.float32)
        pyr = tuple(build_flow_pyramid(img, cfg.n_levels_klt))

        self.ns_prev = self.ns
        self.ns = self._depth_override(predict_navstate(self.ns, pre_frame, self.gravity_w))
        self.Rcw, self.tcw = self._cam_pose(self.ns)

        # the recovery tracks have no landmark guesses
        n = self.tracks.n_slots
        u = draw_uniform(self.gen, 200, n, dev)
        self.tracks = propagate_tracks(
            self.tracks, self.pyr_prev, pyr, self.tracks.xy,
            torch.zeros((n,), dtype=torch.bool, device=dev), None, win=cfg.klt_win,
            iters=cfg.klt_iters, levels=cfg.n_levels_klt, u=u)
        self.tracks = self._undistort(self.tracks)
        self.pyr_prev = pyr

        status = {"state": "IMU_RELOC"}
        since = self.frame_id - self.rec_anchor_frame
        Ra, ta = self._cam_pose(self.rec_anchor_ns)
        R_rel = mm(self.Rcw, Ra.transpose(-1, -2))
        baseline_t = torch.linalg.vector_norm(self.tcw - mv(R_rel, ta))
        n_valid, baseline = self._readf(torch.sum(self.tracks.valid), baseline_t)
        if since >= cfg.recovery_max_frames or n_valid < cfg.min_init_tracks // 2:
            self._enter_recovery(img, pyr)       # re-anchor and keep trying
            status["recovery"] = "re-anchored"
            return status
        if since < cfg.recovery_min_frames or baseline < cfg.recovery_min_baseline:
            return status

        t = self.tracks
        cand = t.valid & (t.birth_frame == self.rec_anchor_frame)
        rec = initialize_two_view(self.gen, t.birth_xy_und, t.xy_und, cand, self.K, sigma=1.0)
        if not self._read(rec["ok"])[0]:
            return status

        # metric scale from the IMU baseline; vision gives the unit-norm
        # relative translation, anchored at the IMU anchor pose
        good = rec["good"]
        s = baseline_t
        Raw = Ra.transpose(-1, -2)
        pts_w = mv(Raw, rec["points"] * s - ta)
        R1 = mm(rec["R"], Ra)
        t1 = rec["t"] * s + mv(rec["R"], ta)
        m = self.map
        normals = pts_w - mv(Raw, -ta)
        dist = torch.linalg.vector_norm(normals, dim=-1)
        normals = normals / torch.clamp(dist[:, None], min=1e-9)
        m, ids = m.add_points(pts_w, t.desc, normals, dist / 2.0, dist * 2.0, m.n_kf,
                              self.frame_id, good)
        feat_pt = torch.where(good, ids, torch.full_like(ids, -1))

        # both stored windows re-integrated at the current bias
        a, w = self.rec_anchor_imu, self.kf_imu
        pre_anchor = preintegrate(a["omg"], a["acc"], a["dt"], a["mask"], self.ns.bg,
                                  self.ns.ba, cfg.gyr_noise_sd, cfg.acc_noise_sd)
        pre_cur = preintegrate(w["omg"], w["acc"], w["dt"], w["mask"], self.ns.bg, self.ns.ba,
                               cfg.gyr_noise_sd, cfg.acc_noise_sd)
        da, dv = self.rec_anchor_depth
        m, k0 = m.add_keyframe(self.rec_anchor_ns, self.rec_anchor_time, self.rec_anchor_frame,
                               t.birth_xy_und, t.desc, t.level, t.angle, cand, feat_pt, da, dv,
                               pre_anchor, self.last_kf_slot, imu_omg=a["omg"],
                               imu_acc=a["acc"], imu_dt=a["dt"], imu_mask=a["mask"])
        ns_cur = dataclasses.replace(_cam_pose_to_ns_ext(R1, t1, self.Rbc, self.tbc),
                                     v=self.ns.v, bg=self.ns.bg, ba=self.ns.ba,
                                     dbg=self.ns.dbg, dba=self.ns.dba)
        m, k1 = m.add_keyframe(ns_cur, self.frame_time, self.frame_id, t.xy_und, t.desc, t.level,
                               t.angle, cand, feat_pt, self.cur_depth, self.cur_depth_valid,
                               pre_cur, k0, imu_omg=w["omg"], imu_acc=w["acc"], imu_dt=w["dt"],
                               imu_mask=w["mask"])
        m = self._run_vi_ba(m)
        self.map = m
        self.tracks = dataclasses.replace(t, pt_id=feat_pt)
        k1, n_good, n_kf = self._read(k1, torch.sum(good), m.n_kf)
        self.ns = _nav_row(m.kf_ns, k1)
        self.Rcw, self.tcw = self._cam_pose(self.ns)
        self.last_kf_slot = k1
        self.last_kf_frame = self.frame_id
        self.n_ref_tracked = n_good
        self._reset_kf_accumulators()
        self._ring_write(self.rec_anchor_frame, Ra, ta)
        self._ring_write(self.frame_id, self.Rcw, self.tcw)
        self.state = WORKING
        self._reset_marginal_prior()
        # the post-recovery bias recompute, once enough fresh keyframes exist
        self._reloc_bias_after_kf = n_kf + 3
        self.trajectory.append((self.frame_id, self.Rcw, self.tcw))
        status.update(state="WORKING", recovery="re-initialized", n_inliers=n_good)
        return status

    # ------------------------------------------------------------------
    def _run_vi_ba(self, m: MapState) -> MapState:
        cam, cfg = self.cam, self.cfg
        return _vi_ba(m, self.gravity_w, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas,
                      cfg.gyr_bias_rw2, cfg.acc_bias_rw2, self.depth_inv_var, self.Rcb, self.tcb)

    # ------------------------------------------------------------------
    def _strided(self, m: MapState, t_span: float, n_kf: int):
        """The strided virtual keyframes of the init solves (a stride of
        ~`vio_init_baseline_s` of keyframe spacing): positions, body
        rotations, validity, indices and the concatenated raw windows."""
        cfg = self.cfg
        dt_avg = t_span / max(n_kf - 1, 1)
        J = max(1, int(round(cfg.vio_init_baseline_s / max(dt_avg, 1e-3))))
        J = max(1, min(J, (n_kf - 2) // 4))
        sel, vvalid, s_omg, s_acc, s_dt, s_mask = vio_init.build_strided_inertial(
            m.kf_valid, m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, J)
        pv = m.kf_ns.p[sel]
        Rv = mm(m.kf_ns.R[sel], self.Rcb)
        vk = torch.arange(sel.shape[0], device=self.device)
        return pv, Rv, vvalid, vk, (s_omg, s_acc, s_dt, s_mask)

    def _triple(self, vvalid, vk, pre):
        return (vvalid & torch.roll(vvalid, 1) & torch.roll(vvalid, 2) & (vk >= 2)
                & (pre.dt > 1e-6) & (torch.roll(pre.dt, 1) > 1e-6))

    def _maybe_init_vio(self):
        """The host TryInitVIO once enough keyframes span enough time:
        the full-map visual BA, the gyro bias over keyframe pairs (body
        rotations Rwb = Rwc Rcb), then mode 1's linear [s, g_w] solve and
        its |g| refinement, or modes 2/3's gravity from the accelerometer
        average, scale from pressure and tilt refinement at fixed scale;
        then the world Sim3, the camera -> body table conversion, the
        depth anchor and the velocities."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        m = self.map
        n_kf, t_span = self._readf(m.n_kf, row(m.kf_time, torch.clamp(m.n_kf - 1, min=0))
                                   - m.kf_time[0])
        n_kf = int(n_kf)
        if n_kf < cfg.vio_init_min_kfs or t_span < cfg.vio_init_min_time:
            return
        # 0. full-map visual BA: the window BA lets the mono map's scale
        # drift across the init window
        m = global_ba_visual(m, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas)
        self.map = m

        # 1. gyro bias over consecutive keyframe pairs, body rotations
        pair_mask = m.kf_valid & (m.kf_prev >= 0)
        bg = vio_init.estimate_gyro_bias(mm(m.kf_ns.R, self.Rcb), m.kf_preint.dR,
                                         m.kf_preint.J_R_bg, pair_mask)
        # 2. every keyframe window re-integrated with it
        z3 = torch.zeros(3, dtype=torch.float32, device=dev)

        def reintegrate(bg_, ba_):
            return preintegrate(m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, bg_, ba_,
                                cfg.gyr_noise_sd, cfg.acc_noise_sd)

        pre2 = reintegrate(bg, z3)
        has_depth = m.kf_valid & m.kf_depth_valid
        n_dep_t = torch.sum(has_depth)
        g = self.gravity_w
        g_cfg_dir = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
        ba_est = z3

        def pressure_scale(Ra):
            s_gn, _ = vio_init.estimate_scale_from_pressure(mv(Ra, m.kf_ns.p)[:, 2], m.kf_depth,
                                                            has_depth)
            return s_gn

        def windows_pre(win, bg_, ba_):
            return preintegrate(*win, bg_, ba_, cfg.gyr_noise_sd, cfg.acc_noise_sd)

        if cfg.init_mode == 1:
            # 3/4 (VI): the joint linear [s, g_w] solve over strided virtual
            # keyframes, then the |g| = 9.81 solve with the accelerometer bias
            pv, Rv, vvalid, vk, win = self._strided(m, t_span, n_kf)
            pre0v = windows_pre(win, z3, z3)
            vpair = vvalid & torch.roll(vvalid, 1) & (vk >= 1) & (pre0v.dt > 1e-6)
            bg = vio_init.estimate_gyro_bias(Rv, pre0v.dR, pre0v.J_R_bg, vpair)
            prev_ = windows_pre(win, bg, z3)
            triple = self._triple(vvalid, vk, prev_)
            _, g_w = vio_init.estimate_scale_gravity_linear(pv, Rv, prev_.dP, prev_.dV, prev_.dt,
                                                            self.tbc, triple)
            s_lin, g_w, ba_est = vio_init.refine_scale_gravity_accbias(
                pv, Rv, prev_.dP, prev_.dV, prev_.dt, prev_.J_P_ba, prev_.J_V_ba, g_w, self.tbc,
                triple)
            scale = self._readf(s_lin)[0]
            if not np.isfinite(scale) or scale <= 1e-3:
                return
            scale_t = s_lin
            g_dir_vision = g_w / torch.clamp(torch.linalg.vector_norm(g_w), min=1e-9)
            pre2 = reintegrate(bg, ba_est)
            n_dep = 0
        else:
            # 3 (VIP, the paper's method): gravity in the vision world from
            # the accelerometer average (the specific force ~ -gravity)
            g_dir_vision = -self.accw_sum / torch.clamp(torch.linalg.vector_norm(self.accw_sum),
                                                        min=1e-9)
        R_align = gravity_alignment(g_dir_vision, g_cfg_dir)

        if cfg.init_mode != 1:
            # 4. metric scale from pressure on the gravity-aligned z
            scale_t = pressure_scale(R_align)
            n_dep, scale = self._readf(n_dep_t, scale_t)
            if n_dep < 3 or not np.isfinite(scale) or scale <= 1e-3:
                return
            # 4b. [dtheta_xy, ba] with the scale fixed, on strided virtual
            # keyframes; accepted under 15 degrees of tilt, then re-scaled
            pv, Rv, vvalid, vk, win = self._strided(m, t_span, n_kf)
            prev_ = windows_pre(win, bg, z3)
            triple = self._triple(vvalid, vk, prev_)
            g_ref, ba_ref = vio_init.refine_gravity_accbias_fixed_scale(
                pv, Rv, prev_.dP, prev_.dV, prev_.dt, prev_.J_P_ba, prev_.J_V_ba,
                g_dir_vision * 9.81, self.tbc, scale_t, triple)
            g_ref_dir = g_ref / torch.clamp(torch.linalg.vector_norm(g_ref), min=1e-9)
            tilt_t = torch.rad2deg(torch.arccos(torch.clamp(torch.dot(g_ref_dir, g_dir_vision),
                                                            -1.0, 1.0)))
            R_ref = gravity_alignment(g_ref_dir, g_cfg_dir)
            s2_t = pressure_scale(R_ref)
            tilt, finite, s2 = self._readf(tilt_t, torch.all(torch.isfinite(g_ref_dir)), s2_t)
            if np.isfinite(tilt) and tilt < 15.0 and finite:
                g_dir_vision, ba_est, R_align = g_ref_dir, ba_ref, R_ref
                if np.isfinite(s2) and s2 > 1e-3:
                    scale, scale_t = s2, s2_t
                pre2 = reintegrate(bg, ba_est)

        # 5. the world Sim3 x' = s R_align x
        self._apply_world_sim3(scale_t, R_align)
        m = self.map
        # 5b. camera-as-body storage -> BODY NavStates through Tbc
        if self.has_extrinsics:
            ns_b = _cam_pose_to_ns_ext(*_ns_to_cam_pose(m.kf_ns), self.Rbc, self.tbc)
            m = dataclasses.replace(m, kf_ns=dataclasses.replace(m.kf_ns, p=ns_b.p, R=ns_b.R))
            self.map = m
        # the depth anchor: world z == pressure depth (not in pure VI mode)
        p_shift, pts_shift = m.kf_ns.p.clone(), m.pt_xyz.clone()
        if cfg.init_mode != 1 and n_dep >= 3:
            off = torch.sum(torch.where(has_depth, m.kf_depth - m.kf_ns.p[:, 2],
                                        torch.zeros_like(m.kf_depth))) / torch.clamp(n_dep_t,
                                                                                     min=1)
            p_shift[:, 2] = p_shift[:, 2] + torch.where(m.kf_valid, off, torch.zeros_like(off))
            pts_shift[:, 2] = pts_shift[:, 2] + torch.where(m.pt_valid, off,
                                                            torch.zeros_like(off))
        # 6. velocities and biases into the keyframe table
        K = m.kf_cap
        kf_ns = dataclasses.replace(m.kf_ns, p=p_shift, bg=bg.expand(K, 3).clone(),
                                    ba=ba_est.expand(K, 3).clone())
        v = vio_init.velocities_from_positions(kf_ns.p, kf_ns.R, pre2.dP, pre2.dt, g,
                                               m.kf_valid)
        # the newest keyframe has no following preintegration: the
        # previous keyframe's velocity
        k_last = n_kf - 1
        if k_last >= 1:
            v = _set_row(v, k_last, v[k_last - 1])
        self.map = dataclasses.replace(m, kf_ns=dataclasses.replace(kf_ns, v=v),
                                       pt_xyz=pts_shift, kf_preint=pre2)
        # the current state: the last keyframe's
        self.ns = _nav_row(self.map.kf_ns, k_last)
        self.ns_prev = self.ns
        self.Rcw, self.tcw = self._cam_pose(self.ns)
        self.vio_ok = True
        self._reset_marginal_prior()

    # ------------------------------------------------------------------
    def _apply_world_sim3(self, s, R_align):
        """x' = s R_align x on every world-frame quantity: the keyframe
        table, the landmarks, the pose, the motion model and the ring."""
        m = self.map
        kf_ns = dataclasses.replace(m.kf_ns, p=s * mv(R_align, m.kf_ns.p),
                                    v=s * mv(R_align, m.kf_ns.v),
                                    R=mm(R_align.expand(m.kf_ns.R.shape), m.kf_ns.R))
        self.map = dataclasses.replace(m, kf_ns=kf_ns, pt_xyz=s * mv(R_align, m.pt_xyz))
        RaT = R_align.transpose(-1, -2)
        self.Rcw = mm(self.Rcw, RaT)
        self.tcw = s * self.tcw
        self.t_vel = s * self.t_vel
        self.ring_R = mm(self.ring_R, RaT[None])
        self.ring_t = s * self.ring_t
