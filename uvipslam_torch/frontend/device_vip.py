"""Device-resident visual-inertial-pressure (VIP) tracker: one
`step(state, bundle)` call per frame.

Counterpart of `uvipslam_tpu/frontend/device_vip.py`, the system's main
path. Per frame, on the tensors' device:

- optional CLAHE, the flow pyramid, and both running IMU integrals
  (frame-to-frame at the posterior bias, since-last-keyframe at zero
  bias) as one loop over the frame's samples on a batch of two; the raw
  samples are stashed for the keyframe; the IMU NavState prediction;
- mono bootstrap (NOT_INITIALIZED -> INITIALIZING -> WORKING) with the
  parallel H/F two-view initialization;
- WORKING before VIO init: the mono pose + local-map solve; after it: the
  VI two-state solve with the pressure factor (`_vi_track`), and on its
  failure a second lane on the first-try relocalization associations;
- keyframes with triangulation, one windowed BA (mono or VI(P)), map
  hygiene, and the on-device VIO init (full-map visual BA, gyro bias,
  pressure scale, gravity refinement, world re-anchor, velocities);
- LOST before VIO init: BoW + PnP relocalization; a VI failure instead
  enters IMU_RELOC: IMU dead-reckoning with the pressure-z override and a
  fresh two-view sub-map re-anchor.

The reference's staged layout stays: each heavy stage (detection, first
try, two-view, mono solve, keyframe, BA, VIO init) is written once and
run behind flags. Its `lax.switch`/`lax.cond` become Python branches on
device scalars; each decision is one counted host read (`host_syncs`),
batched where the conditions are ready together: per frame (state,
vio_ok, recovery anchor set), then the branch's own decision, and on
keyframe frames the VIO-init trigger and the hygiene compaction flag.
Each stage runs in a `torch.profiler.record_function` span `step.<stage>`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.profiler import record_function

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.preintegration import (PreintState, bias_correct, preintegrate,
                                                preintegrate_continue)
from uvipslam_torch.core.state import NavState
from uvipslam_torch.core.tree import over_streams, put_row, row, tree_map
from uvipslam_torch.frontend.device_tracker import (RING, Fleet, _i32, _nanmedian, _nav_row,
                                                    hygiene_compact, hygiene_front,
                                                    relocalize_pose, step_device)
from uvipslam_torch.frontend.frame import (Tracks, propagate_tracks, refill_tracks,
                                           refresh_descriptors)
from uvipslam_torch.frontend.tracker import (IMU_RELOC, INITIALIZING, LOST, NOT_INITIALIZED,
                                             WORKING, _cam_pose_to_ns, _cam_pose_to_ns_ext,
                                             _local_ba, _motion_guess, _ns_to_cam_pose,
                                             _ns_to_cam_pose_ext, _pose_and_localmap,
                                             _triangulate_new)
from uvipslam_torch.frontend.vip_tracker import (VipConfig, _vi_ba, _vi_track, capped_prior,
                                               gravity_alignment, predict_navstate)
from uvipslam_torch.loop.reloc import first_try_associations
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops.clahe import clahe
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import draw_uniform, initialize_two_view
from uvipslam_torch.solver.global_ba import global_ba_visual
from uvipslam_torch.vio import init as vio_init


@dataclasses.dataclass
class VipTrackerState:
    # --- visual core (as device_tracker.TrackerState) ---
    tracks: Tracks
    map: MapState
    pyr_prev: tuple
    state: torch.Tensor
    frame_id: torch.Tensor
    Rcw: torch.Tensor
    tcw: torch.Tensor
    R_vel: torch.Tensor
    t_vel: torch.Tensor
    ring_R: torch.Tensor
    ring_t: torch.Tensor
    ring_frame: torch.Tensor
    init_frame_id: torch.Tensor
    init_time: torch.Tensor       # timestamp of the init anchor frame
    last_kf_slot: torch.Tensor
    last_kf_frame: torch.Tensor
    n_ref_tracked: torch.Tensor
    gen: torch.Generator          # RANSAC draws (the reference's PRNG key)
    # --- inertial / pressure layers ---
    vio_ok: torch.Tensor          # bool
    ns: NavState                  # current body posterior
    H_prior: torch.Tensor         # [15, 15] frame-to-frame marginal information
    preint_kf: PreintState        # accumulated since the last keyframe (zero bias)
    kf_omg: torch.Tensor          # [S, 3] raw IMU window since the last keyframe
    kf_acc: torch.Tensor          # [S, 3]
    kf_dt: torch.Tensor           # [S]
    kf_mask: torch.Tensor         # [S]
    kf_n: torch.Tensor            # i32 fill level
    accw_sum: torch.Tensor        # [3] world-frame specific-force sum
    frame_time: torch.Tensor
    # --- recovery anchor ---
    rec_ns: NavState
    rec_frame: torch.Tensor       # i32, -1 = none
    rec_time: torch.Tensor
    rec_depth: torch.Tensor
    rec_depth_valid: torch.Tensor
    rec_preint: PreintState
    rec_omg: torch.Tensor
    rec_acc: torch.Tensor
    rec_dt: torch.Tensor
    rec_mask: torch.Tensor


@dataclasses.dataclass
class FrameBundle:
    """One frame's sensor bundle (fixed IMU window, mask-padded)."""
    img: torch.Tensor          # [H, W]
    imu_omg: torch.Tensor      # [Simu, 3]
    imu_acc: torch.Tensor      # [Simu, 3]
    imu_dt: torch.Tensor       # [Simu]
    imu_mask: torch.Tensor     # [Simu]
    depth: torch.Tensor        # scalar
    depth_valid: torch.Tensor  # scalar bool
    timestamp: torch.Tensor    # scalar


@dataclasses.dataclass
class VipStepOut:
    Rcw: torch.Tensor
    tcw: torch.Tensor
    p_w: torch.Tensor
    state: torch.Tensor
    vio_ok: torch.Tensor
    new_kf: torch.Tensor       # slot of a keyframe created this frame, else -1


def _imu_window(S, device):
    f32 = dict(dtype=torch.float32, device=device)
    return dict(preint_kf=PreintState.zero((), device=device), kf_omg=torch.zeros((S, 3), **f32),
                kf_acc=torch.zeros((S, 3), **f32), kf_dt=torch.zeros((S,), **f32),
                kf_mask=torch.zeros((S,), **f32), kf_n=_i32(0, device))


def init_vip_state(cfg: VipConfig, kf_cap: int, pt_cap: int, height: int, width: int,
                   seed: int = 0, device="cuda") -> VipTrackerState:
    device = step_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    S = cfg.imu_cap_per_kf
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def scalar(v):
        return torch.full((), v, **f32)

    win = _imu_window(S, device)
    return VipTrackerState(
        tracks=Tracks.empty(cfg.n_tracks, device=device),
        map=MapState.empty(kf_cap, pt_cap, cfg.n_tracks, imu_window=S, device=device),
        pyr_prev=tuple(build_flow_pyramid(torch.zeros((height, width), **f32),
                                          cfg.n_levels_klt)),
        state=_i32(NOT_INITIALIZED, device), frame_id=_i32(-1, device),
        Rcw=torch.eye(3, **f32), tcw=torch.zeros(3, **f32),
        R_vel=torch.eye(3, **f32), t_vel=torch.zeros(3, **f32),
        ring_R=torch.eye(3, **f32).repeat(RING, 1, 1), ring_t=torch.zeros((RING, 3), **f32),
        ring_frame=torch.full((RING,), -1, dtype=torch.int32, device=device),
        init_frame_id=_i32(-1, device), init_time=scalar(0.0),
        last_kf_slot=_i32(-1, device), last_kf_frame=_i32(-1, device),
        n_ref_tracked=_i32(0, device), gen=gen,
        vio_ok=torch.zeros((), dtype=torch.bool, device=device),
        ns=NavState.identity((), device=device), H_prior=torch.eye(15, **f32) * 1e2,
        accw_sum=torch.zeros(3, **f32), frame_time=scalar(0.0),
        rec_ns=NavState.identity((), device=device), rec_frame=_i32(-1, device),
        rec_time=scalar(0.0), rec_depth=scalar(0.0),
        rec_depth_valid=torch.zeros((), dtype=torch.bool, device=device),
        rec_preint=win["preint_kf"], rec_omg=win["kf_omg"], rec_acc=win["kf_acc"],
        rec_dt=win["kf_dt"], rec_mask=win["kf_mask"],
        **_imu_window(S, device))


@dataclasses.dataclass
class _Ctl:
    """Host flags from the state branch to the shared keyframe / BA
    stages (the reference's `ctl` dict)."""
    want_kf: bool = False
    want_ba: bool = False
    adopt: torch.Tensor | None = None   # keyframe slot whose pose is adopted
    want_hyg: bool = False
    want_trigger: bool = False


class VipStep:
    """The per-frame step of the device VIP tracker:
    `st, out = step(st, bundle)`. Counts its host reads in `host_syncs`."""

    def __init__(self, cam: CameraModel, cfg: VipConfig, kf_cap: int, device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.kf_cap = kf_cap
        self.device = dev = step_device(device)
        f32 = dict(dtype=torch.float32)
        self.scale_sigmas = torch.tensor(cfg.scale_sigmas, **f32).to(dev)
        self.K = torch.as_tensor(cam.K).to(dev)
        self.gravity = torch.tensor(cfg.gravity, **f32).to(dev)
        self.depth_info = float(torch.tensor(1.0 / cfg.depth_noise_sd ** 2, **f32))
        Tbc = torch.tensor(cfg.Tbc, **f32)
        self.Rbc, self.tbc = Tbc[:3, :3].to(dev), Tbc[:3, 3].to(dev)
        self.Rcb = Tbc[:3, :3].T.contiguous().to(dev)
        self.tcb = (-(Tbc[:3, :3].T @ Tbc[:3, 3])).to(dev)
        self.H0 = (torch.eye(15, **f32) * 1e2).to(dev)
        self.eye3 = torch.eye(3, **f32).to(dev)
        self.zero3 = torch.zeros(3, **f32).to(dev)
        self.zero_preint = PreintState.zero((), device=dev)
        self.empty_tracks = Tracks.empty(cfg.n_tracks, device=dev)
        self.ft_min = max(20, round(0.15 * cfg.n_tracks))
        self.reloc_min = max(10, round(0.0625 * cfg.n_tracks))   # >= 25/400 inliers
        self.host_syncs = 0

    # -- host reads ----------------------------------------------------
    def _read(self, *flags: torch.Tensor):
        """One host sync for a batch of device flags -> Python values."""
        self.host_syncs += 1
        vals = torch.stack([f.reshape(()).to(torch.int64) for f in flags]).tolist()
        return vals if len(vals) > 1 else vals[0]

    def _read_bool(self, flag: torch.Tensor) -> bool:
        return bool(self._read(flag))

    # -- helpers -------------------------------------------------------
    def _undistort(self, tracks: Tracks) -> Tracks:
        return dataclasses.replace(tracks, xy_und=self.cam.undistort_pixels(tracks.xy))

    def _cam_pose(self, ns):
        return _ns_to_cam_pose_ext(ns, self.Rcb, self.tcb)

    def _zero_kf_accumulators(self, st):
        return dataclasses.replace(st, **_imu_window(st.kf_dt.shape[0], self.device))

    def _mono_ba(self, m: MapState) -> MapState:
        kf_idx = torch.arange(m.kf_cap, device=self.device)
        in_window = (kf_idx >= m.n_kf - self.cfg.local_window) & (kf_idx < m.n_kf)
        fixed = (m.kf_valid & ~in_window) | (kf_idx == 0)
        fixed = torch.where(kf_idx == 1, m.kf_valid[1], fixed)
        cam = self.cam
        return _local_ba(m, fixed, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas)

    def _vi_ba(self, m: MapState) -> MapState:
        cam, cfg = self.cam, self.cfg
        return _vi_ba(m, self.gravity, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas,
                      cfg.gyr_bias_rw2, cfg.acc_bias_rw2, self.depth_info, self.Rcb, self.tcb)

    # -- inertial accumulation ----------------------------------------
    def _accumulate(self, st, b: FrameBundle):
        """Both running integrals in one loop over the frame's samples (a
        batch of two), the raw samples stashed at offset kf_n, and the
        world-frame specific-force sum of the gravity estimate."""
        cfg = self.cfg
        init2 = tree_map(lambda a, c: torch.stack([a, c]), self.zero_preint, st.preint_kf)
        pre2 = preintegrate_continue(
            init2, b.imu_omg, b.imu_acc, b.imu_dt, b.imu_mask,
            torch.stack([st.ns.bg_total, self.zero3]), torch.stack([st.ns.ba_total, self.zero3]),
            cfg.gyr_noise_sd, cfg.acc_noise_sd)
        pre_frame = tree_map(lambda a: a[0], pre2)
        preint_kf = tree_map(lambda a: a[1], pre2)
        # masked lanes go to the spare row S, which is dropped (never onto
        # a live slot)
        Simu, S = b.imu_dt.shape[0], st.kf_dt.shape[0]
        pos = st.kf_n + torch.arange(Simu, dtype=torch.int32, device=self.device)
        take = (b.imu_mask > 0) & (pos < S)
        dst = torch.where(take, pos, torch.full_like(pos, S)).long()

        def stash(buf, vals):
            out = torch.cat([buf, buf[:1]])
            out[dst] = vals.to(buf.dtype)
            return out[:S]

        Rwb = mm(st.Rcw.transpose(-1, -2), self.Rcb)
        msum = torch.clamp(torch.sum(b.imu_mask), min=1.0)
        mean_acc = torch.sum(b.imu_acc * b.imu_mask[:, None], 0) / msum
        do_acc = (~st.vio_ok) & (st.state == WORKING)
        accw = mv(Rwb, mean_acc)
        st = dataclasses.replace(
            st, frame_time=b.timestamp.to(torch.float32).reshape(()), preint_kf=preint_kf,
            kf_omg=stash(st.kf_omg, b.imu_omg), kf_acc=stash(st.kf_acc, b.imu_acc),
            kf_dt=stash(st.kf_dt, b.imu_dt), kf_mask=stash(st.kf_mask, b.imu_mask),
            kf_n=st.kf_n + torch.sum(take).to(torch.int32),
            accw_sum=st.accw_sum + torch.where(do_acc, accw, torch.zeros_like(accw)))
        return st, pre_frame

    # -- on-device TryInitVIO (pressure-scale mode) ---------------------
    def _try_init_vio(self, st):
        """Full-map visual BA, gyro bias, gravity from the accelerometer
        average refined with the scale fixed from pressure, world Sim3
        re-anchor, the camera -> body table conversion, the depth anchor
        and velocities. Returns (state after a successful init, ok flag)."""
        cam, cfg, dev = self.cam, self.cfg, self.device
        Rcb, gravity = self.Rcb, self.gravity
        # full-map BA first: the windowed BA lets mono scale drift across
        # the init window; slots fill in insertion order, so 24 suffice
        m = global_ba_visual(st.map, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas,
                             kf_window=min(24, self.kf_cap), n_iters=5, p_active=2048)
        # gyro bias over keyframe pairs (body rotations Rwb = Rwc Rcb)
        pair_mask = m.kf_valid & (m.kf_prev >= 0)
        bg = vio_init.estimate_gyro_bias(mm(m.kf_ns.R, Rcb), m.kf_preint.dR,
                                         m.kf_preint.J_R_bg, pair_mask)
        has_depth = m.kf_valid & m.kf_depth_valid
        n_dep = torch.sum(has_depth)
        g_cfg_dir = gravity / torch.clamp(torch.linalg.vector_norm(gravity), min=1e-9)
        g_dir_vision = -st.accw_sum / torch.clamp(torch.linalg.vector_norm(st.accw_sum),
                                                  min=1e-9)

        def pressure_scale(Ra):
            s_gn, _ = vio_init.estimate_scale_from_pressure(mv(Ra, m.kf_ns.p)[:, 2], m.kf_depth,
                                                            has_depth)
            return s_gn

        def scale_ok(s):
            return torch.isfinite(s) & (s > 1e-3) & (n_dep >= 3)

        s0 = pressure_scale(gravity_alignment(g_dir_vision, g_cfg_dir))
        s0 = torch.where(scale_ok(s0), s0, torch.ones_like(s0))

        # refine [dtheta_xy, ba] with the scale fixed, on strided virtual
        # keyframes
        sel, vvalid, s_omg, s_acc, s_dt, s_mask = vio_init.build_strided_inertial(
            m.kf_valid, m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, 4)
        prev_ = preintegrate(s_omg, s_acc, s_dt, s_mask, bg, self.zero3, cfg.gyr_noise_sd,
                             cfg.acc_noise_sd)
        vk = torch.arange(sel.shape[0], device=dev)
        triple = (vvalid & torch.roll(vvalid, 1) & torch.roll(vvalid, 2) & (vk >= 2)
                  & (prev_.dt > 1e-6) & (torch.roll(prev_.dt, 1) > 1e-6))
        g_ref, ba_ref = vio_init.refine_gravity_accbias_fixed_scale(
            m.kf_ns.p[sel], mm(m.kf_ns.R[sel], Rcb), prev_.dP, prev_.dV, prev_.dt,
            prev_.J_P_ba, prev_.J_V_ba, g_dir_vision * 9.81, self.tbc, s0, triple)
        g_ref_dir = g_ref / torch.clamp(torch.linalg.vector_norm(g_ref), min=1e-9)
        tilt_ok = ((torch.sum(triple) >= 2) & torch.all(torch.isfinite(g_ref_dir))
                   & (torch.dot(g_ref_dir, g_dir_vision) > math.cos(math.radians(15.0))))
        g_dir_vision = torch.where(tilt_ok, g_ref_dir, g_dir_vision)
        ba_est = torch.where(tilt_ok, ba_ref, torch.zeros_like(ba_ref))

        R_align = gravity_alignment(g_dir_vision, g_cfg_dir)
        s = pressure_scale(R_align)
        ok = scale_ok(s)
        s = torch.where(ok, s, torch.ones_like(s))
        # every keyframe window re-integrated at both biases (velocity
        # recovery and the VI BA's preintegration edges)
        pre2 = preintegrate(m.kf_imu_omg, m.kf_imu_acc, m.kf_imu_dt, m.kf_imu_mask, bg, ba_est,
                            cfg.gyr_noise_sd, cfg.acc_noise_sd)

        # world Sim3 x' = s R_align x, then camera-as-body -> BODY states
        kf_ns = dataclasses.replace(m.kf_ns, p=s * mv(R_align, m.kf_ns.p),
                                    v=s * mv(R_align, m.kf_ns.v),
                                    R=mm(R_align.expand(m.kf_ns.R.shape), m.kf_ns.R))
        pt_xyz = s * mv(R_align, m.pt_xyz)
        ns_b = _cam_pose_to_ns_ext(*_ns_to_cam_pose(kf_ns), self.Rbc, self.tbc)
        # depth anchor: world z == pressure depth
        off = torch.sum(torch.where(has_depth, m.kf_depth - ns_b.p[:, 2],
                                    torch.zeros_like(m.kf_depth))) / torch.clamp(n_dep, min=1)

        def z_shift(p, valid):
            out = p.clone()
            out[:, 2] = p[:, 2] + torch.where(valid, off, torch.zeros_like(off))
            return out

        K = m.kf_cap
        kf_ns = dataclasses.replace(kf_ns, p=z_shift(ns_b.p, m.kf_valid), R=ns_b.R,
                                    bg=bg.expand(K, 3).clone(), ba=ba_est.expand(K, 3).clone())
        vel = vio_init.velocities_from_positions(kf_ns.p, kf_ns.R, pre2.dP, pre2.dt, gravity,
                                                 m.kf_valid)
        k_last = torch.clamp(m.n_kf - 1, min=0)
        vel = put_row(vel, k_last, row(vel, torch.clamp(k_last - 1, min=0)))
        kf_ns = dataclasses.replace(kf_ns, v=vel)
        m2 = dataclasses.replace(m, kf_ns=kf_ns, pt_xyz=z_shift(pt_xyz, m.pt_valid),
                                 kf_preint=pre2)
        ns_new = _nav_row(m2.kf_ns, k_last)
        Rcw2, tcw2 = self._cam_pose(ns_new)
        st_ok = dataclasses.replace(
            st, map=m2, ns=ns_new, Rcw=Rcw2, tcw=tcw2, R_vel=self.eye3, t_vel=self.zero3,
            # the ring z-offset is skipped: the ring only seeds
            # triangulation and refills within a few frames
            ring_R=mm(st.ring_R, R_align.transpose(-1, -2)[None]), ring_t=s * st.ring_t,
            vio_ok=torch.ones((), dtype=torch.bool, device=dev), H_prior=self.H0)
        return st_ok, ok

    # -- the frame's shared stages ---------------------------------------
    # Each takes one stream's tensors and makes no host read, so the fleet
    # fleet step runs it once over a stream dimension (`tree.over_streams`).
    def _images(self, b: FrameBundle):
        """The frame's image on the device, enhanced when asked, and its
        flow pyramid."""
        img = b.img.to(device=self.device, dtype=torch.float32)
        if self.cfg.enhance:
            img = clahe(img)
        return dataclasses.replace(b, img=img), tuple(build_flow_pyramid(img,
                                                                         self.cfg.n_levels_klt))

    def _preintegrate(self, st, b: FrameBundle):
        st = dataclasses.replace(st, frame_id=st.frame_id + 1)
        st, pre_frame = self._accumulate(st, b)
        ns_pred = predict_navstate(st.ns, pre_frame, self.gravity)
        Rcw_pred, tcw_pred = self._cam_pose(ns_pred)
        return st, pre_frame, ns_pred, Rcw_pred, tcw_pred

    def _propagate(self, st, pyr, Rcw_pred, tcw_pred, u):
        """Track propagation from the motion-model pose: the IMU
        prediction after VIO init, the velocity model before. `u` are the
        RANSAC gate's uniform draws (`twoview.draw_uniform`)."""
        cfg, cam = self.cfg, self.cam
        Rp = torch.where(st.vio_ok, Rcw_pred, mm(st.R_vel, st.Rcw))
        tp = torch.where(st.vio_ok, tcw_pred, mv(st.R_vel, st.tcw) + st.t_vel)
        guess, guess_ok = _motion_guess(st.tracks, st.map, Rp, tp, cam.fx, cam.fy, cam.cx, cam.cy)
        return propagate_tracks(st.tracks, st.pyr_prev, pyr, guess, guess_ok, None,
                                win=cfg.klt_win, iters=cfg.klt_iters, levels=cfg.n_levels_klt,
                                u=u)

    def _detect(self, st, img):
        """Shared detection: LOST and a new recovery anchor restart from
        an empty table; NOT_INITIALIZED and WORKING top up dead slots."""
        cfg = self.cfg
        fresh = (st.state == LOST) | ((st.state == IMU_RELOC) & (st.rec_frame < 0))
        base = tree_map(lambda t, e: torch.where(fresh, e, t), st.tracks, self.empty_tracks)
        tracks = refill_tracks(base, img, st.frame_id, n_features=cfg.n_tracks,
                               px_distance=cfg.px_distance)
        return refresh_descriptors(tracks, img)

    def _finish_tracks(self, st, tracks):
        tracks = self._undistort(tracks)
        newborn = tracks.birth_frame == st.frame_id
        tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
            newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
        return dataclasses.replace(st, tracks=tracks)

    def _two_view(self, st, s: int):
        """Shared two-view reconstruction (init and the recovery
        re-anchor); draws from `st.gen`."""
        tracks = st.tracks
        anchor = st.rec_frame if s == IMU_RELOC else st.init_frame_id
        cand_tv = tracks.valid & (tracks.birth_frame == anchor)
        with record_function("step.two_view_init"):
            rec = initialize_two_view(st.gen, tracks.birth_xy_und, tracks.xy_und, cand_tv,
                                      self.K, sigma=1.0)
        return rec, cand_tv

    def _mono_seed_solve(self, st):
        """Pose + local-map solve from the motion-model seed."""
        cam = self.cam
        R, t, _, n, tr = _pose_and_localmap(st.tracks, st.map, mm(st.R_vel, st.Rcw),
                                            mv(st.R_vel, st.tcw) + st.t_vel, cam.fx, cam.fy,
                                            cam.cx, cam.cy, self.scale_sigmas)
        return R, t, n, tr

    def _ring_and_out(self, st, pyr):
        """The pose ring (written on WORKING frames), the carried pyramid
        and the frame's output."""
        working = st.state == WORKING
        slot = torch.remainder(st.frame_id, RING)
        st = dataclasses.replace(
            st, pyr_prev=pyr,
            ring_R=torch.where(working, put_row(st.ring_R, slot, st.Rcw), st.ring_R),
            ring_t=torch.where(working, put_row(st.ring_t, slot, st.tcw), st.ring_t),
            ring_frame=torch.where(working, put_row(st.ring_frame, slot, st.frame_id),
                                   st.ring_frame))
        new_kf = torch.where(st.last_kf_frame == st.frame_id, st.last_kf_slot,
                             torch.full_like(st.last_kf_slot, -1))
        return st, VipStepOut(Rcw=st.Rcw, tcw=st.tcw, p_w=st.ns.p, state=st.state,
                              vio_ok=st.vio_ok, new_kf=new_kf)

    # -- state branches: device flags, then the update of each outcome ----
    def _state(self, st, label: int):
        return dataclasses.replace(st, state=torch.full_like(st.state, label))

    def _not_init_flag(self, st):
        return torch.sum(st.tracks.valid) >= self.cfg.min_init_tracks

    def _not_init_go(self, st):
        t = st.tracks
        t = dataclasses.replace(t, birth_frame=torch.full_like(t.birth_frame, 0) + st.frame_id,
                                birth_xy_und=t.xy_und)
        return dataclasses.replace(self._state(st, INITIALIZING), tracks=t,
                                   init_frame_id=st.frame_id.clone(),
                                   init_time=st.frame_time.clone())

    def _not_initialized(self, st):
        st = self._zero_kf_accumulators(st)
        if not self._read_bool(self._not_init_flag(st)):
            return st, NOT_INITIALIZED, _Ctl()
        return self._not_init_go(st), INITIALIZING, _Ctl()

    def _initializing_flags(self, st, rec, cand_tv):
        cfg = self.cfg
        n_cand = torch.sum(cand_tv)
        return (rec["ok"] & (n_cand >= cfg.min_init_tracks // 2),
                (n_cand < cfg.min_init_tracks // 2) | (st.frame_id - st.init_frame_id > 30))

    def _initializing(self, st, b, rec, cand_tv, decided=None):
        """`decided` = the (ok, stale) flags when the caller has read them
        already (the fleet reads every stream's in one table)."""
        ok_h, stale_h = decided or self._read(*self._initializing_flags(st, rec, cand_tv))
        if not ok_h:
            label = NOT_INITIALIZED if stale_h else INITIALIZING
            return self._state(st, label), label, _Ctl()
        t = st.tracks
        good = rec["good"]
        z = rec["points"][:, 2]
        med = torch.nan_to_num(_nanmedian(torch.where(good, z, torch.full_like(z, float("nan")))),
                               nan=1.0)
        scale = 1.0 / torch.clamp(med, min=1e-6)
        pts3 = rec["points"] * scale
        m = st.map
        ns0 = _cam_pose_to_ns(self.eye3, self.zero3)
        ns1 = _cam_pose_to_ns(rec["R"], rec["t"] * scale)
        dist = torch.linalg.vector_norm(pts3, dim=-1)
        normals = pts3 / torch.clamp(dist[:, None], min=1e-9)
        m, ids = m.add_points(pts3, t.desc, normals, dist / 2.0, dist * 2.0, 0, st.frame_id, good)
        feat_pt = torch.where(good, ids, torch.full_like(ids, -1))
        zp = self.zero_preint
        m, k0 = m.add_keyframe(ns0, st.init_time, st.init_frame_id, t.birth_xy_und, t.desc,
                               t.level, t.angle, cand_tv, feat_pt, 0.0, False, zp, -1)
        m, k1 = m.add_keyframe(ns1, st.frame_time, st.frame_id, t.xy_und, t.desc, t.level,
                               t.angle, cand_tv, feat_pt, b.depth, b.depth_valid, zp, k0)
        slot0 = torch.remainder(st.init_frame_id, RING)
        st = dataclasses.replace(
            st, tracks=dataclasses.replace(t, pt_id=feat_pt), map=m, R_vel=self.eye3,
            t_vel=self.zero3, ring_R=put_row(st.ring_R, slot0, self.eye3),
            ring_t=put_row(st.ring_t, slot0, self.zero3),
            ring_frame=put_row(st.ring_frame, slot0, st.init_frame_id))
        # pose adoption, mono BA and the WORKING transition: stage D
        return st, WORKING, _Ctl(want_ba=True, adopt=k1)

    def _need_kf(self, st, n_in, forced=None):
        cfg = self.cfg
        since = st.frame_id - st.last_kf_frame
        need = (since >= cfg.kf_min_interval) & (
            (since >= cfg.kf_max_interval)
            | (n_in < cfg.kf_track_ratio * torch.clamp(st.n_ref_tracked, min=1)))
        return need if forced is None else need | forced

    def _kf_ctl(self, need: bool, trigger: bool):
        return _Ctl(want_kf=need, want_ba=need, want_hyg=need and self.cfg.map_hygiene,
                    want_trigger=trigger)

    def _mono_flags(self, st, ml):
        n_ml = ml[2]
        return n_ml < self.cfg.min_tracked, self._need_kf(st, n_ml)

    def _mono_apply(self, st, ml):
        R_ml, t_ml, _, tr_ml = ml
        Rinv, tinv = lie.se3_inverse(st.Rcw, st.tcw)
        R_vel, t_vel = lie.se3_compose(R_ml, t_ml, Rinv, tinv)
        return dataclasses.replace(st, tracks=tr_ml, Rcw=lie.normalize_rotation(R_ml), tcw=t_ml,
                                   R_vel=lie.normalize_rotation(R_vel), t_vel=t_vel)

    def _mono_working(self, st, ml):
        lost, need = self._read(*self._mono_flags(st, ml))
        if lost:
            return self._state(st, LOST), LOST, _Ctl()
        return self._mono_apply(st, ml), WORKING, self._kf_ctl(bool(need), trigger=bool(need))

    def _vi_solve(self, st, tracks, b, ns_pred, pre_frame):
        cfg, cam = self.cfg, self.cam
        depth_info = torch.where(b.depth_valid, torch.full_like(b.depth, self.depth_info),
                                 torch.zeros_like(b.depth))
        return _vi_track(tracks, st.map, ns_pred, st.ns, pre_frame, self.gravity, cam.fx,
                         cam.fy, cam.cx, cam.cy, self.scale_sigmas, cfg.gyr_bias_rw2,
                         cfg.acc_bias_rw2, b.depth, depth_info, st.H_prior, self.Rcb, self.tcb)

    def _vi_lane0(self, st, b, ns_pred, pre_frame):
        """Lane 0, the normal associations: the solve and its (ok,
        need-keyframe) flags."""
        out = self._vi_solve(st, st.tracks, b, ns_pred, pre_frame)
        return out, (out[2] >= self.cfg.min_tracked, self._need_kf(st, out[2]))

    def _vi_apply(self, st, out):
        ns_opt, _, _, tracks2, H_post = out
        Rcw, tcw = self._cam_pose(ns_opt)
        return dataclasses.replace(st, tracks=tracks2, ns=ns_opt, Rcw=Rcw, tcw=tcw,
                                   H_prior=capped_prior(H_post))

    def _vi_lane1(self, st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame):
        """Lane 1 (only when lane 0 fails): the first-try relocalization
        associations, which force a keyframe; on their failure IMU
        dead-reckoning with the pressure-z override (the anchor, a fresh
        detection + stash, is captured on the next frame)."""
        cam, cfg = self.cam, self.cfg
        with record_function("step.first_try"):
            ft_pid, ft_nm = first_try_associations(
                st.tracks, st.map, torch.clamp(st.last_kf_slot, 0, self.kf_cap - 1),
                Rcw_pred, tcw_pred, cam.fx, cam.fy, cam.cx, cam.cy,
                min_matches=self.ft_min)
            ft_gate = (ft_nm >= self.ft_min) & (st.last_kf_slot >= 0) & cfg.reloc_first_try
            tracks_ft = dataclasses.replace(
                st.tracks, pt_id=torch.where(ft_gate, ft_pid, torch.full_like(ft_pid, -1)))
        with record_function("step.vi_track"):
            out = self._vi_solve(st, tracks_ft, b, ns_pred, pre_frame)
        if self._read_bool(out[2] >= self.reloc_min):
            return self._vi_apply(st, out), WORKING, self._kf_ctl(True, trigger=False)
        st = dataclasses.replace(self._dead_reckon(st, b, ns_pred),
                                 state=_i32(IMU_RELOC, self.device),
                                 rec_frame=_i32(-1, self.device), H_prior=self.H0)
        return st, IMU_RELOC, _Ctl()

    def _vi_working(self, st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame):
        with record_function("step.vi_track"):
            out, flags = self._vi_lane0(st, b, ns_pred, pre_frame)
        ok, need = self._read(*flags)
        if not ok:
            return self._vi_lane1(st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame)
        return self._vi_apply(st, out), WORKING, self._kf_ctl(bool(need), trigger=False)

    def _dead_reckon(self, st, b, ns_pred):
        p = ns_pred.p.clone()
        p[2] = torch.where(b.depth_valid, b.depth, ns_pred.p[2])
        ns_dr = dataclasses.replace(ns_pred, p=p)
        Rcw, tcw = self._cam_pose(ns_dr)
        return dataclasses.replace(st, ns=ns_dr, Rcw=Rcw, tcw=tcw)

    def _lost(self, st, ml):
        R_ml, t_ml, n_ml, tr_ml = ml
        if not self._read_bool(n_ml >= max(self.cfg.min_tracked, 15)):
            return st, LOST, _Ctl()
        Rcw = lie.normalize_rotation(R_ml)
        ns = _cam_pose_to_ns(Rcw, t_ml)
        st = dataclasses.replace(
            st, tracks=tr_ml, Rcw=Rcw, tcw=t_ml,
            ns=dataclasses.replace(st.ns, p=ns.p, R=ns.R, v=self.zero3),
            R_vel=self.eye3, t_vel=self.zero3, H_prior=self.H0, state=_i32(WORKING, self.device))
        return self._zero_kf_accumulators(st), WORKING, _Ctl()

    def _recovery(self, st, b, ns_pred, rec, cand_tv, has_anchor: bool):
        cfg, dev = self.cfg, self.device
        st = self._dead_reckon(st, b, ns_pred)
        t = st.tracks
        if not has_anchor:
            # first recovery frame: the fresh detection is the re-anchor
            t2 = dataclasses.replace(t, birth_frame=torch.full_like(t.birth_frame, 0) + st.frame_id,
                                     birth_xy_und=t.xy_und)
            st = dataclasses.replace(
                st, tracks=t2, rec_ns=st.ns, rec_frame=st.frame_id.clone(),
                rec_time=st.frame_time, rec_depth=b.depth.to(torch.float32).reshape(()),
                rec_depth_valid=b.depth_valid.reshape(()), rec_preint=st.preint_kf,
                rec_omg=st.kf_omg, rec_acc=st.kf_acc, rec_dt=st.kf_dt, rec_mask=st.kf_mask,
                H_prior=self.H0)
            return self._zero_kf_accumulators(st), IMU_RELOC, _Ctl()

        since = st.frame_id - st.rec_frame
        stale = (since >= cfg.recovery_max_frames) | (torch.sum(t.valid) < cfg.min_init_tracks // 2)
        Ra, ta = self._cam_pose(st.rec_ns)
        R_rel = mm(st.Rcw, Ra.transpose(-1, -2))
        baseline = torch.linalg.vector_norm(st.tcw - mv(R_rel, ta))
        try_ok = (~stale & (since >= cfg.recovery_min_frames)
                  & (baseline >= cfg.recovery_min_baseline) & rec["ok"])
        try_h, stale_h = self._read(try_ok, stale)
        if not try_h:
            # stale: re-anchor on the next frame's fresh detection
            if stale_h:
                st = dataclasses.replace(st, rec_frame=_i32(-1, dev))
            return st, IMU_RELOC, _Ctl()

        good = rec["good"]
        pts_c = rec["points"] * baseline
        Raw = Ra.transpose(-1, -2)
        pts_w = mv(Raw, pts_c - ta)
        R1 = mm(rec["R"], Ra)
        t1 = rec["t"] * baseline + mv(rec["R"], ta)
        m = st.map
        normals = pts_w - mv(Raw, -ta)
        dist = torch.linalg.vector_norm(normals, dim=-1)
        normals = normals / torch.clamp(dist[:, None], min=1e-9)
        m, ids = m.add_points(pts_w, t.desc, normals, dist / 2.0, dist * 2.0, m.n_kf,
                              st.frame_id, good)
        feat_pt = torch.where(good, ids, torch.full_like(ids, -1))
        # both stored windows re-integrated at the current bias, one loop
        pre_2 = preintegrate(torch.stack([st.rec_omg, st.kf_omg]),
                             torch.stack([st.rec_acc, st.kf_acc]),
                             torch.stack([st.rec_dt, st.kf_dt]),
                             torch.stack([st.rec_mask, st.kf_mask]), st.ns.bg, st.ns.ba,
                             cfg.gyr_noise_sd, cfg.acc_noise_sd)
        m, k0 = m.add_keyframe(st.rec_ns, st.rec_time, st.rec_frame, t.birth_xy_und, t.desc,
                               t.level, t.angle, cand_tv, feat_pt, st.rec_depth,
                               st.rec_depth_valid, tree_map(lambda a: a[0], pre_2),
                               st.last_kf_slot, imu_omg=st.rec_omg, imu_acc=st.rec_acc,
                               imu_dt=st.rec_dt, imu_mask=st.rec_mask)
        ns_cur = dataclasses.replace(_cam_pose_to_ns_ext(R1, t1, self.Rbc, self.tbc), v=st.ns.v,
                                     bg=st.ns.bg, ba=st.ns.ba, dbg=st.ns.dbg, dba=st.ns.dba)
        m, k1 = m.add_keyframe(ns_cur, st.frame_time, st.frame_id, t.xy_und, t.desc, t.level,
                               t.angle, cand_tv, feat_pt, b.depth, b.depth_valid,
                               tree_map(lambda a: a[1], pre_2), k0, imu_omg=st.kf_omg,
                               imu_acc=st.kf_acc, imu_dt=st.kf_dt, imu_mask=st.kf_mask)
        slot = torch.remainder(st.rec_frame, RING)
        st = dataclasses.replace(
            st, map=m, tracks=dataclasses.replace(t, pt_id=feat_pt),
            ring_R=put_row(st.ring_R, slot, Ra), ring_t=put_row(st.ring_t, slot, ta),
            ring_frame=put_row(st.ring_frame, slot, st.rec_frame))
        # VI BA, k1 adoption and the WORKING transition: stage D
        return st, WORKING, _Ctl(want_ba=True, adopt=k1)

    # -- shared stages C and D -----------------------------------------
    def _create_kf(self, st, b, vio_ok: bool):
        """Triangulation and the keyframe (VI keyframes store the window
        re-linearized at the base bias through the carried Jacobians)."""
        cam = self.cam
        m, t = _triangulate_new(st.map, st.tracks, st.ring_R, st.ring_t, st.ring_frame, st.Rcw,
                                st.tcw, cam.fx, cam.fy, cam.cx, cam.cy, st.frame_id,
                                st.last_kf_slot)
        if vio_ok:
            pre_store, ns_store = bias_correct(st.preint_kf, st.ns.bg, st.ns.ba), st.ns
        else:
            pre_store, ns_store = st.preint_kf, _cam_pose_to_ns(st.Rcw, st.tcw)
        m, k = m.add_keyframe(ns_store, st.frame_time, st.frame_id, t.xy_und, t.desc, t.level,
                              t.angle, t.valid, t.pt_id, b.depth, b.depth_valid, pre_store,
                              st.last_kf_slot, imu_omg=st.kf_omg, imu_acc=st.kf_acc,
                              imu_dt=st.kf_dt, imu_mask=st.kf_mask)
        return dataclasses.replace(st, tracks=t, map=m), k

    def _ba_front(self, st, k, vio_ok: bool, hygiene: bool):
        """One windowed BA (mono xor VI), pose adoption of keyframe `k`,
        the WORKING transition, and the map hygiene up to its compaction
        flag (returned beside the state)."""
        cam = self.cam
        if vio_ok:
            with record_function("step.vi_ba"):
                m = self._vi_ba(st.map)
        else:
            with record_function("step.local_ba"):
                m = self._mono_ba(st.map)
        ns_k = _nav_row(m.kf_ns, k)
        Rcw, tcw = self._cam_pose(ns_k) if vio_ok else _ns_to_cam_pose(ns_k)
        t = st.tracks
        compact = torch.zeros_like(st.vio_ok)
        if hygiene:
            m, t, compact = hygiene_front(m, t, st.frame_id, Rcw, tcw, cam.fx, cam.fy, cam.cx,
                                          cam.cy)
        st = dataclasses.replace(
            self._state(st, WORKING), tracks=t, map=m, ns=ns_k if vio_ok else st.ns, Rcw=Rcw,
            tcw=tcw, last_kf_slot=k.to(torch.int32), last_kf_frame=st.frame_id.clone(),
            H_prior=self.H0)
        return st, compact

    def _compact(self, st):
        m, t = hygiene_compact(st.map, st.tracks)
        return dataclasses.replace(st, map=m, tracks=t)

    def _ba_finish(self, st):
        t = st.tracks
        st = dataclasses.replace(
            st, n_ref_tracked=torch.sum(t.valid & (t.pt_id >= 0)).to(torch.int32))
        return self._zero_kf_accumulators(st)

    def _trigger_flag(self, st):
        """The VIO-init trigger: enough keyframes over enough time."""
        cfg, m = self.cfg, st.map
        t_span = row(m.kf_time, torch.clamp(m.n_kf - 1, min=0)) - m.kf_time[0]
        return (m.n_kf >= cfg.vio_init_min_kfs) & (t_span >= cfg.vio_init_min_time)

    def _ba_and_adopt(self, st, ctl: _Ctl, vio_ok: bool):
        """Stage D of one stream: BA and adoption, hygiene with its
        compaction, and the VIO-init trigger."""
        st, compact = self._ba_front(st, ctl.adopt, vio_ok, ctl.want_hyg)
        if ctl.want_hyg and self._read_bool(compact):
            st = self._compact(st)
        st = self._ba_finish(st)
        if ctl.want_trigger and not vio_ok and self._read_bool(self._trigger_flag(st)):
            with record_function("step.vio_init"):
                st_ok, ok = self._try_init_vio(st)
            if self._read_bool(ok):
                st = st_ok
        return st

    # ------------------------------------------------------------------
    def _branch(self, st, b, s: int, vio_ok: bool, has_anchor: bool, ns_pred, Rcw_pred,
                tcw_pred, pre_frame):
        """One stream's state branch with the stages only it runs (the
        two-view reconstruction, the mono solve, the relocalization).
        Returns (state, label, ctl)."""
        rec = cand_tv = None
        if s == INITIALIZING or (s == IMU_RELOC and has_anchor):
            rec, cand_tv = self._two_view(st, s)
        if s == NOT_INITIALIZED:
            return self._not_initialized(st)
        if s == INITIALIZING:
            return self._initializing(st, b, rec, cand_tv)
        if s == WORKING and vio_ok:
            return self._vi_working(st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame)
        if s == WORKING:
            with record_function("step.pose_localmap"):
                ml = self._mono_seed_solve(st)
            return self._mono_working(st, ml)
        if s == LOST:
            with record_function("step.relocalize"):
                ml = relocalize_pose(st.tracks, st.map, st.gen, self.cam, self.scale_sigmas)
            return self._lost(st, ml)
        return self._recovery(st, b, ns_pred, rec, cand_tv, has_anchor)

    def __call__(self, st: VipTrackerState, b: FrameBundle):
        """One frame bundle. RANSAC minimal samples draw from `st.gen`."""
        cfg = self.cfg
        b, pyr = self._images(b)
        with record_function("step.preintegrate"):
            st, pre_frame, ns_pred, Rcw_pred, tcw_pred = self._preintegrate(st, b)

        s, vio_ok, has_anchor = self._read(st.state, st.vio_ok, st.rec_frame >= 0)
        vio_ok, has_anchor = bool(vio_ok), bool(has_anchor)

        tracks = st.tracks
        if s in (INITIALIZING, WORKING, IMU_RELOC):
            with record_function("step.propagate"):
                u = draw_uniform(st.gen, 200, cfg.n_tracks, self.device)
                tracks = self._propagate(st, pyr, Rcw_pred, tcw_pred, u)
        need_fresh = s == LOST or (s == IMU_RELOC and not has_anchor)
        if need_fresh or s in (NOT_INITIALIZED, WORKING):
            with record_function("step.refill_refresh"):
                tracks = self._detect(dataclasses.replace(st, tracks=tracks), b.img)
        st = self._finish_tracks(st, tracks)

        st, _, ctl = self._branch(st, b, s, vio_ok, has_anchor, ns_pred, Rcw_pred, tcw_pred,
                                  pre_frame)
        if ctl.want_kf:
            with record_function("step.keyframe"):
                st, ctl.adopt = self._create_kf(st, b, vio_ok)
        if ctl.want_ba:
            st = self._ba_and_adopt(st, ctl, vio_ok)
        return self._ring_and_out(st, pyr)


class VipFleetStep(Fleet):
    """The VIP step over a fleet of S streams in lockstep:
    `st, out = step(st, bundle, gens)` with a leading [S] on every tensor
    leaf of the state, the bundle and the output, and one
    `torch.Generator` per stream held beside the state.

    Lockstep with grouped dispatch: per frame one host read of the
    [S, 3] table (state, vio_ok, recovery anchor set); the streams are
    then grouped by branch and every stage of `VipStep` runs once over
    the streams that take it (their rows gathered, the single-stream
    stage mapped over the stream dimension by `tree.over_streams`, the
    rows scattered back). Each branch decision is one read of an [n, k]
    table for its n streams. The rare, heavy branches run per stream
    through `VipStep`'s own code on that stream's row: the two-view
    reconstruction of INITIALIZING, the relocalization of LOST, the
    first-try lane after a failed VI solve and IMU_RELOC's recovery.

    Stream i of a fleet computes what a single `VipStep` run computes on
    stream i's inputs with generator i: same branches, same draws in the
    same order (to the rounding of the batched matrix products)."""

    def __init__(self, cam: CameraModel, cfg: VipConfig, kf_cap: int, device="cuda"):
        super().__init__(VipStep(cam, cfg, kf_cap, device=device))

    # ------------------------------------------------------------------
    def __call__(self, st: VipTrackerState, b: FrameBundle, gens):
        one, cfg, dev = self.one, self.cfg, self.device
        S = st.state.shape[0]
        every = list(range(S))

        def group(pred):
            return [i for i in every if pred(i)]

        def on(ids, fn, *trees, **kw):
            """fn over the rows of streams `ids` of full-fleet trees."""
            return over_streams(fn, *(self._take(t, ids, every) for t in trees), **kw)

        b, pyr = over_streams(one._images, b)
        with record_function("step.preintegrate"):
            st, pre_frame, ns_pred, Rcw_pred, tcw_pred = over_streams(one._preintegrate, st, b)
        flags = self._read(st.state, st.vio_ok, st.rec_frame >= 0)
        s = [f[0] for f in flags]
        vio = [bool(f[1]) for f in flags]
        anchor = [bool(f[2]) for f in flags]

        tracks = st.tracks
        g = group(lambda i: s[i] in (INITIALIZING, WORKING, IMU_RELOC))
        if g:
            with record_function("step.propagate"):
                u = torch.stack([draw_uniform(gens[i], 200, cfg.n_tracks, dev) for i in g])
                sub = over_streams(one._propagate, *(self._take(t, g, every) for t in
                                                     (st, pyr, Rcw_pred, tcw_pred)), u)
                tracks = self._put(tracks, g, sub, every)
        g = group(lambda i: s[i] in (NOT_INITIALIZED, WORKING, LOST)
                  or (s[i] == IMU_RELOC and not anchor[i]))
        if g:
            with record_function("step.refill_refresh"):
                tracks = self._put(tracks, g, on(g, one._detect,
                                                 dataclasses.replace(st, tracks=tracks), b.img),
                                   every)
        st = over_streams(one._finish_tracks, st, tracks)

        ctl = {i: _Ctl() for i in every}
        adopt = torch.zeros((S,), dtype=torch.long, device=dev)

        def rows(i):
            """Stream i's state (with its generator) and frame context."""
            return [self._row(st, i, gens[i])] + [
                self._row(t, i) for t in (b, ns_pred, Rcw_pred, tcw_pred, pre_frame)]

        def settle(i, result):
            """Write back what a per-stream branch returned."""
            nonlocal st, adopt
            r, _, ctl[i] = result
            st = self._put_row(st, i, r)
            if ctl[i].adopt is not None:
                adopt = adopt.index_copy(0, self._ix([i]), ctl[i].adopt.reshape(1).long())

        # NOT_INITIALIZED
        g = group(lambda i: s[i] == NOT_INITIALIZED)
        if g:
            sub = on(g, one._zero_kf_accumulators, st)
            go = self._read(over_streams(one._not_init_flag, sub))
            g_go = [i for i, f in zip(g, go) if f[0]]
            if g_go:
                sub = self._put(sub, g_go, over_streams(one._not_init_go,
                                                        self._take(sub, g_go, g)), g)
            st = self._put(st, g, sub, every)

        # INITIALIZING: the reconstruction per stream, one read for all
        g = group(lambda i: s[i] == INITIALIZING)
        if g:
            recs = [one._two_view(self._row(st, i, gens[i]), s[i]) for i in g]
            fl = [one._initializing_flags(self._row(st, i), *rc) for i, rc in zip(g, recs)]
            dec = self._read(torch.stack([f[0] for f in fl]), torch.stack([f[1] for f in fl]))
            for i, (rec, cand_tv), d in zip(g, recs, dec):
                r, b_i = rows(i)[:2]
                settle(i, one._initializing(r, b_i, rec, cand_tv, decided=tuple(d)))

        # WORKING before VIO init: the mono pose + local-map solve
        g = group(lambda i: s[i] == WORKING and not vio[i])
        if g:
            sub = self._take(st, g, every)
            with record_function("step.pose_localmap"):
                ml = over_streams(one._mono_seed_solve, sub)
            dec = self._read(*over_streams(one._mono_flags, sub, ml))
            live = [i for i, d in zip(g, dec) if not d[0]]
            lost = [i for i, d in zip(g, dec) if d[0]]
            if live:
                sub = self._put(sub, live, over_streams(
                    one._mono_apply, self._take(sub, live, g), self._take(ml, live, g)), g)
            if lost:
                sub = self._put(sub, lost, over_streams(one._state, self._take(sub, lost, g),
                                                        label=LOST), g)
            st = self._put(st, g, sub, every)
            for i, d in zip(g, dec):
                if not d[0]:
                    ctl[i] = one._kf_ctl(bool(d[1]), trigger=bool(d[1]))

        # WORKING after VIO init: lane 0 for all, lane 1 per failed stream
        g = group(lambda i: s[i] == WORKING and vio[i])
        if g:
            sub = self._take(st, g, every)
            with record_function("step.vi_track"):
                out, fl = over_streams(one._vi_lane0, sub, self._take(b, g, every),
                                       self._take(ns_pred, g, every),
                                       self._take(pre_frame, g, every))
            dec = self._read(*fl)
            good = [i for i, d in zip(g, dec) if d[0]]
            if good:
                sub = self._put(sub, good, over_streams(
                    one._vi_apply, self._take(sub, good, g), self._take(out, good, g)), g)
                st = self._put(st, g, sub, every)
            for i, d in zip(g, dec):
                if d[0]:
                    ctl[i] = one._kf_ctl(bool(d[1]), trigger=False)
                else:
                    settle(i, one._vi_lane1(*rows(i)))

        # LOST and IMU_RELOC: per stream
        for i in group(lambda i: s[i] in (LOST, IMU_RELOC)):
            r, b_i, *pred = rows(i)
            settle(i, one._branch(r, b_i, s[i], vio[i], anchor[i], *pred))

        # stage C: keyframes, grouped by the inertial mode
        for v in (False, True):
            g = group(lambda i: ctl[i].want_kf and vio[i] == v)
            if g:
                with record_function("step.keyframe"):
                    sub, k = on(g, one._create_kf, st, b, vio_ok=v)
                st = self._put(st, g, sub, every)
                adopt = adopt.index_copy(0, self._ix(g), k.long())
        # stage D: BA, adoption, hygiene, the VIO-init trigger, grouped by
        # what the stream asked for
        keys = sorted({(vio[i], ctl[i].want_hyg, ctl[i].want_trigger)
                       for i in every if ctl[i].want_ba})
        for v, hyg, trig in keys:
            g = group(lambda i: ctl[i].want_ba
                      and (vio[i], ctl[i].want_hyg, ctl[i].want_trigger) == (v, hyg, trig))
            sub, compact = on(g, one._ba_front, st, adopt, vio_ok=v, hygiene=hyg)
            if hyg:
                full = [i for i, f in zip(g, self._read(compact)) if f[0]]
                if full:
                    sub = self._put(sub, full, over_streams(one._compact,
                                                            self._take(sub, full, g)), g)
            sub = over_streams(one._ba_finish, sub)
            st = self._put(st, g, sub, every)
            if trig and not v:
                fire = [i for i, f in zip(g, self._read(over_streams(one._trigger_flag, sub)))
                        if f[0]]
                if fire:
                    with record_function("step.vio_init"):
                        st_ok, ok = over_streams(one._try_init_vio, self._take(st, fire, every))
                    done = [i for i, f in zip(fire, self._read(ok)) if f[0]]
                    if done:
                        st = self._put(st, done, self._take(st_ok, done, fire), every)

        return over_streams(one._ring_and_out, st, pyr)


def build_vip_tracker(cam: CameraModel, cfg: VipConfig, kf_cap: int, pt_cap: int,
                      device="cuda", seed: int = 0):
    """Returns (state0, step) with step = VipStep(...), on the card unless
    `device` names another."""
    st0 = init_vip_state(cfg, kf_cap, pt_cap, cam.height, cam.width, seed=seed, device=device)
    return st0, VipStep(cam, cfg, kf_cap, device=device)


def make_bundles(seq, device="cuda"):
    """A synthetic sequence's frame bundles, uploaded to `device` (the
    card unless named) once (each bundle's tensors are views into the
    uploaded arrays)."""
    device = step_device(device)
    def up(a, dtype=torch.float32):
        return torch.from_numpy(a).to(dtype).to(device)

    imgs, omg, acc = up(seq.images), up(seq.imu_omg), up(seq.imu_acc)
    dt, msk, depth = up(seq.imu_dt), up(seq.imu_mask), up(seq.depth)
    dvalid = torch.from_numpy(seq.depth_valid).to(device)
    ts = up(seq.timestamps)
    return [FrameBundle(img=imgs[f], imu_omg=omg[f], imu_acc=acc[f], imu_dt=dt[f],
                        imu_mask=msk[f], depth=depth[f], depth_valid=dvalid[f], timestamp=ts[f])
            for f in range(imgs.shape[0])]
