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
from uvipslam_torch.core.tree import put_row, row, tree_map
from uvipslam_torch.frontend.device_tracker import (RING, _i32, _nanmedian, _nav_row,
                                                    device_hygiene, relocalize_pose,
                                                    step_device)
from uvipslam_torch.frontend.frame import (Tracks, propagate_tracks, refill_tracks,
                                           refresh_descriptors)
from uvipslam_torch.frontend.tracker import (IMU_RELOC, INITIALIZING, LOST, NOT_INITIALIZED,
                                             WORKING, _cam_pose_to_ns, _cam_pose_to_ns_ext,
                                             _local_ba, _motion_guess, _ns_to_cam_pose,
                                             _ns_to_cam_pose_ext, _pose_and_localmap,
                                             _triangulate_new)
from uvipslam_torch.frontend.vip_tracker import VipConfig, _vi_ba, _vi_track
from uvipslam_torch.loop.reloc import first_try_associations
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops.clahe import clahe
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import initialize_two_view
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

    def _predict(self, ns: NavState, pre: PreintState) -> NavState:
        """IMU NavState prediction over one frame's preintegration."""
        g, dt = self.gravity, pre.dt
        return dataclasses.replace(
            ns, p=ns.p + ns.v * dt + 0.5 * g * dt * dt + mv(ns.R, pre.dP),
            v=ns.v + g * dt + mv(ns.R, pre.dV),
            R=lie.normalize_rotation(mm(ns.R, pre.dR)))

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

        def align_from(g_dir):
            v = torch.linalg.cross(g_dir, g_cfg_dir)
            sn = torch.linalg.vector_norm(v)
            axis = v / torch.where(sn < 1e-9, torch.ones_like(sn), sn)
            return lie.so3_exp(axis * torch.atan2(sn, torch.dot(g_dir, g_cfg_dir)))

        def pressure_scale(Ra):
            s_gn, _ = vio_init.estimate_scale_from_pressure(mv(Ra, m.kf_ns.p)[:, 2], m.kf_depth,
                                                            has_depth)
            return s_gn

        def scale_ok(s):
            return torch.isfinite(s) & (s > 1e-3) & (n_dep >= 3)

        s0 = pressure_scale(align_from(g_dir_vision))
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

        R_align = align_from(g_dir_vision)
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

    # -- state branches ------------------------------------------------
    def _not_initialized(self, st):
        cfg = self.cfg
        t = st.tracks
        st = self._zero_kf_accumulators(st)
        if not self._read_bool(torch.sum(t.valid) >= cfg.min_init_tracks):
            return st, NOT_INITIALIZED, _Ctl()
        t = dataclasses.replace(t, birth_frame=torch.full_like(t.birth_frame, 0) + st.frame_id,
                                birth_xy_und=t.xy_und)
        return dataclasses.replace(st, tracks=t, state=_i32(INITIALIZING, self.device),
                                   init_frame_id=st.frame_id.clone(),
                                   init_time=st.frame_time.clone()), INITIALIZING, _Ctl()

    def _initializing(self, st, b, rec, cand_tv):
        cfg, dev = self.cfg, self.device
        n_cand = torch.sum(cand_tv)
        ok_h, stale_h = self._read(rec["ok"] & (n_cand >= cfg.min_init_tracks // 2),
                                   (n_cand < cfg.min_init_tracks // 2)
                                   | (st.frame_id - st.init_frame_id > 30))
        if not ok_h:
            label = NOT_INITIALIZED if stale_h else INITIALIZING
            return dataclasses.replace(st, state=_i32(label, dev)), label, _Ctl()
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

    def _mono_working(self, st, ml):
        R_ml, t_ml, n_ml, tr_ml = ml
        lost, need = self._read(n_ml < self.cfg.min_tracked, self._need_kf(st, n_ml))
        if lost:
            return dataclasses.replace(st, state=_i32(LOST, self.device)), LOST, _Ctl()
        Rinv, tinv = lie.se3_inverse(st.Rcw, st.tcw)
        R_vel, t_vel = lie.se3_compose(R_ml, t_ml, Rinv, tinv)
        st = dataclasses.replace(st, tracks=tr_ml, Rcw=lie.normalize_rotation(R_ml), tcw=t_ml,
                                 R_vel=lie.normalize_rotation(R_vel), t_vel=t_vel)
        return st, WORKING, self._kf_ctl(bool(need), trigger=bool(need))

    def _vi_working(self, st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame):
        cfg, cam = self.cfg, self.cam
        depth_info = torch.where(b.depth_valid, torch.full_like(b.depth, self.depth_info),
                                 torch.zeros_like(b.depth))

        def solve(tk):
            with record_function("step.vi_track"):
                return _vi_track(tk, st.map, ns_pred, st.ns, pre_frame, self.gravity, cam.fx,
                                 cam.fy, cam.cx, cam.cy, self.scale_sigmas, cfg.gyr_bias_rw2,
                                 cfg.acc_bias_rw2, b.depth, depth_info, st.H_prior, self.Rcb,
                                 self.tcb)

        # lane 0: the normal associations; lane 1 (only when lane 0
        # fails): the first-try relocalization associations, which force
        # a keyframe
        out = solve(st.tracks)
        ok, need = self._read(out[2] >= cfg.min_tracked, self._need_kf(st, out[2]))
        if not ok:
            with record_function("step.first_try"):
                ft_pid, ft_nm = first_try_associations(
                    st.tracks, st.map, torch.clamp(st.last_kf_slot, 0, self.kf_cap - 1),
                    Rcw_pred, tcw_pred, cam.fx, cam.fy, cam.cx, cam.cy,
                    min_matches=self.ft_min)
                ft_gate = (ft_nm >= self.ft_min) & (st.last_kf_slot >= 0) & cfg.reloc_first_try
                tracks_ft = dataclasses.replace(
                    st.tracks, pt_id=torch.where(ft_gate, ft_pid, torch.full_like(ft_pid, -1)))
            out = solve(tracks_ft)
            ok = need = self._read_bool(out[2] >= self.reloc_min)
        if not ok:
            # IMU dead-reckoning with the pressure-z override; the anchor
            # (fresh detection + stash) is captured on the next frame
            st = dataclasses.replace(self._dead_reckon(st, b, ns_pred),
                                     state=_i32(IMU_RELOC, self.device),
                                     rec_frame=_i32(-1, self.device), H_prior=self.H0)
            return st, IMU_RELOC, _Ctl()
        ns_opt, _, _, tracks2, H_post = out
        tr = torch.trace(H_post) / 15.0
        H_new = (H_post + torch.eye(15, dtype=torch.float32, device=self.device) * 1e-3) * \
            torch.clamp(1e6 / torch.clamp(tr, min=1e-6), max=1.0)
        Rcw, tcw = self._cam_pose(ns_opt)
        st = dataclasses.replace(st, tracks=tracks2, ns=ns_opt, Rcw=Rcw, tcw=tcw, H_prior=H_new)
        return st, WORKING, self._kf_ctl(bool(need), trigger=False)

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

    def _ba_and_adopt(self, st, ctl: _Ctl, vio_ok: bool):
        """One windowed BA (mono xor VI), pose adoption of keyframe
        `ctl.adopt`, hygiene, the WORKING transition and the VIO-init
        trigger."""
        cam, cfg = self.cam, self.cfg
        if vio_ok:
            with record_function("step.vi_ba"):
                m = self._vi_ba(st.map)
        else:
            with record_function("step.local_ba"):
                m = self._mono_ba(st.map)
        k = ctl.adopt
        ns_k = _nav_row(m.kf_ns, k)
        Rcw, tcw = self._cam_pose(ns_k) if vio_ok else _ns_to_cam_pose(ns_k)
        t = st.tracks
        if ctl.want_hyg:
            m, t = device_hygiene(m, t, st.frame_id, Rcw, tcw, cam.fx, cam.fy, cam.cx, cam.cy,
                                  read=self._read_bool)
        st = dataclasses.replace(
            st, tracks=t, map=m, ns=ns_k if vio_ok else st.ns, Rcw=Rcw, tcw=tcw,
            last_kf_slot=k.to(torch.int32), last_kf_frame=st.frame_id.clone(),
            n_ref_tracked=torch.sum(t.valid & (t.pt_id >= 0)).to(torch.int32),
            H_prior=self.H0, state=_i32(WORKING, self.device))
        st = self._zero_kf_accumulators(st)
        if ctl.want_trigger and not vio_ok:
            t_span = row(m.kf_time, torch.clamp(m.n_kf - 1, min=0)) - m.kf_time[0]
            if self._read_bool((m.n_kf >= cfg.vio_init_min_kfs)
                               & (t_span >= cfg.vio_init_min_time)):
                with record_function("step.vio_init"):
                    st_ok, ok = self._try_init_vio(st)
                if self._read_bool(ok):
                    st = st_ok
        return st

    # ------------------------------------------------------------------
    def __call__(self, st: VipTrackerState, b: FrameBundle):
        """One frame bundle. RANSAC minimal samples draw from `st.gen`."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        img = b.img.to(device=dev, dtype=torch.float32)
        if cfg.enhance:
            img = clahe(img)
        b = dataclasses.replace(b, img=img)
        frame_id = st.frame_id + 1
        pyr = tuple(build_flow_pyramid(img, cfg.n_levels_klt))
        st = dataclasses.replace(st, frame_id=frame_id)

        with record_function("step.preintegrate"):
            st, pre_frame = self._accumulate(st, b)
            ns_pred = self._predict(st.ns, pre_frame)
            Rcw_pred, tcw_pred = self._cam_pose(ns_pred)

        s, vio_ok, has_anchor = self._read(st.state, st.vio_ok, st.rec_frame >= 0)
        vio_ok, has_anchor = bool(vio_ok), bool(has_anchor)

        tracks = st.tracks
        if s in (INITIALIZING, WORKING, IMU_RELOC):
            with record_function("step.propagate"):
                # motion-model pose: the IMU prediction after VIO init, the
                # velocity model before
                if vio_ok:
                    Rp, tp = Rcw_pred, tcw_pred
                else:
                    Rp, tp = mm(st.R_vel, st.Rcw), mv(st.R_vel, st.tcw) + st.t_vel
                guess, guess_ok = _motion_guess(tracks, st.map, Rp, tp, cam.fx, cam.fy, cam.cx,
                                                cam.cy)
                tracks = propagate_tracks(tracks, st.pyr_prev, pyr, guess, guess_ok, st.gen,
                                          win=cfg.klt_win, iters=cfg.klt_iters,
                                          levels=cfg.n_levels_klt)

        # shared detection: LOST and a new recovery anchor restart from an
        # empty table; NOT_INITIALIZED and WORKING top up dead slots
        need_fresh = s == LOST or (s == IMU_RELOC and not has_anchor)
        if need_fresh or s in (NOT_INITIALIZED, WORKING):
            with record_function("step.refill_refresh"):
                base = Tracks.empty(cfg.n_tracks, device=dev) if need_fresh else tracks
                tracks = refill_tracks(base, b.img, st.frame_id, n_features=cfg.n_tracks,
                                       px_distance=cfg.px_distance)
                tracks = refresh_descriptors(tracks, b.img)
        tracks = self._undistort(tracks)
        newborn = tracks.birth_frame == st.frame_id
        tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
            newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
        st = dataclasses.replace(st, tracks=tracks)

        # shared two-view reconstruction (init and the recovery re-anchor)
        rec = cand_tv = None
        if s == INITIALIZING or (s == IMU_RELOC and has_anchor):
            anchor = st.rec_frame if s == IMU_RELOC else st.init_frame_id
            cand_tv = tracks.valid & (tracks.birth_frame == anchor)
            with record_function("step.two_view_init"):
                rec = initialize_two_view(st.gen, tracks.birth_xy_und, tracks.xy_und, cand_tv,
                                          self.K, sigma=1.0)

        # shared mono pose + local-map solve: the motion-model seed on a
        # mono WORKING frame; (PnP seed, best retrieved keyframe) when LOST
        ml = None
        if (s == WORKING and not vio_ok) or s == LOST:
            ml = self._mono_solve(st, tracks, relocalize=s == LOST)

        if s == NOT_INITIALIZED:
            st, label, ctl = self._not_initialized(st)
        elif s == INITIALIZING:
            st, label, ctl = self._initializing(st, b, rec, cand_tv)
        elif s == WORKING and vio_ok:
            st, label, ctl = self._vi_working(st, b, ns_pred, Rcw_pred, tcw_pred, pre_frame)
        elif s == WORKING:
            st, label, ctl = self._mono_working(st, ml)
        elif s == LOST:
            st, label, ctl = self._lost(st, ml)
        else:
            st, label, ctl = self._recovery(st, b, ns_pred, rec, cand_tv, has_anchor)

        if ctl.want_kf:
            with record_function("step.keyframe"):
                st, ctl.adopt = self._create_kf(st, b, vio_ok)
        if ctl.want_ba:
            st = self._ba_and_adopt(st, ctl, vio_ok)

        st = dataclasses.replace(st, pyr_prev=pyr)
        if label == WORKING:
            slot = torch.remainder(frame_id, RING)
            st = dataclasses.replace(
                st, ring_R=put_row(st.ring_R, slot, st.Rcw),
                ring_t=put_row(st.ring_t, slot, st.tcw),
                ring_frame=put_row(st.ring_frame, slot, frame_id))
        new_kf = torch.where(st.last_kf_frame == frame_id, st.last_kf_slot,
                             torch.full_like(st.last_kf_slot, -1))
        return st, VipStepOut(Rcw=st.Rcw, tcw=st.tcw, p_w=st.ns.p, state=st.state,
                              vio_ok=st.vio_ok, new_kf=new_kf)

    def _mono_solve(self, st, tracks, relocalize: bool):
        """Pose + local-map solve from the motion-model seed, or, when
        relocalizing, from the two relocalization seeds
        (`device_tracker.relocalize_pose`)."""
        cam = self.cam
        if relocalize:
            with record_function("step.relocalize"):
                return relocalize_pose(tracks, st.map, st.gen, cam, self.scale_sigmas)
        with record_function("step.pose_localmap"):
            R, t, _, n, tr = _pose_and_localmap(tracks, st.map, mm(st.R_vel, st.Rcw),
                                                mv(st.R_vel, st.tcw) + st.t_vel, cam.fx, cam.fy,
                                                cam.cx, cam.cy, self.scale_sigmas)
        return R, t, n, tr


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
