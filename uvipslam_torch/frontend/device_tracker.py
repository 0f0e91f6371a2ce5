"""Device-resident mono tracker: one `step(state, img)` call per frame.

Counterpart of `uvipslam_tpu/frontend/device_tracker.py`. The whole
per-frame pipeline runs on the tensors' device: optional CLAHE, track
propagation, refill and descriptor refresh, two-view initialization,
pose + local-map solve, keyframes with triangulation, windowed BA, map
hygiene, and relocalization after a loss.

The reference's `lax.switch`/`lax.cond` become Python branches on device
scalars. Each decision is one host read, batched where the reference's
conditions are ready together: per frame the state (1), then in
INITIALIZING the (ok, stale) pair, in NOT_INITIALIZED the go flag, in
WORKING the (lost, need_kf) pair, in LOST the accept flag, and on
keyframe frames the compaction flag of the map hygiene.
`MonoStep.host_syncs` counts them. Removing them (CUDA graphs over
device-side predication) is later work.

Each phase runs inside a `torch.profiler.record_function` span named
`step.<phase>` (propagate, refill, two_view_init, pose_localmap,
refill_refresh, keyframe, relocalize), so a profiler trace splits a
frame's host and device time by phase.

LOST relocalizes as the reference's `branch_lost` does: a fresh
detection, BoW retrieval and PnP RANSAC (`loop.reloc.relocalize_frame`),
two seeds refined by the pose + local-map solve, the better one taken
back to WORKING when it holds max(min_tracked, 15) inliers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.tree import put_row, row, tree_map
from uvipslam_torch.frontend.frame import (Tracks, propagate_tracks, refill_tracks,
                                           refresh_descriptors)
from uvipslam_torch.frontend.tracker import (INITIALIZING, LOST, NOT_INITIALIZED,
                                             WORKING, TrackerConfig, _cam_pose_to_ns,
                                             _local_ba, _motion_guess, _ns_to_cam_pose,
                                             _pose_and_localmap, _triangulate_new)
from uvipslam_torch.loop.reloc import relocalize_frame
from uvipslam_torch.mapstate.hygiene import compact_points, cull_points, fuse_duplicates_recent
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops.clahe import clahe
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import initialize_two_view

RING = 64


def _bool_read(x: torch.Tensor) -> bool:
    return bool(x.item())


def device_hygiene(m: MapState, t: Tracks, frame_id, Rcw, tcw, fx, fy, cx, cy,
                   compact_frac: float = 0.9, read=_bool_read):
    """Per-keyframe map hygiene: cull weak landmarks, fuse recent
    duplicates, sever dead track associations, and compact the landmark
    table when it nears capacity (`read` turns that device flag into a
    host bool)."""
    m = cull_points(m, frame_id)
    m = fuse_duplicates_recent(m, frame_id, Rcw, tcw, fx, fy, cx, cy)
    pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
    alive = (t.pt_id >= 0) & m.pt_valid[pid]
    t = dataclasses.replace(t, pt_id=torch.where(alive, t.pt_id, torch.full_like(t.pt_id, -1)))
    if read(m.n_pt > int(compact_frac * m.pt_cap)):
        m2, remap = compact_points(m)
        pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
        live = (t.pt_id >= 0) & m.pt_valid[pid]
        t = dataclasses.replace(t, pt_id=torch.where(live, remap[pid],
                                                     torch.full_like(t.pt_id, -1)))
        m = m2
    return m, t


@dataclasses.dataclass
class TrackerState:
    tracks: Tracks
    map: MapState
    pyr_prev: tuple          # [h_l, w_l] images of the previous frame
    state: torch.Tensor      # i32 state machine
    frame_id: torch.Tensor   # i32
    Rcw: torch.Tensor
    tcw: torch.Tensor
    R_vel: torch.Tensor
    t_vel: torch.Tensor
    ring_R: torch.Tensor     # [RING, 3, 3]
    ring_t: torch.Tensor     # [RING, 3]
    ring_frame: torch.Tensor  # [RING] i32
    init_frame_id: torch.Tensor
    last_kf_slot: torch.Tensor
    last_kf_frame: torch.Tensor
    n_ref_tracked: torch.Tensor
    gen: torch.Generator     # RANSAC draws (the reference's PRNG key)


@dataclasses.dataclass
class StepOut:
    Rcw: torch.Tensor
    tcw: torch.Tensor
    state: torch.Tensor
    n_inliers: torch.Tensor
    new_kf: torch.Tensor     # slot of a keyframe created this frame, else -1


def _i32(v, device):
    return torch.full((), v, dtype=torch.int32, device=device)


def step_device(device) -> torch.device:
    """The device a step's entry point runs on: the card unless the
    caller names another. Raises when a CUDA device is asked for and none
    is present, rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the step runs on the card unless the caller "
                           "passes device='cpu'")
    return device


def init_state(cfg: TrackerConfig, kf_cap: int, pt_cap: int, height: int, width: int,
               seed: int = 0, device="cuda") -> TrackerState:
    device = step_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    pyr = tuple(build_flow_pyramid(torch.zeros((height, width), **f32), cfg.n_levels_klt))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrackerState(
        tracks=Tracks.empty(cfg.n_tracks, device=device),
        map=MapState.empty(kf_cap, pt_cap, cfg.n_tracks, device=device),
        pyr_prev=pyr,
        state=_i32(NOT_INITIALIZED, device), frame_id=_i32(-1, device),
        Rcw=torch.eye(3, **f32), tcw=torch.zeros(3, **f32),
        R_vel=torch.eye(3, **f32), t_vel=torch.zeros(3, **f32),
        ring_R=torch.eye(3, **f32).repeat(RING, 1, 1),
        ring_t=torch.zeros((RING, 3), **f32),
        ring_frame=torch.full((RING,), -1, dtype=torch.int32, device=device),
        init_frame_id=_i32(-1, device), last_kf_slot=_i32(-1, device),
        last_kf_frame=_i32(-1, device), n_ref_tracked=_i32(0, device),
        gen=gen,
    )


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


class MonoStep:
    """The per-frame step of the device mono tracker (no weights, so no
    nn.Module): `st, out = step(st, img)`. Counts its host reads in
    `host_syncs`."""

    def __init__(self, cam: CameraModel, cfg: TrackerConfig, device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.device = step_device(device)
        self.scale_sigmas = torch.tensor(cfg.scale_sigmas, dtype=torch.float32).to(self.device)
        self.K = torch.as_tensor(cam.K).to(self.device)
        self.host_syncs = 0
        self.zero_preint = PreintState.zero((), device=self.device)

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

    def _run_local_ba(self, m: MapState) -> MapState:
        kf_idx = torch.arange(m.kf_cap, device=self.device)
        in_window = (kf_idx >= m.n_kf - self.cfg.local_window) & (kf_idx < m.n_kf)
        # mono gauge: slot 0 always fixed, slot 1 fixed when valid (set on
        # the device: an indexed write of a Python value would be a
        # host-to-device copy that waits for the stream)
        fixed = (m.kf_valid & ~in_window) | (kf_idx == 0)
        fixed = torch.where(kf_idx == 1, m.kf_valid[1], fixed)
        cam = self.cam
        return _local_ba(m, fixed, cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas)

    def _refill(self, tracks, img, frame_id):
        return refill_tracks(tracks, img, frame_id, n_features=self.cfg.n_tracks,
                             px_distance=self.cfg.px_distance)

    # -- branches (each returns the new state and its host-known label) --
    def _not_initialized(self, st: TrackerState, img):
        cfg = self.cfg
        with record_function("step.refill"):
            tracks = self._undistort(self._refill(st.tracks, img, st.frame_id))
        if not self._read_bool(torch.sum(tracks.valid) >= cfg.min_init_tracks):
            return dataclasses.replace(st, tracks=tracks), NOT_INITIALIZED
        tracks = dataclasses.replace(
            tracks, birth_frame=torch.full_like(tracks.birth_frame, 0) + st.frame_id,
            birth_xy_und=tracks.xy_und)
        return dataclasses.replace(
            st, tracks=tracks, state=_i32(INITIALIZING, self.device),
            init_frame_id=st.frame_id.clone()), INITIALIZING

    def _initializing(self, st: TrackerState, img):
        cfg, dev = self.cfg, self.device
        t = self._undistort(st.tracks)
        cand = t.valid & (t.birth_frame == st.init_frame_id)
        with record_function("step.two_view_init"):
            rec = initialize_two_view(st.gen, t.birth_xy_und, t.xy_und, cand, self.K,
                                      sigma=1.0)
        n_cand = torch.sum(cand)
        ok = rec["ok"] & (n_cand >= cfg.min_init_tracks // 2)
        stale = (n_cand < cfg.min_init_tracks // 2) | (st.frame_id - st.init_frame_id > 30)
        ok_h, stale_h = self._read(ok, stale)
        if not ok_h:
            label = NOT_INITIALIZED if stale_h else INITIALIZING
            return dataclasses.replace(st, tracks=t, state=_i32(label, dev)), label

        good = rec["good"]
        z = rec["points"][:, 2]
        med = torch.nan_to_num(_nanmedian(torch.where(good, z, torch.full_like(z, float("nan")))),
                               nan=1.0)
        scale = 1.0 / torch.clamp(med, min=1e-6)
        pts3 = rec["points"] * scale
        R, tvec = rec["R"], rec["t"] * scale

        m = st.map
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
        ns0 = _cam_pose_to_ns(eye, zero3)
        ns1 = _cam_pose_to_ns(R, tvec)
        dist = torch.linalg.vector_norm(pts3, dim=-1)
        normals = pts3 / torch.clamp(dist[:, None], min=1e-9)
        m, ids = m.add_points(pts3, t.desc, normals, dist / 2.0, dist * 2.0, 0,
                              st.frame_id, good)
        feat_pt = torch.where(good, ids, torch.full_like(ids, -1))
        zp = self.zero_preint
        m, k0 = m.add_keyframe(ns0, 0.0, st.init_frame_id, t.birth_xy_und, t.desc,
                               t.level, t.angle, cand, feat_pt, 0.0, False, zp, -1)
        m, k1 = m.add_keyframe(ns1, 0.0, st.frame_id, t.xy_und, t.desc, t.level,
                               t.angle, cand, feat_pt, 0.0, False, zp, k0)
        m = self._run_local_ba(m)
        t2 = dataclasses.replace(t, pt_id=feat_pt)
        one = torch.ones((), dtype=torch.long, device=dev)
        Rcw, tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, one))
        slot0 = torch.remainder(st.init_frame_id, RING)
        return dataclasses.replace(
            st, tracks=t2, map=m, Rcw=Rcw, tcw=tcw, R_vel=eye, t_vel=zero3,
            ring_R=put_row(st.ring_R, slot0, eye), ring_t=put_row(st.ring_t, slot0, zero3),
            ring_frame=put_row(st.ring_frame, slot0, st.init_frame_id),
            last_kf_slot=k1.to(torch.int32), last_kf_frame=st.frame_id.clone(),
            n_ref_tracked=torch.sum(good).to(torch.int32),
            state=_i32(WORKING, dev)), WORKING

    def _working(self, st: TrackerState, img):
        cfg, cam = self.cfg, self.cam
        t = self._undistort(st.tracks)
        Rp = mm(st.R_vel, st.Rcw)
        tp = mv(st.R_vel, st.tcw) + st.t_vel
        with record_function("step.pose_localmap"):
            R1, t1, _, n_in, t2 = _pose_and_localmap(t, st.map, Rp, tp, cam.fx, cam.fy,
                                                     cam.cx, cam.cy, self.scale_sigmas)
        since = st.frame_id - st.last_kf_frame
        need_kf = (since >= cfg.kf_min_interval) & (
            (since >= cfg.kf_max_interval)
            | (n_in < cfg.kf_track_ratio * torch.clamp(st.n_ref_tracked, min=1)))
        lost, need = self._read(n_in < cfg.min_tracked, need_kf)
        if lost:
            return dataclasses.replace(st, state=_i32(LOST, self.device)), LOST

        Rcw = lie.normalize_rotation(R1)
        Rinv, tinv = lie.se3_inverse(st.Rcw, st.tcw)
        R_vel, t_vel = lie.se3_compose(R1, t1, Rinv, tinv)
        with record_function("step.refill_refresh"):
            tracks = self._refill(t2, img, st.frame_id)
            tracks = self._undistort(refresh_descriptors(tracks, img))
        newborn = tracks.birth_frame == st.frame_id
        tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
            newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
        st = dataclasses.replace(st, tracks=tracks, Rcw=Rcw, tcw=t1,
                                 R_vel=lie.normalize_rotation(R_vel), t_vel=t_vel)
        if need:
            with record_function("step.keyframe"):
                st = self._create_kf(st)
        return st, WORKING

    def _create_kf(self, st: TrackerState) -> TrackerState:
        cam = self.cam
        m, t = _triangulate_new(st.map, st.tracks, st.ring_R, st.ring_t, st.ring_frame,
                                st.Rcw, st.tcw, cam.fx, cam.fy, cam.cx, cam.cy,
                                st.frame_id, st.last_kf_slot)
        ns = _cam_pose_to_ns(st.Rcw, st.tcw)
        m, k = m.add_keyframe(ns, st.frame_id.to(torch.float32), st.frame_id, t.xy_und,
                              t.desc, t.level, t.angle, t.valid, t.pt_id, 0.0, False,
                              self.zero_preint, st.last_kf_slot)
        m = self._run_local_ba(m)
        Rcw, tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, k))
        if self.cfg.map_hygiene:
            m, t = device_hygiene(m, t, st.frame_id, Rcw, tcw, cam.fx, cam.fy, cam.cx,
                                  cam.cy, read=self._read_bool)
        return dataclasses.replace(
            st, tracks=t, map=m, Rcw=Rcw, tcw=tcw, last_kf_slot=k.to(torch.int32),
            last_kf_frame=st.frame_id.clone(),
            n_ref_tracked=torch.sum(t.valid & (t.pt_id >= 0)).to(torch.int32))

    def _relocalize(self, st, img):
        """A fresh detection, relocalized against the map
        (`relocalize_pose`)."""
        fresh = refill_tracks(Tracks.empty(self.cfg.n_tracks, device=self.device), img,
                              st.frame_id, n_features=self.cfg.n_tracks,
                              px_distance=self.cfg.px_distance)
        fresh = self._undistort(refresh_descriptors(fresh, img))
        fresh = dataclasses.replace(
            fresh, birth_frame=torch.full_like(fresh.birth_frame, 0) + st.frame_id,
            birth_xy_und=fresh.xy_und)
        return relocalize_pose(fresh, st.map, st.gen, self.cam, self.scale_sigmas)

    def _lost(self, st: TrackerState, img):
        with record_function("step.relocalize"):
            R, t, n, tr = self._relocalize(st, img)
        if not self._read_bool(n >= max(self.cfg.min_tracked, 15)):
            return st, LOST
        dev = self.device
        return dataclasses.replace(
            st, tracks=tr, Rcw=lie.normalize_rotation(R), tcw=t,
            R_vel=torch.eye(3, dtype=torch.float32, device=dev),
            t_vel=torch.zeros(3, dtype=torch.float32, device=dev),
            state=_i32(WORKING, dev)), WORKING

    # ------------------------------------------------------------------
    def __call__(self, st: TrackerState, img: torch.Tensor):
        """One frame. The RANSAC minimal samples draw from `st.gen`."""
        cfg, cam = self.cfg, self.cam
        img = img.to(device=self.device, dtype=torch.float32)
        frame_id = st.frame_id + 1
        if cfg.enhance:
            img = clahe(img)
        pyr = tuple(build_flow_pyramid(img, cfg.n_levels_klt))
        st = dataclasses.replace(st, frame_id=frame_id)

        state = self._read(st.state)
        if state in (INITIALIZING, WORKING):
            with record_function("step.propagate"):
                guess, guess_ok = _motion_guess(
                    st.tracks, st.map, mm(st.R_vel, st.Rcw), mv(st.R_vel, st.tcw) + st.t_vel,
                    cam.fx, cam.fy, cam.cx, cam.cy)
                tracks = propagate_tracks(st.tracks, st.pyr_prev, pyr, guess, guess_ok,
                                          st.gen, win=cfg.klt_win, iters=cfg.klt_iters,
                                          levels=cfg.n_levels_klt)
            st = dataclasses.replace(st, tracks=tracks)

        if state == NOT_INITIALIZED:
            st, label = self._not_initialized(st, img)
        elif state == INITIALIZING:
            st, label = self._initializing(st, img)
        elif state == WORKING:
            st, label = self._working(st, img)
        else:
            st, label = self._lost(st, img)

        st = dataclasses.replace(st, pyr_prev=pyr)
        if label == WORKING:
            slot = torch.remainder(frame_id, RING)
            st = dataclasses.replace(
                st, ring_R=put_row(st.ring_R, slot, st.Rcw),
                ring_t=put_row(st.ring_t, slot, st.tcw),
                ring_frame=put_row(st.ring_frame, slot, frame_id))
        new_kf = torch.where(st.last_kf_frame == frame_id, st.last_kf_slot,
                             torch.full_like(st.last_kf_slot, -1))
        out = StepOut(Rcw=st.Rcw, tcw=st.tcw, state=st.state,
                      n_inliers=torch.zeros((), dtype=torch.int32, device=self.device),
                      new_kf=new_kf)
        return st, out


def relocalize_pose(tracks, m: MapState, gen, cam: CameraModel, scale_sigmas):
    """BoW retrieval + PnP of `tracks` (a fresh detection) against map m
    (`loop.reloc.relocalize_frame`), then two seeds refined by the pose +
    local-map solve: A = the PnP pose (the best candidate keyframe's pose
    when PnP found fewer than 6 inliers), B = the best candidate
    keyframe's pose. Returns (R, t, n_inliers, tracks) of the seed with
    more inliers (ties: A), all on the device."""
    R0, t0, pt_id, n_pnp, top_kfs = relocalize_frame(tracks, m, gen, cam.fx, cam.fy, cam.cx,
                                                     cam.cy)
    tracks = dataclasses.replace(tracks, pt_id=pt_id)
    Rk, tk = _ns_to_cam_pose(_nav_row(m.kf_ns, top_kfs[0]))
    use_pnp = n_pnp >= 6
    Ra = torch.where(use_pnp, lie.normalize_rotation(R0), Rk)
    ta = torch.where(use_pnp, t0, tk)
    seeds = [_pose_and_localmap(tracks, m, R_, t_, cam.fx, cam.fy, cam.cx, cam.cy, scale_sigmas)
             for R_, t_ in ((Ra, ta), (Rk, tk))]
    pick_b = seeds[1][3] > seeds[0][3]
    R, t, _, n, tr = (tree_map(lambda a, b: torch.where(pick_b, b, a), x, y)
                      for x, y in zip(*seeds))
    return R, t, n, tr


def _nav_row(ns, k):
    """Row k of a NavState table (device-scalar index)."""
    return tree_map(lambda a: row(a, k), ns)


def build_tracker(cam: CameraModel, cfg: TrackerConfig, kf_cap: int, pt_cap: int,
                  device="cuda", seed: int = 0):
    """Returns (state0, step) with step = MonoStep(...), on the card
    unless `device` names another."""
    st0 = init_state(cfg, kf_cap, pt_cap, cam.height, cam.width, seed=seed, device=device)
    return st0, MonoStep(cam, cfg, device=device)


def run_sequence(cam: CameraModel, cfg: TrackerConfig, images, kf_cap: int = 64,
                 pt_cap: int = 8192, device="cuda"):
    """Replay a sequence frame by frame on `device`, each image moved
    there. Returns (final_state, StepOut with a leading time dimension,
    the step object)."""
    st, step = build_tracker(cam, cfg, kf_cap, pt_cap, device=device)
    outs = []
    for img in images:
        st, out = step(st, torch.as_tensor(img).to(step.device))
        outs.append(out)
    stacked = StepOut(*(torch.stack([getattr(o, f.name) for o in outs])
                        for f in dataclasses.fields(StepOut)))
    return st, stacked, step
