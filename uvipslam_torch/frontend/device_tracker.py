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
`MonoStep.host_syncs` counts them, and `MonoStep.compactions` the
compactions that the last flag asked for.

The reference compiles the whole step into one program (`jax.jit`). Its
counterpart here is `MonoStep(graphs=...)` (on by default on a CUDA
device): a WORKING frame, cut at its host reads, replays captured CUDA
graphs (`utils.graphs.Segments`), each segment keyed by the Python values
that pick its path: A, the images and the frame id (every frame, before
the state read); B, after the RANSAC uniforms are drawn eagerly (a
captured graph must not consume the generator), the propagation and the
pose + local-map solve up to the (lost, need_kf) read; C, the solve
taken with the refill and refresh, and on a keyframe-free frame the ring
and the output; on a keyframe frame D, triangulation, the keyframe, the
window BA and the hygiene up to the compaction read, and E (compact), the
compaction when the read asked for it (the reference's `lax.cond`), the
keyframe's bookkeeping, the ring and the output. With `graphs=False` the
same segments are called eagerly, so both forms compose the frame alike;
the graphed frame launches the same kernels on the same inputs and gives
the eager step's outputs and states bit for bit, with the same host
reads. NOT_INITIALIZED, INITIALIZING, LOST and a WORKING frame that
turns LOST stay eager after A: they are rare, their two-view and
relocalization draw from the generator inside, and each would be graphs
of its own. `MonoFleetStep` replays its batched frames' stages as graphs
in the same way (`Fleet`: the counterpart of the reference's
`jax.jit(vmap(scan(step)))`), its groups' rows entering as data, the
compaction inside its E, NOT_INITIALIZED, INITIALIZING and LOST eager.

Each phase runs inside a span of the step's `spans` (`utils.spans`)
named `step.<phase>` (propagate, refill, two_view_init, pose_localmap,
refill_refresh, keyframe, relocalize), so a profiler trace splits a
frame's host and device time by phase; a call runs in `step.call` and
a host read's wait in `step.read`, which the recorder times too.

LOST relocalizes as the reference's `branch_lost` does: a fresh
detection, BoW retrieval and PnP RANSAC (`loop.reloc.relocalize_frame`),
two seeds refined by the pose + local-map solve, the better one taken
back to WORKING when it holds max(min_tracked, 15) inliers.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.tree import (over_streams, put_row, put_streams, take_streams,
                                      tree_map)
from uvipslam_torch.frontend.frame import (Tracks, propagate_tracks, refill_tracks,
                                           refresh_descriptors)
from uvipslam_torch.frontend.tracker import (INITIALIZING, LOST, NOT_INITIALIZED,
                                             WORKING, TrackerConfig, _cam_pose_to_ns,
                                             _motion_guess, _nanmedian, _nav_row,
                                             _ns_to_cam_pose, _pose_and_localmap,
                                             _triangulate_new, _window_ba, step_device)
from uvipslam_torch.loop.reloc import relocalize_frame
from uvipslam_torch.mapstate.hygiene import compact_points, cull_points, fuse_duplicates_recent
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops.clahe import clahe
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.ops.twoview import draw_uniform, initialize_two_view
from uvipslam_torch.utils.graphs import Segments
from uvipslam_torch.utils.spans import Spans, spanned

RING = 64


def _bool_read(x: torch.Tensor) -> bool:
    return bool(x.item())


def hygiene_front(m: MapState, t: Tracks, frame_id, Rcw, tcw, fx, fy, cx, cy,
                  compact_frac: float = 0.9):
    """Per-keyframe map hygiene up to its one decision: cull weak
    landmarks, fuse recent duplicates, sever dead track associations.
    Returns (map, tracks, the device flag that the landmark table nears
    capacity and wants `hygiene_compact`)."""
    m = cull_points(m, frame_id)
    m = fuse_duplicates_recent(m, frame_id, Rcw, tcw, fx, fy, cx, cy)
    pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
    alive = (t.pt_id >= 0) & m.pt_valid[pid]
    t = dataclasses.replace(t, pt_id=torch.where(alive, t.pt_id, torch.full_like(t.pt_id, -1)))
    return m, t, m.n_pt > int(compact_frac * m.pt_cap)


def hygiene_compact(m: MapState, t: Tracks):
    """Compact the landmark table and remap the tracks' associations."""
    m2, remap = compact_points(m)
    pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
    live = (t.pt_id >= 0) & m.pt_valid[pid]
    t = dataclasses.replace(t, pt_id=torch.where(live, remap[pid], torch.full_like(t.pt_id, -1)))
    return m2, t


def device_hygiene(m: MapState, t: Tracks, frame_id, Rcw, tcw, fx, fy, cx, cy,
                   compact_frac: float = 0.9, read=_bool_read):
    """`hygiene_front`, then `hygiene_compact` when the flag holds (`read`
    turns that device flag into a host bool)."""
    m, t, full = hygiene_front(m, t, frame_id, Rcw, tcw, fx, fy, cx, cy, compact_frac)
    if read(full):
        m, t = hygiene_compact(m, t)
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


class MonoStep:
    """The per-frame step of the device mono tracker (no weights, so no
    nn.Module): `st, out = step(st, img)`. Counts its host reads in
    `host_syncs` and the landmark-table compactions in `compactions`.
    `graphs` (default: on for a CUDA device, off on the CPU) replays the
    WORKING frames' segments as captured graphs (`self.segments`, a
    `utils.graphs.Segments`); off, the same segments run eagerly;
    `graphs=True` on the CPU runs their plain form. `spans` (a
    `utils.spans.Spans`, shared with the segments) names and, while
    recording, times the step's spans."""

    def __init__(self, cam: CameraModel, cfg: TrackerConfig, device="cuda",
                 graphs: bool | None = None):
        self.cam = cam
        self.cfg = cfg
        self.device = step_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        self.spans = Spans()
        self.segments = Segments(self.device, graphs=self.graphs, spans=self.spans)
        self.scale_sigmas = torch.tensor(cfg.scale_sigmas, dtype=torch.float32).to(self.device)
        self.K = torch.as_tensor(cam.K).to(self.device)
        self.host_syncs = 0
        self.compactions = 0
        self.zero_preint = PreintState.zero((), device=self.device)

    # -- host reads ----------------------------------------------------
    def _read(self, *flags: torch.Tensor):
        """One host sync for a batch of device flags -> Python values."""
        self.host_syncs += 1
        vals = self.spans.read(torch.stack([f.reshape(()).to(torch.int64) for f in flags]))
        return vals if len(vals) > 1 else vals[0]

    def _read_bool(self, flag: torch.Tensor) -> bool:
        return bool(self._read(flag))

    # -- helpers -------------------------------------------------------
    def _undistort(self, tracks: Tracks) -> Tracks:
        return dataclasses.replace(tracks, xy_und=self.cam.undistort_pixels(tracks.xy))

    def _run_local_ba(self, m: MapState) -> MapState:
        return _window_ba(m, self.cam, self.cfg.local_window, self.scale_sigmas)

    def _refill(self, tracks, img, frame_id):
        return refill_tracks(tracks, img, frame_id, n_features=self.cfg.n_tracks,
                             px_distance=self.cfg.px_distance)

    # -- the frame's shared stages (each maps over a stream dimension) ----
    def _images(self, img):
        img = img.to(device=self.device, dtype=torch.float32)
        if self.cfg.enhance:
            img = clahe(img)
        return img, tuple(build_flow_pyramid(img, self.cfg.n_levels_klt))

    def _propagate(self, st: TrackerState, pyr, u):
        """Track propagation from the velocity-model pose; `u` are the
        RANSAC gate's uniform draws (`twoview.draw_uniform`)."""
        cfg, cam = self.cfg, self.cam
        guess, guess_ok = _motion_guess(
            st.tracks, st.map, mm(st.R_vel, st.Rcw), mv(st.R_vel, st.tcw) + st.t_vel,
            cam.fx, cam.fy, cam.cx, cam.cy)
        return propagate_tracks(st.tracks, st.pyr_prev, pyr, guess, guess_ok, None,
                                win=cfg.klt_win, iters=cfg.klt_iters, levels=cfg.n_levels_klt,
                                u=u)

    def _ring_and_out(self, st: TrackerState, pyr):
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
        return st, StepOut(Rcw=st.Rcw, tcw=st.tcw, state=st.state,
                           n_inliers=torch.zeros_like(st.state), new_kf=new_kf)

    # -- branches: device flags, then the update of each outcome ----------
    def _state(self, st, label: int):
        return dataclasses.replace(st, state=torch.full_like(st.state, label))

    def _not_init_detect(self, st: TrackerState, img):
        with self.spans("step.refill"):
            tracks = self._undistort(self._refill(st.tracks, img, st.frame_id))
        st = dataclasses.replace(st, tracks=tracks)
        return st, torch.sum(tracks.valid) >= self.cfg.min_init_tracks

    def _not_init_go(self, st: TrackerState):
        t = st.tracks
        t = dataclasses.replace(
            t, birth_frame=torch.full_like(t.birth_frame, 0) + st.frame_id,
            birth_xy_und=t.xy_und)
        return dataclasses.replace(self._state(st, INITIALIZING), tracks=t,
                                   init_frame_id=st.frame_id.clone())

    def _not_initialized(self, st: TrackerState, img):
        st, go = self._not_init_detect(st, img)
        if not self._read_bool(go):
            return st, NOT_INITIALIZED
        return self._not_init_go(st), INITIALIZING

    def _two_view(self, st: TrackerState):
        """INITIALIZING's reconstruction (draws from `st.gen`) and its
        (ok, stale) flags."""
        cfg = self.cfg
        t = self._undistort(st.tracks)
        cand = t.valid & (t.birth_frame == st.init_frame_id)
        with self.spans("step.two_view_init"):
            rec = initialize_two_view(st.gen, t.birth_xy_und, t.xy_und, cand, self.K,
                                      sigma=1.0)
        n_cand = torch.sum(cand)
        ok = rec["ok"] & (n_cand >= cfg.min_init_tracks // 2)
        stale = (n_cand < cfg.min_init_tracks // 2) | (st.frame_id - st.init_frame_id > 30)
        return (t, cand, rec), (ok, stale)

    def _initializing(self, st: TrackerState, img, pre=None, decided=None):
        """`pre`, `decided`: the reconstruction and its flags as read, when
        the caller has them already (the fleet reads every stream's in one
        table)."""
        dev = self.device
        if pre is None:
            pre, flags = self._two_view(st)
            decided = self._read(*flags)
        (t, cand, rec), (ok_h, stale_h) = pre, decided
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

    def _working_solve(self, st: TrackerState):
        """The pose + local-map solve from the velocity-model seed and the
        (lost, need-keyframe) flags."""
        cfg, cam = self.cfg, self.cam
        t = self._undistort(st.tracks)
        Rp = mm(st.R_vel, st.Rcw)
        tp = mv(st.R_vel, st.tcw) + st.t_vel
        with self.spans("step.pose_localmap"):
            R1, t1, _, n_in, t2 = _pose_and_localmap(t, st.map, Rp, tp, cam.fx, cam.fy,
                                                     cam.cx, cam.cy, self.scale_sigmas)
        since = st.frame_id - st.last_kf_frame
        need_kf = (since >= cfg.kf_min_interval) & (
            (since >= cfg.kf_max_interval)
            | (n_in < cfg.kf_track_ratio * torch.clamp(st.n_ref_tracked, min=1)))
        return (R1, t1, t2), (n_in < cfg.min_tracked, need_kf)

    def _working_apply(self, st: TrackerState, ml, img):
        R1, t1, t2 = ml
        Rcw = lie.normalize_rotation(R1)
        Rinv, tinv = lie.se3_inverse(st.Rcw, st.tcw)
        R_vel, t_vel = lie.se3_compose(R1, t1, Rinv, tinv)
        with self.spans("step.refill_refresh"):
            tracks = self._refill(t2, img, st.frame_id)
            tracks = self._undistort(refresh_descriptors(tracks, img))
        newborn = tracks.birth_frame == st.frame_id
        tracks = dataclasses.replace(tracks, birth_xy_und=torch.where(
            newborn[:, None], tracks.xy_und, tracks.birth_xy_und))
        return dataclasses.replace(st, tracks=tracks, Rcw=Rcw, tcw=t1,
                                   R_vel=lie.normalize_rotation(R_vel), t_vel=t_vel)

    def _kf_front(self, st: TrackerState):
        """Triangulation, the keyframe, the window BA, its pose adopted,
        and the map hygiene up to its compaction flag (returned beside the
        state)."""
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
        compact = torch.zeros_like(st.state, dtype=torch.bool)
        if self.cfg.map_hygiene:
            m, t, compact = hygiene_front(m, t, st.frame_id, Rcw, tcw, cam.fx, cam.fy, cam.cx,
                                          cam.cy)
        st = dataclasses.replace(
            st, tracks=t, map=m, Rcw=Rcw, tcw=tcw, last_kf_slot=k.to(torch.int32),
            last_kf_frame=st.frame_id.clone())
        return st, compact

    def _compact(self, st: TrackerState):
        """The landmark table compacted and the tracks' associations
        remapped (`hygiene_compact`), inside segment E."""
        m, t = hygiene_compact(st.map, st.tracks)
        return dataclasses.replace(st, map=m, tracks=t)

    def _compaction_due(self, flag: torch.Tensor) -> bool:
        """The compaction read after the map hygiene (none without it),
        counted in `compactions` when it asks for one."""
        compact = self.cfg.map_hygiene and self._read_bool(flag)
        self.compactions += compact
        return compact

    def _kf_finish(self, st: TrackerState):
        t = st.tracks
        return dataclasses.replace(
            st, n_ref_tracked=torch.sum(t.valid & (t.pt_id >= 0)).to(torch.int32))

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
        with self.spans("step.relocalize"):
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
    def _start(self, st: TrackerState, img):
        """Segment A: the frame's images and its id."""
        img, pyr = self._images(img)
        return dataclasses.replace(st, frame_id=st.frame_id + 1), img, pyr

    def _frame(self, st: TrackerState, img, pyr, state: int):
        """A frame that starts in another state than WORKING, after A
        (eager)."""
        if state == INITIALIZING:
            with self.spans("step.propagate"):
                u = draw_uniform(st.gen, 200, self.cfg.n_tracks, self.device)
                st = dataclasses.replace(st, tracks=self._propagate(st, pyr, u))

        if state == NOT_INITIALIZED:
            st, _ = self._not_initialized(st, img)
        elif state == INITIALIZING:
            st, _ = self._initializing(st, img)
        else:
            st, _ = self._lost(st, img)
        return self._ring_and_out(st, pyr)

    # -- the WORKING frame's segments (see the module docstring) ----------
    def _working_body(self, st: TrackerState, pyr, u):
        """Segment B: propagation and the WORKING solve with its (lost,
        need-keyframe) flags."""
        with self.spans("step.propagate"):
            st = dataclasses.replace(st, tracks=self._propagate(st, pyr, u))
        ml, flags = self._working_solve(st)
        return st, ml, flags

    def _accept(self, st: TrackerState, ml, img, pyr, need: bool):
        """Segment C: the solve taken, refill and refresh; without a
        keyframe also the ring and the output."""
        st = self._working_apply(st, ml, img)
        return st if need else self._ring_and_out(st, pyr)

    def _kf_end(self, st: TrackerState, pyr, compact: bool = False):
        """Segment E: the compaction when `compact`, the keyframe's
        bookkeeping, the ring and the output."""
        return self._ring_and_out(self._kf_finish(self._compact(st) if compact else st), pyr)

    @spanned("step.call")
    def __call__(self, st: TrackerState, img: torch.Tensor):
        """One frame. The RANSAC minimal samples draw from `st.gen`. A
        WORKING frame runs segments A-E, replayed from captured graphs
        when `graphs` is on and called eagerly when it is off; every
        other branch runs eagerly after A."""
        seg, gen = self.segments, st.gen
        st, img, pyr = seg.run(("A",), self._start, dataclasses.replace(st, gen=None), img)
        state = self._read(st.state)
        st = dataclasses.replace(st, gen=gen)
        if state != WORKING:
            return self._frame(st, img, pyr, state)
        u = draw_uniform(gen, 200, self.cfg.n_tracks, self.device)
        st, ml, flags = seg.run(("B",), self._working_body, dataclasses.replace(st, gen=None),
                                pyr, u)
        lost, need = self._read(*flags)
        if lost:
            return self._ring_and_out(self._state(dataclasses.replace(st, gen=gen), LOST), pyr)
        need = bool(need)
        st = seg.run(("C", need), lambda *a: self._accept(*a, need=need), st, ml, img, pyr)
        if need:
            with self.spans("step.keyframe"):
                st, compact = seg.run(("D",), self._kf_front, st)
                c = self._compaction_due(compact)
                st = seg.run(("E", c), lambda *a: self._kf_end(*a, compact=c), st, pyr)
        st, out = st
        return dataclasses.replace(st, gen=gen), out


ALL = "all"     # a stream subset that is every stream of its tree: the tree itself, no gather


def take(tree, ix):
    """The rows `ix` (`Fleet._sel`: ALL or a device index tensor) of every
    leaf of a fleet tree."""
    return tree if ix is ALL else take_streams(tree, ix)


def put(tree, ix, sub):
    """`tree` with its rows `ix` (ALL or a device index tensor) replaced by
    the rows of `sub`."""
    return sub if ix is ALL else put_streams(tree, ix, sub)


def _form(ix) -> str:
    return "none" if ix is None else "all" if ix is ALL else "rows"


class Fleet:
    """What the fleet steps share: the host reads of per-stream flag
    tables, the stream subsets (rows gathered for a stage, scattered back
    after it) and the segments of a batched frame.

    The reference compiles its whole batched replay into one program
    (`jax.jit(vmap(scan(step)))`). Its counterpart here is `graphs` (on by
    default on a CUDA device, off on the CPU; `True` on the CPU runs the
    plain form): the batched frame, cut at its host reads and at its
    per-stream branches, replays captured CUDA graphs (`self.segments`, a
    `utils.graphs.Segments`, one memory pool per fleet step). With
    `graphs=False` the same segments are called eagerly, so both forms
    compose the frame alike and give the same outputs, states, host reads,
    hand-kernel launches and draws bit for bit.

    A segment is keyed by its name and the Python values that pick its
    path (`_seg`), never by which streams form its groups: a group enters
    as data. The host makes each group's index tensor before the segment
    (`_sel`, through the cached `_ix`: a first use is a host-to-device
    copy, which a capture cannot hold) and passes it in the segment's
    inputs, whose current values `Segments` copies in at every replay; the
    key holds only whether each group is empty, all of its tree (taken
    as it is) or some rows, and `Segments` adds the index tensors'
    lengths with the inputs' layout. So every group of one size replays
    one graph whatever its members, and no segment's function computes a
    row index from Python stream ids: a graph that baked its capture's
    index in would gather another group's rows at its replays."""

    def __init__(self, one, graphs: bool | None = None):
        self.one = one                    # the single-stream step: constants and stages
        self.cfg, self.device = one.cfg, one.device
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        self.spans = one.spans             # one recorder for the fleet and its `one` step
        self.segments = Segments(self.device, graphs=self.graphs, spans=self.spans)
        self.fleet_syncs = 0
        self.compactions = 0              # rows compacted (the fleet runs every BA)
        self._ix_cache: dict = {}

    @property
    def host_syncs(self) -> int:
        """Host reads: the fleet's tables plus the per-stream branches'."""
        return self.fleet_syncs + self.one.host_syncs

    def _read(self, *flags: torch.Tensor) -> list:
        """One host sync for an [n] column per flag -> n rows of ints."""
        self.fleet_syncs += 1
        return self.spans.read(torch.stack([f.to(torch.int64) for f in flags], dim=-1))

    def _ix(self, ids) -> torch.Tensor:
        """Device index tensor of a stream subset (cached: a subset seen
        before costs no host-to-device copy)."""
        key = tuple(ids)
        if key not in self._ix_cache:
            self._ix_cache[key] = torch.tensor(key, dtype=torch.long).to(self.device)
        return self._ix_cache[key]

    def _sel(self, ids, of):
        """Where streams `ids` sit among streams `of` (both ascending), as
        `take` and `put` take it: None for no stream, ALL for every one,
        else their positions as a device index tensor."""
        if not ids:
            return None
        if len(ids) == len(of):
            return ALL
        pos = {s: p for p, s in enumerate(of)}
        return self._ix([pos[i] for i in ids])

    def _take(self, tree, ids, of):
        """The rows of streams `ids` out of a tree that holds streams `of`."""
        return take(tree, self._sel(ids, of))

    def _put(self, tree, ids, sub, of):
        """`tree` (streams `of`) with the rows of streams `ids` replaced."""
        return put(tree, self._sel(ids, of), sub)

    def _row(self, tree, i: int, gen=None):
        """Stream i's single-stream tree (views), with its generator."""
        r = tree_map(lambda a: a[i], tree)
        return dataclasses.replace(r, gen=gen) if gen is not None else r

    def _put_row(self, tree, i: int, r):
        return put_streams(tree, self._ix([i]), tree_map(lambda a: a[None], r))

    def _seg(self, name: str, fn, *trees, ix=None, **static):
        """`fn(*trees, ix=ix, **static)` as the batched frame's segment
        `name`: `static` (the Python values that pick its path) and the
        form of each group in `ix` (a dict of `_sel` results) make its key;
        the group index tensors ride in its inputs."""
        ix = ix or {}
        key = (name, *sorted(static.items()), *sorted((k, _form(v)) for k, v in ix.items()))
        return self.segments.run(key, lambda *t: fn(*t[:-1], ix=t[-1], **static), *trees, ix)

    def _row_scan(self, key: tuple, *args, **kwargs):
        """`segments.scan` for a loop of a per-stream branch run on one
        stream's row outside any segment (the recovery's re-integration):
        key + the word "row", apart from the lifted scans' keys, which end
        in "streams"."""
        return self.segments.scan(tuple(key) + ("row",), *args, **kwargs)

    def _ring(self, st, pyr, ix=None):
        """The ring and the output of every stream (segment R, or the end
        of the frame's last segment)."""
        return over_streams(self.one._ring_and_out, st, pyr)


class MonoFleetStep(Fleet):
    """The mono step over a fleet of S streams in lockstep:
    `st, out = step(st, imgs, gens)` with a leading [S] on every tensor
    leaf and one `torch.Generator` per stream held beside the state.

    Per frame one host read of the [S] states; the streams are grouped by
    state and every stage of `MonoStep` runs once over the streams that
    take it (`tree.over_streams`), each branch decision one read of an
    [n, k] table. INITIALIZING's two-view reconstruction and LOST's
    relocalization run per stream through `MonoStep`'s own code.

    The segments (`Fleet`): A, the images and the frame ids, up to the
    state read; B, after the RANSAC uniforms are drawn eagerly per stream,
    the propagation of the INITIALIZING and WORKING streams and the
    WORKING solve, up to its (lost, need) read, which follows the eager
    NOT_INITIALIZED and INITIALIZING branches; C, the solves taken (LOST
    for the others) and the keyframe streams' front up to the compaction
    read; E, the compaction of the rows whose read asked for it, the
    keyframes' bookkeeping and the scatters; the ring and the output end C
    or E when no LOST stream
    follows, else run as R after the eager relocalizations. The frame's
    images are taken as one contiguous copy (a no-op for a contiguous
    tensor), so the graphs see one layout."""

    def __init__(self, cam: CameraModel, cfg: TrackerConfig, device="cuda",
                 graphs: bool | None = None):
        super().__init__(MonoStep(cam, cfg, device=device, graphs=False), graphs)

    # -- the batched frame's segments ----------------------------------
    def _start(self, st: TrackerState, imgs, ix):
        """Segment A: every stream's images and frame id."""
        imgs, pyr = over_streams(self.one._images, imgs)
        return dataclasses.replace(st, frame_id=st.frame_id + 1), imgs, pyr

    def _body(self, st: TrackerState, pyr, u, ix):
        """Segment B: propagation of the streams `ix["prop"]`
        (INITIALIZING, WORKING) with their uniforms `u`, then the solve of
        the WORKING streams `ix["work"]` and its (lost, need) flags."""
        one = self.one
        ml = flags = None
        if ix["prop"] is not None:
            with self.spans("step.propagate"):
                sub = over_streams(one._propagate, take(st, ix["prop"]), take(pyr, ix["prop"]), u)
            st = dataclasses.replace(st, tracks=put(st.tracks, ix["prop"], sub))
        if ix["work"] is not None:
            ml, flags = over_streams(one._working_solve, take(st, ix["work"]))
        return st, ml, flags

    def _accept(self, st: TrackerState, ml, imgs, pyr, ix, ring: bool):
        """Segment C: of the WORKING streams `ix["work"]`, `ix["lost"]`
        turn LOST and `ix["live"]` take their solve with refill and
        refresh (`ix["live_all"]`: the same among all streams). With
        keyframe streams `ix["kf"]` among the live ones it returns (the
        WORKING rows, the live rows, the keyframe rows after the keyframe
        front, the compaction flags) for E; else the state, and with
        `ring` the state and the output."""
        one = self.one
        sub = take(st, ix["work"])
        if ix["lost"] is not None:
            sub = put(sub, ix["lost"], over_streams(one._state, take(sub, ix["lost"]), label=LOST))
        if ix["live"] is not None:
            new = over_streams(one._working_apply, take(sub, ix["live"]), take(ml, ix["live"]),
                               take(imgs, ix["live_all"]))
            if ix["kf"] is not None:
                with self.spans("step.keyframe"):
                    k_new, compact = over_streams(one._kf_front, take(new, ix["kf"]))
                return sub, new, k_new, compact
            sub = put(sub, ix["live"], new)
        st = put(st, ix["work"], sub)
        return self._ring(st, pyr) if ring else (st, None)

    def _kf_end(self, st: TrackerState, sub, new, k_new, pyr, ix, ring: bool):
        """Segment E: the keyframe rows `ix["full"]` compacted, every
        keyframe's bookkeeping, the rows scattered back through the live
        and WORKING streams, and with `ring` the ring and the output."""
        if ix["full"] is not None:
            k_new = put(k_new, ix["full"], over_streams(self.one._compact,
                                                        take(k_new, ix["full"])))
        k_new = over_streams(self.one._kf_finish, k_new)
        st = put(st, ix["work"], put(sub, ix["live"], put(new, ix["kf"], k_new)))
        return self._ring(st, pyr) if ring else (st, None)

    @spanned("step.call")
    def __call__(self, st: TrackerState, imgs: torch.Tensor, gens):
        one, cfg, dev, seg, sel = self.one, self.cfg, self.device, self._seg, self._sel
        S = st.state.shape[0]
        every = list(range(S))

        st, imgs, pyr = seg("A", self._start, st, imgs.contiguous())
        s = [f[0] for f in self._read(st.state)]

        def group(*states):
            return [i for i in every if s[i] in states]

        g_prop, g_work = group(INITIALIZING, WORKING), group(WORKING)
        ml = flags = None
        if g_prop:
            u = torch.stack([draw_uniform(gens[i], 200, cfg.n_tracks, dev) for i in g_prop])
            st, ml, flags = seg("B", self._body, st, pyr, u,
                                ix=dict(prop=sel(g_prop, every), work=sel(g_work, every)))

        g = group(NOT_INITIALIZED)
        if g:
            sub, go = over_streams(one._not_init_detect, self._take(st, g, every),
                                   self._take(imgs, g, every))
            g_go = [i for i, f in zip(g, self._read(go)) if f[0]]
            if g_go:
                sub = self._put(sub, g_go, over_streams(one._not_init_go,
                                                        self._take(sub, g_go, g)), g)
            st = self._put(st, g, sub, every)

        g = group(INITIALIZING)
        if g:
            pres = [one._two_view(self._row(st, i, gens[i])) for i in g]
            dec = self._read(torch.stack([f[0] for _, f in pres]),
                             torch.stack([f[1] for _, f in pres]))
            for i, (pre, _), d in zip(g, pres, dec):
                r, _ = one._initializing(self._row(st, i, gens[i]), imgs[i], pre, tuple(d))
                st = self._put_row(st, i, r)

        out = None
        if g_work:
            dec = self._read(*flags)
            live = [i for i, d in zip(g_work, dec) if not d[0]]
            lost = [i for i, d in zip(g_work, dec) if d[0]]
            kf = [i for i, d in zip(g_work, dec) if not d[0] and d[1]]
            ix = dict(work=sel(g_work, every), live=sel(live, g_work), lost=sel(lost, g_work),
                      live_all=sel(live, every), kf=sel(kf, live))
            ring = not group(LOST)         # no eager relocalization follows
            if not kf:
                st, out = seg("C", self._accept, st, ml, imgs, pyr, ix=ix, ring=ring)
            else:
                with self.spans("step.keyframe"):
                    sub, new, k_new, compact = seg("C", self._accept, st, ml, imgs, pyr, ix=ix,
                                                   ring=False)
                    full = ([i for i, f in zip(kf, self._read(compact)) if f[0]]
                            if cfg.map_hygiene else [])
                    self.compactions += len(full)
                    st, out = seg("E", self._kf_end, st, sub, new, k_new, pyr,
                                  ix=dict(ix, full=sel(full, kf)), ring=ring)

        for i in group(LOST):
            r, _ = one._lost(self._row(st, i, gens[i]), imgs[i])
            st = self._put_row(st, i, r)

        return (st, out) if out is not None else seg("R", self._ring, st, pyr)


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


def build_tracker(cam: CameraModel, cfg: TrackerConfig, kf_cap: int, pt_cap: int,
                  device="cuda", seed: int = 0, graphs: bool | None = None):
    """Returns (state0, step) with step = MonoStep(...), on the card
    unless `device` names another; `graphs` as `MonoStep` takes it."""
    st0 = init_state(cfg, kf_cap, pt_cap, cam.height, cam.width, seed=seed, device=device)
    return st0, MonoStep(cam, cfg, device=device, graphs=graphs)


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
