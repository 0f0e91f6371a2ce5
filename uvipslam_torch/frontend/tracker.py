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

A frame is cut at those reads into segments, the counterparts of the
reference's compiled stages, run through the tracker's one
`utils.graphs.Segments` (`self.segments`, which the loop closer shares):
F, CLAHE (with `enhance`: its image then stands for the frame in every
later stage, as in the reference) and the image's pyramid with the
propagation (and the NOT_INITIALIZED frame's detection); T, the WORKING solve up to its read; C, the accepted
frame's refill and refresh (and the pose ring when no keyframe follows);
K, the keyframe up to its read (triangulation, insertion, hygiene, the
window BA, the pose adopted from the keyframe); R, the pose ring. Each
segment takes the attributes it reads as a dict and hands back those it
writes; the host values it reads (the frame id, the last keyframe's
slot) enter as device scalars made beside the host copies (`_dev`), so
no per-frame Python value is baked into a graph. With `graphs` on (the
default on a CUDA device) the segments replay captured CUDA graphs; off,
the same segments run eagerly, bit for bit alike. The two-view bootstrap
and the relocalization draw from `gen` and stay eager.
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
from uvipslam_torch.core.tree import put_row, row, tree_map
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
from uvipslam_torch.utils.graphs import Segments

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
    per image, a status dict of host values back. `graphs` (default: on
    for a CUDA device, off on the CPU) replays the frames' segments as
    captured graphs (`self.segments`); `graphs=False` is the eager form,
    and `graphs=True` on the CPU runs the captures' plain form."""

    RING = 64
    # attributes that hold no state of a frame's (`core.tree.attr_state`)
    NOT_STATE = ("cam", "cfg", "segments", "loop_closer", "graphs")

    def __init__(self, cam: CameraModel, cfg: TrackerConfig | None = None,
                 kf_cap: int = 128, pt_cap: int = 8192, seed: int = 0, device="cuda",
                 graphs: bool | None = None):
        self.cam = cam
        self.cfg = cfg or TrackerConfig()
        self.device = dev = step_device(device)
        self.graphs = dev.type == "cuda" if graphs is None else bool(graphs)
        self.segments = Segments(dev, graphs=self.graphs)
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
                min_total_matches=None if mt < 0 else mt, device=dev, segments=self.segments)
        self.loop_events = []       # (frame_id, loop_kf) for diagnostics

    # ------------------------------------------------------------------
    def _read(self, *xs: torch.Tensor) -> list:
        """One host read of device values (scalars or vectors) -> a flat
        list of Python ints."""
        self.host_syncs += 1
        return torch.cat([x.reshape(-1).to(torch.int64) for x in xs]).tolist()

    def _dev(self) -> dict:
        """The host values the segments read, as device scalars made by
        fills (no host-to-device copy): the frame id and the last
        keyframe's slot."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return dict(frame=torch.full((), self.frame_id, **i32),
                    last_kf=torch.full((), self.last_kf_slot, **i32))

    def _seg(self, key: tuple, fn, names: tuple, *trees):
        """fn(attrs, *trees) as the segment `key`, attrs the dict of the
        attributes `names`: fn returns (a dict of attributes to set, its
        outputs). Sets those attributes and returns the outputs. `fn` reads
        tensors only through its arguments and Python values only of
        `key` (a capture bakes in whatever else it reads)."""
        new, out = self.segments.run(key, fn, {n: getattr(self, n) for n in names}, *trees)
        for n, v in new.items():
            setattr(self, n, v)
        return out

    def _upload(self, x) -> torch.Tensor:
        """A frame's input on the device in float32 at a 16-byte aligned
        offset: a view into the caller's stacked frames that sits
        elsewhere is copied (a graph is specialized to its inputs'
        alignment, which would otherwise change from frame to frame)."""
        t = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        return t.clone() if t.storage_offset() * t.element_size() % 16 else t

    def process_frame(self, img) -> dict:
        """Feed one grayscale frame [H, W] (numpy or tensor). Returns a
        dict of host status values."""
        cfg = self.cfg
        self.frame_id += 1
        img = self._upload(img)
        s = self.state
        prop = self.pyr_prev is not None and s != NOT_INITIALIZED
        detect, und = s == NOT_INITIALIZED, s in (INITIALIZING, WORKING)
        u = draw_uniform(self.gen, 200, self.tracks.n_slots, self.device) if prop else None
        # with `enhance` the frame's CLAHE image stands for it from here on
        pyr, n_valid, img = self._seg(
            ("F", prop, detect, und),
            lambda S, x, u_, sc: self._front(S, x, u_, sc, prop=prop, detect=detect, und=und),
            ("tracks", "map", "pyr_prev", "Rcw", "tcw", "R_vel", "t_vel"), img, u, self._dev())

        status, ringed = {}, False
        if s == NOT_INITIALIZED:
            n = self._read(n_valid)[0]
            if n >= cfg.min_init_tracks:
                self.tracks = dataclasses.replace(
                    self.tracks,
                    birth_frame=torch.full_like(self.tracks.birth_frame, self.frame_id),
                    birth_xy_und=self.tracks.xy_und)
                self.init_frame_id = self.frame_id
                self.state = INITIALIZING
            status.update(state="NOT_INITIALIZED", n_tracks=n)

        elif s == INITIALIZING:
            ok = self._try_initialize()
            # top up and keep trying; restart when too few candidates
            # survive (the tracks are those the attempt counted)
            if not ok and (self.n_init_cand < cfg.min_init_tracks // 2
                           or self.frame_id - self.init_frame_id > 30):
                self.state = NOT_INITIALIZED
                self.tracks = Tracks.empty(cfg.n_tracks, device=self.device)
            status.update(state="INITIALIZING", initialized=ok)

        elif s == WORKING:
            n_in = self._track_frame()
            if n_in < cfg.min_tracked:
                self.state = LOST
                status.update(state="LOST", n_inliers=n_in)
            else:
                need = self._need_keyframe(n_in)
                self._accept_frame(img, ring=not need)
                ringed = not need
                if need:
                    self._create_keyframe()
                status.update(state="WORKING", n_inliers=n_in)

        elif s == LOST:
            ok = self._relocalize(img)
            status.update(state="WORKING" if ok else "LOST", relocalized=ok)

        self.pyr_prev = pyr
        if self.state == WORKING:
            if not ringed:
                self._write_ring()
            self.trajectory.append((self.frame_id, self.Rcw, self.tcw))
        return status

    # -- the segments' stages (pure functions of their arguments) ---------
    def _pyramid(self, img):
        return tuple(build_flow_pyramid(img, self.cfg.n_levels_klt))

    def _propagate(self, tracks: Tracks, pyr_prev, pyr, guess, guess_ok, u) -> Tracks:
        cfg = self.cfg
        return propagate_tracks(tracks, pyr_prev, pyr, guess, guess_ok, None, win=cfg.klt_win,
                                iters=cfg.klt_iters, levels=cfg.n_levels_klt, u=u)

    def _front(self, S, img, u, sc, prop: bool, detect: bool, und: bool):
        """Segment F: CLAHE (with `enhance`), the pyramid, the propagation
        from the motion-model guesses, the NOT_INITIALIZED frame's
        detection, the undistortion; the pyramid, the valid track count
        and the image the frame's later stages detect and describe on (the
        CLAHE image with `enhance`) out."""
        if self.cfg.enhance:
            img = clahe(img)
        pyr = self._pyramid(img)
        t = S["tracks"]
        if prop:
            guess, guess_ok = self._motion_guesses(S)
            t = self._propagate(t, S["pyr_prev"], pyr, guess, guess_ok, u)
        if detect:
            t = self._refill(t, img, sc["frame"])
        if detect or und:
            t = self._undistort(t)
        return {"tracks": t}, (pyr, torch.sum(t.valid), img)

    def _solve(self, S):
        """Segment T: pose solve on the associated tracks, local-map
        search, second pose solve, and the pose and motion model the
        solve would set; taken after the read when it holds."""
        cam = self.cam
        R1, t1, _, n1, tracks2 = _pose_and_localmap(
            S["tracks"], S["map"], mm(S["R_vel"], S["Rcw"]), mv(S["R_vel"], S["tcw"]) + S["t_vel"],
            cam.fx, cam.fy, cam.cx, cam.cy, self.scale_sigmas)
        Rinv, tinv = lie.se3_inverse(S["Rcw"], S["tcw"])
        R_vel, t_vel = lie.se3_compose(R1, t1, Rinv, tinv)
        return {}, (n1, dict(Rcw=lie.normalize_rotation(R1), tcw=t1, tracks=tracks2,
                             R_vel=lie.normalize_rotation(R_vel), t_vel=t_vel))

    def _top_up(self, t: Tracks, img, frame) -> Tracks:
        """Refill and descriptor refresh of an accepted frame's tracks; the
        newborn tracks' birth position is their undistorted one."""
        t = self._undistort(refresh_descriptors(self._refill(t, img, frame), img))
        newborn = t.birth_frame == frame
        return dataclasses.replace(t, birth_xy_und=torch.where(
            newborn[:, None], t.xy_und, t.birth_xy_und))

    def _ring(self, S, frame) -> dict:
        """The pose ring with the frame's pose at slot frame % RING."""
        slot = torch.remainder(frame, self.RING)
        return dict(ring_R=put_row(S["ring_R"], slot, S["Rcw"]),
                    ring_t=put_row(S["ring_t"], slot, S["tcw"]),
                    ring_frame=put_row(S["ring_frame"], slot, frame))

    def _accept(self, S, img, sc, ring: bool):
        """Segment C of a mono frame: the top-up, and the pose ring when
        no keyframe follows."""
        new = {"tracks": self._top_up(S["tracks"], img, sc["frame"])}
        if ring:
            new.update(self._ring(S, sc["frame"]))
        return new, None

    def _keyframe(self, S, sc, hygiene: bool):
        """Segment K: triangulate new landmarks against their birth poses,
        insert the keyframe, map hygiene, window BA; the pose adopted from
        the keyframe; its slot and the reference track count out."""
        cam, t, fr = self.cam, S["tracks"], sc["frame"]
        m, t = _triangulate_new(S["map"], t, S["ring_R"], S["ring_t"], S["ring_frame"],
                                S["Rcw"], S["tcw"], cam.fx, cam.fy, cam.cx, cam.cy, fr,
                                sc["last_kf"])
        m, k = m.add_keyframe(_cam_pose_to_ns(S["Rcw"], S["tcw"]), fr.to(torch.float32), fr,
                              t.xy_und, t.desc, t.level, t.angle, t.valid, t.pt_id, 0.0, False,
                              self.zero_preint, sc["last_kf"])
        if hygiene:
            m, t = self._run_hygiene(m, t, fr, S["Rcw"], S["tcw"])
        m = self._run_local_ba(m)
        Rcw, tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, k))
        return dict(map=m, tracks=t, Rcw=Rcw, tcw=tcw), (k, torch.sum(t.valid & (t.pt_id >= 0)))

    def _set_ring_pose_eagerly(self, frame: int, R, t):
        """The pose ring's slot of `frame` set to (R, t), eagerly."""
        S = dict(ring_R=self.ring_R, ring_t=self.ring_t, ring_frame=self.ring_frame, Rcw=R, tcw=t)
        for k, v in self._ring(S, torch.full((), frame, dtype=torch.int32,
                                             device=self.device)).items():
            setattr(self, k, v)

    # -- the frame's segments, run ------------------------------------------
    def _accept_frame(self, img, ring: bool):
        self._seg(("C", False, ring), lambda S, x, sc: self._accept(S, x, sc, ring=ring),
                  ("tracks", "ring_R", "ring_t", "ring_frame", "Rcw", "tcw"), img, self._dev())

    def _write_ring(self):
        """Segment R: the pose ring's slot of this frame."""
        self._seg(("R",), lambda S, sc: (self._ring(S, sc["frame"]), None),
                  ("ring_R", "ring_t", "ring_frame", "Rcw", "tcw"), self._dev())

    # ------------------------------------------------------------------
    def _refill(self, tracks: Tracks, img, frame) -> Tracks:
        return refill_tracks(tracks, img, frame, n_features=self.cfg.n_tracks,
                             px_distance=self.cfg.px_distance)

    def _undistort(self, tracks: Tracks) -> Tracks:
        return dataclasses.replace(tracks, xy_und=self.cam.undistort_pixels(tracks.xy))

    def _motion_guesses(self, S):
        """Landmarks projected with the motion-model pose: the KLT
        initial guesses."""
        cam = self.cam
        return _motion_guess(S["tracks"], S["map"], mm(S["R_vel"], S["Rcw"]),
                             mv(S["R_vel"], S["tcw"]) + S["t_vel"], cam.fx, cam.fy, cam.cx,
                             cam.cy)

    # ------------------------------------------------------------------
    def _try_initialize(self) -> bool:
        """H/F two-view bootstrap: the initial map of two keyframes, the
        median depth normalized to 1, refined by the window BA (eager: the
        reconstruction draws from `gen`)."""
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
        # keyframe 1's pose as a row of its own (the layout every later
        # keyframe's adopted pose has)
        self.Rcw, self.tcw = _ns_to_cam_pose(_nav_row(m.kf_ns, k1))
        self.R_vel, self.t_vel = eye, zero3
        self.last_kf_slot, self.n_ref_tracked = self._read(k1, torch.sum(good))
        self.last_kf_frame = self.frame_id
        # the init frame's pose (identity), so that tracks born then can
        # triangulate against their birth pose
        self._set_ring_pose_eagerly(self.init_frame_id, eye, zero3)
        self.state = WORKING
        return True

    # ------------------------------------------------------------------
    def _track_frame(self) -> int:
        """Segment T up to its read; when the solve holds, the pose, the
        motion model following it and the tracks are taken."""
        n1, upd = self._seg(("T",), self._solve, ("tracks", "map", "Rcw", "tcw", "R_vel",
                                                  "t_vel"))
        n1 = self._read(n1)[0]
        if n1 >= self.cfg.min_tracked:
            for k, v in upd.items():
                setattr(self, k, v)
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
        """Segment K up to its read, then the keyframe's bookkeeping and
        the loop closer's pass."""
        hyg = self.cfg.map_hygiene
        k, n_ref = self._seg(("K", False, hyg), lambda S, sc: self._keyframe(S, sc, hygiene=hyg),
                             ("map", "tracks", "ring_R", "ring_t", "ring_frame", "Rcw", "tcw"),
                             self._dev())
        k, self.n_ref_tracked = self._read(k, n_ref)
        self.last_kf_slot = k
        self.last_kf_frame = self.frame_id
        self._maybe_close_loop(k)

    # ------------------------------------------------------------------
    def _run_hygiene(self, m: MapState, t: Tracks, frame, Rcw, tcw):
        """Landmark culling and recent-duplicate fusion at each keyframe
        (`map_hygiene`); tracks lose associations to landmarks that went."""
        cam = self.cam
        m = cull_points(m, frame)
        m = fuse_duplicates_recent(m, frame, Rcw, tcw, cam.fx, cam.fy, cam.cx, cam.cy)
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
        fresh = self._refill(Tracks.empty(cfg.n_tracks, device=dev), img, self.frame_id)
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
