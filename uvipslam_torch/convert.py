"""Carry reference state into the port.

Turns a reference `TrackerState`, `VipTrackerState`, `MapState`, `Tracks`
or `NavState` whose leaves are numpy arrays (on the reference side:
`jax.tree_util.tree_map(np.asarray, state)`) into the port's dataclass of
tensors on a given device. Fields are read by name, so this module needs
nothing from the reference package. The reference's PRNG key has no
torch counterpart: a converted tracker state gets a fresh generator, and
so does a converted `LoopCloser`, whose host state (consistency groups,
last loop frame, cluster tables) is carried over as it is. A batched
reference state (every leaf with a leading stream dimension, as
`parallel.replay.batched_replay*`'s `make_states` gives it) becomes the
port's batched state through `tracker_fleet` / `vip_fleet`; its `gen`
field is None, since a fleet's generators live beside the state. A host
`MonoTracker` of the reference becomes the port's through `mono_tracker`,
a host `VipTracker` through `vip_tracker`: its camera, configuration and
host fields as they are, its arrays as tensors, a fresh generator in
place of its PRNG key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.state import NavState
from uvipslam_torch.frontend.device_tracker import TrackerState
from uvipslam_torch.frontend.device_vip import VipTrackerState
from uvipslam_torch.frontend.frame import Tracks
from uvipslam_torch.mapstate.map import MapState

_NESTED = {"kf_ns": NavState, "kf_preint": PreintState, "tracks": Tracks,
           "map": MapState, "ns": NavState, "rec_ns": NavState, "preint_kf": PreintState,
           "rec_preint": PreintState}


def to_tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def convert(cls, src, device=None, seed: int | None = 0):
    """Build the port's `cls` from the same-named fields of `src`
    (`seed=None`: no generator, for a fleet's batched state)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "gen":
            kw["gen"] = None
            if seed is not None:
                kw["gen"] = torch.Generator(device=device)
                kw["gen"].manual_seed(seed)
            continue
        v = getattr(src, f.name)
        if f.name in _NESTED:
            kw[f.name] = convert(_NESTED[f.name], v, device)
        elif f.name == "pyr_prev":
            kw[f.name] = tuple(to_tensor(a, device) for a in v)
        else:
            kw[f.name] = to_tensor(v, device)
    return cls(**kw)


def tracker_state(src, device=None, seed: int = 0) -> TrackerState:
    return convert(TrackerState, src, device, seed)


def vip_state(src, device=None, seed: int = 0) -> VipTrackerState:
    return convert(VipTrackerState, src, device, seed)


def tracker_fleet(src, device=None) -> TrackerState:
    """A batched reference `TrackerState` (leaves [S, ...])."""
    return convert(TrackerState, src, device, seed=None)


def vip_fleet(src, device=None) -> VipTrackerState:
    """A batched reference `VipTrackerState` (leaves [S, ...])."""
    return convert(VipTrackerState, src, device, seed=None)


def map_state(src, device=None) -> MapState:
    return convert(MapState, src, device)


def tracks(src, device=None) -> Tracks:
    return convert(Tracks, src, device)


def nav_state(src, device=None) -> NavState:
    return convert(NavState, src, device)


def loop_closer(src, device=None, seed: int = 11):
    """The port's `LoopCloser` with the settings and host state of a
    reference one, so that both start a `process_keyframe` call from the
    same state. `post_ba` stays the port's default (visual global BA)."""
    from uvipslam_torch.loop.closer import LoopCloser

    lc = LoopCloser(src.fx, src.fy, src.cx, src.cy, consistency_th=src.consistency_th,
                    covis_th=src.covis_th, min_gap=src.min_gap,
                    min_sim3_inliers=src.min_sim3_inliers,
                    min_total_matches=src.min_total_matches, seed=seed,
                    device="cpu" if device is None else device)
    for f in ("Rcb", "tcb", "Rbc", "tbc"):
        setattr(lc, f, to_tensor(getattr(src, f), lc.device))
    lc.consistent_groups = [(frozenset(int(k) for k in g), int(n))
                            for g, n in src.consistent_groups]
    lc.last_loop_frame = int(src.last_loop_frame)
    lc.n_closed = int(src.n_closed)
    lc.cl_kf = [int(k) for k in src.cl_kf]
    lc.cl_hash = [np.array(h, copy=True) for h in src.cl_hash]
    lc.cl_cent = [np.array(c, copy=True) for c in src.cl_cent]
    lc.kf_cluster_ids = {int(k): [int(i) for i in v] for k, v in src.kf_cluster_ids.items()}
    lc.cluster_lc_found = [(int(a), int(b)) for a, b in src.cluster_lc_found]
    lc.cluster_min_pts = int(src.cluster_min_pts)
    return lc


def _camera(c):
    from uvipslam_torch.models.camera import CameraModel

    return CameraModel.create(float(np.asarray(c.fx)), float(np.asarray(c.fy)),
                              float(np.asarray(c.cx)), float(np.asarray(c.cy)),
                              dist=tuple(np.asarray(c.dist, np.float64).tolist()), kind=c.kind,
                              width=c.width, height=c.height)


def _host_tracker(cls, cfg_cls, src, device, seed):
    """A `cls` tracker with the camera, configuration and MonoTracker
    state of the reference tracker `src`."""
    cfg = cfg_cls(**{f.name: getattr(src.cfg, f.name) for f in dataclasses.fields(cfg_cls)})
    tr = cls(_camera(src.cam), cfg, kf_cap=int(np.asarray(src.map.kf_valid).shape[0]),
             pt_cap=int(np.asarray(src.map.pt_valid).shape[0]), seed=seed,
             device="cpu" if device is None else device)
    tr.tracks = tracks(src.tracks, tr.device)
    tr.map = map_state(src.map, tr.device)
    tr.pyr_prev = None if src.pyr_prev is None else tuple(
        to_tensor(np.asarray(a), tr.device) for a in src.pyr_prev)
    for f in ("Rcw", "tcw", "R_vel", "t_vel", "ring_R", "ring_t", "ring_frame"):
        setattr(tr, f, to_tensor(np.asarray(getattr(src, f)), tr.device))
    for f in ("state", "frame_id", "init_frame_id", "last_kf_slot", "last_kf_frame",
              "n_ref_tracked"):
        setattr(tr, f, int(getattr(src, f)))
    tr.trajectory = [(int(f), to_tensor(np.asarray(R), tr.device),
                      to_tensor(np.asarray(t), tr.device)) for f, R, t in src.trajectory]
    tr.loop_events = list(src.loop_events)
    if src.loop_closer is not None:
        tr.loop_closer = loop_closer(src.loop_closer, tr.device)
    return tr


def mono_tracker(src, device=None, seed: int = 0):
    """The port's `MonoTracker` with the state of a reference one: the
    state machine, frame ids and keyframe bookkeeping, tracks, map, pose,
    motion model, pose ring, the previous frame's pyramid, the stored
    trajectory (its poses as tensors) and the loop closer's host state
    (`loop_closer`)."""
    from uvipslam_torch.frontend.tracker import MonoTracker, TrackerConfig

    return _host_tracker(MonoTracker, TrackerConfig, src, device, seed)


def _imu_window(w: dict, device) -> dict:
    return {k: (torch.tensor(int(v), dtype=torch.int32, device=device) if k == "n"
                else to_tensor(np.asarray(v), device)) for k, v in w.items()}


def vip_tracker(src, device=None, seed: int = 0):
    """The port's `VipTracker` with the state of a reference one: what
    `mono_tracker` carries, and the inertial state: `vio_ok`, the current
    and previous NavStates, the since-keyframe preintegration and its raw
    window (its fill level `n` as a device scalar), the accelerometer sum,
    the frame's depth and time, the marginal prior, the recovery anchor
    (`rec_anchor_*`, where the reference has entered recovery) and the
    pending post-recovery bias recompute."""
    from uvipslam_torch.frontend.vip_tracker import VipConfig, VipTracker

    tr = _host_tracker(VipTracker, VipConfig, src, device, seed)
    dev = tr.device
    tr.vio_ok = bool(src.vio_ok)
    tr.ns, tr.ns_prev = nav_state(src.ns, dev), nav_state(src.ns_prev, dev)
    tr.preint_kf = convert(PreintState, src.preint_kf, dev)
    tr.kf_imu = _imu_window(src.kf_imu, dev)
    tr.accw_sum = to_tensor(np.asarray(src.accw_sum), dev)
    tr.cur_depth = to_tensor(np.asarray(src.cur_depth), dev)
    tr.cur_depth_valid = bool(src.cur_depth_valid)
    tr.frame_time = float(src.frame_time)
    tr.dt_frame = float(src.dt_frame)
    tr.H_prior = to_tensor(np.asarray(src.H_prior), dev)
    pending = getattr(src, "_reloc_bias_after_kf", None)
    tr._reloc_bias_after_kf = None if pending is None else int(pending)
    if hasattr(src, "rec_anchor_ns"):
        tr.rec_anchor_ns = nav_state(src.rec_anchor_ns, dev)
        tr.rec_anchor_frame = int(src.rec_anchor_frame)
        tr.rec_anchor_time = float(src.rec_anchor_time)
        d, dv = src.rec_anchor_depth
        tr.rec_anchor_depth = (to_tensor(np.asarray(d), dev), bool(dv))
        tr.rec_anchor_preint = convert(PreintState, src.rec_anchor_preint, dev)
        tr.rec_anchor_imu = _imu_window(src.rec_anchor_imu, dev)
    return tr
