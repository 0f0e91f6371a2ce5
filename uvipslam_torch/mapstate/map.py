"""Fixed-capacity device-resident world model (keyframes + landmarks).

Counterpart of `uvipslam_tpu/mapstate/map.py`: one dataclass of
structure-of-arrays tables with validity masks and monotonic slot
counters. Updates are functional (each returns a new MapState whose
touched tables are fresh tensors), like the reference, so a branch that
is not taken leaves the caller's state intact. Index writes follow JAX's
rules: a row outside the table is dropped, not an error.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.state import NavState
from uvipslam_torch.core.tree import full_like_scalar, put_row, scatter_rows, tree_map
from uvipslam_torch.loop import reloc
from uvipslam_torch.loop.haloc import HASH_DIM, compute_hash
from uvipslam_torch.loop.vocab import bow_vector

N_BITS = 256
LOOP_CAP = 16


@dataclasses.dataclass
class MapState:
    # --- keyframes -----------------------------------------------------
    kf_ns: NavState            # [K] camera state (MONO: NavState.R = Rwc, p = center)
    kf_time: torch.Tensor      # [K]
    kf_valid: torch.Tensor     # [K] bool
    kf_frame_id: torch.Tensor  # [K] i32
    kf_prev: torch.Tensor      # [K] i32 previous-KF slot (-1 for first)
    kf_depth: torch.Tensor     # [K]
    kf_depth_valid: torch.Tensor  # [K] bool
    kf_preint: PreintState     # [K]
    kf_imu_omg: torch.Tensor   # [K, S, 3]
    kf_imu_acc: torch.Tensor   # [K, S, 3]
    kf_imu_dt: torch.Tensor    # [K, S]
    kf_imu_mask: torch.Tensor  # [K, S]
    kf_feat_xy: torch.Tensor   # [K, F, 2] undistorted pixel coords
    kf_feat_desc: torch.Tensor  # [K, F, 256] i8
    kf_feat_level: torch.Tensor  # [K, F] i32
    kf_feat_angle: torch.Tensor  # [K, F] f32
    kf_feat_valid: torch.Tensor  # [K, F] bool
    kf_feat_pt: torch.Tensor   # [K, F] i32 landmark id (-1 = none)
    kf_bow: torch.Tensor       # [K, W] L1-normalized TF-IDF BoW vector
    kf_hash: torch.Tensor      # [K, D] haloc hash
    # --- landmarks -----------------------------------------------------
    pt_xyz: torch.Tensor       # [P, 3]
    pt_valid: torch.Tensor     # [P] bool
    pt_desc: torch.Tensor      # [P, 256] i8
    pt_normal: torch.Tensor    # [P, 3]
    pt_min_dist: torch.Tensor  # [P]
    pt_max_dist: torch.Tensor  # [P]
    pt_ref_kf: torch.Tensor    # [P] i32
    pt_found: torch.Tensor     # [P] f32
    pt_visible: torch.Tensor   # [P] f32
    pt_first_frame: torch.Tensor  # [P] i32
    # --- retained loop edges -------------------------------------------
    loop_i: torch.Tensor       # [L] i32
    loop_j: torch.Tensor       # [L] i32
    loop_s: torch.Tensor       # [L]
    loop_R: torch.Tensor       # [L, 3, 3]
    loop_t: torch.Tensor       # [L, 3]
    # --- counters ------------------------------------------------------
    n_kf: torch.Tensor         # i32 next free KF slot
    n_pt: torch.Tensor         # i32 next free landmark slot
    n_loop: torch.Tensor       # i32

    @property
    def kf_cap(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def pt_cap(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_feat_valid.shape[1]

    @staticmethod
    def empty(kf_cap: int = 256, pt_cap: int = 16384, n_feat: int = 400,
              imu_window: int = 256, dtype=torch.float32, device=None) -> "MapState":
        K, P, F, S = kf_cap, pt_cap, n_feat, imu_window

        def z(*s, dt=dtype):
            return torch.zeros(s, dtype=dt, device=device)

        def full(s, v, dt=torch.int32):
            return torch.full(s, v, dtype=dt, device=device)

        return MapState(
            kf_ns=NavState.identity((K,), dtype, device),
            kf_time=z(K), kf_valid=z(K, dt=torch.bool),
            kf_frame_id=full((K,), -1), kf_prev=full((K,), -1),
            kf_depth=z(K), kf_depth_valid=z(K, dt=torch.bool),
            kf_preint=PreintState.zero((K,), dtype, device),
            kf_imu_omg=z(K, S, 3), kf_imu_acc=z(K, S, 3),
            kf_imu_dt=z(K, S), kf_imu_mask=z(K, S),
            kf_feat_xy=z(K, F, 2), kf_feat_desc=z(K, F, N_BITS, dt=torch.int8),
            kf_feat_level=z(K, F, dt=torch.int32), kf_feat_angle=z(K, F),
            kf_feat_valid=z(K, F, dt=torch.bool), kf_feat_pt=full((K, F), -1),
            kf_bow=z(K, reloc.N_WORDS), kf_hash=z(K, HASH_DIM),
            pt_xyz=z(P, 3), pt_valid=z(P, dt=torch.bool),
            pt_desc=z(P, N_BITS, dt=torch.int8), pt_normal=z(P, 3),
            pt_min_dist=z(P), pt_max_dist=z(P), pt_ref_kf=full((P,), -1),
            pt_found=torch.ones(P, dtype=dtype, device=device),
            pt_visible=torch.ones(P, dtype=dtype, device=device),
            pt_first_frame=full((P,), -1),
            loop_i=full((LOOP_CAP,), -1), loop_j=full((LOOP_CAP,), -1),
            loop_s=torch.ones(LOOP_CAP, dtype=dtype, device=device),
            loop_R=torch.eye(3, dtype=dtype, device=device).repeat(LOOP_CAP, 1, 1),
            loop_t=z(LOOP_CAP, 3),
            n_kf=full((), 0), n_pt=full((), 0), n_loop=full((), 0),
        )

    # -------------------------------------------------------------------
    # keyframe insertion
    # -------------------------------------------------------------------

    def add_keyframe(self, ns: NavState, time, frame_id, feat_xy, feat_desc,
                     feat_level, feat_angle, feat_valid, feat_pt, depth,
                     depth_valid, preint: PreintState, prev_kf, imu_omg=None,
                     imu_acc=None, imu_dt=None, imu_mask=None):
        """Insert a keyframe at the next slot; returns (new_map, kf_slot).
        The BoW and haloc retrieval vectors are computed once here. The
        raw IMU window since the previous keyframe ([S, 3], [S, 3], [S],
        [S]) is stored when given (the VIP step re-integrates it at VIO
        init); otherwise the slot keeps its old window."""
        dev = feat_desc.device
        bow = bow_vector(feat_desc, feat_valid, reloc.codebook(dev), reloc.idf(dev))
        hsh = compute_hash(feat_desc, feat_valid)

        k = self.n_kf
        m = self

        def put(tbl, v):
            return put_row(tbl, k, v)

        # observed landmarks take this keyframe's descriptor (the newest
        # observation; the last feature wins where two share a landmark)
        has = feat_valid & (feat_pt >= 0)
        pt_desc = scatter_rows(m.pt_desc, feat_pt, feat_desc, has)
        new = dataclasses.replace(
            m,
            kf_ns=tree_map(put, m.kf_ns, ns),
            kf_time=put(m.kf_time, time),
            kf_valid=put(m.kf_valid, True),
            kf_frame_id=put(m.kf_frame_id, frame_id),
            kf_prev=put(m.kf_prev, prev_kf),
            kf_depth=put(m.kf_depth, depth),
            kf_depth_valid=put(m.kf_depth_valid, depth_valid),
            kf_preint=tree_map(put, m.kf_preint, preint),
            kf_feat_xy=put(m.kf_feat_xy, feat_xy),
            kf_feat_desc=put(m.kf_feat_desc, feat_desc),
            kf_feat_level=put(m.kf_feat_level, feat_level),
            kf_feat_angle=put(m.kf_feat_angle, feat_angle),
            kf_feat_valid=put(m.kf_feat_valid, feat_valid),
            kf_feat_pt=put(m.kf_feat_pt, torch.where(feat_valid, feat_pt,
                                                     torch.full_like(feat_pt, -1))),
            kf_bow=put(m.kf_bow, bow),
            kf_hash=put(m.kf_hash, hsh),
            pt_desc=pt_desc,
            n_kf=k + 1,
        )
        if imu_omg is not None:
            new = dataclasses.replace(
                new, kf_imu_omg=put(m.kf_imu_omg, imu_omg), kf_imu_acc=put(m.kf_imu_acc, imu_acc),
                kf_imu_dt=put(m.kf_imu_dt, imu_dt), kf_imu_mask=put(m.kf_imu_mask, imu_mask))
        return new, k

    # -------------------------------------------------------------------
    # landmark insertion (batched)
    # -------------------------------------------------------------------

    def add_points(self, xyz, desc, normal, min_dist, max_dist, ref_kf,
                   frame_id, valid):
        """Append up to M landmarks, valid candidates packed to the front
        by a stable sort so slots stay dense. Returns (new_map,
        pt_ids [M] with -1 for rejected candidates)."""
        M = xyz.shape[0]
        dev = xyz.device
        order = torch.sort((~valid).to(torch.uint8), stable=True).indices
        inv_order = torch.sort(order, stable=True).indices
        n_new = torch.sum(valid).to(torch.int32)
        slots_packed = self.n_pt + torch.arange(M, dtype=torch.int32, device=dev)
        ids = torch.where(valid, slots_packed[inv_order], torch.full_like(slots_packed, -1))

        val_p = valid[order]
        refk = full_like_scalar(ref_kf, M, torch.int32, dev)
        fid = full_like_scalar(frame_id, M, torch.int32, dev)

        m = self

        def upd(tbl, vals):
            # slots past the table are dropped, as in JAX
            return scatter_rows(tbl, slots_packed, vals, val_p)

        one = torch.ones(M, dtype=m.pt_found.dtype, device=dev)
        new = dataclasses.replace(
            m,
            pt_xyz=upd(m.pt_xyz, xyz[order]),
            pt_desc=upd(m.pt_desc, desc[order]),
            pt_normal=upd(m.pt_normal, normal[order]),
            pt_min_dist=upd(m.pt_min_dist, min_dist[order]),
            pt_max_dist=upd(m.pt_max_dist, max_dist[order]),
            pt_ref_kf=upd(m.pt_ref_kf, refk),
            pt_valid=upd(m.pt_valid, torch.ones(M, dtype=torch.bool, device=dev)),
            pt_first_frame=upd(m.pt_first_frame, fid),
            pt_found=upd(m.pt_found, one),
            pt_visible=upd(m.pt_visible, one),
            n_pt=m.n_pt + n_new,
        )
        return new, ids
