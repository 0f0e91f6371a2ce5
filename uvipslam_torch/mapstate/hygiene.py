"""Map maintenance: landmark culling, recent-duplicate fusion and slot
compaction.

Counterpart of `cull_points`, `fuse_duplicates_recent` and
`compact_points` in `uvipslam_tpu/mapstate/hygiene.py`: masked batched
passes over the landmark table. `cull_keyframes` and the O(P^2)
`fuse_duplicates` are on no path of the mono slice and wait.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.ops.hamming import hamming_matrix


def cull_points(m: MapState, frame_id: torch.Tensor, min_found_ratio: float = 0.25,
                min_obs_after: int = 2, probation_frames: int = 60) -> MapState:
    """Invalidate weak landmarks (poor found/visible ratio, or too few
    observations after the probation window) and detach them from the
    keyframe feature tables."""
    P = m.pt_cap
    has = (m.kf_feat_pt >= 0) & m.kf_feat_valid
    idx = torch.where(has, m.kf_feat_pt, torch.full_like(m.kf_feat_pt, P - 1)).reshape(-1)
    n_obs = torch.zeros((P,), dtype=torch.int32, device=idx.device).index_add_(
        0, idx.long(), has.reshape(-1).to(torch.int32))
    ratio = m.pt_found / torch.clamp(m.pt_visible, min=1.0)
    age = frame_id - m.pt_first_frame
    weak = (ratio < min_found_ratio) | ((age > probation_frames) & (n_obs < min_obs_after))
    keep = m.pt_valid & ~weak
    detach = m.kf_feat_pt >= 0
    culled = ~keep[m.kf_feat_pt.clamp(0, P - 1).long()] & detach
    return dataclasses.replace(
        m, pt_valid=keep,
        kf_feat_pt=torch.where(culled, torch.full_like(m.kf_feat_pt, -1), m.kf_feat_pt))


def compact_points(m: MapState):
    """Pack valid landmarks to the front so `n_pt` resets to the live
    count. Returns (compacted_map, remap) with remap[old] = new; keyframe
    observation tables are rewritten here, live track associations are
    the caller's."""
    P = m.pt_cap
    order = torch.sort((~m.pt_valid).to(torch.uint8), stable=True).indices
    remap = torch.sort(order, stable=True).indices.to(torch.int32)
    n_valid = torch.sum(m.pt_valid).to(torch.int32)

    pid = m.kf_feat_pt.clamp(0, P - 1).long()
    live = (m.kf_feat_pt >= 0) & m.pt_valid[pid]
    new_feat_pt = torch.where(live, remap[pid], torch.full_like(m.kf_feat_pt, -1))
    m2 = dataclasses.replace(
        m,
        pt_xyz=m.pt_xyz[order], pt_desc=m.pt_desc[order],
        pt_normal=m.pt_normal[order],
        pt_min_dist=m.pt_min_dist[order], pt_max_dist=m.pt_max_dist[order],
        pt_ref_kf=m.pt_ref_kf[order], pt_found=m.pt_found[order],
        pt_visible=m.pt_visible[order], pt_first_frame=m.pt_first_frame[order],
        pt_valid=m.pt_valid[order], kf_feat_pt=new_feat_pt, n_pt=n_valid,
    )
    return m2, remap


def fuse_duplicates_recent(m: MapState, frame_id, Rcw, tcw, fx, fy, cx, cy,
                           recent_frames: int = 40, px_radius: float = 2.0,
                           max_desc_dist: float = 50.0, rel_depth_tol: float = 0.15,
                           cap: int = 512) -> MapState:
    """Fuse the newest `cap` recently created landmarks into the oldest
    coincident point of the whole table: same pixel (within px_radius) in
    the current keyframe's camera, agreeing depth, matching descriptor.
    Observations are rewritten, the recent copies invalidated."""
    P = m.pt_cap
    dev = m.pt_xyz.device
    ids = torch.arange(P, device=dev)
    recent = m.pt_valid & (m.pt_first_frame >= frame_id - recent_frames)
    score = torch.where(recent, m.pt_first_frame, torch.full_like(m.pt_first_frame, -1))
    k = min(cap, P)
    srt = torch.sort(score, descending=True, stable=True)
    val, rid = srt.values[:k], srt.indices[:k]
    rok = val >= 0

    pc_all = (m.pt_xyz @ Rcw.T) + tcw
    z_all = pc_all[:, 2]
    zs = torch.where(torch.abs(z_all) < 1e-6, torch.full_like(z_all, 1e-6), z_all)
    uv_all = torch.stack([fx * pc_all[:, 0] / zs + cx, fy * pc_all[:, 1] / zs + cy], -1)
    infront = z_all > 0.05

    uv_r = uv_all[rid]
    z_r = z_all[rid]
    duv2 = torch.sum((uv_r[:, None, :] - uv_all[None, :, :]) ** 2, -1)
    dz_ok = torch.abs(z_r[:, None] - z_all[None, :]) < rel_depth_tol * torch.clamp(
        torch.abs(z_all[None, :]), min=1e-3)
    desc_d = hamming_matrix(m.pt_desc[rid], m.pt_desc)
    ff = m.pt_first_frame
    older = (ff[None, :] < ff[rid][:, None]) | (
        (ff[None, :] == ff[rid][:, None]) & (ids[None, :] < rid[:, None]))
    dup = ((duv2 < px_radius * px_radius) & dz_ok & (desc_d < max_desc_dist)
           & rok[:, None] & m.pt_valid[None, :] & older
           & infront[rid][:, None] & infront[None, :])
    target = torch.where(dup, ids[None, :], torch.full_like(dup, P, dtype=torch.long))
    best_target = torch.min(target, dim=1).values
    has_dup = best_target < P

    bt = ids.clone()
    bt[rid] = torch.where(has_dup, best_target, rid)
    bt = bt[bt]

    old_pt = m.kf_feat_pt
    mapped = bt[old_pt.clamp(0, P - 1).long()]
    new_pt = torch.where(old_pt >= 0, mapped.to(torch.int32), old_pt)
    fused = torch.zeros((P,), dtype=torch.bool, device=dev)
    fused[rid] = has_dup
    return dataclasses.replace(m, kf_feat_pt=new_pt, pt_valid=m.pt_valid & ~fused)
