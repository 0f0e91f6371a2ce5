"""Map maintenance: landmark and keyframe culling, duplicate fusion and
slot compaction.

Counterpart of `uvipslam_tpu/mapstate/hygiene.py`: masked batched passes
over the landmark and keyframe tables. The whole-table `fuse_duplicates`
(run after a loop closure) walks its [P, P] comparison in row blocks, so
its memory does not grow with P^2.
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
    n_obs = _obs_counts(m, (m.kf_feat_pt >= 0) & m.kf_feat_valid)
    ratio = m.pt_found / torch.clamp(m.pt_visible, min=1.0)
    age = frame_id - m.pt_first_frame
    weak = (ratio < min_found_ratio) | ((age > probation_frames) & (n_obs < min_obs_after))
    keep = m.pt_valid & ~weak
    detach = m.kf_feat_pt >= 0
    culled = ~keep[m.kf_feat_pt.clamp(0, P - 1).long()] & detach
    return dataclasses.replace(
        m, pt_valid=keep,
        kf_feat_pt=torch.where(culled, torch.full_like(m.kf_feat_pt, -1), m.kf_feat_pt))


def _obs_counts(m: MapState, obs_ok: torch.Tensor) -> torch.Tensor:
    """[P] i32 observation count per landmark over the masked
    observations (an integer scatter-add: exact in any order)."""
    P = m.pt_cap
    idx = torch.where(obs_ok, m.kf_feat_pt.clamp(0, P - 1),
                      torch.full_like(m.kf_feat_pt, P - 1)).reshape(-1)
    return torch.zeros((P,), dtype=torch.int32, device=idx.device).index_add(
        0, idx.long(), obs_ok.reshape(-1).to(torch.int32))


def cull_keyframes(m: MapState, redundancy: float = 0.9, min_other_obs: int = 3,
                   keep_last: int = 3) -> MapState:
    """Invalidate the single most redundant keyframe, if any: one whose
    landmarks are more than `redundancy` observed by at least
    `min_other_obs` other keyframes. The first and the `keep_last` newest
    keyframes are kept; the kf_prev chain is spliced across the culled
    slot and its observations are detached."""
    K, F = m.kf_feat_pt.shape
    dev = m.kf_feat_pt.device
    obs_ok = (m.kf_feat_pt >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    pid = m.kf_feat_pt.clamp(0, m.pt_cap - 1).long()
    obs_ok = obs_ok & m.pt_valid[pid]
    n_obs = _obs_counts(m, obs_ok)
    redundant = obs_ok & (n_obs[pid] - 1 >= min_other_obs)
    n_own = torch.sum(obs_ok, dim=1)
    frac = torch.sum(redundant, dim=1) / torch.clamp(n_own, min=1)

    first = torch.argmax(m.kf_valid.to(torch.int32))
    slot = torch.arange(K, device=dev)
    protect = (slot == first) | (slot >= m.n_kf - keep_last) | ~m.kf_valid
    cullable = ~protect & (frac > redundancy) & (n_own > 0)
    score = torch.where(cullable, frac, torch.full_like(frac, -1.0))
    # the lowest slot among equal scores, as jnp.argmax picks
    k = torch.sort(score, descending=True, stable=True).indices[0]
    do = score[k] > 0

    hit = (slot == k) & do
    prev_k = m.kf_prev[k]
    return dataclasses.replace(
        m, kf_valid=m.kf_valid & ~hit,
        kf_prev=torch.where((m.kf_prev == k) & do, prev_k, m.kf_prev),
        kf_feat_valid=m.kf_feat_valid & ~hit[:, None])


def fuse_duplicates(m: MapState, radius: float = 0.05, max_desc_dist: float = 50.0,
                    block: int = 1024) -> MapState:
    """Merge landmark pairs that nearly coincide in space with matching
    descriptors: the younger (higher slot) point is redirected to its
    oldest duplicate, its observations rewritten and the point
    invalidated. The P x P comparison runs in blocks of `block` rows, the
    squared distance accumulated per coordinate in float32, so the peak
    memory is a few [block, P] arrays and not the [P, P, 3] difference."""
    P = m.pt_cap
    dev = m.pt_xyz.device
    ids = torch.arange(P, device=dev)
    x = m.pt_xyz
    best = []
    for lo in range(0, P, block):
        hi = min(lo + block, P)
        d2 = torch.zeros((hi - lo, P), dtype=x.dtype, device=dev)
        for c in range(3):
            d = x[lo:hi, None, c] - x[None, :, c]
            d2 += d * d
        dup = ((d2 < radius * radius)
               & (hamming_matrix(m.pt_desc[lo:hi], m.pt_desc) < max_desc_dist)
               & m.pt_valid[lo:hi, None] & m.pt_valid[None, :]
               & (ids[lo:hi, None] > ids[None, :]))     # younger row, older column
        target = torch.where(dup, ids[None, :], torch.full_like(ids, P)[None, :])
        best.append(torch.min(target, dim=1).values)
    best_target = torch.cat(best)                       # [P], P = none
    has_dup = best_target < P

    # resolve chains (a -> b, b -> c) with a few passes
    bt = torch.where(has_dup, best_target, ids)
    for _ in range(3):
        tc = bt.clamp(0, P - 1)
        bt = torch.where(bt < P, torch.minimum(bt, torch.where(has_dup[tc], best_target[tc], bt)),
                         bt)

    old_pt = m.kf_feat_pt
    mapped = bt[old_pt.clamp(0, P - 1).long()]
    new_pt = torch.where(old_pt >= 0, mapped.to(torch.int32), old_pt)
    return dataclasses.replace(m, kf_feat_pt=new_pt, pt_valid=m.pt_valid & ~has_dup)


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

    bt = ids.scatter(0, rid, torch.where(has_dup, best_target, rid))   # rid: distinct slots
    bt = bt[bt]

    old_pt = m.kf_feat_pt
    mapped = bt[old_pt.clamp(0, P - 1).long()]
    new_pt = torch.where(old_pt >= 0, mapped.to(torch.int32), old_pt)
    fused = torch.zeros((P,), dtype=torch.bool, device=dev).scatter(0, rid, has_dup)
    return dataclasses.replace(m, kf_feat_pt=new_pt, pt_valid=m.pt_valid & ~fused)
