"""Loop closing: detect -> Sim3 -> correct.

Counterpart of `uvipslam_tpu/loop/closer.py`: a functional pass run
after a keyframe is inserted.

  1. candidates from BoW scores (gated by the min covisible score), the
     haloc hash distance, and the two keypoint-cluster channels (cluster
     hash and centroid proximity), deduplicated;
  2. a covisibility-consistency chain over consecutive detections;
  3. 3D-3D correspondences from descriptor matching between the query
     and candidate keyframes' landmarks, Horn Sim3 RANSAC, the paired
     reprojection refinement, a Sim3-guided extension and the 20/40
     inlier / total-match gates;
  4. correction: essential-graph optimization over all keyframes
     (spanning chain, strong covisibility edges, retained loop edges, the
     new edge), the landmark re-expression sweep, duplicate fusion and a
     global BA.

The tables stay on the map's device; the decisions are host reads
(`float()`, `int()`, `.cpu()`), each counted in the module's `host_reads`
(and per pass in `LoopCloser.last_reads`).
The cluster tables live in numpy on the host, as in the reference.
RANSAC samples draw from an explicit `torch.Generator`, where the
reference splits a PRNG key.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.frontend.device_tracker import step_device
from uvipslam_torch.frontend.tracker import _cam_pose_to_ns_ext, _ns_to_cam_pose_ext
from uvipslam_torch.loop import haloc
from uvipslam_torch.loop.clusters import (HALOC_BEST_N, HALOC_ID_WINDOW, PROX_BEST_N,
                                          PROX_ID_WINDOW, keyframe_clusters)
from uvipslam_torch.loop.vocab import l1_score
from uvipslam_torch.mapstate.hygiene import fuse_duplicates
from uvipslam_torch.mapstate.map import MapState
from uvipslam_torch.ops import hamming
from uvipslam_torch.ops.sim3solver import optimize_sim3, sim3_ransac
from uvipslam_torch.solver.essential_graph import (correct_points_after_pose_graph,
                                                   optimize_essential_graph)
from uvipslam_torch.solver.global_ba import global_ba_visual
from uvipslam_torch.utils.graphs import Segments


host_reads = 0    # device-to-host reads made by this module's functions


def _count_read(n: int = 1):
    global host_reads
    host_reads += n


def kf_insertion_gap(m: MapState, query_kf) -> torch.Tensor:
    """Per-slot keyframe-insertion distance to `query_kf`: for each slot
    c, the number of valid keyframes inserted after c and up to (and
    including) the query, keyed on `kf_frame_id` and not on the slot
    index. Slots holding frames newer than the query get gap 0."""
    f = m.kf_frame_id
    fq = f[query_kf]
    newer = m.kf_valid[None, :] & (f[None, :] > f[:, None]) & (f[None, :] <= fq)
    return torch.sum(newer, dim=1)


def _top_k(values: torch.Tensor, k: int):
    """The k largest values and their indices, equal values ranking the
    lower index first."""
    srt = torch.sort(values, descending=True, stable=True)
    return srt.values[:k], srt.indices[:k]


def detect_loop_candidates(m: MapState, query_kf: int, min_gap: int = 10, top_k: int = 3,
                           min_score: float | None = None):
    """BoW + haloc candidate retrieval for `query_kf` from the vectors
    stored at keyframe insertion, excluding the `min_gap` most recent
    keyframe insertions and gating BoW candidates at `min_score`. One
    host read. Returns (idx [<= 2*top_k], scores [top_k]) in numpy."""
    scores = l1_score(m.kf_bow[query_kf], m.kf_bow)
    exclude = (kf_insertion_gap(m, query_kf) < min_gap) | ~m.kf_valid
    s = torch.where(exclude, torch.full_like(scores, -1.0), scores)
    bow_val, bow_idx = _top_k(s, top_k)
    h_idx, _, h_ok = haloc.detect_candidates_haloc(
        m.kf_hash[query_kf], m.kf_hash, m.kf_valid, exclude, top_k=top_k)

    _count_read()
    bow_val, bow_idx, h_idx, h_ok, s = (a.cpu().numpy() for a in _host(
        bow_val, bow_idx, h_idx, h_ok, s))
    gate = 0.0 if min_score is None else max(float(min_score), 0.0)
    idx = np.unique(np.concatenate([bow_idx[bow_val > gate], h_idx[h_ok.astype(bool)]]))
    idx = idx.astype(np.int64)
    idx = idx[s[idx] > 0]
    return idx, bow_val


def _host(*tensors):
    """The tensors brought to the host together (one wait for the
    stream)."""
    if tensors[0].device.type == "cpu":
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].to(t.dtype).reshape(t.shape))
        o += t.numel()
    return tuple(out)


def _covisible(m: MapState, query_kf: int, covis_th: int) -> torch.Tensor:
    """[K] bool: valid keyframes sharing at least `covis_th` landmarks
    with `query_kf`, the query itself excluded."""
    slots = torch.arange(m.kf_cap, device=m.kf_valid.device)
    w = m.covisibility_with(m.points_seen_by(slots == query_kf))
    return m.kf_valid & (w >= covis_th) & (slots != query_kf)


def min_covisible_score(m: MapState, query_kf: int, covis_th: int = 15) -> float:
    """Min BoW similarity between the query keyframe and its covisible
    keyframes (0 when it has none): the gate of the BoW candidates. One
    host read."""
    covis = _covisible(m, query_kf, covis_th)
    s = l1_score(m.kf_bow[query_kf], m.kf_bow)
    mn = torch.min(torch.where(covis, s, torch.full_like(s, float("inf"))))
    _count_read()
    return float(torch.where(torch.isinf(mn), torch.zeros_like(mn), mn))


def max_covisible_haloc(m: MapState, query_kf: int, covis_th: int = 15) -> float:
    """Max haloc L1 distance between the query keyframe and its covisible
    keyframes, at least 1: the gate cluster-hash candidates must beat.
    One host read."""
    covis = _covisible(m, query_kf, covis_th)
    d = haloc.hash_distance(m.kf_hash[query_kf], m.kf_hash)
    mx = torch.max(torch.where(covis, d, torch.full_like(d, -float("inf"))))
    _count_read()
    return float(torch.where(torch.isinf(mx), torch.ones_like(mx), torch.clamp(mx, min=1.0)))


def _project(X, fx, fy, cx, cy):
    z = X[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([fx * X[:, 0] / zs + cx, fy * X[:, 1] / zs + cy], -1), z


def compute_loop_sim3(m: MapState, kf_a: int, kf_b: int, gen, fx, fy, cx, cy,
                      min_inliers: int = 20, min_total: int = 40, Rcb=None, tcb=None,
                      loop_group=None, idx_samples=None):
    """Match landmarks between two keyframes and solve the relative Sim3:
    open ratio-test matches behind the rotation-consistency gate ->
    Sim3 RANSAC (samples from `gen`, or `idx_samples`) -> paired
    reprojection refinement -> Sim3-guided window matching of all of b's
    landmark features, adopted only if it gains inliers -> scale sanity
    and the `min_inliers` gate -> total support against the landmarks of
    `loop_group` (kf_b's covisibility neighbourhood; {kf_b} when None)
    behind the `min_total` gate. The defaults are ORB-SLAM's 20/40.

    Two host reads (the inlier counts and scale; the total). Returns (ok,
    s, R, t, n_in, n_total) with (s, R, t) mapping kf_b-camera
    coordinates to kf_a-camera coordinates."""
    dev = m.pt_xyz.device
    F, P = m.n_feat, m.pt_cap
    da, va = m.kf_feat_desc[kf_a], m.kf_feat_valid[kf_a] & (m.kf_feat_pt[kf_a] >= 0)
    db, vb = m.kf_feat_desc[kf_b], m.kf_feat_valid[kf_b] & (m.kf_feat_pt[kf_b] >= 0)
    idx, _, ok = hamming.match_best(da, db, va, vb, max_dist=hamming.TH_HIGH, ratio=0.9)
    ok = hamming.rotation_consistency(m.kf_feat_angle[kf_a], m.kf_feat_angle[kf_b], idx, ok)

    pid_a = m.kf_feat_pt[kf_a]
    pid_b = m.kf_feat_pt[kf_b][idx.clamp(0, F - 1).long()]
    good = ok & (pid_a >= 0) & (pid_b >= 0)

    if Rcb is None:
        Rcb = torch.eye(3, dtype=torch.float32, device=dev)
    if tcb is None:
        tcb = torch.zeros(3, dtype=torch.float32, device=dev)
    Ra, ta = _ns_to_cam_pose_ext(_nav_row(m.kf_ns, kf_a), Rcb, tcb)
    Rb, tb = _ns_to_cam_pose_ext(_nav_row(m.kf_ns, kf_b), Rcb, tcb)
    Xa = mv(Ra, m.pt_xyz[pid_a.clamp(0, P - 1).long()]) + ta
    Xb = mv(Rb, m.pt_xyz[pid_b.clamp(0, P - 1).long()]) + tb

    s, R, t, inl, n_in = sim3_ransac(gen, Xb, Xa, good, fx, fy, cx, cy, idx=idx_samples)

    uv_b = m.kf_feat_xy[kf_b][idx.clamp(0, F - 1).long()]
    uv_a = m.kf_feat_xy[kf_a]
    s, R, t, inl, n_in = optimize_sim3(s, R, t, Xb, Xa, uv_b, uv_a, inl & good, fx, fy, cx, cy)

    # Sim3-guided extension: all of b's landmark features projected into
    # a's camera through the refined Sim3 and window-matched
    pid_b_all = m.kf_feat_pt[kf_b]
    Xb_all = mv(Rb, m.pt_xyz[pid_b_all.clamp(0, P - 1).long()]) + tb
    proj, z = _project(s * mv(R, Xb_all) + t, fx, fy, cx, cy)
    pair = hamming.window_mask(m.kf_feat_xy[kf_a], proj, 9.0) & (z > 0.1)[None, :]
    idx2, _, ok2 = hamming.match_best(da, db, va, vb & (pid_b_all >= 0), pair_mask=pair,
                                      max_dist=hamming.TH_HIGH, ratio=1.0)
    # RANSAC inliers keep their match; unmatched a-features adopt the
    # guided one
    use2 = ok2 & ~(inl & good)
    idx_u = torch.where(use2, idx2, idx)
    pid_b_u = m.kf_feat_pt[kf_b][idx_u.clamp(0, F - 1).long()]
    good_u = ((inl & good) | use2) & (pid_a >= 0) & (pid_b_u >= 0)
    Xb_u = mv(Rb, m.pt_xyz[pid_b_u.clamp(0, P - 1).long()]) + tb
    uv_b_u = m.kf_feat_xy[kf_b][idx_u.clamp(0, F - 1).long()]
    s2, R2, t2, inl2, n2 = optimize_sim3(s, R, t, Xb_u, Xa, uv_b_u, uv_a, good_u,
                                         fx, fy, cx, cy)
    # the extended solve is adopted only if it strictly gains support
    gain = n2 > n_in
    s, R, t = torch.where(gain, s2, s), torch.where(gain, R2, R), torch.where(gain, t2, t)
    n_in = torch.where(gain, n2, n_in)
    sup = torch.where(gain, inl2 & good_u, inl & good)
    _count_read()
    n_in_h, s_h = (float(v) for v in _host(n_in.to(torch.float64), s.to(torch.float64)))
    n_in_h = int(n_in_h)
    # a genuine metric-map loop has a scale near 1
    s_sane = bool(np.isfinite(s_h)) and 1.0 / 3.0 < s_h < 3.0
    if not (n_in_h >= min_inliers and s_sane):
        return False, s, R, t, n_in_h, 0

    # total support against the loop neighbourhood's landmarks: any world
    # point X maps into kf_a's corrected camera as s R (Rb X + tb) + t
    group = [int(kf_b)] if loop_group is None else [int(g) for g in loop_group]
    kf_mask = torch.zeros((m.kf_cap,), dtype=torch.bool)
    kf_mask[group] = True
    pt_mask = m.points_seen_by(kf_mask.to(dev)) & m.pt_valid
    proj_g, zg = _project(s * mv(R, mv(Rb, m.pt_xyz) + tb) + t, fx, fy, cx, cy)
    pair_g = (hamming.window_mask(m.kf_feat_xy[kf_a], proj_g, 10.0) & (zg > 0.1)[None, :]
              & pt_mask[None, :])
    _, _, ok_g = hamming.match_best(da, m.pt_desc, va, pt_mask, pair_mask=pair_g,
                                    max_dist=hamming.TH_LOW, ratio=1.0)
    _count_read()
    n_total = int(torch.sum(sup | ok_g))
    return n_total >= min_total, s, R, t, n_in_h, n_total


def _nav_row(ns, k: int):
    return tree_map(lambda a: a[k], ns)


COVIS_EDGE_W = 100    # covisibility-edge weight threshold
COVIS_EDGE_CAP = 128  # fixed capacity for covisibility edges


def close_loop(m: MapState, query_kf: int, loop_kf: int, s_rel, R_rel, t_rel,
               n_iters: int = 20, Rcb=None, tcb=None, Rbc=None, tbc=None,
               scan=None) -> MapState:
    """Apply a verified loop: essential-graph optimization + landmark
    correction. The pose-graph state is each keyframe's world->camera Sim3
    (scale 1). Edges: the kf_prev spanning chain, strong covisibility
    edges (weight >= COVIS_EDGE_W, the heaviest COVIS_EDGE_CAP, equal
    weights ranking the lower pair first), every retained loop edge with
    its stored measurement, and the new measured edge (i = loop, j =
    query, S_query = S_rel S_loop). The loop keyframe is the gauge.
    NavState velocities are re-expressed through each keyframe's
    correction. No host read. `scan` runs the pose graph's LM iterations
    (`optimize_essential_graph`'s)."""
    K = m.kf_cap
    dev = m.pt_xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    if Rcb is None:
        Rcb, tcb = torch.eye(3, **f32), torch.zeros(3, **f32)
        Rbc, tbc = torch.eye(3, **f32), torch.zeros(3, **f32)
    kf_R, kf_t = _ns_to_cam_pose_ext(m.kf_ns, Rcb, tcb)
    kf_s = torch.ones((K,), **f32)

    def rel_sim3(i, j):
        """Current relative Sim3 S_j S_i^-1 (scale 1)."""
        return lie.sim3_compose(kf_s[j], kf_R[j], kf_t[j],
                                *lie.sim3_inverse(kf_s[i], kf_R[i], kf_t[i]))

    # 1. spanning chain: edge (k, prev(k)) with the current relative pose
    slots = torch.arange(K, device=dev)
    e_j = m.kf_prev.clamp(0, K - 1).long()
    Sm = rel_sim3(slots, e_j)
    e_mask = m.kf_valid & (m.kf_prev >= 0) & m.kf_valid[e_j]

    # 2. strong covisibility edges not already linked by the chain
    W = m.covisibility_matrix()
    ii, jj = slots[:, None], slots[None, :]
    chain = (m.kf_prev[None, :] == ii) | (m.kf_prev[:, None] == jj)
    covis_ok = (jj > ii) & ~chain & (W >= COVIS_EDGE_W)
    topw, topidx = _top_k(torch.where(covis_ok, W, torch.zeros_like(W)).reshape(-1),
                          min(COVIS_EDGE_CAP, K * K))
    c_i, c_j = topidx // K, topidx % K
    Sc = rel_sim3(c_i, c_j)

    # 3. past loop edges with their stored measurements
    l_i = m.loop_i.clamp(0, K - 1).long()
    l_j = m.loop_j.clamp(0, K - 1).long()
    l_mask = (torch.arange(m.loop_i.shape[0], device=dev) < m.n_loop) & (m.loop_i >= 0)

    # 4. the new loop edge
    s_rel = torch.as_tensor(s_rel, **f32).reshape(1)
    e_i = torch.cat([slots, c_i, l_i, torch.full((1,), loop_kf, device=dev)])
    e_j = torch.cat([e_j, c_j, l_j, torch.full((1,), query_kf, device=dev)])
    m_s = torch.cat([Sm[0], Sc[0], m.loop_s, s_rel])
    m_R = torch.cat([Sm[1], Sc[1], m.loop_R, R_rel[None]])
    m_t = torch.cat([Sm[2], Sc[2], m.loop_t, t_rel[None]])
    e_mask = torch.cat([e_mask, topw > 0, l_mask, torch.ones(1, dtype=torch.bool, device=dev)])

    s2, R2, t2 = optimize_essential_graph(kf_s, kf_R, kf_t, m.kf_valid, slots == loop_kf,
                                          e_i, e_j, m_s, m_R, m_t, e_mask, n_iters=n_iters,
                                          scan=scan)
    pts2 = correct_points_after_pose_graph(m.pt_xyz, m.pt_ref_kf, kf_s, kf_R, kf_t,
                                           s2, R2, t2, m.pt_valid)

    # corrected camera poses back as NavStates (the scale folds into t);
    # velocity is a world-frame free vector: the linear part of the
    # per-keyframe world correction T_k = S_new^-1 S_old applies to it
    s_safe = torch.clamp(s2, min=1e-9)
    ns_new = _cam_pose_to_ns_ext(R2, t2 / s_safe[:, None], Rbc, tbc)
    L = (1.0 / s_safe)[:, None, None] * mm(R2.transpose(-1, -2), kf_R)
    kf_ns2 = dataclasses.replace(m.kf_ns, p=ns_new.p, R=ns_new.R, v=mv(L, m.kf_ns.v))
    m = dataclasses.replace(m, kf_ns=kf_ns2, pt_xyz=pts2)
    return m.add_loop_edge(loop_kf, query_kf, s_rel[0], R_rel, t_rel)


class LoopCloser:
    """Per-keyframe loop-closing orchestration with covisibility-
    consistency gating.

    A candidate group is the candidate keyframe plus its covisible
    keyframes; a candidate is accepted only after its group shares a
    member with a chain of groups from `consistency_th` consecutive
    detections. On acceptance: Sim3 verification, essential-graph
    correction, landmark re-expression, duplicate fusion and `post_ba`.
    `device` (the card unless the caller names another) is where the
    RANSAC generator and the extrinsics live: the device of the maps the
    closer is given.

    `last_reads` holds the device-to-host reads of the last pass and
    `host_reads` their sum over all passes; `last_timing` holds the last
    pass's milliseconds by part (each part ends in a host read or, on a
    CUDA device, a synchronize). `segments` (a `utils.graphs.Segments`:
    a stream's step's own, or by default one of the closer's own, graphed
    on a CUDA device) runs the loops of the essential graph and the
    default `post_ba` through its `scan`: captured graphs replayed per
    iteration on the card, the plain loops with graphs off."""

    def __init__(self, fx, fy, cx, cy, consistency_th: int = 3, covis_th: int = 15,
                 min_gap: int = 10, min_sim3_inliers: int = 20,
                 min_total_matches: int | None = None, seed: int = 11, device="cuda",
                 segments: Segments | None = None):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.consistency_th = consistency_th
        self.covis_th = covis_th
        self.min_gap = min_gap
        self.min_sim3_inliers = min_sim3_inliers
        # None -> 10% of the per-frame feature budget (40 at 400
        # features), floored at 15 for tiny configurations
        self.min_total_matches = min_total_matches
        self.device = step_device(device)
        self.segments = Segments(self.device, graphs=self.device.type == "cuda") \
            if segments is None else segments
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        f32 = dict(dtype=torch.float32, device=self.device)
        # body-camera extrinsics (identity unless the stream sets them)
        self.Rcb, self.tcb = torch.eye(3, **f32), torch.zeros(3, **f32)
        self.Rbc, self.tbc = torch.eye(3, **f32), torch.zeros(3, **f32)
        # (frozenset group, chain length) of the last detection
        self.consistent_groups: list[tuple[frozenset, int]] = []
        # last closure keyed by frame id, not slot: slots are recycled
        self.last_loop_frame: int = -(10 ** 9)
        self.n_closed = 0
        # cluster channel state: host tables, not map state
        self.cl_kf: list[int] = []           # owning keyframe slot per cluster id
        self.cl_hash: list[np.ndarray] = []  # per-cluster haloc hash
        self.cl_cent: list[np.ndarray] = []  # per-cluster world centroid
        self.kf_cluster_ids: dict[int, list[int]] = {}
        # accepted loop cluster pairs, excluded from later searches
        self.cluster_lc_found: list[tuple[int, int]] = []
        self.cluster_min_pts: int = 100
        self.host_reads = 0
        self.last_reads = 0
        self.last_timing: dict[str, float] = {}
        # polish after the correction; visual by default, the stream swaps
        # in the NavState form once VIO is initialized
        sigmas = torch.tensor([1.2 ** (2 * i) for i in range(8)], **f32)
        self.post_ba = lambda m: global_ba_visual(m, self.fx, self.fy, self.cx, self.cy, sigmas,
                                                  scan=self.segments.scan)

    def _covis_group(self, m: MapState, kf: int) -> frozenset:
        _count_read()
        grp = np.nonzero(_covisible(m, kf, self.covis_th).cpu().numpy())[0]
        return frozenset(grp.tolist()) | {kf}

    def _tick(self, m: MapState, name: str, t0: float) -> float:
        if m.pt_xyz.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.last_timing[name] = self.last_timing.get(name, 0.0) + (t1 - t0) * 1e3
        return t1

    # --- cluster channel --------------------------------------------------

    def _add_clusters(self, m: MapState, kf: int) -> list[int]:
        """Cluster the new keyframe's mapped keypoints and append the
        per-cluster hashes and centroids to the table. One host read.
        Returns the new cluster ids."""
        hashes, cents, cnt = keyframe_clusters(m, kf, min_pts=self.cluster_min_pts)
        _count_read()
        hashes, cents, cnt = (a.cpu().numpy() for a in _host(hashes, cents, cnt))
        ids = []
        for c in range(cnt.shape[0]):
            if cnt[c] <= 0:
                continue
            ids.append(len(self.cl_kf))
            self.cl_kf.append(kf)
            self.cl_hash.append(hashes[c])
            self.cl_cent.append(cents[c])
        self.kf_cluster_ids[kf] = ids
        return ids

    def _cluster_candidates(self, m: MapState, query_kf: int, covis_group: frozenset,
                            max_haloc: float, kf_valid: np.ndarray | None = None) -> list[int]:
        """Loop-candidate keyframes from the two cluster channels, on the
        host tables: cluster-hash matching (id window HALOC_ID_WINDOW, the
        best HALOC_BEST_N under the covisible-haloc gate) and centroid 2D
        proximity (id window PROX_ID_WINDOW, the best PROX_BEST_N). A
        matched cluster votes for its owning keyframe. Clusters of the
        covisible group, of invalid keyframes, and those paired with the
        query cluster by a past closure are no candidates. `kf_valid` is
        the host copy of `m.kf_valid` where the caller holds one."""
        if kf_valid is None:
            _count_read()
            kf_valid = m.kf_valid.cpu().numpy()
        q_ids = self.kf_cluster_ids.get(query_kf, [])
        n = len(self.cl_kf)
        if not q_ids or n == 0:
            return []
        owners = np.asarray(self.cl_kf)
        table_h = np.stack(self.cl_hash)
        table_c = np.stack(self.cl_cent)
        non = np.isin(owners, np.fromiter(covis_group | {query_kf}, int))
        non |= ~kf_valid[owners]
        lc: dict[int, set] = {}
        for a, b in self.cluster_lc_found:
            lc.setdefault(a, set()).add(b)
            lc.setdefault(b, set()).add(a)
        cand_kfs: list[int] = []
        all_ids = np.arange(n)
        for cid in q_ids:
            paired = np.zeros(n, bool)
            paired[list(lc.get(cid, ()))] = True
            excl = non | paired | (np.abs(all_ids - cid) < HALOC_ID_WINDOW)
            d = np.abs(table_h - self.cl_hash[cid][None]).sum(1)
            d = np.where(excl, np.inf, d)
            order = np.argsort(d)[:HALOC_BEST_N]
            cand_kfs += owners[order[d[order] < max_haloc]].tolist()

            excl_p = non | paired | (np.abs(all_ids - cid) < PROX_ID_WINDOW)
            dxy = np.linalg.norm((table_c - self.cl_cent[cid][None])[:, :2], axis=1)
            dxy = np.where(excl_p, np.inf, dxy)
            order = np.argsort(dxy)[:PROX_BEST_N]
            cand_kfs += owners[order[np.isfinite(dxy[order])]].tolist()
        return sorted(set(cand_kfs))

    def process_keyframe(self, m: MapState, query_kf: int):
        """Run detection for the new keyframe `query_kf`; if a candidate
        passes the consistency chain and the Sim3 verification, returns
        the corrected map. Returns (map, status dict)."""
        before = host_reads
        try:
            return self._process_keyframe(m, query_kf)
        finally:
            self.last_reads = host_reads - before
            self.host_reads += self.last_reads

    def _process_keyframe(self, m: MapState, query_kf: int):
        status = {"loop": False, "candidates": 0}
        self.last_timing = {}
        t = time.perf_counter()
        with record_function("loop.detect"):
            out = self._detect(m, query_kf, status)
        t = self._tick(m, "detect", t)
        if out is None:
            return m, status
        fq, accepted = out

        mt = (self.min_total_matches if self.min_total_matches is not None
              else max(15, round(0.1 * m.n_feat)))
        for c in accepted:
            with record_function("loop.sim3"):
                grp = sorted(self._covis_group(m, int(c)))
                ok, s, R, tr, n_in, n_total = compute_loop_sim3(
                    m, query_kf, c, self.gen, self.fx, self.fy, self.cx, self.cy,
                    min_inliers=self.min_sim3_inliers, min_total=mt,
                    Rcb=self.Rcb, tcb=self.tcb, loop_group=grp)
            t = self._tick(m, "sim3", t)
            if not ok:
                continue
            with record_function("loop.essential_graph"):
                m = close_loop(m, query_kf, c, s, R, tr, Rcb=self.Rcb, tcb=self.tcb,
                               Rbc=self.Rbc, tbc=self.tbc, scan=self.segments.scan)
            t = self._tick(m, "essential_graph", t)
            with record_function("loop.fuse"):
                m = fuse_duplicates(m)
            t = self._tick(m, "fuse", t)
            with record_function("loop.global_ba"):
                m = self.post_ba(m)
            t = self._tick(m, "global_ba", t)
            self.last_loop_frame = fq
            self.n_closed += 1
            self.consistent_groups = []
            # this closure's cluster pairs are excluded from later searches
            for qc in self.kf_cluster_ids.get(query_kf, []):
                for lc_ in self.kf_cluster_ids.get(int(c), []):
                    self.cluster_lc_found.append((qc, lc_))
            _count_read()
            status.update(loop=True, loop_kf=int(c), sim3_inliers=int(n_in),
                          total_matches=int(n_total), scale=float(s))
            break
        return m, status

    def _detect(self, m: MapState, query_kf: int, status: dict):
        """Candidates of the four channels and the consistency chain.
        Returns (query frame id, accepted candidates), or None when the
        pass ends without a candidate to verify."""
        # cluster hashes are stored for every processed keyframe, before
        # any early return
        self._add_clusters(m, query_kf)
        # all gap logic is keyed on frame ids and insertion counts
        _count_read()
        f_np, valid_np, gap_np = (a.cpu().numpy() for a in _host(
            m.kf_frame_id, m.kf_valid, kf_insertion_gap(m, query_kf)))
        valid_np = valid_np.astype(bool)
        fq = int(f_np[query_kf])
        kfs_since_loop = int(np.sum(valid_np & (f_np > self.last_loop_frame) & (f_np <= fq)))
        if kfs_since_loop < self.min_gap:
            return None

        ms = min_covisible_score(m, query_kf, self.covis_th)
        idx, _ = detect_loop_candidates(m, query_kf, min_gap=self.min_gap, min_score=ms)
        covis_group = self._covis_group(m, query_kf)
        max_h = max_covisible_haloc(m, query_kf, self.covis_th)
        cl = [c for c in self._cluster_candidates(m, query_kf, covis_group, max_h, valid_np)
              if gap_np[c] >= self.min_gap]
        if cl:
            idx = np.unique(np.concatenate([idx, np.asarray(cl, idx.dtype)]))
        status["candidates"] = len(idx)

        # covisibility-consistency chaining
        new_groups: list[tuple[frozenset, int]] = []
        accepted: list[int] = []
        for c in idx:
            grp = self._covis_group(m, int(c))
            chain = 0
            for prev_grp, prev_len in self.consistent_groups:
                if grp & prev_grp:
                    chain = max(chain, prev_len + 1)
            new_groups.append((grp, chain))
            if chain >= self.consistency_th:
                accepted.append(int(c))
        self.consistent_groups = new_groups
        return (fq, accepted) if accepted else None
