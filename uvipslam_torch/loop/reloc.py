"""Relocalization: BoW retrieval, descriptor matching and PnP.

Counterpart of `uvipslam_tpu/loop/reloc.py`:

- the vocabulary constants (the trained binary codebook and its idf
  weights, read with numpy from this package's own `loop/vocab_data.npz`,
  a byte-equal copy of the reference's) that `MapState` stores
  per-keyframe BoW vectors with;
- `first_try_associations`, the cheap first tier after a failed VI solve:
  a projection search of the last keyframe's landmarks at the
  IMU-predicted pose, narrow then wide;
- `relocalize_frame`: L1 BoW scores against every stored keyframe, the
  top three candidates matched (mutual, rotation-consistent), PnP RANSAC
  and a motion-only refine on each, the candidate with most inliers wins.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from uvipslam_torch.loop.vocab import bow_vector, l1_score
from uvipslam_torch.ops import hamming
from uvipslam_torch.ops.pnp import pnp_ransac
from uvipslam_torch.solver.pose_opt import pose_optimization_se3

_VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vocab_data.npz")


def _load_vocab():
    with np.load(_VOCAB_PATH) as z:
        return z["codebook"].astype(np.int8), z["idf"].astype(np.float32)


CODEBOOK, IDF = _load_vocab()
N_WORDS = CODEBOOK.shape[0]
N_CANDIDATES = 3
PNP_ITERS = 256


@functools.lru_cache(maxsize=8)
def codebook(device) -> torch.Tensor:
    return torch.as_tensor(CODEBOOK, device=device)


@functools.lru_cache(maxsize=8)
def idf(device) -> torch.Tensor:
    return torch.as_tensor(IDF, device=device)


def _project(Rcw, tcw, X, fx, fy, cx, cy):
    Xc = torch.einsum("ij,nj->ni", Rcw, X) + tcw
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy], -1), z


def first_try_associations(tracks, m, kf_slot, Rcw, tcw, fx, fy, cx, cy,
                           radius: float = 15.0, radius_wide: float = 40.0,
                           min_matches: int = 30):
    """Projection re-association of keyframe `kf_slot`'s landmarks into
    the current tracks at pose (Rcw, tcw); the wide window's result is
    taken when the narrow one finds fewer than `min_matches`. Returns
    (pt_id [N] with -1 where unmatched, n_matches)."""
    kf = kf_slot.reshape(1).long()
    F = m.kf_feat_pt.shape[1]
    pid = m.kf_feat_pt.index_select(0, kf)[0]
    pid_c = pid.clamp(0, m.pt_cap - 1).long()
    okf = m.kf_feat_valid.index_select(0, kf)[0] & (pid >= 0) & m.pt_valid[pid_c]
    proj, z = _project(Rcw, tcw, m.pt_xyz[pid_c], fx, fy, cx, cy)
    good_z = (z > 0.05)[None, :] & okf[None, :]
    kf_desc = m.kf_feat_desc.index_select(0, kf)[0]
    kf_angle = m.kf_feat_angle.index_select(0, kf)[0]

    def match_at(r):
        pair = hamming.window_mask(tracks.xy_und, proj, r) & good_z
        idx, _, ok = hamming.match_best(tracks.desc, kf_desc, tracks.valid, okf, pair_mask=pair,
                                        max_dist=hamming.TH_HIGH, ratio=0.9)
        ok = hamming.rotation_consistency(tracks.angle, kf_angle, idx, ok)
        new_pid = torch.where(ok, pid[idx.clamp(0, F - 1).long()], torch.full_like(idx, -1))
        return new_pid.to(torch.int32), torch.sum(ok).to(torch.int32)

    pid1, n1 = match_at(radius)
    pid2, n2 = match_at(radius_wide)
    narrow_ok = n1 >= min_matches
    return torch.where(narrow_ok, pid1, pid2), torch.where(narrow_ok, n1, n2)


def candidate_matches(tracks, m, kf):
    """Matches of the frame's descriptors to keyframe `kf`'s landmarks
    (best match both ways, mutual, rotation-consistent). Returns (pt_id
    [N] with -1 where unmatched, landmark positions [N, 3], PnP candidate
    mask [N])."""
    kf = kf.reshape(1)
    kf_desc = m.kf_feat_desc.index_select(0, kf)[0]
    kf_pt = m.kf_feat_pt.index_select(0, kf)[0]
    kf_ok = m.kf_feat_valid.index_select(0, kf)[0] & (kf_pt >= 0)
    idx_ab, _, ok = hamming.match_best(tracks.desc, kf_desc, tracks.valid, kf_ok,
                                       max_dist=hamming.TH_HIGH, ratio=0.9)
    # mutual cross-check and the rotation-consistency gate: match
    # precision is what makes or breaks the PnP RANSAC
    idx_ba, _, ok_b = hamming.match_best(kf_desc, tracks.desc, kf_ok, tracks.valid,
                                         max_dist=hamming.TH_HIGH, ratio=0.9)
    ok = hamming.mutual_filter(idx_ab, ok, idx_ba, ok_b)
    ok = hamming.rotation_consistency(tracks.angle, m.kf_feat_angle.index_select(0, kf)[0],
                                      idx_ab, ok)
    pid = torch.where(ok, kf_pt[idx_ab.clamp(0, kf_pt.shape[0] - 1).long()],
                      torch.full_like(idx_ab, -1))
    pid_c = pid.clamp(0, m.pt_cap - 1).long()
    return pid, m.pt_xyz[pid_c], ok & (pid >= 0) & m.pt_valid[pid_c]


def _try_candidate(tracks, m, kf, gen, idx, fx, fy, cx, cy):
    pid, pw, cand = candidate_matches(tracks, m, kf)
    # independent re-detections jitter by ~2-3 px against the keyframe's
    # stored features: gate at sigma ~ 2 px
    R0, t0, _, _ = pnp_ransac(gen, pw, tracks.xy_und, cand, fx, fy, cx, cy,
                              n_iters=PNP_ITERS, max_err2=24.0, idx=idx)
    R1, t1, inl1, n1 = pose_optimization_se3(
        R0, t0, pw, tracks.xy_und, cand, torch.full((pw.shape[0],), 0.25, dtype=pw.dtype,
                                                    device=pw.device),
        fx, fy, cx, cy, rounds=3, iters=8)
    return R1, t1, torch.where(inl1, pid, torch.full_like(pid, -1)).to(torch.int32), n1


def relocalize_frame(tracks, m, gen: torch.Generator, fx, fy, cx, cy,
                     idx: torch.Tensor | None = None):
    """Returns (Rcw, tcw, pt_id [N], n_inliers, top_kfs [3]); pt_id holds
    the landmark of each inlier match, -1 elsewhere. `idx` [3, PNP_ITERS,
    6] injects the candidates' PnP minimal samples."""
    dev = tracks.desc.device
    v_frame = bow_vector(tracks.desc, tracks.valid, codebook(dev), idf(dev))
    scores = l1_score(v_frame, m.kf_bow)
    scores = torch.where(m.kf_valid, scores, torch.full_like(scores, -1.0))
    # XLA's top_k order: ties rank the lower slot first
    top_kfs = torch.sort(scores, descending=True, stable=True).indices[:N_CANDIDATES]
    outs = [_try_candidate(tracks, m, top_kfs[c], gen, None if idx is None else idx[c],
                           fx, fy, cx, cy) for c in range(N_CANDIDATES)]
    Rs, ts, pids, ns = (torch.stack(v) for v in zip(*outs))
    b = torch.argmax(ns).reshape(1)
    return (Rs.index_select(0, b)[0], ts.index_select(0, b)[0], pids.index_select(0, b)[0],
            ns.index_select(0, b)[0], top_kfs)
