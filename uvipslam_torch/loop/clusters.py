"""Per-keyframe keypoint-cluster loop channel (DBSCAN + cluster haloc).

Counterpart of `uvipslam_tpu/loop/clusters.py`: a keyframe's mapped
keypoints are DBSCAN-clustered in pixel space (eps 50 px, min_pts 100;
one cluster of all mapped keypoints when at most one real cluster
forms), each of the `CLUSTERS_PER_KF` largest clusters gets a haloc hash
of its members' descriptors and the 3D centroid of their landmarks. The
cross-cluster matching runs on the table `LoopCloser` keeps on the host.
"""

from __future__ import annotations

import torch

from uvipslam_torch.loop.dbscan import dbscan_labels, label_counts
from uvipslam_torch.loop.haloc import _projections_on

CLUSTERS_PER_KF = 4
EPS_PX = 50.0
MIN_PTS = 100
HALOC_ID_WINDOW = 10   # temporal discard window of the cluster-hash channel, in cluster ids
PROX_ID_WINDOW = 12    # the same for the centroid-proximity channel
HALOC_BEST_N = 5
PROX_BEST_N = 3


def _clusters_from_features(xy, desc, pt_xyz, valid, n_clusters: int = CLUSTERS_PER_KF,
                            eps: float = EPS_PX, min_pts: int = MIN_PTS):
    """xy [F, 2], desc [F, 256] i8, pt_xyz [F, 3] (world position of each
    feature's landmark), valid [F] (mapped keypoints). Returns (hashes
    [C, HASH_DIM], centroids [C, 3], counts [C] i32)."""
    labels, _ = dbscan_labels(xy, valid, eps=eps, min_pts=min_pts)
    n_real = torch.sum(label_counts(labels) > 0)
    # at most one real cluster: one cluster of all mapped keypoints
    fallback = torch.where(valid, torch.zeros_like(labels), torch.full_like(labels, -1))
    labels = torch.where(n_real <= 1, fallback, labels)

    # the largest clusters, equal sizes ranking the lower label first
    srt = torch.sort(label_counts(labels), descending=True, stable=True)
    cnt, ids = srt.values[:n_clusters], srt.indices[:n_clusters]

    member = (labels[None, :] == ids[:, None]) & (cnt[:, None] > 0) & valid[None, :]
    R = _projections_on(desc.shape[0], desc.device)
    D = desc.to(torch.float32)[None] * member.to(torch.float32)[:, :, None]   # [C, F, 256]
    hashes = torch.matmul(R[None], D).reshape(n_clusters, -1)
    wsum = torch.clamp(torch.sum(member, dim=1), min=1)
    cents = torch.sum(torch.where(member[:, :, None], pt_xyz[None], torch.zeros_like(pt_xyz[None])),
                      dim=1) / wsum[:, None]
    return hashes, cents, cnt


def keyframe_clusters(m, kf_slot: int, min_pts: int = MIN_PTS):
    """Cluster keyframe `kf_slot`'s mapped keypoints. Returns (hashes
    [C, HASH_DIM], world centroids [C, 3], counts [C]); a count of 0 marks
    a padding cluster."""
    pid = m.kf_feat_pt[kf_slot]
    valid = m.kf_feat_valid[kf_slot] & (pid >= 0)
    pt_xyz = m.pt_xyz[pid.clamp(0, m.pt_cap - 1).long()]
    return _clusters_from_features(
        m.kf_feat_xy[kf_slot], m.kf_feat_desc[kf_slot],
        torch.where(valid[:, None], pt_xyz, torch.zeros_like(pt_xyz)), valid, min_pts=min_pts)
