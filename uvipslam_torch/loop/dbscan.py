"""DBSCAN keypoint clustering as fixed-iteration label propagation.

Counterpart of `uvipslam_tpu/loop/dbscan.py`: a dense [N, N] adjacency,
core points by degree, connected components of the core-core graph by
`n_iters` rounds of min-label propagation, border points adopting the
smallest adjacent core label. Fixed shapes, no host read.
"""

from __future__ import annotations

import torch


def dbscan_labels(xy: torch.Tensor, valid: torch.Tensor, eps: float = 50.0,
                  min_pts: int = 20, n_iters: int = 12):
    """xy [N, 2] keypoints, valid [N]. Returns (labels [N] i32, is_core
    [N] bool); a cluster's id is the smallest point index in it, -1 marks
    noise and invalid points."""
    N = xy.shape[0]
    dev = xy.device
    d2 = torch.sum((xy[:, None, :] - xy[None, :, :]) ** 2, dim=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    core = valid & (torch.sum(adj, dim=1) >= min_pts)

    idx = torch.arange(N, dtype=torch.int32, device=dev)
    INF = torch.full((), N + 1, dtype=torch.int32, device=dev)
    labels = torch.where(core, idx, INF)
    core_adj = adj & core[:, None] & core[None, :]
    for _ in range(n_iters):
        best = torch.min(torch.where(core_adj, labels[None, :], INF), dim=1).values
        labels = torch.where(core, torch.minimum(labels, best), labels)

    # border points: adopt any adjacent core label
    border_lab = torch.min(torch.where(adj & core[None, :], labels[None, :], INF), dim=1).values
    out = torch.where(core, labels, torch.where(valid & (border_lab < INF), border_lab, INF))
    return torch.where(out >= INF, torch.full_like(out, -1), out), core


def label_counts(labels: torch.Tensor) -> torch.Tensor:
    """[N] i32 member count per label value (labels are point indices in
    [0, N); -1 counts nowhere). An integer scatter-add, exact in any
    order."""
    N = labels.shape[0]
    lab = torch.where(labels >= 0, labels, torch.full_like(labels, N)).long()
    return torch.zeros((N + 1,), dtype=torch.int32, device=labels.device).index_add_(
        0, lab, torch.ones_like(labels, dtype=torch.int32))[:N]


def cluster_centroids(xyz: torch.Tensor, labels: torch.Tensor, n_clusters_cap: int = 16):
    """Per-cluster 3D centroids of the `n_clusters_cap` largest clusters
    (equal sizes rank the lower label first), mask-padded. Returns (ids
    [C] i32, centroids [C, 3], counts [C]). The sums are masked
    reductions, not a float scatter-add, so they repeat bit for bit."""
    srt = torch.sort(label_counts(labels), descending=True, stable=True)
    cnt, ids = srt.values[:n_clusters_cap], srt.indices[:n_clusters_cap]
    member = (labels[None, :] == ids[:, None]) & (labels >= 0)[None, :]
    sums = torch.sum(torch.where(member[:, :, None], xyz[None], torch.zeros_like(xyz[None])), dim=1)
    cents = sums / torch.clamp(cnt[:, None], min=1)
    return ids.to(torch.int32), cents, cnt
