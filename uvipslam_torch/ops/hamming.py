"""Batched Hamming-distance descriptor matching.

Counterpart of `uvipslam_tpu/ops/hamming.py`. 256-bit descriptors are
0/1 int8 vectors; mapped to +-1, the whole NA x NB distance matrix is one
matmul: dot(a_pm, b_pm) = 256 - 2 * hamming(a, b). The port computes it
in float32 (TF32 off): every partial sum of +-1 products is an integer
of magnitude <= 256, exact in float32, so the distances are exact.
"""

from __future__ import annotations

import torch

N_BITS = 256
TH_HIGH = 100
TH_LOW = 50


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[NA, 256] x [NB, 256] (0/1 int8) -> [NA, NB] Hamming distances (f32)."""
    a = desc_a.to(torch.float32) * 2 - 1
    b = desc_b.to(torch.float32) * 2 - 1
    return (N_BITS - a @ b.T) * 0.5


def match_best(desc_a, desc_b, valid_a, valid_b, pair_mask=None,
               max_dist: float = TH_LOW, ratio: float = 1.0):
    """Best-match search A -> B with optional candidate mask and the
    best/second-best ratio test. Returns (idx_b [NA] i32, dist [NA] f32,
    ok [NA] bool)."""
    D = hamming_matrix(desc_a, desc_b)
    big = torch.full((), 1e9, dtype=D.dtype, device=D.device)
    bad = ~(valid_a[:, None] & valid_b[None, :])
    if pair_mask is not None:
        bad = bad | ~pair_mask
    D = torch.where(bad, big, D)
    idx = torch.argmin(D, dim=1)
    best = torch.min(D, dim=1).values
    cols = torch.arange(D.shape[1], device=D.device)
    D2 = torch.where(cols[None, :] == idx[:, None], big, D)
    second = torch.min(D2, dim=1).values
    ok = valid_a & (best <= max_dist)
    if ratio < 1.0:
        ok = ok & (best <= ratio * second)
    return idx.to(torch.int32), best, ok


def window_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, radius) -> torch.Tensor:
    """[NA, NB] mask: b within `radius` px of a's predicted position;
    radius is scalar or per-A."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    if not isinstance(radius, torch.Tensor):
        return d2 <= float(radius) * float(radius)
    r2 = (radius * radius) if radius.dim() == 0 else (radius * radius)[:, None]
    return d2 <= r2
