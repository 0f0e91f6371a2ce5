"""Batched Hamming-distance descriptor matching.

Counterpart of `uvipslam_tpu/ops/hamming.py` (the matcher, its gates
and the search masks). 256-bit descriptors are 0/1 int8 vectors; mapped
to +-1, the whole NA x NB distance matrix is one matmul:
dot(a_pm, b_pm) = 256 - 2 * hamming(a, b). The port computes it in
float32 (TF32 off): every partial sum of +-1 products is an integer of
magnitude <= 256, exact in float32, so the distances are exact.
"""

from __future__ import annotations

import math

import torch

N_BITS = 256
TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30


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


def mutual_filter(idx_ab, ok_ab, idx_ba, ok_ba) -> torch.Tensor:
    """Keep only mutual best matches (cross-check)."""
    nb = idx_ba.shape[0]
    inb = (idx_ab >= 0) & (idx_ab < nb)
    j = idx_ab.clamp(0, nb - 1).long()
    back = torch.where(inb, idx_ba[j], torch.full_like(idx_ab, -1))
    return ok_ab & inb & ok_ba[j] & (back == torch.arange(idx_ab.shape[0], device=idx_ab.device))


def rotation_consistency(angle_a, angle_b, idx_ab, ok, n_keep_bins: int = 3,
                         min_top_fraction: float = 0.35) -> torch.Tensor:
    """Keep matches whose orientation difference falls in the dominant
    histogram bins: the top `n_keep_bins`, or the top 2*n_keep_bins when
    those hold less than `min_top_fraction` of the matches. Ties between
    bins rank the lower bin first (XLA's top_k)."""
    nb = angle_b.shape[0]
    rot = angle_a - angle_b[idx_ab.clamp(0, nb - 1).long()]
    two_pi = 2.0 * math.pi
    rot = torch.fmod(rot, two_pi)               # jnp.mod: the sign of the divisor
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1)
    hist = torch.zeros((HISTO_BINS,), dtype=torch.float32, device=rot.device).index_add(
        0, bins.long(), ok.to(torch.float32))
    n_wide = min(2 * n_keep_bins, HISTO_BINS)
    srt = torch.sort(hist, descending=True, stable=True)
    topv, top_bins = srt.values[:n_wide], srt.indices[:n_wide]
    hit = bins.long()[:, None] == top_bins[None, :]
    in_top = hit[:, :n_keep_bins].any(dim=1)
    in_wide = hit.any(dim=1)
    informative = torch.sum(topv[:n_keep_bins]) >= min_top_fraction * torch.clamp(
        torch.sum(hist), min=1.0)
    return ok & torch.where(informative, in_top, in_wide)


def window_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, radius) -> torch.Tensor:
    """[NA, NB] mask: b within `radius` px of a's predicted position;
    radius is scalar or per-A."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    if not isinstance(radius, torch.Tensor):
        return d2 <= float(radius) * float(radius)
    r2 = (radius * radius) if radius.dim() == 0 else (radius * radius)[:, None]
    return d2 <= r2


def level_mask(level_a: torch.Tensor, level_b: torch.Tensor, tol: int = 1) -> torch.Tensor:
    """[NA, NB] mask: pyramid levels within tolerance."""
    return torch.abs(level_a[:, None] - level_b[None, :]) <= tol


def bow_node_mask(words_a: torch.Tensor, words_b: torch.Tensor) -> torch.Tensor:
    """[NA, NB] mask: descriptors quantized to the same vocabulary word
    (with a flat codebook the BoW node is the word)."""
    return words_a[:, None] == words_b[None, :]


def epipolar_band_mask(F12: torch.Tensor, xy_1: torch.Tensor, xy_2: torch.Tensor,
                       band) -> torch.Tensor:
    """[N1, N2] mask: feature 2 within `band` px (scalar or per feature 2)
    of feature 1's epipolar line x2^T F12 x1 = 0, for lines whose normal
    is not degenerate."""
    x1h = torch.cat([xy_1, torch.ones_like(xy_1[..., :1])], dim=-1)
    l2 = x1h @ F12.T
    num = torch.abs(l2[:, None, 0] * xy_2[None, :, 0] + l2[:, None, 1] * xy_2[None, :, 1]
                    + l2[:, None, 2])
    den = torch.sqrt(torch.clamp(l2[:, 0] ** 2 + l2[:, 1] ** 2, min=1e-12))
    d = num / den[:, None]
    b = band[None, :] if isinstance(band, torch.Tensor) and band.dim() > 0 else band
    return (d <= b) & (den > 1e-6)[:, None]
