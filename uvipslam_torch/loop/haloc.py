"""libhaloc-style global image hash as one matmul.

Counterpart of `uvipslam_tpu/loop/haloc.py`: H = R @ D with R the seeded
random unit projection rows (regenerated here from the reference's
RandomState seed, bit for bit) and D the masked 0/1 descriptor matrix;
loop candidates ranked by L1 hash distance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_PROJ = 3
HASH_DIM = N_PROJ * 256


@functools.lru_cache(maxsize=8)
def _projections(n_feat: int, n_proj: int = N_PROJ, seed: int = 42) -> np.ndarray:
    rs = np.random.RandomState(seed)
    R = rs.randn(n_proj, n_feat).astype(np.float32)
    R /= np.linalg.norm(R, axis=1, keepdims=True)
    return R


@functools.lru_cache(maxsize=8)
def _projections_on(n_feat: int, device) -> torch.Tensor:
    return torch.as_tensor(_projections(n_feat), device=device)


def compute_hash(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[N, 256] i8 descriptors (+mask) -> [n_proj * 256] f32 hash."""
    R = _projections_on(desc.shape[0], desc.device)
    D = desc.to(torch.float32) * valid.to(torch.float32)[:, None]
    return (R @ D).reshape(-1)


def hash_distance(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """L1 distance, batched over the leading dims of h2."""
    return torch.sum(torch.abs(h1 - h2), dim=-1)


def detect_candidates_haloc(query_hash, kf_hashes, kf_valid, exclude, top_k: int = 3,
                            rel_threshold: float = 0.8):
    """Best-k hash matches under the relative gate: candidates whose
    similarity 1/(1+d) reaches rel_threshold times the best one's. Equal
    distances rank the lower slot first. Returns (idx [k] i32, dist [k],
    ok [k])."""
    d = hash_distance(query_hash, kf_hashes)
    d = torch.where(kf_valid & ~exclude, d, torch.full_like(d, float("inf")))
    srt = torch.sort(d, stable=True)
    dist, idx = srt.values[:top_k], srt.indices[:top_k]
    sim = 1.0 / (1.0 + dist)
    ok = (sim >= rel_threshold * (1.0 / (1.0 + dist[0]))) & torch.isfinite(dist)
    return idx.to(torch.int32), dist, ok
