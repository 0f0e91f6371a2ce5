"""libhaloc-style global image hash as one matmul.

Counterpart of `uvipslam_tpu/loop/haloc.py::compute_hash`: H = R @ D with
R the seeded random unit projection rows (regenerated here from the
reference's RandomState seed, bit for bit) and D the masked 0/1
descriptor matrix. Candidate ranking belongs to the loop-closing slice.
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
