"""Bag-of-words vectors over a flat binary codebook.

Counterpart of `uvipslam_tpu/loop/vocab.py`: `bow_vector` quantizes
descriptors by one Hamming matmul against the codebook and builds the
L1-normalized TF-IDF vector; `l1_score` scores it against the stored
keyframe vectors. Loop-candidate retrieval (`detect_candidates`) belongs
to the loop-closing slice.
"""

from __future__ import annotations

import torch

from uvipslam_torch.ops.hamming import hamming_matrix


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, codebook: torch.Tensor,
               idf: torch.Tensor) -> torch.Tensor:
    """desc [N, 256] i8, codebook [W, 256] i8, idf [W] -> [W] f32, L1 norm 1."""
    D = hamming_matrix(desc, codebook)
    word = torch.argmin(D, dim=1)
    W = codebook.shape[0]
    v = torch.zeros((W,), dtype=torch.float32, device=desc.device).index_add_(
        0, word, valid.to(torch.float32))
    v = v * idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - |v1 - v2|_1 / 2 of L1-normalized vectors,
    batched over the leading dims of v2."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)
