"""Bag-of-words vectors over a flat binary codebook.

Counterpart of `uvipslam_tpu/loop/vocab.py::bow_vector`: quantize
descriptors by one Hamming matmul against the codebook and build the
L1-normalized TF-IDF vector. Retrieval scoring (`l1_score`,
`detect_candidates`) belongs to the relocalization slice.
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
