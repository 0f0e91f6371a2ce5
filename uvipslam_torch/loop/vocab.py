"""Bag-of-words vectors over a flat binary codebook.

Counterpart of `uvipslam_tpu/loop/vocab.py`: `bow_vector` quantizes
descriptors by one Hamming matmul against the codebook and builds the
L1-normalized TF-IDF vector; `l1_score` scores it against the stored
keyframe vectors; `detect_candidates` ranks them for loop retrieval.
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
    v = torch.zeros((W,), dtype=torch.float32, device=desc.device).index_add(
        0, word, valid.to(torch.float32))
    v = v * idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - |v1 - v2|_1 / 2 of L1-normalized vectors,
    batched over the leading dims of v2."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def bow_words(desc: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Word id per descriptor (the direct index of a BoW-constrained
    match)."""
    return torch.argmin(hamming_matrix(desc, codebook), dim=1).to(torch.int32)


def detect_candidates(query_bow, kf_bows, kf_valid, exclude, min_score, top_k: int = 8):
    """Loop-candidate retrieval: score every stored keyframe, gate by the
    covisible min-score and return the top candidates; equal scores rank
    the lower slot first. Returns (idx [top_k] i32, score [top_k],
    ok [top_k])."""
    s = l1_score(query_bow, kf_bows)
    s = torch.where(kf_valid & ~exclude, s, torch.full_like(s, -1.0))
    srt = torch.sort(s, descending=True, stable=True)
    val, idx = srt.values[:top_k], srt.indices[:top_k]
    ok = val >= torch.clamp(torch.as_tensor(min_score, dtype=val.dtype, device=val.device),
                            min=0.0)
    return idx.to(torch.int32), val, ok
