"""Bag-of-words vectors over a flat binary codebook.

Counterpart of `uvipslam_tpu/loop/vocab.py`: `bow_vector` quantizes
descriptors by one Hamming matmul against the codebook and builds the
L1-normalized TF-IDF vector; `l1_score` scores it against the stored
keyframe vectors; `detect_candidates` ranks them for loop retrieval.
`train_codebook` is the offline binary k-means that made the shipped
codebook (`vocab_data.npz`), on the host in numpy as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from uvipslam_torch.ops.hamming import hamming_matrix


def train_codebook(descs: np.ndarray, n_words: int = 1024, n_iters: int = 8,
                   seed: int = 0) -> np.ndarray:
    """Binary k-means: [M, 256] 0/1 -> [W, 256] 0/1 int8. Majority-vote
    centroids; an empty cluster is re-seeded with a random descriptor.
    Draws from `np.random.RandomState(seed)` in the reference's order, so
    the same descriptors give the same codebook bit for bit."""
    rs = np.random.RandomState(seed)
    M = descs.shape[0]
    centers = descs[rs.choice(M, n_words, replace=M < n_words)].astype(np.float32)
    d = descs.astype(np.float32)
    for _ in range(n_iters):
        # Hamming distances through the +-1 dot product
        D = (256 - (2 * d - 1) @ (2 * centers - 1).T) / 2
        assign = D.argmin(1)
        for w in range(n_words):
            sel = assign == w
            if sel.sum() == 0:
                centers[w] = d[rs.randint(M)]
            else:
                centers[w] = (d[sel].mean(0) > 0.5).astype(np.float32)
    return centers.astype(np.int8)


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
