"""Relocalization vocabulary constants.

Counterpart of the module-level constants of `uvipslam_tpu/loop/reloc.py`:
the trained binary codebook and its idf weights, read from the reference
package's `loop/vocab_data.npz` by path with numpy (the same file), so
that `MapState` can store per-keyframe BoW vectors.
`relocalize_frame` and `first_try_associations` (BoW retrieval, PnP
RANSAC) belong to the next slice.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

# the reference package sits beside this one; its artifact is read as a
# file, without importing that package
_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "uvipslam_tpu", "loop", "vocab_data.npz")


def _load_vocab():
    with np.load(_VOCAB_PATH) as z:
        return z["codebook"].astype(np.int8), z["idf"].astype(np.float32)


CODEBOOK, IDF = _load_vocab()
N_WORDS = CODEBOOK.shape[0]


@functools.lru_cache(maxsize=8)
def codebook(device) -> torch.Tensor:
    return torch.as_tensor(CODEBOOK, device=device)


@functools.lru_cache(maxsize=8)
def idf(device) -> torch.Tensor:
    return torch.as_tensor(IDF, device=device)
