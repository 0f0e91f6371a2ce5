"""The benchmark's own tests: on the CPU at small sizes, and on the card
(marked `cuda`) at the cells' sizes.

    python -m pytest benchmark/tests -q -p no:cacheprovider

The card's tests skip without a CUDA device; whether there is one is
decided inside the `card` fixture, never at import."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
