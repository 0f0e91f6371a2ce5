"""The port's CUDA kernels against their plain torch versions on the card.

Needs an NVIDIA GPU and nvcc; skipped without a CUDA device. This file
imports no jax, so it also runs on a machine without the reference's
dependencies (tests/conftest.py imports jax, hence `--noconftest`):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from uvipslam_torch.ops import klt

H, W = 512, 640


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _points(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 2), generator=g) * torch.tensor([float(W), float(H)])
    pts[:8] = torch.tensor([[0.0, 0.0], [W - 1e-3, H - 1e-3], [-9.0, 4.0], [W + 3.0, 7.0],
                            [float("nan"), 1.0], [float("inf"), 2.0], [3.0, float("-inf")],
                            [5.0, -1e12]])
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("psize", [19, 25, 27, 35])
def test_extract_patches_kernel_matches_plain(cuda_device, psize):
    img = torch.rand((H, W), generator=torch.Generator().manual_seed(1)) * 255.0
    pts = _points()
    plain, local_plain = klt._extract_patches(img, pts, psize)
    before = klt.launches
    kern, local_kern = klt.extract_patches_any(img.to(cuda_device), pts.to(cuda_device), psize)
    torch.cuda.synchronize()
    assert klt.launches == before + 1
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.nan_to_num(local_kern.cpu()), torch.nan_to_num(local_plain))


@pytest.mark.cuda
def test_extract_patches_kernel_rejects_cpu_tensors(cuda_device):
    with pytest.raises(ValueError):
        klt.extract_patches_cuda(torch.zeros((40, 50)), torch.zeros((3, 2)), 19)
