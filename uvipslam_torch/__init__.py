"""uvipslam_torch — the PyTorch + CUDA (Hopper) port of uvipslam_tpu.

The JAX package `uvipslam_tpu` stays the reference; every module here has
its counterpart at the same path there and is tested against it on
identical float32 inputs (tests/test_torch_*.py).

Plain tensor code is PyTorch run eagerly. The one TPU kernel of the
reference (`uvipslam_tpu/ops/klt.py::_extract_patches_pallas`) becomes two
hand-written CUDA kernels here, bound by `kernels.py`: the patch pull
(`csrc/extract_patches.cu`) and the pull fused with the anchor
refinement's Gauss-Newton loop (`csrc/anchor_refine.cu`). On CPU tensors
their plain torch versions run instead. The step entry points run on the
card unless the caller passes `device="cpu"`.

Subpackages mirror the reference: core, models, ops, solver, mapstate,
loop, frontend. This package never imports jax and reads no file of the
reference package.
"""

import torch

# The reference runs its geometry at Precision.HIGHEST (core/lie.py::mm);
# TF32 keeps ~3 decimal digits and corrupts rotations by degrees, so the
# port turns it off for both matmuls and cuDNN convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
