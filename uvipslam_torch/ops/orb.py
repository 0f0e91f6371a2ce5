"""ORB feature extraction over a scale pyramid (unsteered BRIEF path).

Counterpart of `uvipslam_tpu/ops/orb.py` as the tracker calls it:
`extract_orb(..., steer=False, score_type=0)`, which is the only form
here. Per level: dense FAST
response pair, NMS, occupancy suppression, grid top-k, then one patch
pull per keypoint (the CUDA kernel on the card) for the intensity-
centroid angle and the unsteered BRIEF bits. The steered path
(`ic_angles`, `brief_descriptors`) and the Harris ranking are not ported
yet.

`BRIEF_PATTERN` is regenerated from the reference's seed with numpy, bit
for bit (tests/test_torch_nojax.py compares it).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from uvipslam_torch.ops import fast as fast_ops
from uvipslam_torch.ops.image import gaussian_blur, resize_bilinear
from uvipslam_torch.ops.klt import _sample_patch, extract_patches_any

N_BITS = 256
PATCH_R = 15


def _make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) Gaussian offsets clipped to the
    31x31 patch (same RandomState stream as the reference)."""
    rs = np.random.RandomState(seed)
    sigma = 31.0 / 5.0
    pts = rs.randn(N_BITS, 4) * sigma
    return np.clip(np.round(pts), -PATCH_R + 2, PATCH_R - 2).astype(np.int32)


BRIEF_PATTERN = _make_brief_pattern()


def _circle_mask_offsets():
    ys, xs = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = (ys * ys + xs * xs) <= PATCH_R * PATCH_R
    return ys, xs, mask


_OY, _OX, _OMASK = _circle_mask_offsets()


@dataclasses.dataclass
class Features:
    """SoA feature set for one frame (fixed capacity, mask-padded)."""

    xy: torch.Tensor      # [N, 2] f32 level-0 pixel coords (distorted)
    level: torch.Tensor   # [N] i32
    angle: torch.Tensor   # [N] f32
    score: torch.Tensor   # [N] f32
    desc: torch.Tensor    # [N, 256] i8 bits
    valid: torch.Tensor   # [N] bool

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


def level_quotas(n_features: int, n_levels: int, scale: float) -> list:
    """Geometric per-level quotas n*(1-f)/(1-f^L)*f^l, summing to n."""
    f = 1.0 / scale
    total = (1 - f ** n_levels) / (1 - f)
    qs = [int(round(n_features * (f ** l) / total)) for l in range(n_levels)]
    qs[0] += n_features - sum(qs)
    return qs


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list:
    """Level l resized by 1/scale^l (bilinear, antialiased like jax)."""
    H, W = img.shape
    pyr = [img]
    for l in range(1, n_levels):
        s = scale ** l
        pyr.append(resize_bilinear(img, (int(round(H / s)), int(round(W / s)))))
    return pyr


@functools.lru_cache(maxsize=8)
def _describe_consts(device):
    W = 2 * PATCH_R + 1
    ox = torch.as_tensor(_OX.reshape(-1).astype(np.float32), device=device)
    oy = torch.as_tensor(_OY.reshape(-1).astype(np.float32), device=device)
    msk = torch.as_tensor(_OMASK.reshape(-1).astype(np.float32), device=device)
    pat = BRIEF_PATTERN
    i1 = (pat[:, 1] + PATCH_R) * W + (pat[:, 0] + PATCH_R)
    i2 = (pat[:, 3] + PATCH_R) * W + (pat[:, 2] + PATCH_R)
    return (ox * msk, oy * msk, torch.as_tensor(i1, device=device).long(),
            torch.as_tensor(i2, device=device).long())


def orient_and_describe_fast(img_blur: torch.Tensor, xy: torch.Tensor,
                             valid: torch.Tensor):
    """IC orientation + unsteered BRIEF from one patch pull per keypoint
    and one separable sampling of the centered 31x31 window."""
    N = xy.shape[0]
    W = 2 * PATCH_R + 1
    patches, local = extract_patches_any(img_blur, xy, W + 4)
    win = _sample_patch(patches, local, W)
    flat = win.reshape(N, W * W)

    oxm, oym, i1, i2 = _describe_consts(img_blur.device)
    m10 = flat @ oxm
    m01 = flat @ oym
    ang = torch.where(valid, torch.atan2(m01, m10), torch.zeros_like(m01))

    v1 = flat[:, i1]
    v2 = flat[:, i2]
    desc = torch.where(valid[:, None], (v1 < v2).to(torch.int8),
                       torch.zeros((), dtype=torch.int8, device=xy.device))
    return ang, desc


def extract_orb(img: torch.Tensor, occupied_xy: torch.Tensor,
                occupied_mask: torch.Tensor, n_features: int = 400,
                n_levels: int = 8, scale: float = 1.2,
                fast_threshold: float = 20.0, fast_threshold_min: float = 5.0,
                cell: int = 20, px_distance: int = 20) -> Features:
    """ORB extraction for one frame: exactly `n_features` mask-padded
    slots. `occupied_xy`/`occupied_mask` are tracked positions whose
    neighborhoods are suppressed (a size-1 mask means none)."""
    min_side = min(img.shape[0], img.shape[1])
    while n_levels > 1 and min_side / scale ** (n_levels - 1) < 40:
        n_levels -= 1
    pyr = build_pyramid(img, n_levels, scale)
    quotas = level_quotas(n_features, n_levels, scale)

    parts = []
    for l, (im_l, quota) in enumerate(zip(pyr, quotas)):
        if quota <= 0:
            continue
        s = scale ** l
        hi, lo = fast_ops.fast_response2(im_l, fast_threshold, fast_threshold_min)
        resp = hi + float(np.float32(1e-4)) * lo
        resp = fast_ops.nms(resp)
        if occupied_mask.shape[0] > 1:
            occ_l = occupied_xy / float(np.float32(s))
            resp = fast_ops.occupancy_suppress(
                resp, occ_l, occupied_mask, max(2.0, px_distance / s))
        cell_l = max(8, int(round(cell / math.sqrt(s))))
        xy_l, score_l, valid_l = fast_ops.grid_topk(resp, cell_l, quota)

        blur_l = gaussian_blur(im_l, 7, 2.0)
        ang_l, desc_l = orient_and_describe_fast(blur_l, xy_l, valid_l)
        parts.append(Features(
            xy=xy_l * float(np.float32(s)),
            level=torch.full((quota,), l, dtype=torch.int32, device=img.device),
            angle=ang_l, score=score_l, desc=desc_l, valid=valid_l,
        ))

    return Features(*(torch.cat([getattr(p, f.name) for p in parts], dim=0)
                      for f in dataclasses.fields(Features)))
