"""ORB feature extraction over a scale pyramid.

Counterpart of `uvipslam_tpu/ops/orb.py`. Per level: dense FAST response
pair (re-ranked by Harris with `score_type=1`), NMS, occupancy
suppression, grid top-k, then the angle and the BRIEF bits on the
blurred level image, by one of two paths:

- `steer=True` (the default, as in the reference): the intensity-
  centroid angle from integer-truncated centres (`ic_angles`) and the
  pattern rotated by it (`brief_descriptors`), both plain gathers;
- `steer=False` (what the trackers run, through
  `frontend.frame.refill_tracks`): one patch pull per keypoint (the CUDA
  kernel on the card) and one sub-pixel sampling of the 31x31 window for
  the angle and the unsteered bits (`orient_and_describe_fast`).

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


@functools.lru_cache(maxsize=8)
def _moment_consts(device):
    """Circle offsets and mask of the IC angle, flattened [961]."""
    return tuple(torch.as_tensor(a.reshape(-1), device=device)
                 for a in (_OX.astype(np.int64), _OY.astype(np.int64),
                           _OMASK.astype(np.float32)))


def ic_angles(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint over the radius-15 disk
    around its integer-truncated centre (the reference's `astype(int32)`,
    toward zero), pixels clipped to the image; 0 where not valid.

    The moments are summed in float64 and rounded once to float32. Each
    product of a float32 pixel and an offset of at most 15 is exact in
    float64 and the sum of 961 of them is within float64 rounding of the
    exact one in any order, so the moments are the same on every device.
    A float32 sum rounds by the order it runs in, and a keypoint with a
    weak centroid turns that into tens of microradians of angle: the
    reference's eager and jitted forms differ by that much."""
    H, W = img.shape
    ox, oy, m = _moment_consts(img.device)
    x = xy[:, 0].to(torch.int32).long()
    y = xy[:, 1].to(torch.int32).long()
    yy = (y[:, None] + oy[None]).clamp(0, H - 1)
    xx = (x[:, None] + ox[None]).clamp(0, W - 1)
    patch = (img[yy, xx] * m).to(torch.float64)
    m10 = torch.sum(ox.to(torch.float64) * patch, dim=1).to(img.dtype)
    m01 = torch.sum(oy.to(torch.float64) * patch, dim=1).to(img.dtype)
    return torch.where(valid, torch.atan2(m01, m10), torch.zeros_like(m01))


@functools.lru_cache(maxsize=8)
def _pattern(device):
    return torch.as_tensor(BRIEF_PATTERN.astype(np.float32), device=device)


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 bits [N, 256] i8: each pattern pair rotated by
    the keypoint's angle, rounded half to even (as `jnp.round`), clipped
    to the image and compared; 0 where not valid."""
    H, W = img_blur.shape
    pat = _pattern(img_blur.device)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]

    def sample(px, py):
        # (px, py) @ [[ca, -sa], [sa, ca]]^T, one product per term
        qx = px[None] * ca + py[None] * -sa
        qy = px[None] * sa + py[None] * ca
        xi = torch.round(xy[:, 0:1] + qx).to(torch.int32).long().clamp(0, W - 1)
        yi = torch.round(xy[:, 1:2] + qy).to(torch.int32).long().clamp(0, H - 1)
        return img_blur[yi, xi]

    desc = (sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])).to(torch.int8)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def extract_orb(img: torch.Tensor, occupied_xy: torch.Tensor,
                occupied_mask: torch.Tensor, n_features: int = 400,
                n_levels: int = 8, scale: float = 1.2,
                fast_threshold: float = 20.0, fast_threshold_min: float = 5.0,
                cell: int = 20, px_distance: int = 20, steer: bool = True,
                score_type: int = 0) -> Features:
    """ORB extraction for one frame: exactly `n_features` mask-padded
    slots. `occupied_xy`/`occupied_mask` are tracked positions whose
    neighborhoods are suppressed (a size-1 mask means none).

    `steer=False` takes the unsteered path (the angle is still reported);
    `score_type=1` ranks the FAST corners by their Harris response
    instead of the FAST score."""
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
        if score_type == 1:
            # the FAST candidates, ordered by Harris; a candidate whose
            # Harris response is not positive keeps 1e-6
            har = fast_ops.harris_response(im_l)
            resp = torch.where(resp > 0, torch.clamp(har, min=float(np.float32(1e-6))),
                               torch.zeros_like(resp))
        resp = fast_ops.nms(resp)
        if occupied_mask.shape[0] > 1:
            occ_l = occupied_xy / float(np.float32(s))
            resp = fast_ops.occupancy_suppress(
                resp, occ_l, occupied_mask, max(2.0, px_distance / s))
        cell_l = max(8, int(round(cell / math.sqrt(s))))
        xy_l, score_l, valid_l = fast_ops.grid_topk(resp, cell_l, quota)

        blur_l = gaussian_blur(im_l, 7, 2.0)
        if steer:
            ang_l = ic_angles(blur_l, xy_l, valid_l)
            desc_l = brief_descriptors(blur_l, xy_l, ang_l, valid_l)
        else:
            ang_l, desc_l = orient_and_describe_fast(blur_l, xy_l, valid_l)
        parts.append(Features(
            xy=xy_l * float(np.float32(s)),
            level=torch.full((quota,), l, dtype=torch.int32, device=img.device),
            angle=ang_l, score=score_l, desc=desc_l, valid=valid_l,
        ))

    return Features(*(torch.cat([getattr(p, f.name) for p in parts], dim=0)
                      for f in dataclasses.fields(Features)))
