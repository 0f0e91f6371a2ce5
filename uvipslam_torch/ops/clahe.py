"""CLAHE (contrast-limited adaptive histogram equalization).

Counterpart of `uvipslam_tpu/ops/clahe.py`, the reference's
cv::createCLAHE(clip=4, tiles=12x12) enhancement of every frame when
`enhance` is set: per-tile 256-bin histograms, OpenCV's clip and integer
redistribution, per-tile CDF lookup tables, and bilinear interpolation
between the four neighbouring tiles' tables. Fixed-shape tensor ops, no
host reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clahe(img: torch.Tensor, clip_limit: float = 4.0, tiles: tuple = (12, 12)) -> torch.Tensor:
    """CLAHE of an [H, W] float image with values in [0, 255]. Sizes that
    do not divide the tile grid are padded by reflect-101 to a divisible
    size, as OpenCV extends the image."""
    H, W = img.shape
    ty, tx = tiles
    th = -(-H // ty)
    tw = -(-W // tx)
    Hp, Wp = th * ty, tw * tx
    dev, dtype = img.device, img.dtype
    imgp = F.pad(img[None, None], (0, Wp - W, 0, Hp - H), mode="reflect")[0, 0]

    iv = torch.clamp(imgp, 0, 255).to(torch.int64)
    T = ty * tx
    tile_of = (torch.arange(Hp, device=dev) // th)[:, None] * tx + \
        (torch.arange(Wp, device=dev) // tw)[None, :]
    # integer counts by one scatter-add (exact in any order)
    bins = (tile_of * 256 + iv).reshape(-1)
    hist = torch.zeros((T * 256,), dtype=torch.int64, device=dev).scatter_add(
        0, bins, torch.ones_like(bins)).reshape(T, 256)

    # OpenCV: limit max(int(clip*area/256), 1); the excess goes evenly to
    # every bin, the residual one count at a time on bins 0, s, 2s, ...
    area = th * tw
    limit = max(int(clip_limit * area / 256.0), 1)
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    batch = excess // 256
    residual = excess - batch * 256
    idx = torch.arange(256, device=dev)[None, :]
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    bump = ((idx % step) == 0) & ((idx // step) < residual)
    redist = clipped + batch + bump.to(hist.dtype)

    cdf = torch.cumsum(redist, dim=1).to(dtype)
    lut = torch.clamp(torch.round(cdf * (255.0 / area)), 0, 255).reshape(-1)   # [T*256]

    # tile coordinates as OpenCV: f = x / tile - 0.5, the weight taken
    # before the indices are clamped
    fy = torch.arange(Hp, device=dev, dtype=dtype) / th - 0.5
    fx = torch.arange(Wp, device=dev, dtype=dtype) / tw - 0.5
    y0f = torch.floor(fy)
    x0f = torch.floor(fx)
    wy = (fy - y0f)[:, None]
    wx = (fx - x0f)[None, :]
    y0 = torch.clamp(y0f, 0, ty - 1).long()
    x0 = torch.clamp(x0f, 0, tx - 1).long()
    y1 = torch.clamp(y0f + 1, 0, ty - 1).long()
    x1 = torch.clamp(x0f + 1, 0, tx - 1).long()

    def lut_at(tyi, txi):
        return lut[((tyi[:, None] * tx + txi[None, :]) * 256 + iv).reshape(-1)].reshape(Hp, Wp)

    out = (lut_at(y0, x0) * (1 - wy) * (1 - wx)
           + lut_at(y0, x1) * (1 - wy) * wx
           + lut_at(y1, x0) * wy * (1 - wx)
           + lut_at(y1, x1) * wy * wx)
    # contiguous: the patch kernel reads the image row-major
    return out[:H, :W].to(dtype).contiguous()
