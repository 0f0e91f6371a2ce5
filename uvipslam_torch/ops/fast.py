"""FAST-9/16 corner detection as dense, branch-free tensor ops.

Counterpart of `uvipslam_tpu/ops/fast.py`: 16 statically shifted views,
a packed-bit contiguous-arc test, 3x3 max-pool NMS, occupancy
suppression by dilation and grid-cell winner selection. The
`score_type=1` Harris path (`harris_response`) is not ported yet.

Ties: JAX's argmax and `lax.top_k` keep the lowest index among equal
values; the port uses `torch.argmax` (first maximum) and a stable
descending sort for the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CIRCLE16 = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shifted_views(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W]: the circle-16 neighbor intensity of each pixel, with
    edge-replicated borders."""
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    views = [p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for (dx, dy) in CIRCLE16]
    return torch.stack(views, dim=0)


def _arc9_mask(bits: torch.Tensor) -> torch.Tensor:
    """True where the 16 packed circle flags hold a circular run of >= 9
    set bits (doubling the ring, log-step shift-ANDs). int64 holds every
    intermediate without overflow; the low 16 bits equal the reference's
    int32 result."""
    m = bits | (bits << 16)
    r2 = m & (m >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (m >> 8)
    return (r9 & 0xFFFF) != 0


def _fast_score_from_diff(diff, interior, threshold: float):
    t = float(threshold)
    bright = diff > t
    dark = diff < -t
    weights = (1 << torch.arange(16, device=diff.device, dtype=torch.int64))[:, None, None]
    bright_bits = torch.sum(bright.long() * weights, dim=0)
    dark_bits = torch.sum(dark.long() * weights, dim=0)
    is_bright = _arc9_mask(bright_bits)
    is_dark = _arc9_mask(dark_bits)
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    bright_score = torch.sum(torch.where(bright, diff - t, zero), dim=0)
    dark_score = torch.sum(torch.where(dark, -diff - t, zero), dim=0)
    score = (torch.where(is_bright, bright_score, zero)
             + torch.where(is_dark, dark_score, zero))
    return torch.where(interior, score, zero)


def _interior_mask(H, W, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)


def fast_response2(img: torch.Tensor, t_hi: float, t_lo: float):
    """Both threshold response maps from one set of shifted views."""
    views = _shifted_views(img)
    diff = views - img[None]
    H, W = img.shape
    interior = _interior_mask(H, W, img.device)
    return (_fast_score_from_diff(diff, interior, t_hi),
            _fast_score_from_diff(diff, interior, t_lo))


def nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Zero out non-local-maxima over a (2r+1)^2 window (-inf padded)."""
    w = 2 * radius + 1
    pooled = F.max_pool2d(score[None, None], w, stride=1, padding=radius)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def occupancy_suppress(score: torch.Tensor, occupied_xy: torch.Tensor,
                       occupied_mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Zero the response within `radius` px of tracked features: scatter
    the occupied points into a binary image, dilate it by a separable
    (2r+1) square max-pool."""
    H, W = score.shape
    xi = torch.round(occupied_xy[..., 0]).long()
    yi = torch.round(occupied_xy[..., 1]).long()
    valid = occupied_mask & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    occ = torch.zeros(H * W, dtype=torch.float32, device=score.device)
    occ = occ.scatter_reduce(0, flat, valid.to(torch.float32), reduce="amax")
    occ = occ.reshape(H, W)
    r = int(radius)
    w = 2 * r + 1
    # occ >= 0, so the -inf padding of max_pool2d equals the reference's
    # zero-initialized reduce_window
    dil = F.max_pool2d(occ[None, None], (w, 1), stride=1, padding=(r, 0))
    dil = F.max_pool2d(dil, (1, w), stride=1, padding=(0, r))[0, 0]
    return torch.where(dil > 0, torch.zeros_like(score), score)


def grid_topk(score: torch.Tensor, cell: int, max_feats: int):
    """At most one winner per cell, then the global top `max_feats`.
    Returns (xy [N, 2] f32, score [N], valid [N] bool)."""
    H, W = score.shape
    gy = -(-H // cell)
    gx = -(-W // cell)
    Hp, Wp = gy * cell, gx * cell
    sp = F.pad(score, (0, Wp - W, 0, Hp - H), value=0.0)
    cells = sp.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(
        gy * gx, cell * cell)
    best = torch.argmax(cells, dim=1)
    best_val = torch.gather(cells, 1, best[:, None])[:, 0]
    c = torch.arange(gy * gx, device=score.device)
    cy = best // cell + (c // gx) * cell
    cx = best % cell + (c % gx) * cell

    k = min(max_feats, gy * gx)
    top_val, top_idx = torch.sort(best_val, descending=True, stable=True)
    top_val, top_idx = top_val[:k], top_idx[:k]
    xy = torch.stack([cx[top_idx].to(score.dtype), cy[top_idx].to(score.dtype)], dim=-1)
    valid = top_val > 0.0
    if k < max_feats:
        pad = max_feats - k
        xy = torch.cat([xy, xy.new_zeros((pad, 2))], dim=0)
        top_val = torch.cat([top_val, top_val.new_zeros((pad,))], dim=0)
        valid = torch.cat([valid, valid.new_zeros((pad,))], dim=0)
    return xy, top_val, valid
