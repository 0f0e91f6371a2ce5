"""Batched PnP RANSAC for relocalization.

Counterpart of `uvipslam_tpu/ops/pnp.py`: a 6-point DLT minimal solver
(the null vector of each [2n, 12] system by `ops.twoview._solve_dlt`,
the rotation re-orthonormalized through its quaternion) over a batch of
hypotheses, the best by inlier count, then four all-inlier DLT
refinements of which the best-scoring pose is kept. Minimal samples draw
from a `torch.Generator`, or come in through `idx` (how the tests feed
both sides the same draws).
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mv
from uvipslam_torch.ops.twoview import _sample_minimal, _solve_dlt


def _dlt_rows(X, Y, Z, u, v):
    one = torch.ones_like(X)
    zr = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, one, zr, zr, zr, zr, -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([zr, zr, zr, zr, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], -1)
    return r1, r2


def _dlt_pnp(pts_w: torch.Tensor, xn: torch.Tensor):
    """Batched DLT: pts_w [B, n, 3], xn [B, n, 2] normalized image coords
    -> (R [B, 3, 3], t [B, 3]), n >= 6. The 3D points are
    Hartley-normalized (centroid, unit RMS) before the null-space solve."""
    c3 = torch.mean(pts_w, dim=-2, keepdim=True)
    scale = torch.sqrt(torch.mean(torch.sum((pts_w - c3) ** 2, -1), -1, keepdim=True))
    s3 = 1.0 / torch.clamp(scale, min=1e-9)
    R_n, t_n = _dlt_pnp_core((pts_w - c3) * s3[..., None], xn)
    t = t_n - s3 * mv(R_n, c3[..., 0, :])
    return R_n, t / s3


def _dlt_pnp_core(pts_w: torch.Tensor, xn: torch.Tensor):
    B = pts_w.shape[0]
    r1, r2 = _dlt_rows(pts_w[..., 0], pts_w[..., 1], pts_w[..., 2], xn[..., 0], xn[..., 1])
    p = _solve_dlt(torch.cat([r1, r2], dim=-2)).reshape(B, 3, 4)
    # sign: the centroid must lie in front of the camera
    c = torch.mean(pts_w, dim=-2)
    zc = torch.einsum("bj,bj->b", p[:, 2, :3], c) + p[:, 2, 3]
    p = p * torch.where(zc < 0, -1.0, 1.0)[:, None, None]
    M = p[:, :, :3]
    # geometric-mean row norm: ||row|| = s for a scaled rotation
    s = torch.exp(torch.mean(torch.log(torch.clamp(
        torch.linalg.vector_norm(M, dim=-1), min=1e-12)), dim=-1))
    R = lie.normalize_rotation(M / s[:, None, None])
    return R, p[:, :, 3] / s[:, None]


def _reproj_inliers(R, t, pts_w, uvs, valid, fx, fy, cx, cy, max_err2):
    pc = mv(R, pts_w) + t
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(pc[..., 2], 1e-9), pc[..., 2])
    uvp = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)
    err = torch.sum((uvp - uvs) ** 2, -1)
    return (err < max_err2) & (pc[..., 2] > 0) & valid


def pnp_ransac(gen: torch.Generator, pts_w: torch.Tensor, uvs: torch.Tensor,
               valid: torch.Tensor, fx, fy, cx, cy, max_err2: float = 5.991,
               n_iters: int = 128, min_set: int = 6, idx: torch.Tensor | None = None):
    """Returns (Rcw, tcw, inliers [N], n_inliers). `idx` [n_iters,
    min_set] injects the minimal samples; otherwise they draw from `gen`."""
    xn = torch.stack([(uvs[:, 0] - cx) / fx, (uvs[:, 1] - cy) / fy], -1)
    if idx is None:
        idx = _sample_minimal(gen, n_iters, min_set, valid)
    idx = idx.long()
    R_c, t_c = _dlt_pnp(pts_w[idx], xn[idx])

    pc = torch.einsum("hij,nj->hni", R_c, pts_w) + t_c[:, None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(pc[..., 2], 1e-9), pc[..., 2])
    uvp = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)
    err = torch.sum((uvp - uvs[None]) ** 2, -1)
    inl = (err < max_err2) & (pc[..., 2] > 0) & valid[None]
    score = torch.sum(inl, dim=1)
    best = torch.argmax(score).reshape(1)
    hist = [(R_c.index_select(0, best)[0], t_c.index_select(0, best)[0],
             inl.index_select(0, best)[0], score.index_select(0, best)[0])]

    # all-inlier DLT refinement, iterated; the best-scoring pose of the
    # history is reported (the first refine can drop below the sample's count)
    dtype = pts_w.dtype
    for _ in range(4):
        w = hist[-1][2].to(dtype)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        c3 = torch.sum(pts_w * w[:, None], 0) / wsum
        scale = torch.sqrt(torch.sum(torch.sum((pts_w - c3) ** 2, -1) * w) / wsum)
        s3 = 1.0 / torch.clamp(scale, min=1e-9)
        pts_n = (pts_w - c3) * s3
        r1, r2 = _dlt_rows(pts_n[:, 0], pts_n[:, 1], pts_n[:, 2], xn[:, 0], xn[:, 1])
        A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
        p = _solve_dlt(A[None])[0].reshape(3, 4)
        cn = torch.sum(pts_n * w[:, None], 0) / wsum
        zc = p[2, :3] @ cn + p[2, 3]
        p = p * torch.where(zc < 0, -1.0, 1.0)
        M = p[:, :3]
        sc = torch.exp(torch.mean(torch.log(torch.clamp(
            torch.linalg.vector_norm(M, dim=-1), min=1e-12))))
        R_r = lie.normalize_rotation(M / sc)
        t_r = (p[:, 3] / sc) / s3 - mv(R_r, c3)
        inl_r = _reproj_inliers(R_r, t_r, pts_w, uvs, valid, fx, fy, cx, cy, max_err2)
        hist.append((R_r, t_r, inl_r, torch.sum(inl_r)))
    k = torch.argmax(torch.stack([h[3] for h in hist])).reshape(1)
    return tuple(torch.stack([h[i] for h in hist]).index_select(0, k)[0] for i in range(4))
