"""Closed-form Sim3 alignment (Horn) + batched RANSAC + GN refinement.

Counterpart of `uvipslam_tpu/ops/sim3solver.py`: every minimal 3-point
sample solved at once by the batched Horn closed form (the quaternion is
the eigenvector of the largest eigenvalue of the 4x4 N matrix), scored
densely by symmetric reprojection error, refined by weighted Horn on the
best hypothesis's inliers; `optimize_sim3` is the paired-reprojection
Gauss-Newton of the relative Sim3, with analytic Jacobians.

The eigenvector's sign is free, and `rotmat_from_quat` is even in q, so
R, s and t do not depend on it.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mv
from uvipslam_torch.ops.twoview import _sample_minimal


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor | None = None,
              fix_scale: bool = False):
    """Similarity aligning p1 -> p2, batched over leading dims: (s, R, t)
    with p2 ~ s R p1 + t. p1, p2 [..., N, 3]; w optional weights [..., N]."""
    dtype = p1.dtype
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=dtype, device=p1.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c1 = torch.sum(p1 * wn[..., None], dim=-2, keepdim=True)
    c2 = torch.sum(p2 * wn[..., None], dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2

    M = torch.einsum("...ni,...nj,...n->...ij", q1, q2, wn)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evecs = torch.linalg.eigh(N)
    R = lie.rotmat_from_quat(evecs[..., :, -1])      # (w, x, y, z) of the largest eigenvalue

    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=dtype, device=p1.device)
    else:
        n2 = torch.sum(torch.sum(q2 * q2, -1) * wn, -1)
        n1 = torch.sum(torch.sum(q1 * q1, -1) * wn, -1)
        s = torch.sqrt(n2 / torch.clamp(n1, min=1e-12))
    t = c2[..., 0, :] - s[..., None] * mv(R, c1[..., 0, :])
    return s, R, t


def _proj(p, fx, fy, cx, cy):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, torch.full_like(p[..., 2], 1e-9), p[..., 2])
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def sim3_ransac(gen, p1, p2, valid, fx, fy, cx, cy, max_err2: float = 9.21,
                n_iters: int = 128, fix_scale: bool = False, idx=None):
    """RANSAC Horn alignment of p1 [N, 3] (camera 1) onto p2 [N, 3]
    (camera 2) with symmetric reprojection gating. The minimal samples
    draw from `gen` unless `idx` [n_iters, 3] gives them. Returns (s, R,
    t, inliers [N], n_inliers)."""
    if idx is None:
        idx = _sample_minimal(gen, n_iters, 3, valid)
    s_c, R_c, t_c = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)

    def proj(p):
        return _proj(p, fx, fy, cx, cy)

    p1in2 = s_c[:, None, None] * torch.einsum("hij,nj->hni", R_c, p1) + t_c[:, None, :]
    s_inv = 1.0 / torch.clamp(s_c, min=1e-12)
    p2in1 = s_inv[:, None, None] * torch.einsum("hji,hnj->hni", R_c, p2 - t_c[:, None, :])
    e1 = torch.sum((proj(p1in2) - proj(p2[None])) ** 2, -1)
    e2 = torch.sum((proj(p2in1) - proj(p1[None])) ** 2, -1)
    inl = (e1 < max_err2) & (e2 < max_err2) & valid[None]
    score = torch.sum(inl, dim=1)
    best = torch.argmax(score)

    w = inl[best].to(p1.dtype)
    s_r, R_r, t_r = horn_sim3(p1, p2, w, fix_scale=fix_scale)
    p1in2 = s_r * mv(R_r, p1) + t_r
    p2in1 = (1.0 / torch.clamp(s_r, min=1e-12)) * mv(R_r.T, p2 - t_r)
    e1 = torch.sum((proj(p1in2) - proj(p2)) ** 2, -1)
    e2 = torch.sum((proj(p2in1) - proj(p1)) ** 2, -1)
    inl_r = (e1 < max_err2) & (e2 < max_err2) & valid
    better = torch.sum(inl_r) >= score[best]
    s_o = torch.where(better, s_r, s_c[best])
    R_o = torch.where(better, R_r, R_c[best])
    t_o = torch.where(better, t_r, t_c[best])
    inl_o = torch.where(better, inl_r, inl[best])
    return s_o, R_o, t_o, inl_o, torch.sum(inl_o)


def optimize_sim3(s, R, t, p1, p2, uv1, uv2, valid, fx, fy, cx, cy, max_err2: float = 9.21,
                  iters: int = 10):
    """Gauss-Newton refinement of a relative Sim3 from paired reprojection
    edges: p1 (camera-1 coordinates) through S against uv2, p2 through
    S^-1 against uv1; Huber delta^2 = 10; a step is kept only if the
    robust cost falls.

    The 7-dof Jacobians w.r.t. the left-multiplicative increment
    [rho, phi, sigma] are analytic where the reference differentiates its
    residual by forward mode: with q = S p1, d(exp(xi) S p1)/dxi =
    [I, -hat(q), q]; and (exp(xi) S)^-1 p2 = S^-1 exp(-xi) p2 gives
    -(1/s) R^T [I, -hat(p2), p2]. The float64 parity test holds the two
    to 1e-9. Returns (s, R, t, inlier_mask, n_inliers)."""
    dtype, dev = p1.dtype, p1.device
    huber2 = 10.0
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(p1.shape[0], 3, 3)
    # d(exp(-xi) p2)/dxi at 0, constant over the iterations
    G2 = -torch.cat([eye3, -lie.hat(p2), p2[..., None]], dim=-1)          # [N, 3, 7]

    def proj_jac(pc):
        """Projection and its [N, 2, 3] Jacobian."""
        x, y = pc[..., 0], pc[..., 1]
        z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(x, 1e-9), pc[..., 2])
        zero = torch.zeros_like(x)
        uv = torch.stack([fx * x / z + cx, fy * y / z + cy], -1)
        J = torch.stack([torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
                         torch.stack([zero, fy / z, -fy * y / (z * z)], -1)], -2)
        return uv, J

    def transfer(s, R, t):
        si, Ri, ti = lie.sim3_inverse(s, R, t)
        return s * mv(R, p1) + t, si * mv(Ri, p2) + ti, si, Ri

    def residuals(s, R, t):
        q1, q2, _, _ = transfer(s, R, t)
        return torch.cat([_proj(q1, fx, fy, cx, cy) - uv2, _proj(q2, fx, fy, cx, cy) - uv1], 0)

    eye7 = torch.eye(7, dtype=dtype, device=dev)
    w = valid.to(dtype).repeat(2)
    for _ in range(iters):
        q1, q2, si, Ri = transfer(s, R, t)
        u1, Ju1 = proj_jac(q1)
        u2, Ju2 = proj_jac(q2)
        r = torch.cat([u1 - uv2, u2 - uv1], 0)                            # [2N, 2]
        J1 = Ju1 @ torch.cat([eye3, -lie.hat(q1), q1[..., None]], dim=-1)
        J2 = Ju2 @ (si * (Ri @ G2))
        J = torch.cat([J1, J2], 0)                                        # [2N, 2, 7]
        chi2 = torch.sum(r * r, -1)
        wh = torch.where(chi2 > huber2, torch.sqrt(huber2 / torch.clamp(chi2, min=1e-12)),
                         torch.ones_like(chi2))
        ww = w * wh
        JW = J * ww[:, None, None]
        H = torch.einsum("eri,erj->ij", JW, J) + eye7 * 1e-6
        g = torch.einsum("eri,er->i", JW, r)
        # a singular or non-finite system (no valid match, a degenerate
        # start) yields a NaN step, which the accept test refuses: no raise
        sol, info = torch.linalg.solve_ex(H, g)
        dx = -torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
        ds, dR, dt = lie.sim3_exp(dx)
        s2, R2, t2 = lie.sim3_compose(ds, dR, dt, s, R, t)
        R2 = lie.normalize_rotation(R2)
        c_old = torch.sum(ww * chi2)
        r_new = residuals(s2, R2, t2)
        c_new = torch.sum(ww * torch.sum(r_new * r_new, -1))
        ok = c_new < c_old
        s, R, t = torch.where(ok, s2, s), torch.where(ok, R2, R), torch.where(ok, t2, t)

    q1, q2, _, _ = transfer(s, R, t)
    e1 = torch.sum((_proj(q1, fx, fy, cx, cy) - uv2) ** 2, -1)
    e2 = torch.sum((_proj(q2, fx, fy, cx, cy) - uv1) ** 2, -1)
    inl = (e1 < max_err2) & (e2 < max_err2) & valid
    return s, R, t, inl, torch.sum(inl)
