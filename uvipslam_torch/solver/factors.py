"""Residuals and analytic Jacobians of the factor types.

Counterpart of `uvipslam_tpu/solver/factors.py`; only the visual SE3
reprojection factor used by the mono slice is ported so far. The
inertial, pressure and Sim3 factors belong to later slices.

SE3 camera pose Tcw increments are left-multiplicative,
Tcw <- Exp([rho, phi]) Tcw; residual = observed_uv - projected_uv.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv


def reproj_se3(Rcw, tcw, pw, uv, fx, fy, cx, cy):
    """Visual reprojection w.r.t. an SE3 camera pose and a world point,
    batched over leading dims of (pw, uv). Returns (r [.., 2],
    J_pose [.., 2, 6] for [rho, phi], J_point [.., 2, 3])."""
    pc = mv(Rcw, pw) + tcw
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = uv - torch.stack([u, v], dim=-1)

    zero = torch.zeros_like(x)
    J_uv_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    J_pc_pose = torch.cat([eye, -lie.hat(pc)], dim=-1)

    J_pose = -mm(J_uv_pc, J_pc_pose)
    J_point = -mm(J_uv_pc, Rcw.expand(pc.shape[:-1] + (3, 3)))
    return r, J_pose, J_point
