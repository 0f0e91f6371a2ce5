"""Pose-only optimization of the visual tracking solve.

Counterpart of `uvipslam_tpu/solver/pose_opt.py::pose_optimization_se3`
(motion-only BA: LM rounds with an annealed Huber kernel and chi2
re-gating between rounds). The VI solves (`pose_optimization_vi`,
`pose_optimization_vi2`) belong to the VIP slice.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.solver import factors
from uvipslam_torch.solver.gn import (accumulate_normal_eqs, huber_cost,
                                      huber_weight, lm_solve)

CHI2_MONO = 5.991
HUBER2_MONO = 5.991


def pose_optimization_se3(Rcw0, tcw0, pts_w, uvs, valid, inv_sigma2,
                          fx, fy, cx, cy, rounds: int = 4, iters: int = 10):
    """Motion-only BA of one camera pose against fixed map points.
    Returns (Rcw, tcw, inlier [N] bool, n_inliers). Early rounds use a
    widened kernel and a loose 4x gate; the last round tightens both to
    the reference's values."""
    dtype = tcw0.dtype
    inlier = valid

    def make_residual_fn(inlier_mask, delta2):
        def residual_fn(x):
            Rcw, tcw = x
            r, Jp, _ = factors.reproj_se3(Rcw, tcw, pts_w, uvs, fx, fy, cx, cy)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = huber_weight(chi2, delta2)
            w = w * inv_sigma2 * inlier_mask.to(dtype)
            H, g = accumulate_normal_eqs(Jp, r, w)
            total = torch.sum(torch.where(inlier_mask, huber_cost(chi2, delta2),
                                          torch.zeros_like(chi2)))
            return H, g, total
        return residual_fn

    def retract(x, dx):
        Rcw, tcw = x
        dR, dt = lie.se3_exp(dx)
        return lie.normalize_rotation(mm(dR, Rcw)), mv(dR, tcw) + dt

    delta_scale = (16.0, 4.0, 1.0, 1.0)
    x = (Rcw0, tcw0)
    for rd in range(rounds):
        last = rd == rounds - 1
        d2 = float(torch.tensor(
            HUBER2_MONO * (1.0 if last else delta_scale[min(rd, len(delta_scale) - 1)]),
            dtype=dtype))
        gate = float(torch.tensor(CHI2_MONO if last else 4.0 * CHI2_MONO, dtype=dtype))
        x, _ = lm_solve(x, make_residual_fn(inlier, d2), retract, n_iters=iters)
        Rcw, tcw = x
        r, _, _ = factors.reproj_se3(Rcw, tcw, pts_w, uvs, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        pc_z = (mv(Rcw, pts_w) + tcw)[..., 2]
        inlier = valid & (chi2 <= gate) & (pc_z > 0)
    return x[0], x[1], inlier, torch.sum(inlier)
