"""Essential-graph optimization: a Sim3 pose graph over all keyframes.

Counterpart of `uvipslam_tpu/solver/essential_graph.py`: fixed-capacity
edge arrays (i, j, measured Sim3, mask), a [K, 7]-dof state stored as
(s, R, t) world->keyframe, per-edge Jacobians from
`factors.sim3_relative`, dense [7K, 7K] normal equations solved by
`gn.solve_spd`, Levenberg-Marquardt with accept/reject.

The normal equations are assembled as one matmul of the edge Jacobians
spread over the full state (a one-hot placement), not as a float
scatter-add: the sums then repeat bit for bit on a CUDA device.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.solver import factors
from uvipslam_torch.solver.gn import solve_spd


def optimize_essential_graph(kf_s, kf_R, kf_t, kf_valid, kf_fixed, e_i, e_j, m_s, m_R, m_t,
                             e_mask, n_iters: int = 12):
    """kf_s [K], kf_R [K, 3, 3], kf_t [K, 3] world->keyframe Sim3s; kf_fixed
    marks the gauge (the loop keyframe); edges e_i, e_j [E] with measured
    relative Sim3 (m_s, m_R, m_t) = S_j S_i^-1 and mask e_mask. Edge
    residual r = log(S_m S_i S_j^-1), left-multiplicative increments on
    S_i and S_j. Returns (kf_s', kf_R', kf_t')."""
    dtype, dev = kf_t.dtype, kf_t.device
    K = kf_s.shape[0]
    C = K * 7
    e_i, e_j = e_i.long(), e_j.long()
    free = kf_valid & ~kf_fixed
    w = e_mask.to(dtype)
    slots = torch.arange(K, device=dev)
    # [E, K] placement of each edge's two blocks, zeroed for fixed vertices
    place_i = ((e_i[:, None] == slots[None, :]) & free[None, :]).to(dtype)
    place_j = ((e_j[:, None] == slots[None, :]) & free[None, :]).to(dtype)
    fixed_diag = torch.diag((~free).repeat_interleave(7).to(dtype))

    def build(state):
        s, R, t = state
        r, J_i, J_j = factors.sim3_relative(s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j],
                                            m_s, m_R, m_t)
        # J [E*7, C]: row block e holds J_i at columns of e_i and J_j at e_j
        J = (J_i[:, :, None, :] * place_i[:, None, :, None]
             + J_j[:, :, None, :] * place_j[:, None, :, None]).reshape(-1, C)
        Jw = J * w.repeat_interleave(7)[:, None]
        H = Jw.T @ J + fixed_diag
        g = Jw.T @ r.reshape(-1)
        total = torch.sum(torch.where(e_mask, torch.sum(r * r, -1), torch.zeros_like(w)))
        return H, g, total

    def retract(state, dc):
        s, R, t = state
        ds, dR, dt = lie.sim3_exp(dc.reshape(K, 7))
        s2, R2, t2 = lie.sim3_compose(ds, dR, dt, s, R, t)
        return (s2, lie.normalize_rotation(R2), t2)

    state = (kf_s, kf_R, kf_t)
    H, g, chi2 = build(state)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    for _ in range(n_iters):
        dc = solve_spd(H, -g, damping=lam)
        state_new = retract(state, dc)
        H_new, g_new, chi2_new = build(state_new)
        accept = chi2_new < chi2
        state = tree_map(lambda a, b: torch.where(accept, b, a), state, state_new)
        H, g = torch.where(accept, H_new, H), torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        chi2 = torch.where(accept, chi2_new, chi2)
    return state


def correct_points_after_pose_graph(pt_xyz, pt_ref_kf, old_s, old_R, old_t, new_s, new_R, new_t,
                                    pt_valid):
    """Re-express each valid landmark through its reference keyframe's
    corrected Sim3: x' = S_new^-1 (S_old x)."""
    k = pt_ref_kf.clamp(0, old_s.shape[0] - 1).long()
    cam = lie.sim3_apply(old_s[k], old_R[k], old_t[k], pt_xyz)
    out = lie.sim3_apply(*lie.sim3_inverse(new_s[k], new_R[k], new_t[k]), cam)
    return torch.where(pt_valid[:, None], out, pt_xyz)
