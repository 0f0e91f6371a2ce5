"""On-manifold IMU preintegration.

Counterpart of `uvipslam_tpu/core/preintegration.py` (Forster RSS'15, the
reference IMUPreintegrator): over a fixed-length, mask-padded window of
bias-corrected IMU samples, accumulate the delta measurements (dP, dV,
dR), the five bias Jacobians and the 9x9 [P, V, Phi] noise covariance.

The per-sample recurrence is the reference's `lax.scan`: a `scan`
argument (`utils.graphs.Segments.scan`, which replays one captured graph
per sample on the card) or by default the plain Python loop over the
window (`graphs.plain_scan`); every step is batched over the leading dims
of its inputs, so several windows (the VIP step's two running integrals,
a keyframe table's windows) integrate in one loop instead of one loop
each. Padded samples carry dt = 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.utils.graphs import plain_scan


@dataclasses.dataclass
class PreintState:
    """Accumulated preintegrated measurement between two states."""

    dP: torch.Tensor        # [..., 3]
    dV: torch.Tensor        # [..., 3]
    dR: torch.Tensor        # [..., 3, 3]
    J_P_bg: torch.Tensor    # [..., 3, 3]
    J_P_ba: torch.Tensor    # [..., 3, 3]
    J_V_bg: torch.Tensor    # [..., 3, 3]
    J_V_ba: torch.Tensor    # [..., 3, 3]
    J_R_bg: torch.Tensor    # [..., 3, 3]
    cov: torch.Tensor       # [..., 9, 9]  order: P, V, Phi
    dt: torch.Tensor        # [...]

    @staticmethod
    def zero(batch_shape: tuple = (), dtype=torch.float32,
             device=None) -> "PreintState":
        b = tuple(batch_shape)

        def z(*s):
            return torch.zeros(b + s, dtype=dtype, device=device)

        return PreintState(
            dP=z(3), dV=z(3),
            dR=torch.eye(3, dtype=dtype, device=device).expand(b + (3, 3)).clone(),
            J_P_bg=z(3, 3), J_P_ba=z(3, 3), J_V_bg=z(3, 3), J_V_ba=z(3, 3),
            J_R_bg=z(3, 3), cov=z(9, 9), dt=z(),
        )


def _blocks3(rows):
    """3x3 grid of [..., 3, 3] blocks -> [..., 9, 9]."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def preint_step(st: PreintState, omega, acc, dt, gyr_cov, acc_cov) -> PreintState:
    """One update with bias-corrected (omega, acc) over dt, in the
    reference's order: covariance first (with the previous dR), then the
    bias Jacobians (P, V, R), then the deltas (P, V, R)."""
    dtype = st.dP.dtype
    dt = dt.to(dtype)
    dt2 = dt * dt
    w_dt = omega * dt[..., None]
    dR_inc = lie.so3_exp(w_dt)
    Jr = lie.so3_right_jacobian(w_dt)
    R_skew_a = mm(st.dR, lie.hat(acc))

    dt_b = dt[..., None, None]
    eye = lie.eye3(st.dP, st.dR.shape[:-2])
    z = torch.zeros_like(eye)
    A = _blocks3([[eye, eye * dt_b, -0.5 * R_skew_a * dt_b * dt_b],
                  [z, eye, -R_skew_a * dt_b],
                  [z, z, dR_inc.transpose(-1, -2)]])
    Bg = Jr * dt_b
    Ca_v = st.dR * dt_b
    Ca_p = 0.5 * st.dR * dt_b * dt_b
    cov = mm(mm(A, st.cov), A.transpose(-1, -2))
    # the noise terms touch disjoint blocks, each added once (as the
    # reference's indexed adds)
    gyr = mm(mm(Bg, gyr_cov), Bg.transpose(-1, -2))
    app = mm(mm(Ca_p, acc_cov), Ca_p.transpose(-1, -2))
    avv = mm(mm(Ca_v, acc_cov), Ca_v.transpose(-1, -2))
    apv = mm(mm(Ca_p, acc_cov), Ca_v.transpose(-1, -2))
    cov = cov + _blocks3([[app, apv, z], [apv.transpose(-1, -2), avv, z], [z, z, gyr]])

    J_P_ba = st.J_P_ba + st.J_V_ba * dt_b - 0.5 * st.dR * dt_b * dt_b
    RJ = mm(R_skew_a, st.J_R_bg)
    J_P_bg = st.J_P_bg + st.J_V_bg * dt_b - 0.5 * RJ * dt_b * dt_b
    J_V_ba = st.J_V_ba - st.dR * dt_b
    J_V_bg = st.J_V_bg - RJ * dt_b
    J_R_bg = mm(dR_inc.transpose(-1, -2), st.J_R_bg) - Jr * dt_b

    Ra = mv(st.dR, acc)
    dP = st.dP + st.dV * dt[..., None] + 0.5 * Ra * dt2[..., None]
    dV = st.dV + Ra * dt[..., None]
    dR = lie.normalize_rotation(mm(st.dR, dR_inc))
    return PreintState(dP=dP, dV=dV, dR=dR, J_P_bg=J_P_bg, J_P_ba=J_P_ba, J_V_bg=J_V_bg,
                       J_V_ba=J_V_ba, J_R_bg=J_R_bg, cov=cov, dt=st.dt + dt)


def _noise_covs(gyr_noise_sd, acc_noise_sd, dtype, device):
    """diag(sd^2) per-sample measurement covariances (the reference's
    `_gyrMeasCov = I * noise^2`, the square taken in `dtype`). The
    variances enter as Python numbers: a tensor made from one on the
    card would be a host-to-device copy that waits for the stream."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    eye = torch.eye(3, dtype=dtype, device=device)
    return (eye * float(np_dt(gyr_noise_sd) * np_dt(gyr_noise_sd)),
            eye * float(np_dt(acc_noise_sd) * np_dt(acc_noise_sd)))


def _preint_body(st: PreintState, x, bg, ba, gyr_cov, acc_cov) -> PreintState:
    """One sample x = (omega, acc, dt) of the windows, its biases taken off
    (the first operation on the sample is elementwise)."""
    omega, acc, dt = x
    return preint_step(st, omega - bg, acc - ba, dt, gyr_cov, acc_cov)


def preintegrate_continue(state: PreintState, omegas, accs, dts, mask, bg, ba,
                          gyr_noise_sd, acc_noise_sd, scan=None) -> PreintState:
    """Extend `state` [B...] with the windows omegas/accs [B..., T, 3],
    dts/mask [B..., T] (or unbatched windows shared by every state),
    subtracting biases bg/ba [B..., 3]. `scan` runs the loop over the T
    samples (the plain loop when None)."""
    dtype, dev = state.dP.dtype, state.dP.device
    gyr_cov, acc_cov = _noise_covs(gyr_noise_sd, acc_noise_sd, dtype, dev)
    bg = torch.as_tensor(bg, dtype=dtype, device=dev)
    ba = torch.as_tensor(ba, dtype=dtype, device=dev)
    omegas, accs = omegas.to(dtype), accs.to(dtype)
    dts = dts.to(dtype) * mask.to(dtype)     # padded samples: dt = 0
    return (scan or plain_scan)(
        ("preint", tuple(dts.shape)), _preint_body, state,
        xs=(omegas.movedim(-2, 0), accs.movedim(-2, 0), dts.movedim(-1, 0)),
        consts=(bg, ba, gyr_cov, acc_cov))


def preintegrate(omegas, accs, dts, mask, bg, ba, gyr_noise_sd, acc_noise_sd,
                 scan=None) -> PreintState:
    """Preintegrate padded windows [B..., T, 3] from zero (`scan` as
    `preintegrate_continue` takes it)."""
    batch = torch.broadcast_shapes(dts.shape[:-1], torch.as_tensor(bg).shape[:-1])
    zero = PreintState.zero(batch, dtype=omegas.dtype, device=omegas.device)
    return preintegrate_continue(zero, omegas, accs, dts, mask, bg, ba, gyr_noise_sd,
                                 acc_noise_sd, scan=scan)


def bias_correct(st: PreintState, dbg, dba) -> PreintState:
    """Re-linearize at a bias shifted by (dbg, dba) through the carried
    bias Jacobians (first order, the reference's own convention); the
    Jacobians and covariance are kept."""
    dR = mm(st.dR, lie.so3_exp(mv(st.J_R_bg, dbg)))
    dV = st.dV + mv(st.J_V_bg, dbg) + mv(st.J_V_ba, dba)
    dP = st.dP + mv(st.J_P_bg, dbg) + mv(st.J_P_ba, dba)
    return dataclasses.replace(st, dR=dR, dV=dV, dP=dP)
