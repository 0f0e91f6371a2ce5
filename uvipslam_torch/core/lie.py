"""Lie-group math for SO(3), SE(3) and Sim(3).

Counterpart of `uvipslam_tpu/core/lie.py`: the same formulas, the same
Taylor guards and the same small-matrix product helpers, batched over
arbitrary leading dims. Rotations are 3x3 matrices; quaternions are used
internally for `log` and re-normalization. No data-dependent control
flow: small-angle branches are `torch.where` on Taylor expansions.

Precision: `mm`/`mv` expand tiny products as broadcast multiply + sum
(exact f32 arithmetic, like the reference's VPU form); larger products go
to `torch.matmul`, which runs in full f32 because the package turns TF32
off (`uvipslam_torch/__init__.py`).
"""

from __future__ import annotations

import torch

_EPS2 = 1e-12
_SMALL_MM = 12


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small-matrix matmul at full precision (broadcast-sum for tiny
    static shapes, matmul otherwise)."""
    if (a.shape[-1] <= _SMALL_MM and a.shape[-2] <= _SMALL_MM
            and b.shape[-1] <= _SMALL_MM):
        return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)
    return torch.matmul(a, b)


def mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product [..., i, j] @ [..., j] at full precision."""
    if a.shape[-1] <= _SMALL_MM and a.shape[-2] <= _SMALL_MM:
        return torch.sum(a * x[..., None, :], dim=-1)
    return torch.einsum("...ij,...j->...i", a, x)


def _stack_last(*cols):
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def eye3(like: torch.Tensor, batch_shape=()) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        tuple(batch_shape) + (3, 3))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    row0 = _stack_last(z, -wz, wy)
    row1 = _stack_last(wz, z, -wx)
    row2 = _stack_last(-wy, wx, z)
    return torch.stack([row0, row1, row2], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: [..., 3, 3] -> [..., 3]."""
    return _stack_last(W[..., 2, 1], W[..., 0, 2], W[..., 1, 0])


def _safe_sqrt(x2, small):
    return torch.sqrt(torch.where(small, torch.ones_like(x2), x2))


def _sin_over_x(x2):
    small = x2 < _EPS2
    x = _safe_sqrt(x2, small)
    taylor = 1.0 - x2 / 6.0 + x2 * x2 / 120.0
    closed = torch.sin(x) / x
    return torch.where(small, taylor, closed)


def _one_minus_cos_over_x2(x2):
    small = x2 < _EPS2
    x = _safe_sqrt(x2, small)
    taylor = 0.5 - x2 / 24.0 + x2 * x2 / 720.0
    closed = (1.0 - torch.cos(x)) / torch.where(small, torch.ones_like(x2), x2)
    return torch.where(small, taylor, closed)


def _x_minus_sin_over_x3(x2):
    small = x2 < _EPS2
    x = _safe_sqrt(x2, small)
    taylor = 1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0
    closed = (x - torch.sin(x)) / torch.where(small, torch.ones_like(x2), x2 * x)
    return torch.where(small, taylor, closed)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues, Taylor-guarded)."""
    theta2 = torch.sum(w * w, dim=-1)
    A = _sin_over_x(theta2)[..., None, None]
    B = _one_minus_cos_over_x2(theta2)[..., None, None]
    W = hat(w)
    W2 = mm(W, W)
    return eye3(w, W.shape[:-2]) + A * W + B * W2


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0
    (branch-free Shepperd construction)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = _stack_last(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    qx0 = _stack_last(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy0 = _stack_last(m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21)
    qz0 = _stack_last(m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)  # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q * sign


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = _stack_last(1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy))
    row1 = _stack_last(2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx))
    row2 = _stack_last(2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))
    return torch.stack([row0, row1, row2], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return _stack_last(
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3) via quaternion (uniformly stable incl. pi)."""
    q = quat_from_rotmat(R)
    w, v = q[..., 0], q[..., 1:]
    v2 = torch.sum(v * v, dim=-1)
    small = v2 < 1e-14
    safe_vnorm = _safe_sqrt(v2, small)
    angle = 2.0 * torch.atan2(torch.where(small, torch.zeros_like(v2), safe_vnorm), w)
    factor = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / safe_vnorm)
    return v * factor[..., None]


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian Jl = I + B*hat(w) + C*hat(w)^2."""
    theta2 = torch.sum(w * w, dim=-1)
    B = _one_minus_cos_over_x2(theta2)[..., None, None]
    C = _x_minus_sin_over_x3(theta2)[..., None, None]
    W = hat(w)
    return eye3(w, W.shape[:-2]) + B * W + C * mm(W, W)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


def _half_x_cot_half_x_combo(x2):
    small = x2 < 1e-8
    x = _safe_sqrt(x2, small)
    one = torch.ones_like(x2)
    taylor = 1.0 / 12.0 + x2 / 720.0 + x2 * x2 / 30240.0
    sx = torch.where(small, one, torch.sin(x))
    closed = 1.0 / torch.where(small, one, x2) - (1.0 + torch.cos(x)) / (
        2.0 * torch.where(small, one, x) * sx)
    return torch.where(small, taylor, closed)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian: Jl^{-1} = I - 0.5*hat(w) + c*hat(w)^2."""
    theta2 = torch.sum(w * w, dim=-1)
    c = _half_x_cot_half_x_combo(theta2)[..., None, None]
    W = hat(w)
    return eye3(w, W.shape[:-2]) - 0.5 * W + c * mm(W, W)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian_inv(-w)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation matrix via its quaternion."""
    return rotmat_from_quat(quat_from_rotmat(R))


# ---------------------------------------------------------------------------
# SE(3): stored as (R [..., 3, 3], t [..., 3])
# ---------------------------------------------------------------------------


def se3_exp(xi: torch.Tensor):
    """Exp map se(3) -> SE(3). xi = [rho(3), phi(3)] -> (R, Jl(phi) rho)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = mv(so3_left_jacobian(phi), rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    rho = mv(so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -mv(Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return mm(Ra, Rb), mv(Ra, tb) + ta


def se3_apply(R, t, x):
    return mv(R, x) + t


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


# ---------------------------------------------------------------------------
# Sim(3): stored as (s [...], R [..., 3, 3], t [..., 3]); x -> s R x + t
# ---------------------------------------------------------------------------


def sim3_exp(xi: torch.Tensor):
    """Exp map sim(3) -> Sim(3). xi = [rho(3), phi(3), sigma(1)]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = _safe_sqrt(theta2, theta2 < 1e-14) * (theta2 >= 1e-14)
    W = _sim3_W(sigma, s, theta, hat(phi))
    return s, R, mv(W, rho)


def _sim3_W(sigma, s, theta, Phi):
    """W = A I + B Phi + C Phi^2 with the Strasdat coefficients."""
    one = torch.ones_like(sigma)
    sigma2 = sigma * sigma
    theta2 = theta * theta
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5

    safe_sigma = torch.where(small_sigma, one, sigma)
    safe_theta = torch.where(small_theta, one, theta)
    safe_theta2 = safe_theta * safe_theta

    A = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma2 / 6.0,
                    (s - 1.0) / safe_sigma)
    a = s * torch.sin(safe_theta)
    b = s * torch.cos(safe_theta)
    c = safe_theta2 + sigma2

    B_closed = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * c)
    B_sig0 = _one_minus_cos_over_x2(theta2)
    B_th0 = torch.where(small_sigma, 0.5 + sigma / 3.0,
                        ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B = torch.where(small_sigma, B_sig0, torch.where(small_theta, B_th0, B_closed))

    C_closed = (A - ((b - 1.0) * safe_sigma + a * safe_theta) / c) / safe_theta2
    C_sig0 = _x_minus_sin_over_x3(theta2)
    C_th0 = torch.where(
        small_sigma, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sigma2 - safe_sigma + 1.0) - 1.0)
        / (safe_sigma * safe_sigma * safe_sigma))
    C = torch.where(small_sigma, C_sig0, torch.where(small_theta, C_th0, C_closed))

    eye = eye3(Phi, Phi.shape[:-2])
    return (A[..., None, None] * eye + B[..., None, None] * Phi
            + C[..., None, None] * mm(Phi, Phi))


def sim3_log(s, R, t):
    """Log map Sim(3) -> sim(3): [rho, phi, sigma]."""
    sigma = torch.log(s)
    phi = so3_log(R)
    phi2 = torch.sum(phi * phi, dim=-1)
    theta = _safe_sqrt(phi2, phi2 < 1e-14) * (phi2 >= 1e-14)
    W = _sim3_W(sigma, s, theta, hat(phi))
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * mv(Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, mm(Ra, Rb), sa[..., None] * mv(Ra, tb) + ta


def sim3_apply(s, R, t, x):
    return s[..., None] * mv(R, x) + t


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj / det[..., None, None]
