"""Parity of the port's math core and solvers with the reference on
seeded float32 fixtures: Lie-group maps, NavState, the batched SPD inverse and
null-vector solver, the motion-only pose solve and the windowed SE3 BA.

Tolerances: the Lie maps and linear algebra agree to float32 rounding
(atol 1e-5 on unit-scale quantities). The iterative solves accumulate
float32 sums in another order than XLA and re-run accept/reject LM
steps on those numbers, so poses are held at atol 1e-4 (rotation
entries, metres) and points at atol 1e-4 relative to the scene depth;
inlier sets must match exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.core import lie as jlie
from uvipslam_tpu.solver import gn as jgn
from uvipslam_tpu.solver.local_ba import local_ba_se3 as j_local_ba
from uvipslam_tpu.solver.pose_opt import pose_optimization_se3 as j_pose_opt
from uvipslam_torch.core import lie as tlie
from uvipslam_torch.solver import gn as tgn
from uvipslam_torch.solver.local_ba import local_ba_se3 as t_local_ba
from uvipslam_torch.solver.pose_opt import pose_optimization_se3 as t_pose_opt
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FX, FY, CX, CY = 420.0, 420.0, 320.0, 240.0


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lie_inputs():
    """Seeded float32 arguments spanning tiny, small and large angles."""
    rs = np.random.RandomState(0)
    w = (rs.randn(64, 3) * rs.choice([1e-7, 1e-3, 0.5, 3.0], (64, 1))).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    R2 = np.asarray(jlie.so3_exp(jnp.asarray(rs.randn(64, 3).astype(np.float32))))
    t = rs.randn(64, 3).astype(np.float32)
    t2 = rs.randn(64, 3).astype(np.float32)
    x = rs.randn(64, 3).astype(np.float32)
    s = np.exp(rs.randn(64) * 0.3).astype(np.float32)
    s2 = np.exp(rs.randn(64) * 0.3).astype(np.float32)
    q = rs.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rs.randn(64, 4).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    M = rs.randn(64, 3, 3).astype(np.float32)
    spd = (M @ M.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)).astype(np.float32)
    return dict(w=w, R=R, R2=R2, t=t, t2=t2, x=x, s=s, s2=s2, q=q, q2=q2, M=M, spd=spd,
                xi6=(rs.randn(64, 6) * 0.3).astype(np.float32),
                xi7=(rs.randn(64, 7) * 0.3).astype(np.float32),
                W=np.asarray(jlie.hat(jnp.asarray(w))))


LIE_CASES = {
    "mm": ("M", "R"), "mv": ("M", "x"), "hat": ("w",), "vee": ("W",),
    "so3_exp": ("w",), "so3_log": ("R",), "quat_from_rotmat": ("R",),
    "rotmat_from_quat": ("q",), "quat_mul": ("q", "q2"),
    "so3_left_jacobian": ("w",), "so3_right_jacobian": ("w",),
    "so3_left_jacobian_inv": ("w",), "so3_right_jacobian_inv": ("w",),
    "normalize_rotation": ("R_noisy",), "se3_exp": ("xi6",), "se3_log": ("R", "t"),
    "se3_inverse": ("R", "t"), "se3_compose": ("R", "t", "R2", "t2"),
    "se3_apply": ("R", "t", "x"), "se3_matrix": ("R", "t"), "sim3_exp": ("xi7",),
    "sim3_log": ("s", "R", "t"), "sim3_inverse": ("s", "R", "t"),
    "sim3_compose": ("s", "R", "t", "s2", "R2", "t2"), "sim3_apply": ("s", "R", "t", "x"),
    "inv3x3": ("spd",),
}


# C(x) = (x - sin x) / x^3 cancels in float32 just above its Taylor
# switch (x ~ 3e-3): there both implementations sit ~9e-6 from float64,
# on either side, in the hat(w)^2 term of the Jacobians
LIE_ATOL = {"so3_left_jacobian": 2e-5, "so3_right_jacobian": 2e-5}


@pytest.mark.parametrize("fn", sorted(LIE_CASES))
def test_lie_maps_match(fn):
    """Every public map of core/lie.py, to float32 rounding (atol 1e-5
    on unit-scale quantities, LIE_ATOL where the formula cancels)."""
    inp = _lie_inputs()
    inp["R_noisy"] = inp["R"] + np.float32(1e-3)
    args = [inp[k] for k in LIE_CASES[fn]]
    j = getattr(jlie, fn)(*map(jnp.asarray, args))
    t = getattr(tlie, fn)(*map(_t, args))
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_allclose(_np(b), _np(a), atol=LIE_ATOL.get(fn, 1e-5), rtol=1e-5)


def test_navstate_methods_match():
    from uvipslam_tpu.core.state import NavState as JNav
    from uvipslam_torch.core.state import NavState as TNav

    rs = np.random.RandomState(6)
    inp = _lie_inputs()
    fields = dict(p=inp["t"], v=inp["t2"], R=inp["R"], bg=inp["x"] * 0.01,
                  ba=inp["x"] * 0.1, dbg=inp["t"] * 0.001, dba=inp["t2"] * 0.01)
    j = JNav(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = TNav(**{k: _t(v) for k, v in fields.items()})
    upd9 = (rs.randn(64, 9) * 0.1).astype(np.float32)
    upd6 = (rs.randn(64, 6) * 0.01).astype(np.float32)
    pairs = [(j.inc_small_pvr(jnp.asarray(upd9)), t.inc_small_pvr(_t(upd9))),
             (j.inc_small_bias(jnp.asarray(upd6)), t.inc_small_bias(_t(upd6))),
             (j.normalized(), t.normalized())]
    for a, b in pairs:
        for f in fields:
            np.testing.assert_allclose(_np(getattr(b, f)), _np(getattr(a, f)), atol=1e-5,
                                       rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(_np(t.bg_total), _np(j.bg_total), atol=1e-6)
    np.testing.assert_allclose(_np(t.ba_total), _np(j.ba_total), atol=1e-6)
    ident = TNav.identity((4,))
    jident = JNav.identity((4,))
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(ident, f)), _np(getattr(jident, f)))


def test_inv_spd_and_nullvec_match():
    rs = np.random.RandomState(1)
    A = rs.randn(32, 12, 12).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 12 * np.eye(12, dtype=np.float32)).astype(np.float32)
    np.testing.assert_allclose(_np(tgn.inv_spd_scaled(_t(H))),
                               _np(jgn.inv_spd_scaled(jnp.asarray(H))), atol=1e-5)
    M = rs.randn(50, 8, 9).astype(np.float32)
    vj = _np(jgn.nullvec_ls(jnp.asarray(M)))
    vt = _np(tgn.nullvec_ls(_t(M)))
    sign = np.sign(np.sum(vj * vt, -1, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=1e-4)


def _scene(rs, n=120, depth=(4.0, 9.0)):
    pts = np.stack([rs.uniform(-3, 3, n), rs.uniform(-2, 2, n), rs.uniform(*depth, n)], -1)
    return pts.astype(np.float32)


def _project(R, t, pts):
    pc = pts @ R.T + t
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)


def test_pose_optimization_se3_matches():
    rs = np.random.RandomState(2)
    pts = _scene(rs)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t = np.array([0.3, -0.1, 0.2], np.float32)
    uv = _project(R, t, pts) + rs.randn(len(pts), 2) * 0.5
    out = rs.choice(len(pts), 15, replace=False)
    uv[out] += rs.uniform(20, 60, (15, 2))
    uv = uv.astype(np.float32)
    valid = rs.uniform(size=len(pts)) > 0.05
    inv_sig = (1.0 / 1.2 ** (2 * rs.randint(0, 3, len(pts)))).astype(np.float32)
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.01, 0.02, -0.01], jnp.float32)))
    R0, t0 = (dR @ R).astype(np.float32), (t + np.array([0.05, 0.03, -0.04])).astype(np.float32)
    args = (R0, t0, pts, uv, valid, inv_sig)
    for rounds, iters in [(2, 4), (2, 2), (4, 10)]:
        Rj, tj, ij, nj = j_pose_opt(*map(jnp.asarray, args), FX, FY, CX, CY,
                                    rounds=rounds, iters=iters)
        Rt, tt, it, nt = t_pose_opt(*map(_t, args), FX, FY, CX, CY, rounds=rounds, iters=iters)
        np.testing.assert_array_equal(_np(it), _np(ij))
        np.testing.assert_allclose(_np(Rt), _np(Rj), atol=1e-4)
        np.testing.assert_allclose(_np(tt), _np(tj), atol=1e-4)
        assert int(nt) == int(nj) and int(nt) > 80


def _ba_problem(seed=0, K=5, P=100, F=100, pose_noise=0.005, pt_noise=0.02):
    """K keyframes in the grid layout the tracker uses: row k holds
    keyframe k's F observation slots (some empty). The scene is close
    (2-5 m) so the float32 Schur complement of the first LM step stays
    well-conditioned; farther scenes make both implementations' first
    step float32 noise, which no parity test can hold."""
    rs = np.random.RandomState(seed)
    pts = _scene(rs, P, depth=(2.0, 5.0))
    Rs, ts = [], []
    for k in range(K):
        Rk = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.02, -0.03, 0.01]) * k,
                                                 jnp.float32)))
        Rs.append(Rk)
        ts.append(-Rk @ np.array([0.3 * k, 0.02 * k, 0.0]))
    Rs, ts = np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)
    obs_pt = np.zeros((K, F), np.int32)
    obs_uv = np.zeros((K, F, 2), np.float32)
    obs_ok = np.zeros((K, F), bool)
    for k in range(K):
        sel = rs.permutation(P)[:F]
        obs_pt[k] = sel
        obs_uv[k] = _project(Rs[k], ts[k], pts[sel]) + rs.randn(F, 2) * 0.4
        obs_ok[k] = rs.uniform(size=F) > 0.1
    # perturb all but the two gauge keyframes, and the points
    R0, t0 = Rs.copy(), ts.copy()
    for k in range(2, K):
        dR = np.asarray(jlie.so3_exp(jnp.asarray(rs.randn(3) * pose_noise, jnp.float32)))
        R0[k] = dR @ R0[k]
        t0[k] = t0[k] + rs.randn(3) * 2 * pose_noise
    pts0 = (pts + rs.randn(P, 3) * pt_noise).astype(np.float32)
    inv_sig = (1.0 / 1.2 ** (2 * rs.randint(0, 3, (K, F)))).astype(np.float32)
    fixed = np.array([True, True] + [False] * (K - 2))
    kf_valid = np.ones(K, bool)
    pt_valid = rs.uniform(size=P) > 0.02
    obs_kf = np.broadcast_to(np.arange(K, dtype=np.int32)[:, None], (K, F)).copy()
    return (R0.astype(np.float32), t0.astype(np.float32), fixed, kf_valid, pts0, pt_valid,
            obs_kf, obs_pt, obs_uv, inv_sig, obs_ok)


@pytest.mark.parametrize("p_active", [2048, 128])
def test_local_ba_se3_matches(p_active):
    args = _ba_problem()
    Rj, tj, pj, ij = j_local_ba(*map(jnp.asarray, args), FX, FY, CX, CY,
                                n_iters=2, rounds=2, p_active=p_active)
    Rt, tt, pt_, it = t_local_ba(*map(_t, args), FX, FY, CX, CY,
                                 n_iters=2, rounds=2, p_active=p_active)
    np.testing.assert_array_equal(_np(it), _np(ij))
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=1e-4)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=1e-4)
    np.testing.assert_allclose(_np(pt_), _np(pj), atol=1e-4 * 5.0)
    # the solve moved the free poses
    assert np.abs(_np(Rt)[2:] - args[0][2:]).max() > 1e-4
