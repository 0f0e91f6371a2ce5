"""Parity of the port's loop-closing solvers with the reference on seeded
numpy inputs, on the CPU: the Horn / RANSAC / Gauss-Newton Sim3 solver,
the essential graph with its landmark sweep, and the NavState global BA.

Tolerances: inlier sets and kept observations are exact. The closed-form
Horn fit agrees to 2e-5. The iterative solves are held tightly in float64
(1e-8 or better) and at a stated looser tolerance in float32, where
accept/reject steps run on sums accumulated in another order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.ops import sim3solver as jsim3
from uvipslam_tpu.solver import essential_graph as jeg
from uvipslam_tpu.solver import global_ba as jgba
from uvipslam_torch import convert
from uvipslam_torch.ops import sim3solver as tsim3
from uvipslam_torch.solver import essential_graph as teg
from uvipslam_torch.solver import global_ba as tgba

from tests.test_torch_loop import CX, CY, DTYPES, FX, FY, _np, _rot, _t, _tree_np
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


# ---------------------------------------------------------------------------
# Sim3 solver
# ---------------------------------------------------------------------------

def _sim3_problem(seed, n=60, npdt=np.float32, outliers=12, noise=0.002):
    """Matched clouds p2 = s R p1 + t (+ noise, some gross outliers) in
    front of both cameras, and their projections."""
    rs = np.random.RandomState(seed)
    s, R, t = 1.07, _rot(rs, 0.15, 1)[0], np.array([0.3, -0.1, 0.05])
    p1 = rs.uniform(-1.5, 1.5, (n, 3)) + [0, 0, 5]
    p2 = s * p1 @ R.T + t + rs.randn(n, 3) * noise
    bad = rs.choice(n, outliers, replace=False)
    p2[bad] += rs.randn(outliers, 3) * 0.8
    valid = np.ones(n, bool)
    valid[rs.choice(n, 5, replace=False)] = False

    def proj(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)

    uv1 = proj(p1) + rs.randn(n, 2) * 0.3
    uv2 = proj(p2) + rs.randn(n, 2) * 0.3
    good = valid.copy()
    good[bad] = False
    return dict(p1=p1.astype(npdt), p2=p2.astype(npdt), uv1=uv1.astype(npdt),
                uv2=uv2.astype(npdt), valid=valid, good=good, s=s, R=R, t=t)


def test_horn_sim3():
    """R, s, t (not the quaternion, whose sign is free), batched minimal
    samples and a weighted fit: 2e-5 on well-separated samples."""
    pb = _sim3_problem(12, outliers=0, noise=0.0)
    rs = np.random.RandomState(13)
    idx = np.stack([rs.choice(60, 3, replace=False) for _ in range(32)])
    j = jsim3.horn_sim3(jnp.asarray(pb["p1"][idx]), jnp.asarray(pb["p2"][idx]))
    t = tsim3.horn_sim3(_t(pb["p1"][idx]), _t(pb["p2"][idx]))
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(_np(t[1]), np.broadcast_to(pb["R"], (32, 3, 3)), atol=1e-4)
    w = rs.rand(60).astype(np.float32)
    for fix in (False, True):
        j = jsim3.horn_sim3(jnp.asarray(pb["p1"]), jnp.asarray(pb["p2"]), jnp.asarray(w),
                            fix_scale=fix)
        t = tsim3.horn_sim3(_t(pb["p1"]), _t(pb["p2"]), _t(w), fix_scale=fix)
        for a, b in zip(t, j):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("seed", [14, 15])
def test_sim3_ransac_injected_samples(seed):
    """Both sides get the same minimal samples (the port's `idx` argument;
    the reference's `_sample_minimal` replaced for the call): the same
    inlier set, and s, R, t within 1e-4."""
    from uvipslam_tpu.ops import twoview as jtv

    pb = _sim3_problem(seed)
    rs = np.random.RandomState(seed)
    ok = np.nonzero(pb["valid"])[0]
    idx = np.stack([rs.choice(ok, 3, replace=False) for _ in range(128)]).astype(np.int32)
    orig = jtv._sample_minimal
    jtv._sample_minimal = lambda key, n, k, valid: jnp.asarray(idx)
    try:
        j = jsim3.sim3_ransac.__wrapped__(
            jax.random.PRNGKey(0), jnp.asarray(pb["p1"]), jnp.asarray(pb["p2"]),
            jnp.asarray(pb["valid"]), FX, FY, CX, CY)
    finally:
        jtv._sample_minimal = orig
    t = tsim3.sim3_ransac(None, _t(pb["p1"]), _t(pb["p2"]), _t(pb["valid"]), FX, FY, CX, CY,
                          idx=_t(idx).long())
    np.testing.assert_array_equal(_np(t[3]), np.asarray(j[3]))
    assert int(t[4]) == int(j[4]) >= 35
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)
    # without `idx` the samples come from the generator: same support
    g = torch.Generator().manual_seed(3)
    t2 = tsim3.sim3_ransac(g, _t(pb["p1"]), _t(pb["p2"]), _t(pb["valid"]), FX, FY, CX, CY)
    assert int(t2[4]) >= int(t[4]) - 3


@pytest.mark.parametrize("dkey", ["f32", "f64"])
def test_optimize_sim3(dkey):
    """From a perturbed start: float64 to 1e-9; float32 s, R, t within
    2e-4 and the same inlier set (the accept test runs on float32 sums)."""
    npdt, tdt, x64 = DTYPES[dkey]
    pb = _sim3_problem(16, npdt=npdt)
    rs = np.random.RandomState(17)
    s0 = np.asarray(pb["s"] * 1.03, npdt)
    R0 = (pb["R"] @ _rot(rs, 0.02, 1)[0]).astype(npdt)
    t0 = (pb["t"] + rs.randn(3) * 0.03).astype(npdt)
    with jax.enable_x64(x64):
        j = [np.asarray(a) for a in jsim3.optimize_sim3(
            jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pb["p1"]),
            jnp.asarray(pb["p2"]), jnp.asarray(pb["uv1"]), jnp.asarray(pb["uv2"]),
            jnp.asarray(pb["good"]), FX, FY, CX, CY)]
    t = tsim3.optimize_sim3(_t(s0), _t(R0), _t(t0), _t(pb["p1"]), _t(pb["p2"]), _t(pb["uv1"]),
                            _t(pb["uv2"]), _t(pb["good"]), FX, FY, CX, CY)
    atol = 1e-9 if x64 else 2e-4
    for a, b in zip(t[:3], j[:3]):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), b, atol=atol, rtol=0)
    np.testing.assert_array_equal(_np(t[3]), j[3])
    assert int(t[4]) == int(j[4]) >= 35
    assert abs(float(t[0]) - pb["s"]) < 5e-3


def test_optimize_sim3_degenerate_input_keeps_start():
    """No valid match, or a non-finite start: the normal equations are
    singular or NaN; like the reference, the port raises nothing, refuses
    every step and returns the start with no inlier."""
    pb = _sim3_problem(16)
    none = np.zeros_like(pb["good"])
    args = [jnp.asarray(pb[k]) for k in ("p1", "p2", "uv1", "uv2")]
    targs = [_t(pb[k]) for k in ("p1", "p2", "uv1", "uv2")]
    for s0 in (1.0, float("nan")):
        j = jsim3.optimize_sim3(jnp.asarray(s0, jnp.float32), jnp.eye(3, dtype=jnp.float32),
                                jnp.zeros(3, jnp.float32), *args, jnp.asarray(none),
                                FX, FY, CX, CY)
        t = tsim3.optimize_sim3(torch.tensor(s0), torch.eye(3), torch.zeros(3), *targs,
                                _t(none), FX, FY, CX, CY)
        np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
        np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))
        assert int(t[4]) == int(j[4]) == 0


# ---------------------------------------------------------------------------
# essential graph
# ---------------------------------------------------------------------------

def _graph_problem(npdt, K=9, seed=18):
    """A drifted chain of K keyframes (one invalid slot) with a loop edge
    from the last back to the first, two extra covisibility edges and a
    masked edge."""
    rs = np.random.RandomState(seed)
    R_true = _rot(rs, 0.2, K)
    t_true = rs.randn(K, 3)
    drift = np.cumsum(rs.randn(K, 3) * 0.03, axis=0)
    kf_R = (R_true @ _rot(rs, 0.01, K)).astype(npdt)
    kf_t = (t_true + drift).astype(npdt)
    kf_s = np.ones(K, npdt)
    valid = np.ones(K, bool)
    valid[K - 2] = False
    fixed = np.zeros(K, bool)
    fixed[0] = True

    def rel(Ri, ti, Rj, tj):       # S_j S_i^-1 at scale 1
        Rm = Rj @ Ri.transpose(0, 2, 1)
        return Rm, tj - np.einsum("eij,ej->ei", Rm, ti)

    e_i = np.array([1, 2, 3, 4, 5, 6, 8, 0, 2, 5, 3], np.int32)
    e_j = np.array([0, 1, 2, 3, 4, 5, 6, 8, 0, 2, 7], np.int32)
    m_R, m_t = rel(kf_R[e_i].astype(float), kf_t[e_i].astype(float),
                   kf_R[e_j].astype(float), kf_t[e_j].astype(float))
    # the loop edge 0 -> 8 is measured from the truth, at scale 1.02
    mR8, mt8 = rel(R_true[[0]], t_true[[0]], R_true[[8]], t_true[[8]])
    m_R[7], m_t[7] = mR8[0], mt8[0]
    m_s = np.ones(len(e_i))
    m_s[7] = 1.02
    e_mask = np.ones(len(e_i), bool)
    e_mask[10] = False
    return (kf_s, kf_R, kf_t, valid, fixed, e_i, e_j, m_s.astype(npdt), m_R.astype(npdt),
            m_t.astype(npdt), e_mask)


@pytest.mark.parametrize("dkey", ["f32", "f64"])
def test_optimize_essential_graph(dkey):
    """float64 to 1e-8; float32 to 2e-3 (20 LM steps whose accept test
    runs on float32 sums). The fixed and the invalid slot stay put."""
    npdt, tdt, x64 = DTYPES[dkey]
    args = _graph_problem(npdt)
    with jax.enable_x64(x64):
        j = [np.asarray(a) for a in jeg.optimize_essential_graph(
            *(jnp.asarray(a) for a in args), n_iters=20)]
    t = teg.optimize_essential_graph(*(_t(a) for a in args), n_iters=20)
    atol = 1e-8 if x64 else 2e-3
    for a, b in zip(t, j):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), b, atol=atol, rtol=0)
    for k in (0, 7):
        np.testing.assert_array_equal(_np(t[2])[k], args[2][k])
    assert np.abs(_np(t[2]) - args[2]).max() > 0.01        # the graph moved
    # the landmark sweep through the corrected Sim3s
    rs = np.random.RandomState(19)
    pts = rs.randn(40, 3).astype(npdt)
    ref = rs.randint(-1, 9, 40).astype(np.int32)
    pv = rs.rand(40) < 0.8
    with jax.enable_x64(x64):
        jp = np.asarray(jeg.correct_points_after_pose_graph(
            jnp.asarray(pts), jnp.asarray(ref), *(jnp.asarray(a) for a in args[:3]),
            *(jnp.asarray(a) for a in j), jnp.asarray(pv)))
    tp = teg.correct_points_after_pose_graph(_t(pts), _t(ref), *(_t(a) for a in args[:3]),
                                             *(_t(a) for a in j), _t(pv))
    np.testing.assert_allclose(_np(tp), jp, atol=1e-12 if x64 else 1e-5, rtol=0)
    np.testing.assert_array_equal(_np(tp)[~pv], pts[~pv])


# ---------------------------------------------------------------------------
# NavState global BA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dkey", ["f32", "f64"])
def test_global_ba_navstate(dkey):
    """The reference test's own map (keyframes on a constant-velocity line
    with consistent raw IMU windows). float64: poses, velocities and points
    to 1e-8. float32: positions within 2e-3 m and velocities within 5e-3
    m/s of the reference, the same observation set kept, and the reference
    test's own convergence assertions on the port's output."""
    from tests.test_global_ba import build_map

    npdt, tdt, x64 = DTYPES[dkey]
    m32, true_C, _ = build_map(K=5, P=64, F=64, with_imu=True, seed=1, S=24, dt=0.02)
    m = jax.tree_util.tree_map(lambda a: a.astype(npdt) if a.dtype == np.float32 else a,
                               _tree_np(m32))
    noise = (1.7e-4, 2e-3, 1e-9, 1e-8, 1.0 / 0.01 ** 2)
    g = np.asarray([0.0, 0.0, -9.81], npdt)
    with jax.enable_x64(x64):
        j = _tree_np(jgba.global_ba_navstate(
            jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(g), jnp.eye(3, dtype=npdt),
            jnp.zeros(3, npdt), FX, FY, CX, CY, *noise, jnp.ones((8,), npdt)))
    t = tgba.global_ba_navstate(convert.map_state(m), _t(g), torch.eye(3, dtype=tdt),
                                torch.zeros(3, dtype=tdt), FX, FY, CX, CY, *noise,
                                torch.ones(8, dtype=tdt))
    tol = dict(p=1e-8, v=1e-8, R=1e-8, pts=1e-8) if x64 else dict(p=2e-3, v=5e-3, R=1e-3,
                                                                    pts=1e-2)
    for f in ("p", "v", "R"):
        assert getattr(t.kf_ns, f).dtype == tdt
        np.testing.assert_allclose(_np(getattr(t.kf_ns, f)), getattr(j.kf_ns, f), atol=tol[f],
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(_np(t.pt_xyz), j.pt_xyz, atol=tol["pts"], rtol=0)
    np.testing.assert_array_equal(_np(t.kf_feat_pt), j.kf_feat_pt)
    err0 = np.linalg.norm(np.asarray(m.kf_ns.p[:5]) - true_C, axis=1)
    err1 = np.linalg.norm(_np(t.kf_ns.p)[:5] - true_C, axis=1)
    assert err1[1:].max() < 0.3 * err0[1:].max(), (err0, err1)
    v_err = np.linalg.norm(_np(t.kf_ns.v)[:5] - [0.4, 0.05, 0.0], axis=1)
    assert v_err.max() < 0.05, v_err
