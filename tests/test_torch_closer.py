"""Parity of the port's loop-closer functions with the reference, on the
CPU, on the reference tests' own fixtures (`tests/test_loop_closer.py`:
the looped map with a drifted revisit and the two-revisit map), carried
across with `convert.map_state`.

Candidates, accept decisions and inlier counts are exact. The fixtures'
matches are outlier-free, so the Sim3 does not depend on which minimal
samples RANSAC draws (the reference splits a PRNG key, the port draws
from a torch.Generator): s, R, t agree to 1e-4. Corrected keyframe
positions agree to 2e-3 after one essential graph (25 float32 LM steps on
a 0.4 drift) and to 5e-3 after two; the reference tests' own assertions
are made on the port's output.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.test_loop_closer import build_looped_map, build_two_loop_map
from tests.test_torch_stream import CAM4, _np, _port
from uvipslam_tpu.loop import closer as jcl
from uvipslam_torch.loop import closer as tcl
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def looped():
    with jax.enable_x64(False):
        return build_looped_map()


def test_detect_loop_candidates(looped):
    jm, _, _ = looped
    tm = _port(jm)
    np.testing.assert_array_equal(_np(tcl.kf_insertion_gap(tm, 9)),
                                  np.asarray(jcl.kf_insertion_gap(jm, 9)))
    for kw in (dict(min_gap=5), dict(min_gap=5, min_score=0.05), dict(min_gap=2, top_k=5),
               dict(min_gap=20)):
        ji, js = jcl.detect_loop_candidates(jm, query_kf=9, **kw)
        ti, ts = tcl.detect_loop_candidates(tm, query_kf=9, **kw)
        assert list(ti) == list(ji), kw
        np.testing.assert_allclose(ts, js, atol=1e-6)
    assert 0 in list(tcl.detect_loop_candidates(tm, query_kf=9, min_gap=5)[0])
    for th in (8, 15, 1000):
        for q in (9, 4):
            assert tcl.min_covisible_score(tm, q, th) == pytest.approx(
                jcl.min_covisible_score(jm, q, th), abs=1e-6)
            assert tcl.max_covisible_haloc(tm, q, th) == pytest.approx(
                jcl.max_covisible_haloc(jm, q, th), rel=1e-5)


def test_compute_loop_sim3_and_close_loop(looped):
    jm, true_C, est_C = looped
    tm = _port(jm)
    jok, js, jR, jt, jn, jtot = jcl.compute_loop_sim3(jm, 9, 0, jax.random.PRNGKey(0), *CAM4)
    tok, ts, tR, tt, tn, ttot = tcl.compute_loop_sim3(tm, 9, 0, torch.Generator().manual_seed(0),
                                                      *CAM4)
    assert tok and jok and (tn, ttot) == (jn, jtot)
    for a, b in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)
    assert abs(float(ts) - 1.0) < 0.05

    # the same verified Sim3 into both corrections
    s, R, t = np.asarray(js), np.asarray(jR), np.asarray(jt)
    jm2 = jcl.close_loop(jm, 9, 0, jnp.asarray(s), jnp.asarray(R), jnp.asarray(t), n_iters=25)
    tm2 = tcl.close_loop(tm, 9, 0, torch.from_numpy(s.copy()), torch.from_numpy(R.copy()),
                         torch.from_numpy(t.copy()), n_iters=25)
    np.testing.assert_allclose(_np(tm2.kf_ns.p), np.asarray(jm2.kf_ns.p), atol=2e-3)
    np.testing.assert_allclose(_np(tm2.kf_ns.R), np.asarray(jm2.kf_ns.R), atol=2e-3)
    np.testing.assert_allclose(_np(tm2.pt_xyz), np.asarray(jm2.pt_xyz), atol=2e-3)
    for f in ("loop_i", "loop_j", "n_loop"):
        np.testing.assert_array_equal(_np(getattr(tm2, f)), np.asarray(getattr(jm2, f)))
    np.testing.assert_allclose(_np(tm2.loop_t), np.asarray(jm2.loop_t), atol=1e-6)
    # the reference test's assertions, on the port's output
    C2 = _np(tm2.kf_ns.p)[:10]
    assert np.linalg.norm(C2[9] - C2[0]) < 0.08, C2[9] - C2[0]
    drift_before = np.linalg.norm(est_C[9] - true_C[9])
    assert np.linalg.norm(C2[9] - true_C[9]) < 0.5 * drift_before


def test_close_loop_reexpresses_velocity(looped):
    """Body NavStates behind camera-in-body extrinsics: the corrected
    poses go back through the extrinsics and each keyframe's velocity
    through the linear part of its correction."""
    jm, _, _ = looped
    rs = np.random.RandomState(0)
    v = rs.randn(10, 3).astype(np.float32)
    jm = dataclasses.replace(jm, kf_ns=dataclasses.replace(jm.kf_ns, v=jnp.asarray(v)))
    ang = 0.3
    Rbc = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    tbc = np.array([0.05, -0.02, 0.1], np.float32)
    Rcb, tcb = Rbc.T.copy(), -Rbc.T @ tbc
    _, s, R, t, _, _ = jcl.compute_loop_sim3(jm, 9, 0, jax.random.PRNGKey(0), *CAM4,
                                             Rcb=jnp.asarray(Rcb), tcb=jnp.asarray(tcb))
    jm2 = jcl.close_loop(jm, 9, 0, s, R, t, n_iters=25, Rcb=jnp.asarray(Rcb),
                         tcb=jnp.asarray(tcb), Rbc=jnp.asarray(Rbc), tbc=jnp.asarray(tbc))
    tm2 = tcl.close_loop(_port(jm), 9, 0, *(torch.from_numpy(np.array(a)) for a in (s, R, t)),
                         n_iters=25, Rcb=torch.from_numpy(Rcb), tcb=torch.from_numpy(tcb),
                         Rbc=torch.from_numpy(Rbc), tbc=torch.from_numpy(tbc))
    for f in ("p", "R", "v"):
        np.testing.assert_allclose(_np(getattr(tm2.kf_ns, f)), np.asarray(getattr(jm2.kf_ns, f)),
                                   atol=2e-3, err_msg=f)
    assert np.abs(_np(tm2.kf_ns.v)[9] - v[9]).max() > 1e-4      # the velocity did move


def test_second_loop_retains_first_edge():
    """The two-revisit map: after the second closure both revisit
    constraints hold, on both sides, through the retained loop edge."""
    K, half = 11, 5
    jm, true_C, est_C = build_two_loop_map(K=K)
    tm = _port(jm)
    for n, (q, seed) in enumerate(((half, 1), (K - 1, 2)), start=1):
        jok, js, jR, jt, jn, jtot = jcl.compute_loop_sim3(jm, q, 0, jax.random.PRNGKey(seed),
                                                          *CAM4)
        tok, ts, tR, tt, tn, ttot = tcl.compute_loop_sim3(
            tm, q, 0, torch.Generator().manual_seed(seed), *CAM4)
        assert jok and tok and (tn, ttot) == (jn, jtot)
        np.testing.assert_allclose(_np(tt), np.asarray(jt), atol=2e-3)
        jm = jcl.close_loop(jm, q, 0, js, jR, jt, n_iters=25)
        tm = tcl.close_loop(tm, q, 0, ts, tR, tt, n_iters=25)
        assert int(tm.n_loop) == int(jm.n_loop) == n
        np.testing.assert_allclose(_np(tm.kf_ns.p), np.asarray(jm.kf_ns.p), atol=5e-3)
    C = _np(tm.kf_ns.p)[:K]
    assert np.linalg.norm(C[half] - C[0]) < 0.08
    assert np.linalg.norm(C[K - 1] - C[0]) < 0.08
    from uvipslam_torch.io.synthetic import ate_rmse
    assert ate_rmse(C, true_C, align_scale=False)[0] < 0.5 * ate_rmse(est_C, true_C,
                                                                     align_scale=False)[0]


def test_gates_20_40_vs_10_10_same_decisions(looped):
    jm, _, _ = looped
    fv = np.array(jm.kf_feat_valid)
    fv[9, 16:] = False              # a low-texture revisit
    for m in (jm, dataclasses.replace(jm, kf_feat_valid=jnp.asarray(fv))):
        for gates in ((20, 40), (10, 10)):
            j = jcl.compute_loop_sim3(m, 9, 0, jax.random.PRNGKey(0), *CAM4,
                                      min_inliers=gates[0], min_total=gates[1])
            t = tcl.compute_loop_sim3(_port(m), 9, 0, torch.Generator().manual_seed(0), *CAM4,
                                      min_inliers=gates[0], min_total=gates[1])
            assert (t[0], t[4], t[5]) == (j[0], j[4], j[5]), gates
