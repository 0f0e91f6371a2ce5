"""Parity of the port's image ops, FAST/ORB, Hamming matching, two-view
RANSAC and track refill with the reference, on identical float32 inputs.

Tolerances:
  * reflect-101 filters, pyrDown, FAST/NMS/occupancy/grid top-k, ORB
    positions/levels/descriptors, Hamming distances and frame-0 track
    refill integer fields: exact (same arithmetic in the same order);
  * `resize_bilinear`: rtol 1e-4 + atol 1e-3 on a 0..255 scale. The
    reference's HIGHEST-precision einsum on the CPU is itself ~1e-3 off
    a float64 product at 120x160 (more at 512x640), the port's two
    float32 matmuls ~3e-5;
  * ORB scores (computed on resized levels): atol 2e-3; angles: 1e-5 rad;
  * RANSAC and reconstruction, fed the reference's own minimal samples:
    inlier sets and model choice exact, matrices and points atol 1e-4
    relative to their scale.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.io.synthetic import make_sequence
from uvipslam_tpu.frontend import frame as jframe
from uvipslam_tpu.ops import fast as jfast, hamming as jham, image as jimg
from uvipslam_tpu.ops import orb as jorb, twoview as jtv
from uvipslam_torch.frontend import frame as tframe
from uvipslam_torch.ops import fast as tfast, hamming as tham, image as timg
from uvipslam_torch.ops import orb as torb, twoview as ttv


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def frame0():
    seq = make_sequence(n_frames=1, H=120, W=160, n_points=800, seed=3, speed=1.2)
    return seq.images[0].astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(fn_j, fn_t, img):
    return fn_j(jnp.asarray(img)), fn_t(torch.from_numpy(img.copy()))


@pytest.mark.parametrize("op", ["blur", "pyr_down", "scharr_x", "scharr_y", "sobel_x",
                                "sobel_y", "box5"])
def test_image_filters_exact(frame0, op):
    fns = {
        "blur": (lambda x: jimg.gaussian_blur(x, 7, 2.0), lambda x: timg.gaussian_blur(x, 7, 2.0)),
        "pyr_down": (jimg.pyr_down, timg.pyr_down),
        "scharr_x": (lambda x: jimg.scharr_gradients(x)[0], lambda x: timg.scharr_gradients(x)[0]),
        "scharr_y": (lambda x: jimg.scharr_gradients(x)[1], lambda x: timg.scharr_gradients(x)[1]),
        "sobel_x": (lambda x: jimg.sobel_gradients(x)[0], lambda x: timg.sobel_gradients(x)[0]),
        "sobel_y": (lambda x: jimg.sobel_gradients(x)[1], lambda x: timg.sobel_gradients(x)[1]),
        "box5": (lambda x: jimg.box_filter(x, 5), lambda x: timg.box_filter(x, 5)),
    }[op]
    j, t = _both(*fns, frame0)
    np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("sampler", ["bilinear_sample", "nearest_sample"])
def test_image_samplers_match(frame0, sampler):
    """Continuous-position sampling with out-of-bounds padding: atol 1e-4
    on a 0..255 scale (the bilinear weights are summed in the same order)."""
    rs = np.random.RandomState(7)
    xy = np.concatenate([np.stack([rs.uniform(-3, 163, 300), rs.uniform(-3, 123, 300)], -1),
                         [[0.0, 0.0], [159.0, 119.0], [159.5, 60.0], [-0.5, -0.5]]])
    xy = xy.astype(np.float32)
    j = getattr(jimg, sampler)(jnp.asarray(frame0), jnp.asarray(xy), 7.0)
    t = getattr(timg, sampler)(torch.from_numpy(frame0.copy()), torch.from_numpy(xy), 7.0)
    np.testing.assert_allclose(_np(t), _np(j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind,dist", [(0, (-0.28, 0.07, 1e-3, -5e-4)),
                                       (1, (-0.01, 0.02, -0.005, 0.001)),
                                       (0, (0.0, 0.0, 0.0, 0.0))])
def test_camera_undistort_pixels_matches(kind, dist):
    """Radtan and Kannala-Brandt undistortion of pixels the reference
    distorted: atol 1e-4 px after the fixed-iteration solves."""
    from uvipslam_tpu.models.camera import CameraModel as JCam
    from uvipslam_torch.models.camera import CameraModel as TCam

    args = (458.654, 457.296, 367.215, 248.375)
    jc = JCam.create(*args, dist=dist, kind=kind, width=752, height=480)
    tc = TCam.create(*args, dist=dist, kind=kind, width=752, height=480)
    np.testing.assert_array_equal(tc.K, np.asarray(jc.K))
    rs = np.random.RandomState(8)
    pc = np.stack([rs.uniform(-0.7, 0.7, 200), rs.uniform(-0.45, 0.45, 200),
                   np.ones(200)], -1).astype(np.float32)
    uv = np.array(jc.project(jnp.asarray(pc)))
    j = np.asarray(jc.undistort_pixels(jnp.asarray(uv)))
    t = tc.undistort_pixels(torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    ideal = pc[:, :2] * np.array([args[0], args[1]]) + np.array([args[2], args[3]])
    np.testing.assert_allclose(t, ideal, atol=1e-2)     # the solve converged


@pytest.mark.parametrize("level", range(1, 8))
def test_resize_bilinear_at_orb_scales(frame0, level):
    s = 1.2 ** level
    for H, W, img in [(120, 160, frame0),
                      (512, 640, np.kron(frame0, np.ones((4, 4), np.float32))[:512, :640])]:
        hw = (int(round(H / s)), int(round(W / s)))
        j, t = _both(lambda x: jimg.resize_bilinear(x, hw),
                     lambda x: timg.resize_bilinear(x, hw), img)
        assert t.shape == j.shape
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-3, rtol=1e-4)


def test_fast_nms_occupancy_grid_exact(frame0):
    hj, lj = jfast.fast_response2(jnp.asarray(frame0), 20.0, 5.0)
    ht, lt = tfast.fast_response2(torch.from_numpy(frame0.copy()), 20.0, 5.0)
    np.testing.assert_array_equal(_np(ht), _np(hj))
    np.testing.assert_array_equal(_np(lt), _np(lj))
    rj = jfast.nms(hj + 1e-4 * lj)
    rt = tfast.nms(ht + 1e-4 * lt)
    np.testing.assert_array_equal(_np(rt), _np(rj))
    rs = np.random.RandomState(0)
    occ = rs.uniform(-5, 165, (60, 2)).astype(np.float32)
    msk = rs.uniform(size=60) > 0.2
    oj = jfast.occupancy_suppress(rj, jnp.asarray(occ), jnp.asarray(msk), 7.0)
    ot = tfast.occupancy_suppress(rt, torch.from_numpy(occ), torch.from_numpy(msk), 7.0)
    np.testing.assert_array_equal(_np(ot), _np(oj))
    for cell, k in [(20, 30), (8, 500)]:
        for a, b in zip(jfast.grid_topk(oj, cell, k), tfast.grid_topk(ot, cell, k)):
            np.testing.assert_array_equal(_np(b), _np(a))


def test_extract_orb_matches(frame0):
    rs = np.random.RandomState(1)
    occ = rs.uniform(0, 160, (100, 2)).astype(np.float32)
    msk = rs.uniform(size=100) > 0.5
    fj = jorb.extract_orb(jnp.asarray(frame0), jnp.asarray(occ), jnp.asarray(msk),
                          n_features=100, steer=False)
    ft = torb.extract_orb(torch.from_numpy(frame0.copy()), torch.from_numpy(occ),
                          torch.from_numpy(msk), n_features=100)
    for k in ("xy", "level", "valid", "desc"):
        np.testing.assert_array_equal(_np(getattr(ft, k)), _np(getattr(fj, k)), err_msg=k)
    np.testing.assert_allclose(_np(ft.score), _np(fj.score), atol=2e-3, rtol=0)
    np.testing.assert_allclose(_np(ft.angle), _np(fj.angle), atol=1e-5, rtol=0)
    assert _np(ft.valid).sum() > 15


def test_hamming_matrix_exact():
    rs = np.random.RandomState(2)
    a = rs.randint(0, 2, (70, 256)).astype(np.int8)
    b = rs.randint(0, 2, (90, 256)).astype(np.int8)
    j = jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    t = tham.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(_np(t), ref)
    np.testing.assert_array_equal(_np(t), _np(j))


def test_match_best_with_window_matches():
    """Best-match search with a pixel window and ratio test: exact."""
    rs = np.random.RandomState(9)
    a = rs.randint(0, 2, (80, 256)).astype(np.int8)
    b = a[rs.permutation(80)[:60]].copy()
    flip = rs.uniform(size=b.shape) < 0.08
    b[flip] = 1 - b[flip]
    b = np.concatenate([b, rs.randint(0, 2, (40, 256)).astype(np.int8)])
    xa = rs.uniform(0, 160, (80, 2)).astype(np.float32)
    xb = rs.uniform(0, 160, (100, 2)).astype(np.float32)
    va = rs.uniform(size=80) > 0.1
    vb = rs.uniform(size=100) > 0.1
    for radius in (9.0, 200.0):
        pj = jham.window_mask(jnp.asarray(xa), jnp.asarray(xb), radius)
        pt = tham.window_mask(torch.from_numpy(xa), torch.from_numpy(xb), radius)
        np.testing.assert_array_equal(_np(pt), _np(pj))
        for max_dist, ratio in [(jham.TH_HIGH, 0.9), (jham.TH_LOW, 1.0)]:
            j = jham.match_best(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                jnp.asarray(vb), pair_mask=pj, max_dist=max_dist, ratio=ratio)
            t = tham.match_best(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(va),
                                torch.from_numpy(vb), pair_mask=pt, max_dist=max_dist,
                                ratio=ratio)
            for x, y in zip(j, t):
                np.testing.assert_array_equal(_np(y), _np(x))
    assert _np(t[2]).sum() > 20


def _two_view_scene(planar: bool, seed=0, n=150):
    rs = np.random.RandomState(seed)
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1.0]], np.float32)
    z = np.full(n, 4.0) if planar else rs.uniform(3, 8, n)
    X = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n), z], -1)
    a = np.array([0.02, -0.12, 0.03])
    th = np.linalg.norm(a)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.6, 0.05, 0.02])

    def proj(P):
        return (K @ (P / P[:, 2:3]).T).T[:, :2]

    x1 = proj(X) + rs.randn(n, 2) * 0.3
    x2 = proj(X @ R.T + t) + rs.randn(n, 2) * 0.3
    out = rs.choice(n, n // 5, replace=False)
    x2[out] += rs.uniform(30, 120, (len(out), 2)) * rs.choice([-1, 1], (len(out), 2))
    valid = rs.uniform(size=n) > 0.05
    return K, x1.astype(np.float32), x2.astype(np.float32), valid


def _normalized(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def test_find_fundamental_with_injected_samples():
    _, x1, x2, valid = _two_view_scene(planar=False)
    key = jax.random.PRNGKey(11)
    idx = np.array(jtv._sample_minimal(key, 200, 8, jnp.asarray(valid)))
    Fj, sj, ij = jtv.find_fundamental(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid))
    Ft, st, it = ttv.find_fundamental(None, torch.from_numpy(x1), torch.from_numpy(x2),
                                      torch.from_numpy(valid), idx=torch.from_numpy(idx).long())
    np.testing.assert_array_equal(_np(it), _np(ij))
    np.testing.assert_allclose(_normalized(_np(Ft)), _normalized(Fj), atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-4)
    assert _np(it).sum() > 90


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_with_injected_samples(planar):
    K, x1, x2, valid = _two_view_scene(planar=planar, seed=3)
    key = jax.random.PRNGKey(5)
    kf_, kh_ = jax.random.split(key)
    idx_f = np.array(jtv._sample_minimal(kf_, 200, 8, jnp.asarray(valid)))
    idx_h = np.array(jtv._sample_minimal(kh_, 200, 4, jnp.asarray(valid)))
    rj = jtv.initialize_two_view(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                 jnp.asarray(K))
    rt = ttv.initialize_two_view(None, torch.from_numpy(x1), torch.from_numpy(x2),
                                 torch.from_numpy(valid), torch.from_numpy(K),
                                 idx_f=torch.from_numpy(idx_f).long(),
                                 idx_h=torch.from_numpy(idx_h).long())
    for k in ("used_homography", "ok", "inliers", "good"):
        np.testing.assert_array_equal(_np(rt[k]), _np(rj[k]), err_msg=k)
    assert bool(rj["ok"]) and bool(rj["used_homography"]) == planar
    np.testing.assert_allclose(_np(rt["R"]), _np(rj["R"]), atol=1e-4)
    np.testing.assert_allclose(_np(rt["t"]), _np(rj["t"]), atol=1e-4)
    good = _np(rj["good"])
    scale = np.abs(_np(rj["points"])[good]).max()
    np.testing.assert_allclose(_np(rt["points"])[good], _np(rj["points"])[good],
                               atol=1e-4 * scale)


def test_refill_tracks_frame0_matches(frame0):
    tj = jframe.refill_tracks(jframe.Tracks.empty(100), jnp.asarray(frame0),
                              jnp.asarray(0, jnp.int32), n_features=100, px_distance=20)
    tt = tframe.refill_tracks(tframe.Tracks.empty(100), torch.from_numpy(frame0.copy()),
                              torch.zeros((), dtype=torch.int32), n_features=100,
                              px_distance=20)
    for f in ("xy", "desc", "level", "valid", "pt_id", "birth_frame", "age"):
        np.testing.assert_array_equal(_np(getattr(tt, f)), _np(getattr(tj, f)), err_msg=f)
    np.testing.assert_allclose(_np(tt.angle), _np(tj.angle), atol=1e-5, rtol=0)
    for f in ("tpl", "tpl_gx", "tpl_gy", "tpl2", "tpl2_gx", "tpl2_gy"):
        np.testing.assert_allclose(_np(getattr(tt, f)), _np(getattr(tj, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    assert _np(tt.valid).sum() >= 90
