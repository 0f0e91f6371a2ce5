"""The last public frontend functions of the port against the reference,
on the same seeded numpy inputs (CPU, float32).

- `ic_angles` within 1e-5 rad of the reference run in float64. The
  port sums the moments in float64 (see its docstring); the reference's
  float32 moments round by XLA's order of summation, so where a centroid
  is weak its float32 angle moves by tens of microradians (its eager and
  jitted forms differ by up to 3.9e-5 rad on this texture; printed).
- `extract_orb` with its default arguments, which steer BRIEF
  (`ic_angles`, `brief_descriptors`), and with the Harris ranking
  (`score_type=1`), steered and unsteered, against the float32
  reference: keypoints, levels and validity exactly, scores within 1e-5
  relative. Steered angles within 1e-5 rad of the reference's angles at
  its own keypoints and blurred levels with the moments in float64, as
  above (against its float32 angles up to 1.2e-4 apart; printed);
  unsteered angles within 1e-4 rad (both sides' moments are float32
  matrix products in other orders: 2.1e-5 apart at worst here). Bits
  exactly except at pattern points whose rotated coordinate lies within
  1e-3 px of a half pixel, widened by the point's radius times the two
  angles' difference: a rounding of the angle or of the rotation's
  products takes the other pixel there. Their count is printed.
- `fast_response` exactly; `harris_response` within 1e-6 of its scale.
- `klt_track` on the fixtures of tests/test_ops_frontend.py (a known
  translation, an out-of-bounds guess): points within 1e-3 px and `ok`
  exactly.
- The slow template forms `extract_templates` and `anchor_refine`:
  templates within 1e-4, refined points within 1e-3 px, acceptance
  exactly.
- `bow_node_mask` exactly; `epipolar_band_mask` exactly except where the
  point's distance to the line lies within 1e-4 px of the band.
- `train_codebook` bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.loop import vocab as jvocab
from uvipslam_tpu.ops import fast as jfast, hamming as jham, image as jimg
from uvipslam_tpu.ops import klt as jklt, orb as jorb
from uvipslam_torch.loop import vocab as tvocab
from uvipslam_torch.ops import fast as tfast, hamming as tham
from uvipslam_torch.ops import klt as tklt, orb as torb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HALF_BAND = 1e-3     # px: a rotated pattern coordinate this close to a half may round either way


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def checker_texture(h=240, w=320, seed=0):
    """tests/test_ops_frontend.py's texture: 8x8 blocks plus noise."""
    rs = np.random.RandomState(seed)
    img = rs.uniform(40, 220, (h // 8, w // 8))
    img = np.kron(img, np.ones((8, 8)))
    img += rs.uniform(-5, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _near_half_bits(xy, level, angle, dangle, valid, scale=1.2):
    """[N, 256] True where one of a bit's two rotated pattern points has a
    coordinate within HALF_BAND + its radius x |dangle| of a half pixel on
    its level (at the reference's angle)."""
    s = np.float32(scale) ** level.astype(np.float32)
    xl = np.round(xy / s[:, None])            # grid positions are whole pixels
    ca, sa = np.cos(angle.astype(np.float64)), np.sin(angle.astype(np.float64))
    pat = torb.BRIEF_PATTERN.astype(np.float64)
    near = np.zeros((len(xy), torb.N_BITS), bool)
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        band = HALF_BAND + np.hypot(px, py)[None] * np.abs(dangle)[:, None]
        for c in (xl[:, :1] + px * ca[:, None] - py * sa[:, None],
                  xl[:, 1:] + px * sa[:, None] + py * ca[:, None]):
            near |= np.abs(np.abs(c - np.floor(c)) - 0.5) < band
    return near & valid[:, None]


def _reference_angles_f64(img, fj, scale=1.2):
    """The reference's `ic_angles` at its own keypoints on its own float32
    blurred pyramid levels, with the moments in float64."""
    n_levels = 8
    while n_levels > 1 and min(img.shape) / scale ** (n_levels - 1) < 40:
        n_levels -= 1
    xy, level, valid = _np(fj.xy), _np(fj.level), _np(fj.valid)
    out = np.zeros(len(xy))
    for l, im in enumerate(jorb.build_pyramid(jnp.asarray(img), n_levels, scale)):
        blur = np.asarray(jimg.gaussian_blur(im, 7, 2.0), np.float64)
        xy_l = np.round(xy / np.float32(scale ** l)).astype(np.float32)
        with jax.enable_x64(True):
            a = np.asarray(jorb.ic_angles(jnp.asarray(blur), jnp.asarray(xy_l),
                                          jnp.asarray(valid & (level == l))))
        out = np.where(level == l, a, out)
    return out


def _compare_features(ft, fj, img, steer, label):
    for k in ("xy", "level", "valid"):
        np.testing.assert_array_equal(_np(getattr(ft, k)), _np(getattr(fj, k)), err_msg=k)
    np.testing.assert_allclose(_np(ft.score), _np(fj.score), atol=2e-3, rtol=1e-5)
    at, aj = _np(ft.angle), _np(fj.angle)
    if steer:
        np.testing.assert_allclose(at, _reference_angles_f64(img, fj), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(at, aj, atol=1e-4, rtol=0)
    dt, dj = _np(ft.desc), _np(fj.desc)
    near = _near_half_bits(_np(fj.xy), _np(fj.level), aj, at - aj, _np(fj.valid))
    off = dt != dj
    print(f"{label}: angles up to {np.abs(at - aj).max():.3g} rad from the float32 reference; "
          f"{int(near.sum())} of {int(_np(fj.valid).sum()) * 256} bits at pattern points near a "
          f"half, {int(off.sum())} differ")
    assert not (off & ~near).any(), np.argwhere(off & ~near)[:10]
    assert _np(fj.valid).sum() > 50


def test_ic_angles_match_reference_in_float64():
    img = np.asarray(jimg.gaussian_blur(jnp.asarray(checker_texture()), 7, 2.0))
    rs = np.random.RandomState(1)
    xy = np.stack([rs.randint(-5, 325, 400), rs.randint(-5, 245, 400)], -1).astype(np.float32)
    xy[:50] += rs.uniform(-0.99, 0.99, (50, 2)).astype(np.float32)   # truncated toward zero
    valid = rs.uniform(size=400) > 0.1
    t = torb.ic_angles(_t(img), _t(xy), _t(valid)).numpy()
    with jax.enable_x64(True):
        j64 = np.asarray(jorb.ic_angles(jnp.asarray(img, jnp.float64), jnp.asarray(xy),
                                        jnp.asarray(valid)))
    np.testing.assert_allclose(t, j64, atol=1e-5, rtol=0)
    args = (jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid))
    eager = np.asarray(jorb.ic_angles(*args))
    jitted = np.asarray(jax.jit(jorb.ic_angles)(*args))
    print(f"float32 reference, eager vs jitted: {np.abs(eager - jitted).max():.3g} rad; "
          f"port vs float64 reference: {np.abs(t - j64).max():.3g} rad")
    assert (t[~valid] == 0).all()


def test_extract_orb_default_call_matches_reference():
    """The call with default arguments steers BRIEF in both packages."""
    img = checker_texture()
    fj = jorb.extract_orb(jnp.asarray(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                          n_features=200)
    ft = torb.extract_orb(_t(img), torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool),
                          n_features=200)
    _compare_features(ft, fj, img, True, "default")


@pytest.mark.parametrize("steer", [True, False])
def test_extract_orb_harris_ranking_matches_reference(steer):
    """`score_type=1`, with tracked points to suppress; every FAST-positive
    pixel with a negative Harris response ties at 1e-6, and the grid's
    lowest-index rule picks among the ties."""
    img = checker_texture(seed=2)
    rs = np.random.RandomState(4)
    occ = rs.uniform(0, 320, (120, 2)).astype(np.float32)
    msk = rs.uniform(size=120) > 0.5
    kw = dict(n_features=1000, steer=steer, score_type=1)
    fj = jorb.extract_orb(jnp.asarray(img), jnp.asarray(occ), jnp.asarray(msk), **kw)
    ft = torb.extract_orb(_t(img), _t(occ), _t(msk), **kw)
    _compare_features(ft, fj, img, steer, f"harris steer={steer}")
    s = _np(fj.score)[_np(fj.valid)]
    assert (s == np.float32(1e-6)).any(), "no candidate on the 1e-6 plateau"


def test_steered_bits_survive_rotation():
    """The reference's steered-BRIEF rotation test through the port: a
    90-degree rotation of the image keeps matches on the rotated points."""
    base = checker_texture(200, 200, seed=5)
    no_occ = (torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool))
    fa = torb.extract_orb(_t(base), *no_occ, n_features=100)
    fb = torb.extract_orb(_t(np.rot90(base).copy()), *no_occ, n_features=100)
    idx, _, ok = tham.match_best(fa.desc, fb.desc, fa.valid, fb.valid, max_dist=70.0,
                                 ratio=0.85)
    ok = ok.numpy()
    assert ok.sum() >= 8
    xa, xb = fa.xy.numpy()[ok], fb.xy.numpy()[idx.numpy()[ok]]
    pred = np.stack([xa[:, 1], 200 - 1 - xa[:, 0]], -1)
    assert np.median(np.linalg.norm(pred - xb, axis=1)) < 3.0


@pytest.mark.parametrize("which", ["corner", "texture"])
def test_fast_and_harris_responses_match_reference(which):
    if which == "corner":
        img = np.full((120, 160), 50.0, np.float32)
        img[30:, 40:] = 200.0
    else:
        img = checker_texture()
    for t in (20.0, 5.0):
        np.testing.assert_array_equal(tfast.fast_response(_t(img), t).numpy(),
                                      np.asarray(jfast.fast_response(jnp.asarray(img), t)))
    hj = np.asarray(jfast.harris_response(jnp.asarray(img)))
    ht = tfast.harris_response(_t(img)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-6 * np.abs(hj).max())
    np.testing.assert_array_equal(np.sign(ht[np.abs(hj) > 1e-3 * np.abs(hj).max()]),
                                  np.sign(hj[np.abs(hj) > 1e-3 * np.abs(hj).max()]))


def _shifted_pair(dx=6.3, dy=-3.7):
    """tests/test_ops_frontend.py::test_recovers_known_translation's
    inputs: a blurred texture and its sub-pixel shift, and the tracked
    points (the reference's detections, away from the border)."""
    base = np.asarray(jimg.gaussian_blur(jnp.asarray(checker_texture(300, 400, seed=7)), 5, 1.2))
    H, W = 240, 320
    A = base[30:30 + H, 40:40 + W].copy()
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    B = np.asarray(jimg.bilinear_sample(jnp.asarray(base),
                                        jnp.asarray(np.stack([xs + 40 + dx, ys + 30 + dy], -1))))
    feats = jorb.extract_orb(jnp.asarray(A), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                             n_features=80)
    pts = np.asarray(feats.xy)
    valid = np.asarray(feats.valid) & (pts[:, 0] > 30) & (pts[:, 0] < W - 30) & \
        (pts[:, 1] > 30) & (pts[:, 1] < H - 30)
    return A, B, pts, valid


def test_klt_track_recovers_translation_as_reference():
    A, B, pts, valid = _shifted_pair()
    kw = dict(win=21, iters=10, levels=4)
    nj, okj = jklt.klt_track(tuple(jklt.build_flow_pyramid(jnp.asarray(A), 4)),
                             tuple(jklt.build_flow_pyramid(jnp.asarray(B), 4)),
                             jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid), **kw)
    nt, okt = tklt.klt_track(tklt.build_flow_pyramid(_t(A), 4), tklt.build_flow_pyramid(_t(B), 4),
                             _t(pts), _t(pts), _t(valid), **kw)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-3, rtol=0)
    ok = okt.numpy()
    assert ok.sum() >= 10
    med = np.median(nt.numpy()[ok] - pts[ok], axis=0)
    assert abs(med[0] + 6.3) < 0.3 and abs(med[1] - 3.7) < 0.3, med


def test_klt_track_rejects_out_of_bounds_as_reference():
    img = checker_texture()
    pts = np.asarray([[5.0, 5.0], [150.0, 100.0]], np.float32)
    guess = np.asarray([[-50.0, -50.0], [150.0, 100.0]], np.float32)
    kw = dict(win=21, iters=5, levels=3)
    nj, okj = jklt.klt_track(tuple(jklt.build_flow_pyramid(jnp.asarray(img), 3)),
                             tuple(jklt.build_flow_pyramid(jnp.asarray(img), 3)),
                             jnp.asarray(pts), jnp.asarray(guess), jnp.ones(2, bool), **kw)
    pyr = tklt.build_flow_pyramid(_t(img), 3)
    nt, okt = tklt.klt_track(pyr, pyr, _t(pts), _t(guess), torch.ones(2, dtype=torch.bool), **kw)
    assert okt.tolist() == np.asarray(okj).tolist() == [False, True]
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-3, rtol=0)


def test_slow_template_forms_match_reference():
    """`extract_templates` at the birth positions in A, then
    `anchor_refine` from perturbed starts in the shifted B."""
    A, B, pts, valid = _shifted_pair(dx=0.6, dy=-0.4)
    Tj = jklt.extract_templates(jnp.asarray(A), jnp.asarray(pts), win=21)
    Tt = tklt.extract_templates(_t(A), _t(pts), win=21)
    for a, b in zip(Tt, Tj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    rs = np.random.RandomState(11)
    start = (pts - [0.6, -0.4] + rs.uniform(-0.8, 0.8, pts.shape)).astype(np.float32)
    for kw in (dict(), dict(win=13, iters=4, max_correction=1.0, max_residual=3.0)):
        T = [np.asarray(x) for x in (jklt.extract_templates(jnp.asarray(A), jnp.asarray(pts),
                                                              win=kw.get("win", 21)))]
        oj, aj = jklt.anchor_refine(jnp.asarray(B), *map(jnp.asarray, T), jnp.asarray(start),
                                    jnp.asarray(valid), **kw)
        ot, at = tklt.anchor_refine(_t(B), *map(_t, T), _t(start), _t(valid), **kw)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-3, rtol=0)
    assert np.asarray(aj).sum() >= 5 and (~np.asarray(aj) & valid).sum() >= 1


def test_matching_masks_match_reference():
    rs = np.random.RandomState(12)
    wa, wb = rs.randint(0, 6, 40), rs.randint(0, 6, 55)
    np.testing.assert_array_equal(tham.bow_node_mask(_t(wa), _t(wb)).numpy(),
                                  np.asarray(jham.bow_node_mask(jnp.asarray(wa), jnp.asarray(wb))))
    F = rs.randn(3, 3).astype(np.float32)
    F[2] *= 1e-2
    F[:, 2] *= 1e-2
    x1 = rs.uniform(0, 320, (40, 2)).astype(np.float32)
    x2 = rs.uniform(0, 320, (55, 2)).astype(np.float32)
    x1h = np.concatenate([x1, np.ones((40, 1))], 1).astype(np.float64)
    l2 = x1h @ F.astype(np.float64).T
    d = np.abs(l2[:, None, 0] * x2[None, :, 0] + l2[:, None, 1] * x2[None, :, 1] + l2[:, None, 2])
    d /= np.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
    for band in (8.0, rs.uniform(2, 30, 55).astype(np.float32)):
        jm = np.asarray(jham.epipolar_band_mask(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2),
                                                band if np.isscalar(band) else jnp.asarray(band)))
        tm = tham.epipolar_band_mask(_t(F), _t(x1), _t(x2),
                                     band if np.isscalar(band) else _t(band)).numpy()
        edge = np.abs(d - np.broadcast_to(band, d.shape)) < 1e-4
        assert not ((tm != jm) & ~edge).any()
        assert 20 < jm.sum() < jm.size - 20


@pytest.mark.parametrize("m,n_words", [(600, 32), (20, 32)])
def test_train_codebook_bit_equal(m, n_words):
    """On the same descriptors, the same codebook; with fewer descriptors
    than words the draws repeat and empty clusters re-seed."""
    descs = (np.random.RandomState(13).rand(m, 256) > 0.5).astype(np.int8)
    j = jvocab.train_codebook(descs, n_words=n_words, n_iters=3, seed=4)
    t = tvocab.train_codebook(descs, n_words=n_words, n_iters=3, seed=4)
    assert t.dtype == j.dtype == np.int8 and t.shape == (n_words, 256)
    np.testing.assert_array_equal(t, j)
