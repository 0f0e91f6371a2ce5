"""Parity of the port's patch extraction and anchor refinement
(uvipslam_torch/ops/klt.py) with the reference (uvipslam_tpu/ops/klt.py),
on identical float32 inputs made with numpy.

Tolerances: patch extraction is a pure copy, so patches and `local` must
match bit for bit (NaN where the reference has NaN). The sampling and
Gauss-Newton stages sum float32 products in another order than XLA, so
they are held at atol 1e-4 (pixels, and intensities on a 0..255 scale).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.ops import klt as jklt
from uvipslam_torch.ops import klt as tklt
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def smooth_image(h=96, w=128, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0, 255, (h // 4 + 2, w // 4 + 2)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))[:h, :w]
    # separable box smoothing so bilinear sampling has gradients
    k = np.ones(5, np.float32) / 5
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return np.ascontiguousarray(img, dtype=np.float32)


def probe_points(h, w, seed=0):
    """Interior, border, outside and non-finite positions."""
    rs = np.random.RandomState(seed)
    inner = np.stack([rs.uniform(0, w, 40), rs.uniform(0, h, 40)], -1)
    edges = np.array([[0.0, 0.0], [w - 1e-3, h - 1e-3], [0.5, h / 2], [w / 2, 0.2],
                      [w - 0.5, h / 2], [w / 2, h - 0.7]])
    outside = np.array([[-5.3, 10.0], [w + 7.1, 3.0], [10.0, -40.0], [20.0, h + 90.0],
                        [-1e12, 5.0], [5.0, 3e9]])
    nonfinite = np.array([[np.nan, 10.0], [10.0, np.nan], [np.inf, 5.0], [5.0, -np.inf],
                          [-np.inf, np.inf]])
    return np.concatenate([inner, edges, outside, nonfinite]).astype(np.float32)


@pytest.mark.parametrize("psize", [19, 25, 27, 35])
def test_plain_extract_patches_bit_exact(psize):
    img = smooth_image()
    pts = probe_points(*img.shape)
    jp, jl = jklt._extract_patches(jnp.asarray(img), jnp.asarray(pts), psize)
    tp, tl = tklt.extract_patches_any(torch.from_numpy(img), torch.from_numpy(pts), psize)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_extract_patches_rejects_bad_arguments():
    img = torch.zeros((40, 50))
    pts = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        tklt.extract_patches_any(img, pts, 41)
    with pytest.raises(TypeError):
        tklt.extract_patches_any(img.double(), pts, 19)
    with pytest.raises(ValueError):
        tklt.extract_patches_any(torch.zeros((50, 40)).T, pts, 19)


def test_refine_psize_limit_is_the_kernels():
    """`_check_refine_args` refuses what csrc/anchor_refine.cu refuses:
    its limit is the kernel's kMaxPsize, read from the source."""
    src = (Path(tklt.__file__).parents[1] / "csrc" / "anchor_refine.cu").read_text()
    found = re.findall(r"constexpr int kMaxPsize = (\d+);", src)
    assert [int(v) for v in found] == [tklt.MAX_REFINE_PSIZE]


@pytest.mark.parametrize("win,max_correction", [(13, 19.0), (14, 19.0)])
def test_refine_args_hold_the_psize_limit(win, max_correction):
    psize = tklt.refine_psize(win, max_correction)
    n = 3
    img = torch.zeros((64, 64))
    z = torch.zeros((n, win * win))
    args = (img, z, z, z, torch.zeros((n, 2)), torch.ones(n, dtype=torch.bool), win, 8,
            max_correction)
    if psize <= tklt.MAX_REFINE_PSIZE:
        assert psize == 55
        tklt._check_refine_args(*args)
    else:
        assert psize == 56
        with pytest.raises(ValueError, match="above 55"):
            tklt._check_refine_args(*args)


def test_cpu_dispatch_does_not_count_launches():
    before = (tklt.patch_launches, tklt.refine_launches)
    img = torch.from_numpy(smooth_image())
    pts = torch.from_numpy(probe_points(96, 128))
    tklt.extract_patches_any(img, pts, 19)
    T, Tx, Ty = tklt.extract_templates_fast(img, pts[:40])
    tklt.anchor_refine_fast(img, T, Tx, Ty, pts[:40], torch.ones(40, dtype=torch.bool))
    assert (tklt.patch_launches, tklt.refine_launches) == before


def test_sample_patch_matches():
    rs = np.random.RandomState(3)
    patches = rs.uniform(0, 255, (30, 27, 27)).astype(np.float32)
    center = rs.uniform(7, 19, (30, 2)).astype(np.float32)
    j = jklt._sample_patch(jnp.asarray(patches), jnp.asarray(center), 13)
    t = tklt._sample_patch(torch.from_numpy(patches), torch.from_numpy(center), 13)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _shifted_pair(seed=1):
    """Image b is image a resampled at a sub-pixel shift."""
    a = smooth_image(seed=seed)
    h, w = a.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    b = np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.asarray(a), [jnp.asarray(ys - 0.6), jnp.asarray(xs - 1.3)], order=1,
        mode="nearest"))
    return a, b.astype(np.float32)


def test_extract_templates_fast_matches():
    a, _ = _shifted_pair()
    rs = np.random.RandomState(4)
    pts = np.stack([rs.uniform(12, 116, 64), rs.uniform(12, 84, 64)], -1).astype(np.float32)
    j = jklt.extract_templates_fast(jnp.asarray(a), jnp.asarray(pts), win=13)
    t = tklt.extract_templates_fast(torch.from_numpy(a), torch.from_numpy(pts), win=13)
    for jj, tt in zip(j, t):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jj), atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_correction,iters", [(4.0, 8), (5.0, 10)])
def test_anchor_refine_fast_matches(max_correction, iters):
    a, b = _shifted_pair()
    rs = np.random.RandomState(5)
    pts = np.stack([rs.uniform(14, 114, 64), rs.uniform(14, 82, 64)], -1).astype(np.float32)
    T, Tx, Ty = (np.array(x) for x in jklt.extract_templates_fast(
        jnp.asarray(a), jnp.asarray(pts), win=13))
    start = (pts + np.array([1.0, 0.4], np.float32)
             + rs.uniform(-0.5, 0.5, pts.shape).astype(np.float32))
    valid = rs.uniform(size=64) > 0.1
    kw = dict(win=13, iters=iters, max_correction=max_correction, max_residual=32.0)
    jo, ja = jklt.anchor_refine_fast(jnp.asarray(b), jnp.asarray(T), jnp.asarray(Tx),
                                     jnp.asarray(Ty), jnp.asarray(start),
                                     jnp.asarray(valid), **kw)
    to, ta = tklt.anchor_refine_fast(torch.from_numpy(b), torch.from_numpy(T),
                                     torch.from_numpy(Tx), torch.from_numpy(Ty),
                                     torch.from_numpy(start), torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    assert np.asarray(ja).sum() > 30   # the refinement really converged


def _edge_starts(case, h, w):
    """Start points whose refinement takes the plain form's edge paths:
    a first sample far outside the patch (a clipped corner), a position
    absorbed by a huge coordinate, NaN/inf, or a track marked invalid."""
    return {
        "outside": [[-7.5, 20.0], [-0.6, 40.0], [w + 2.5, 30.0], [w + 40.0, 50.0],
                    [60.0, -3.2], [70.0, h + 0.4], [-30.0, -30.0], [w + 9.0, h + 9.0]],
        "huge": [[-1e12, 40.0], [1e12, 40.0], [60.0, -1e12], [60.0, 1e12], [3e9, 5.0],
                 [-1e12, 1e12]],
        "nonfinite": [[np.nan, 30.0], [30.0, np.nan], [np.inf, 40.0], [40.0, -np.inf],
                      [-np.inf, np.inf], [np.nan, np.nan]],
        "invalid": [],
    }[case]


@pytest.mark.parametrize("case", ["outside", "huge", "nonfinite", "invalid"])
@pytest.mark.parametrize("max_correction,iters", [(4.0, 8), (5.0, 10)])
def test_anchor_refine_fast_edge_cases(case, max_correction, iters):
    """The plain port against the reference where the kernel's traps lie:
    `accept` equal, `out` at ATOL, NaN where NaN (rejected tracks keep
    their start point exactly)."""
    a, b = _shifted_pair()
    h, w = a.shape
    rs = np.random.RandomState(6)
    pts = np.stack([rs.uniform(14, 114, 32), rs.uniform(14, 82, 32)], -1).astype(np.float32)
    T, Tx, Ty = (np.array(x) for x in jklt.extract_templates_fast(
        jnp.asarray(a), jnp.asarray(pts), win=13))
    start = pts + np.array([1.0, 0.4], np.float32)
    edge = np.asarray(_edge_starts(case, h, w), np.float32).reshape(-1, 2)
    start[:len(edge)] = edge
    valid = np.ones(32, bool)
    if case == "invalid":
        valid[::2] = False
    kw = dict(win=13, iters=iters, max_correction=max_correction, max_residual=32.0)
    jo, ja = jklt.anchor_refine_fast(jnp.asarray(b), jnp.asarray(T), jnp.asarray(Tx),
                                     jnp.asarray(Ty), jnp.asarray(start),
                                     jnp.asarray(valid), **kw)
    to, ta = tklt.anchor_refine_fast(torch.from_numpy(b), torch.from_numpy(T),
                                     torch.from_numpy(Tx), torch.from_numpy(Ty),
                                     torch.from_numpy(start), torch.from_numpy(valid), **kw)
    ja, jo = np.asarray(ja), np.asarray(jo)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(to.numpy()[~ja], start[~ja])
    assert not ja[:len(edge)].any() and not ja[~valid].any()
    assert ja[len(edge):][valid[len(edge):]].sum() >= 0.8 * valid[len(edge):].sum()


@pytest.mark.parametrize("win,max_correction,fits", [
    (13, 4.0, True), (11, 5.0, True), (13, 19.0, True), (16, 4.0, True),
    (17, 4.0, False), (13, 20.0, False), (14, 19.0, False)])
def test_refine_route_is_a_function_of_the_shape(win, max_correction, fits):
    """The card's route of `anchor_refine_fast` is chosen from (win,
    max_correction) alone: the fused kernel inside its limits (win^2 <=
    256, patch side <= 55), the wide route (patch kernel + plain loop)
    outside them."""
    assert tklt.refine_in_kernel_limits(win, max_correction) is fits
    assert fits == (win * win <= 256
                    and tklt.refine_psize(win, max_correction) <= tklt.MAX_REFINE_PSIZE)


@pytest.mark.parametrize("win,max_correction,psize", [(17, 4.0, 29), (13, 20.0, 57)])
def test_anchor_refine_fast_outside_the_kernel_limits(win, max_correction, psize):
    """Shapes the fused kernel refuses: on CPU tensors the public call is
    `_anchor_refine_plain` bit for bit, counts no launch and no wide call,
    and agrees with the reference (accept equal, out at ATOL)."""
    assert tklt.refine_psize(win, max_correction) == psize
    a, b = _shifted_pair()
    rs = np.random.RandomState(7)
    pts = np.stack([rs.uniform(14, 114, 64), rs.uniform(14, 82, 64)], -1).astype(np.float32)
    T, Tx, Ty = (np.array(x) for x in jklt.extract_templates_fast(
        jnp.asarray(a), jnp.asarray(pts), win=win))
    start = (pts + np.array([1.0, 0.4], np.float32)
             + rs.uniform(-0.5, 0.5, pts.shape).astype(np.float32))
    valid = rs.uniform(size=64) > 0.1
    kw = dict(win=win, iters=8, max_correction=max_correction, max_residual=32.0)
    args = tuple(torch.from_numpy(x) for x in (b, T, Tx, Ty, start, valid))
    before = (tklt.patch_launches, tklt.refine_launches, tklt.refine_wide_calls)
    to, ta = tklt.anchor_refine_fast(*args, **kw)
    assert (tklt.patch_launches, tklt.refine_launches, tklt.refine_wide_calls) == before
    po, pa = tklt._anchor_refine_plain(*args, **kw)
    assert torch.equal(to, po) and torch.equal(ta, pa)
    jo, ja = jklt.anchor_refine_fast(*(jnp.asarray(x) for x in (b, T, Tx, Ty, start, valid)),
                                     **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    assert np.asarray(ja).sum() > 30


def test_wide_refine_pulls_a_fleet_in_one_call():
    """The wide route's pull is handed the stacked [S, H, W] images once
    (a raw kernel launch cannot take vmap's batched tensors), and the
    fleet's result is each stream's."""
    S, n, win, mc = 3, 32, 17, 4.0
    imgs = torch.stack([torch.from_numpy(smooth_image(seed=s)) for s in range(S)])
    rs = np.random.RandomState(8)
    pts = torch.from_numpy(np.stack([rs.uniform(14, 114, (S, n)), rs.uniform(14, 82, (S, n))],
                                    -1).astype(np.float32))
    T, Tx, Ty = tklt.extract_templates_fast(imgs, pts, win)
    valid = torch.ones((S, n), dtype=torch.bool)
    calls = []

    def pull(img, p, psize):
        calls.append((type(img), tuple(img.shape), psize))
        return tklt._extract_patches(img, p, psize)

    start = pts + 0.6
    out, acc = tklt._anchor_refine_plain(imgs, T, Tx, Ty, start, valid, win=win,
                                         max_correction=mc, pull=pull)
    assert calls == [(torch.Tensor, (S, 96, 128), 29)]
    for s in range(S):
        o, a = tklt.anchor_refine_fast(imgs[s], T[s], Tx[s], Ty[s], start[s], valid[s],
                                       win=win, max_correction=mc)
        assert torch.equal(a, acc[s]) and torch.equal(o, out[s])
