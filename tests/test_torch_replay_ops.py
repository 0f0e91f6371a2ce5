"""The stream dimension of the port, module by module, on the CPU.

Every stage of the fleet steps is the single-stream function run over a
leading stream dimension (`core.tree.over_streams`), and the patch
functions of `ops.klt` take that dimension themselves. Here each batched
function over S = 3 different inputs is held against the single-stream
function on each input: integer and boolean outputs exactly, float32
outputs at rtol 1e-5 / atol 1e-6, and the iterative solves (whose float32
accept tests can tie below resolution) in float64 at 1e-10. The inputs of
the geometry stages are carried states of three small VIP runs (120x160,
96 tracks: a multiple of 16, so that every stream's rows start on the
same vector boundary and the CPU's vectorized transcendentals round one
way in every row), RANSAC stages get their minimal samples injected.

Two tests look for leakage between streams on the whole VIP fleet step,
with streams in different states (not initialized, mono WORKING, VI
WORKING): permuting the streams permutes the outputs bit for bit, and a
fleet [A, B, A] gives rows 0 and 2 bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uvipslam_torch.core import tree
from uvipslam_torch.core.tree import over_streams, stack_streams, tree_leaves, tree_map
from uvipslam_torch.frontend import device_vip as dv
from uvipslam_torch.frontend import frame as fr
from uvipslam_torch.frontend import tracker as tr
from uvipslam_torch.frontend.vip_tracker import VipConfig
from uvipslam_torch.io.synthetic import make_sequence
from uvipslam_torch.mapstate import hygiene as hy
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops import clahe as cl
from uvipslam_torch.ops import fast, image, klt, orb
from uvipslam_torch.ops import twoview as tv
from uvipslam_torch.solver import gn, pose_opt
from tests.test_torch_threads import one_torch_thread  # noqa: F401

H, W, N_TRACKS = 120, 160, 96
KF_CAP, PT_CAP = 16, 1024
MONO_F, VI_F, N_FRAMES = 12, 26, 26
CFG = dict(n_tracks=N_TRACKS, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
           acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5, vio_init_min_time=1.0)
S = 3


def _rs(seed):
    return np.random.RandomState(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def assert_rows(batched, singles, rtol=1e-5, atol=1e-6):
    """Row i of every leaf of `batched` against the i-th single result."""
    bl = tree._out_leaves(batched)
    for i, single in enumerate(singles):
        sl = tree._out_leaves(single)
        assert len(bl) == len(sl)
        for j, (a, b) in enumerate(zip(bl, sl)):
            a = a[i]
            assert a.shape == b.shape and a.dtype == b.dtype, (j, a.shape, b.shape)
            if a.dtype.is_floating_point:
                assert torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True), \
                    (i, j, float((a - b).abs().max()))
            else:
                assert torch.equal(a, b), (i, j)


@pytest.fixture(scope="module")
def world():
    """Three streams' carried states: stream s of the fleet `mono` /`vi`
    is run s's state after MONO_F / VI_F frames (WORKING before and after
    VIO init), with the next frame's bundle beside it."""
    cfg = VipConfig(**CFG)
    runs = []
    for seed in (3, 4):
        seq = make_sequence(n_frames=N_FRAMES + 8, H=H, W=W, n_points=800, seed=seed,
                            speed=1.2, gyr_noise=0.005, acc_noise=0.05,
                            gyr_bias=(0.004, -0.006, 0.003), depth_noise=0.02, z_amp=0.5)
        cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 width=W, height=H)
        st, step = dv.build_vip_tracker(cam, cfg, KF_CAP, PT_CAP, device="cpu", seed=seed)
        bundles = dv.make_bundles(seq, device="cpu")
        states = [st]
        for b in bundles[:N_FRAMES]:
            st, _ = step(st, b)
            states.append(st)
        runs.append((states, bundles))
    (sa, ba), (sb, bb) = runs
    picks = {"mono": [(sa[MONO_F], ba[MONO_F]), (sb[MONO_F], bb[MONO_F]),
                      (sa[MONO_F - 3], ba[MONO_F - 3])],
             "vi": [(sa[VI_F], ba[VI_F]), (sb[VI_F], bb[VI_F]), (sa[VI_F - 2], ba[VI_F - 2])],
             "mixed": [(sa[0], ba[0]), (sb[MONO_F], bb[MONO_F]), (sa[VI_F], ba[VI_F])]}
    assert all(int(s.state) == tr.WORKING for s, _ in picks["mono"] + picks["vi"])
    assert all(bool(s.vio_ok) for s, _ in picks["vi"])
    assert not any(bool(s.vio_ok) for s, _ in picks["mono"])
    return dict(cam=cam, cfg=cfg, step=step, picks=picks, runs=runs)


def _fleet(pairs):
    return (stack_streams([dataclasses.replace(s, gen=None) for s, _ in pairs]),
            stack_streams([b for _, b in pairs]))


# --------------------------------------------------------------------------
# core/tree.py
# --------------------------------------------------------------------------

def test_tree_rows_per_stream():
    rs = _rs(0)
    a = _t(rs.randn(S, 7, 3))
    k = torch.tensor([2, 9, -1])               # in range, above, below
    v = _t(rs.randn(S, 3))
    assert_rows(over_streams(tree.row, a, k), [tree.row(a[i], k[i]) for i in range(S)])
    assert_rows(over_streams(tree.put_row, a, k, v),
                [tree.put_row(a[i], k[i], v[i]) for i in range(S)])
    idx = torch.from_numpy(rs.randint(-1, 8, size=(S, 12)))
    vals = _t(rs.randn(S, 12, 3))
    mask = torch.from_numpy(rs.rand(S, 12) > 0.3)
    assert_rows(over_streams(tree.scatter_rows, a, idx, vals, mask),
                [tree.scatter_rows(a[i], idx[i], vals[i], mask[i]) for i in range(S)])


def test_tree_stack_take_put_roundtrip(world):
    pairs = world["picks"]["mixed"]
    st, _ = _fleet(pairs)
    for i, row in enumerate(tree.unstack_streams(st)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(row),
                                                     tree_leaves(pairs[i][0])))
    ix = torch.tensor([2, 0])
    sub = tree.take_streams(st, ix)
    assert all(torch.equal(a[0], b[2]) and torch.equal(a[1], b[0])
               for a, b in zip(tree_leaves(sub), tree_leaves(st)))
    back = tree.put_streams(st, torch.tensor([0, 2]), sub)
    assert all(torch.equal(a[0], b[2]) and torch.equal(a[2], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(tree_leaves(back), tree_leaves(st)))


# --------------------------------------------------------------------------
# ops/klt.py: the functions that hold the kernels (their plain versions on
# the CPU) and the rest of the pull
# --------------------------------------------------------------------------

def _patch_inputs(seed=1, n=40):
    rs = _rs(seed)
    img = _t(rs.rand(S, 48, 64) * 255)
    pts = rs.rand(S, n, 2) * [64 + 20, 48 + 20] - 10        # border and outside points
    pts[0, :3] = np.nan                                      # non-finite, per stream
    pts[1, 3:5] = [1e12, -1e12]
    pts[2, 5] = [-np.inf, np.inf]
    return img, _t(pts)


@pytest.mark.parametrize("psize", [9, 19, 27])
def test_extract_patches_stream_dim(psize):
    img, pts = _patch_inputs()
    for fn in (klt._extract_patches, klt.extract_patches_any):
        out = fn(img, pts, psize)
        assert out[0].shape == (S, pts.shape[1], psize, psize)
        singles = [fn(img[i], pts[i], psize) for i in range(S)]
        for i in range(S):
            assert torch.equal(out[0][i], singles[i][0])
            assert torch.equal(torch.nan_to_num(out[1][i], nan=7.0),
                               torch.nan_to_num(singles[i][1], nan=7.0))
    # the mapped wrapper (how the fleet's stages reach it) is the same call
    mapped = torch.func.vmap(lambda i, p: klt.extract_patches_any(i, p, psize))(img, pts)
    assert torch.equal(mapped[0], out[0])


def test_extract_patches_clips_to_own_image():
    """A window at the lower border of stream 0 must not read stream 1."""
    img = torch.zeros((2, 32, 32))
    img[1] = 100.0
    pts = torch.tensor([[[16.0, 31.5]], [[16.0, 0.0]]])
    out, _ = klt.extract_patches_any(img, pts, 9)
    assert float(out[0].abs().max()) == 0.0 and float(out[1].min()) == 100.0


@pytest.mark.parametrize("win,iters,max_corr", [(13, 8, 4.0), (13, 10, 5.0)])
def test_anchor_refine_stream_dim(win, iters, max_corr):
    rs = _rs(2)
    img, pts = _patch_inputs(seed=2)
    pts = torch.nan_to_num(pts, nan=20.0, posinf=30.0, neginf=5.0).clamp(-5, 70)
    T, Tx, Ty = klt.extract_templates_fast(img, pts, win)
    assert T.shape == (S, pts.shape[1], win * win)
    assert_rows((T, Tx, Ty), [klt.extract_templates_fast(img[i], pts[i], win)
                              for i in range(S)])
    start = pts + _t(rs.randn(*pts.shape) * 0.8)
    valid = torch.from_numpy(rs.rand(S, pts.shape[1]) > 0.2)
    kw = dict(win=win, iters=iters, max_correction=max_corr, max_residual=40.0)
    out, acc = klt.anchor_refine_fast(img, T, Tx, Ty, start, valid, **kw)
    singles = [klt.anchor_refine_fast(img[i], T[i], Tx[i], Ty[i], start[i], valid[i], **kw)
               for i in range(S)]
    assert_rows((out, acc), singles)
    plain = klt._anchor_refine_plain(img, T, Tx, Ty, start, valid, **kw)
    assert torch.equal(plain[0], out) and torch.equal(plain[1], acc)
    mapped = torch.func.vmap(lambda *a: klt.anchor_refine_fast(*a, **kw))(
        img, T, Tx, Ty, start, valid)
    assert torch.equal(mapped[0], out) and torch.equal(mapped[1], acc)
    assert int(acc.sum()) > 10


def test_pyramid_and_global_shift_stream_dim():
    rs = _rs(3)
    a = _t(rs.rand(S, 64, 80) * 255)
    shifts = [(3, -2), (0, 5), (-4, 1)]
    b = torch.stack([torch.roll(a[i], (dy, dx), (0, 1)) for i, (dx, dy) in enumerate(shifts)])
    pyr = over_streams(lambda im: tuple(klt.build_flow_pyramid(im, 4)), a)
    assert_rows(pyr, [tuple(klt.build_flow_pyramid(a[i], 4)) for i in range(S)])
    d = over_streams(klt.global_shift, a, b)
    assert_rows(d, [klt.global_shift(a[i], b[i]) for i in range(S)])
    assert d.tolist() == [[float(x), float(y)] for x, y in shifts]


# --------------------------------------------------------------------------
# ops/image.py, ops/clahe.py, ops/fast.py, ops/orb.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,fn", [
    ("gaussian_blur", lambda im: image.gaussian_blur(im, 7, 2.0)),
    ("pyr_down", image.pyr_down),
    ("resize", lambda im: image.resize_bilinear(im, (50, 67))),
    ("clahe", cl.clahe),
    ("fast_response2", lambda im: fast.fast_response2(im, 20.0, 7.0)),
    ("nms", lambda im: fast.nms(im, 1)),
    ("grid_topk", lambda im: fast.grid_topk(im, 16, 40)),
])
def test_image_ops_stream_dim(name, fn):
    img = _t(_rs(4).rand(S, 60, 80) * 255)
    assert_rows(over_streams(fn, img), [fn(img[i]) for i in range(S)])


def test_extract_orb_stream_dim(world):
    pairs = world["picks"]["mono"]
    imgs = torch.stack([b.img for _, b in pairs])
    occ = torch.stack([s.tracks.xy for s, _ in pairs])
    # thin the live tracks so that the detector has free cells to fill
    occ_ok = torch.stack([s.tracks.valid for s, _ in pairs]) & torch.from_numpy(
        _rs(9).rand(S, N_TRACKS) > 0.7)

    def f(im, xy, ok):
        return orb.extract_orb(im, xy, ok, n_features=N_TRACKS, px_distance=20, steer=False)

    # atol 1e-5: the angles are atan2 of patch moments, and the CPU's
    # vectorized and scalar atan2 round differently (which one an element
    # gets depends on where its row starts)
    out = over_streams(f, imgs, occ, occ_ok)
    assert_rows(out, [f(imgs[i], occ[i], occ_ok[i]) for i in range(S)], atol=1e-5)
    assert int(out.valid.sum()) > 0

    def g(im, xy, ok):
        return orb.orient_and_describe_fast(image.gaussian_blur(im, 7, 2.0), xy, ok)

    assert_rows(over_streams(g, imgs, occ, occ_ok), [g(imgs[i], occ[i], occ_ok[i])
                                                    for i in range(S)], atol=1e-5)


# --------------------------------------------------------------------------
# ops/twoview.py::find_fundamental, models/camera.py::undistort_pixels
# --------------------------------------------------------------------------

def test_find_fundamental_stream_dim(world):
    pairs = world["picks"]["mono"]
    rs = _rs(5)
    xa = torch.stack([s.tracks.birth_xy_und for s, _ in pairs])
    xb = torch.stack([s.tracks.xy_und for s, _ in pairs])
    ok = torch.stack([s.tracks.valid for s, _ in pairs])
    idx = torch.from_numpy(np.stack([
        np.stack([rs.choice(np.flatnonzero(ok[i].numpy()), 8, replace=False)
                  for _ in range(50)]) for i in range(S)]))

    def f(a, b, v, ix):
        return tv.find_fundamental(None, a, b, v, sigma=1.0, idx=ix)

    out = over_streams(f, xa, xb, ok, idx)
    assert_rows(out, [f(xa[i], xb[i], ok[i], idx[i]) for i in range(S)], rtol=1e-4,
                atol=1e-5)
    # the uniform draws handed in are the draws a generator would make
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(11), g2.manual_seed(11)
    u = tv.draw_uniform(g1, 200, N_TRACKS, "cpu")
    a = tv.find_fundamental(None, xa[0], xb[0], ok[0], u=u)
    b = tv.find_fundamental(g2, xa[0], xb[0], ok[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_undistort_stream_dim(world):
    cam = CameraModel.create(100.0, 101.0, 80.0, 60.0, width=W, height=H,
                             dist=(-0.1, 0.02, 0.001, -0.002))
    xy = _t(_rs(6).rand(S, 50, 2) * [W, H])
    assert_rows(over_streams(cam.undistort_pixels, xy),
                [cam.undistort_pixels(xy[i]) for i in range(S)])


# --------------------------------------------------------------------------
# frontend/frame.py
# --------------------------------------------------------------------------

def test_frame_functions_stream_dim(world):
    pairs = world["picks"]["mono"]
    st, b = _fleet(pairs)
    pyr = over_streams(lambda im: tuple(klt.build_flow_pyramid(im, 5)), b.img)
    u = _t(_rs(7).rand(S, 200, N_TRACKS)).clamp(1e-6, 1 - 1e-6)
    guess_ok = torch.zeros((S, N_TRACKS), dtype=torch.bool)

    def prop(t, pp, pc, gok, uu):
        return fr.propagate_tracks(t, pp, pc, t.xy, gok, None, u=uu)

    out = over_streams(prop, st.tracks, st.pyr_prev, pyr, guess_ok, u)
    singles = [prop(s.tracks, s.pyr_prev, tuple(klt.build_flow_pyramid(bb.img, 5)),
                    guess_ok[i], u[i]) for i, (s, bb) in enumerate(pairs)]
    assert_rows(out, singles)
    assert int(out.valid.sum()) > S * 20

    def refill(t, im, fid):
        return fr.refresh_descriptors(
            fr.refill_tracks(t, im, fid, n_features=N_TRACKS, px_distance=20), im)

    out2 = over_streams(refill, out, b.img, st.frame_id)
    assert_rows(out2, [refill(singles[i], bb.img, s.frame_id)
                       for i, (s, bb) in enumerate(pairs)])
    assert int(out2.valid.sum()) > int(out.valid.sum())


# --------------------------------------------------------------------------
# solver/gn.py, and the stages built on the solvers (float64)
# --------------------------------------------------------------------------

def test_spd_solves_stream_dim():
    rs = _rs(8)
    A = rs.randn(S, 12, 12)
    Hm = _t(A @ A.transpose(0, 2, 1) + 12 * np.eye(12), torch.float64)
    g = _t(rs.randn(S, 12), torch.float64)
    assert_rows(over_streams(gn.inv_spd, Hm), [gn.inv_spd(Hm[i]) for i in range(S)],
                rtol=1e-10, atol=1e-12)
    assert_rows(over_streams(gn.solve_spd, Hm, g), [gn.solve_spd(Hm[i], g[i])
                                                    for i in range(S)], rtol=1e-10, atol=1e-12)


def test_lm_solve_accepts_per_stream():
    """One stream refusing its LM steps (a residual that grows with any
    step) neither holds back nor alters the others."""
    target = torch.tensor([[1.0, 2.0], [5.0, 5.0], [-3.0, 0.5]], dtype=torch.float64)
    refuse = torch.tensor([False, True, False])

    def solve(tgt, bad):
        def residual(x):
            # gradient towards tgt; the refusing stream's cost grows with
            # any step away from its start
            r = x - tgt
            chi2 = torch.where(bad, 1.0 + torch.sum(x * x), torch.sum(r * r))
            return torch.eye(2, dtype=torch.float64), r, chi2
        return gn.lm_solve(torch.zeros(2, dtype=torch.float64) + 0.0 * tgt, residual,
                           lambda x, d: x + d, n_iters=6)

    out = over_streams(solve, target, refuse)
    singles = [solve(target[i], refuse[i]) for i in range(S)]
    assert_rows(out, singles, rtol=1e-10, atol=1e-12)
    x = out[0]
    assert torch.allclose(x[0], target[0], atol=1e-3) and torch.allclose(x[2], target[2],
                                                                         atol=1e-3)
    assert torch.equal(x[1], torch.zeros(2, dtype=torch.float64))


def _f64(t):
    return tree_map(lambda a: a.double() if a.dtype == torch.float32 else a, t)


STAGES64 = ["pose_se3", "pose_vi2", "local_ba", "vi_ba"]


@pytest.mark.parametrize("stage", STAGES64)
def test_solver_stages_stream_dim_f64(world, stage):
    cam, step = world["cam"], world["step"]
    sig, grav = step.scale_sigmas.double(), step.gravity.double()
    Rcb, tcb = step.Rcb.double(), step.tcb.double()
    fxy = (cam.fx, cam.fy, cam.cx, cam.cy)
    pairs = world["picks"]["vi" if "vi" in stage else "mono"]
    st, b = _fleet([(_f64(s), _f64(bb)) for s, bb in pairs])

    def assoc(s):
        t, m = s.tracks, s.map
        pid = t.pt_id.clamp(0, m.pt_cap - 1).long()
        ok = t.valid & (t.pt_id >= 0) & m.pt_valid[pid]
        return m.pt_xyz[pid], t.xy_und, ok, tr._inv_sigma(sig, t.level)

    def pose_se3(s, bb):
        return pose_opt.pose_optimization_se3(s.Rcw, s.tcw, *assoc(s), *fxy, rounds=2, iters=4)

    def pose_vi2(s, bb):
        return pose_opt.pose_optimization_vi2(
            s.ns, s.ns, s.H_prior, s.preint_kf, *assoc(s), grav, Rcb, tcb, *fxy, 2.5e-9, 1e-6,
            depth_meas=bb.depth, depth_info=torch.full_like(bb.depth, 400.0), use_depth=True,
            rounds=2, iters=3)

    def local_ba(s, bb):
        m = s.map
        kf_idx = torch.arange(m.kf_cap)
        fixed = (m.kf_valid & (kf_idx < m.n_kf - 6)) | (kf_idx == 0)
        return tr._local_ba(m, fixed, *fxy, sig)

    def vi_ba(s, bb):
        from uvipslam_torch.frontend.vip_tracker import _vi_ba
        return _vi_ba(s.map, grav, *fxy, sig, 2.5e-9, 1e-6, 400.0, Rcb, tcb)

    fn = dict(pose_se3=pose_se3, pose_vi2=pose_vi2, local_ba=local_ba, vi_ba=vi_ba)[stage]
    out = over_streams(fn, st, b)
    singles = [fn(_f64(s), _f64(bb)) for s, bb in pairs]
    # the pose solves at 1e-10; the window BAs at 1e-7, since their reduced
    # camera systems are conditioned ~1e8 and the batched matrix products
    # round in another order
    tol = 1e-7 if stage.endswith("ba") else 1e-10
    assert_rows(out, singles, rtol=100 * tol, atol=tol)


# --------------------------------------------------------------------------
# mapstate, tracker stages without an iterative solve (float32)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["pose_and_localmap", "vi_track"])
def test_association_stages_stream_dim(world, stage):
    """The two per-frame tracking stages in float32: the associations and
    inlier sets exactly; the poses at 1e-2, since their float32
    Levenberg-Marquardt accept tests can tie below resolution and a
    flipped accept moves the result by millimetres (the solves themselves
    are held in float64 above)."""
    cam, step = world["cam"], world["step"]
    fxy = (cam.fx, cam.fy, cam.cx, cam.cy)
    pairs = world["picks"]["vi" if stage == "vi_track" else "mono"]
    st, b = _fleet(pairs)

    def pose_and_localmap(s, bb):
        return tr._pose_and_localmap(s.tracks, s.map, s.Rcw, s.tcw, *fxy, step.scale_sigmas)

    def vi_track(s, bb):
        s, pre_frame, ns_pred, _, _ = step._preintegrate(s, bb)
        (ns, inl, n, tracks, _), flags = step._vi_lane0(s, bb, ns_pred, pre_frame)
        return ns.p, ns.R, inl, n, tracks, flags

    fn = dict(pose_and_localmap=pose_and_localmap, vi_track=vi_track)[stage]
    assert_rows(over_streams(fn, st, b), [fn(s, bb) for s, bb in pairs], rtol=1e-2, atol=1e-2)


STAGES32 = ["motion_guess", "triangulate_new", "create_kf", "cull_points", "fuse_recent",
            "compact_points", "points_seen_by", "accumulate_predict", "ring_and_out"]


@pytest.mark.parametrize("stage", STAGES32)
def test_map_and_tracker_stages_stream_dim(world, stage):
    cam, step = world["cam"], world["step"]
    fxy = (cam.fx, cam.fy, cam.cx, cam.cy)
    pairs = world["picks"]["vi" if stage in ("accumulate_predict",) else "mono"]
    st, b = _fleet(pairs)
    fns = dict(
        motion_guess=lambda s, bb: tr._motion_guess(s.tracks, s.map, s.Rcw, s.tcw, *fxy),
        triangulate_new=lambda s, bb: tr._triangulate_new(
            s.map, s.tracks, s.ring_R, s.ring_t, s.ring_frame, s.Rcw, s.tcw, *fxy, s.frame_id,
            s.last_kf_slot),
        create_kf=lambda s, bb: step._create_kf(s, bb, False),
        cull_points=lambda s, bb: hy.cull_points(s.map, s.frame_id),
        fuse_recent=lambda s, bb: hy.fuse_duplicates_recent(s.map, s.frame_id, s.Rcw, s.tcw,
                                                            *fxy),
        compact_points=lambda s, bb: hy.compact_points(s.map),
        points_seen_by=lambda s, bb: s.map.points_seen_by(
            torch.arange(KF_CAP) == s.last_kf_slot),
        accumulate_predict=lambda s, bb: step._preintegrate(s, bb),
        ring_and_out=lambda s, bb: step._ring_and_out(s, s.pyr_prev),
    )
    fn = fns[stage]
    out = over_streams(fn, st, b)
    assert_rows(out, [fn(s, bb) for s, bb in pairs])
    if stage == "create_kf":       # a keyframe and its slot per stream
        assert out[1].tolist() == [int(s.map.n_kf) for s, _ in pairs]


# --------------------------------------------------------------------------
# leakage between streams, on the whole VIP fleet step
# --------------------------------------------------------------------------

def _run_fleet(world, order, n_frames=6):
    """The fleet step over the `mixed` streams taken in `order` (stream
    ids may repeat), each with its own generator and its own sequence
    from where its carried state stands. Returns the stacked outputs and
    the final state."""
    cfg, cam = world["cfg"], world["cam"]
    (sa, ba), (sb, bb) = world["runs"]
    streams = [(sa[0], ba, 0), (sb[MONO_F], bb, MONO_F), (sa[VI_F - n_frames], ba,
                                                          VI_F - n_frames)]
    fleet = dv.VipFleetStep(cam, cfg, KF_CAP, device="cpu")
    st = stack_streams([dataclasses.replace(streams[i][0], gen=None) for i in order])
    gens = []
    for i in order:
        g = torch.Generator()
        g.manual_seed(100 + i)
        gens.append(g)
    outs = []
    for f in range(n_frames):
        b = stack_streams([streams[i][1][streams[i][2] + f] for i in order])
        st, out = fleet(st, b, gens)
        outs.append(out)
    return outs, st


def test_fleet_permutation_is_bitwise(world):
    outs, st = _run_fleet(world, [0, 1, 2])
    perm = [2, 0, 1]
    outs_p, st_p = _run_fleet(world, perm)
    states = torch.stack([o.state for o in outs])
    # the streams sit in different states: one starts NOT_INITIALIZED,
    # one tracks before VIO init, one after it
    assert states[0].tolist() == [tr.INITIALIZING, tr.WORKING, tr.WORKING]
    assert st.vio_ok.tolist() == [False, False, True]
    for o, op in zip(outs + [st], outs_p + [st_p]):
        for a, c in zip(tree_leaves(o), tree_leaves(op)):
            assert torch.equal(torch.nan_to_num(a[perm]), torch.nan_to_num(c))


def test_fleet_duplicate_rows_are_bitwise(world):
    outs, st = _run_fleet(world, [2, 1, 2])
    for o in outs + [st]:
        for a in tree_leaves(o):
            assert torch.equal(torch.nan_to_num(a[0]), torch.nan_to_num(a[2]))
    assert int(st.map.n_kf[0]) != int(st.map.n_kf[1])


def test_fleet_rare_branches_match_single_stream(world):
    """Three black frames send the mono stream to LOST and the VI stream
    through the first-try lane into IMU_RELOC, the branches the fleet runs
    per stream through the single-stream code: the fleet's labels are
    those of single-stream runs on the same inputs with the same seeds."""
    cfg, cam = world["cfg"], world["cam"]
    (sa, ba), (sb, bb) = world["runs"]
    n, f_vi = 7, VI_F
    starts = [(sb[MONO_F], bb[MONO_F:MONO_F + n]), (sa[f_vi], ba[f_vi:f_vi + n])]

    def black(bundle, f):
        return dataclasses.replace(bundle, img=torch.zeros_like(bundle.img)) if f < 3 else bundle

    def gen(i):
        g = torch.Generator()
        g.manual_seed(50 + i)
        return g

    single = []
    for i, (st0, bundles) in enumerate(starts):
        step = dv.VipStep(cam, cfg, KF_CAP, device="cpu")
        st, labels = dataclasses.replace(st0, gen=gen(i)), []
        for f, b in enumerate(bundles):
            st, out = step(st, black(b, f))
            labels.append((int(out.state), bool(out.vio_ok)))
        single.append(labels)
    assert tr.LOST in [s for s, _ in single[0]]
    assert tr.IMU_RELOC in [s for s, _ in single[1]]

    fleet = dv.VipFleetStep(cam, cfg, KF_CAP, device="cpu")
    st = stack_streams([dataclasses.replace(s, gen=None) for s, _ in starts])
    gens = [gen(0), gen(1)]
    got = [[], []]
    for f in range(n):
        st, out = fleet(st, stack_streams([black(bs[f], f) for _, bs in starts]), gens)
        for i in range(2):
            got[i].append((int(out.state[i]), bool(out.vio_ok[i])))
    assert got == single


def test_mono_fleet_matches_single_streams():
    """`batched_replay` over two scenes against two single-stream runs
    seeded like the fleet's streams: the same labels on every frame
    (bootstrap, WORKING, keyframes), the same keyframe count, and poses
    that agree while float32 rounding has had few frames to spread
    (1e-3 of the unit-depth map over the first ten frames)."""
    from uvipslam_torch.frontend import device_tracker as dt
    from uvipslam_torch.parallel.replay import batched_replay

    T = 14
    seqs = [make_sequence(n_frames=T, H=H, W=W, n_points=800, seed=s, speed=1.2)
            for s in (3, 4)]
    k = seqs[0].K
    cam = CameraModel.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=W, height=H)
    cfg = tr.TrackerConfig(n_tracks=N_TRACKS, min_init_tracks=60, local_window=8)
    make_states, run = batched_replay(cam, cfg, KF_CAP, PT_CAP, device="cpu", seed=5)
    stf, outs, fleet = run(make_states(2), np.stack([s.images for s in seqs]))
    assert int(fleet) == int((outs.state == tr.WORKING).sum()) > T
    for i, seq in enumerate(seqs):
        st, step = dt.build_tracker(cam, cfg, KF_CAP, PT_CAP, device="cpu", seed=5 + i)
        for f in range(T):
            st, out = step(st, torch.from_numpy(seq.images[f]))
            assert int(out.state) == int(outs.state[i, f]), (i, f)
            assert int(out.new_kf) == int(outs.new_kf[i, f]), (i, f)
            if f < 10:
                assert torch.allclose(out.tcw, outs.tcw[i, f], atol=1e-3), (i, f)
        assert int(st.map.n_kf) == int(stf.map.n_kf[i]) >= 3
