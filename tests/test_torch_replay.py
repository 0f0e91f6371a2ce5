"""Batched replay of the port against the reference's
`uvipslam_tpu/parallel/replay.py`, on the CPU.

(a) The module that holds the kernels: `jax.vmap` of the reference's
    `_extract_patches` and `anchor_refine_fast` (their slab form, as the
    reference's own tests run them on the CPU) against the port's batched
    plain versions on the same numpy inputs, S = 3: patches exactly,
    refined points within 1e-4 px.
(b) The slice as a whole at the size of the reference's CPU-mesh test
    (S = 2, T = 3, 64x80, 32 tracks, a 2-device CPU mesh): the reference
    `batched_replay` and the port's, started from the reference's batched
    state carried over with `uvipslam_torch.convert`, give the same state
    labels per stream and frame, the same first-frame track table (xy to
    1e-4, descriptors and levels exactly), outputs of shape [S, T, ...]
    and the same `fleet` count. The RANSAC draws differ between the
    frameworks, and at this size no stream gets past INITIALIZING, where
    the draws would first matter to a label.
(c) Marked slow: the VIP fleet of the reference's sharded test (distinct
    scenes, 45 frames at 240x320, 160 tracks) through the port at S = 4
    with that test's own bars: most streams initialize VIO and track with
    metric ATE below 12% of the span.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.io.synthetic import ate_rmse, make_sequence
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.ops import klt as jklt
from uvipslam_tpu.parallel import replay as jreplay
from uvipslam_torch import convert
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend.vip_tracker import VipConfig as TVipConfig
from uvipslam_torch.models.camera import CameraModel as TCam
from uvipslam_torch.ops import klt as tklt
from uvipslam_torch.parallel import replay as treplay
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S3 = 3


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _fleet_images(seed, h=96, w=128):
    rs = np.random.RandomState(seed)
    base = rs.rand(S3, h // 4, w // 4).astype(np.float32)
    img = np.kron(base, np.ones((4, 4), np.float32)) * 200 + rs.rand(S3, h, w).astype(
        np.float32) * 20
    return img.astype(np.float32)


@pytest.mark.parametrize("psize", [19, 27])
def test_extract_patches_fleet_matches_reference_vmap(psize):
    img = _fleet_images(0)
    rs = np.random.RandomState(1)
    pts = (rs.rand(S3, 48, 2) * [128 + 16, 96 + 16] - 8).astype(np.float32)   # border, outside
    jp, jl = jax.vmap(lambda i, p: jklt._extract_patches(i, p, psize))(jnp.asarray(img),
                                                                       jnp.asarray(pts))
    tp, tl = tklt.extract_patches_any(torch.from_numpy(img), torch.from_numpy(pts), psize)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("max_correction,iters", [(4.0, 8), (5.0, 10)])
def test_anchor_refine_fleet_matches_reference_vmap(max_correction, iters):
    import scipy.ndimage as ndi
    a = np.stack([ndi.gaussian_filter(x, 2.0) for x in _fleet_images(2)]).astype(np.float32)
    a = (a - a.min()) / (a.max() - a.min()) * 255
    b = np.stack([ndi.shift(x, (0.4 + 0.1 * s, 1.0 - 0.2 * s), order=1, mode="nearest")
                  for s, x in enumerate(a)]).astype(np.float32)
    rs = np.random.RandomState(3)
    pts = np.stack([rs.uniform(16, 112, (S3, 48)), rs.uniform(16, 80, (S3, 48))],
                   -1).astype(np.float32)
    T, Tx, Ty = (np.array(x) for x in jax.vmap(
        lambda i, p: jklt.extract_templates_fast(i, p, win=13))(jnp.asarray(a),
                                                                jnp.asarray(pts)))
    tT = tklt.extract_templates_fast(torch.from_numpy(a), torch.from_numpy(pts), win=13)
    for x, y in zip(tT, (T, Tx, Ty)):
        np.testing.assert_allclose(x.numpy(), y, atol=1e-4, rtol=0)
    start = (pts + rs.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
    valid = rs.uniform(size=(S3, 48)) > 0.1
    kw = dict(win=13, iters=iters, max_correction=max_correction, max_residual=32.0)
    jo, ja = jax.vmap(lambda *x: jklt.anchor_refine_fast(*x, **kw))(
        *(jnp.asarray(x) for x in (b, T, Tx, Ty, start, valid)))
    to, ta = tklt.anchor_refine_fast(*(torch.from_numpy(x) for x in (b, T, Tx, Ty, start,
                                                                     valid)), **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4, rtol=0)
    assert np.asarray(ja).sum() > S3 * 20


def test_batched_replay_matches_reference():
    S, T, H, W = 2, 3, 64, 80
    mesh = jreplay.make_mesh(S, platform="cpu")
    seq = make_sequence(n_frames=T, H=H, W=W, n_points=300, seed=0, speed=1.0)
    seq2 = make_sequence(n_frames=T, H=H, W=W, n_points=300, seed=1, speed=1.0)
    imgs = np.stack([seq.images, seq2.images]).astype(np.float32)
    cfg = dict(n_tracks=32, min_init_tracks=8, local_window=2, n_levels_klt=3, px_distance=6)
    k = seq.K
    jcam = JCam.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=W, height=H)
    tcam = TCam.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=W, height=H)

    jmake, jrun = jreplay.batched_replay(jcam, jtr.TrackerConfig(**cfg), 8, 256, mesh)
    jstates = jmake(S)
    jstf, jouts, jfleet = jrun(jstates, jreplay.shard_stream_axis(mesh, jnp.asarray(imgs)))

    tmake, trun = treplay.batched_replay(tcam, ttr.TrackerConfig(**cfg), 8, 256, device="cpu")
    tstates = convert.tracker_fleet(jax.tree_util.tree_map(np.asarray, jstates), "cpu")
    own = tmake(S)       # the port's own initial fleet is the carried-over one
    for name in ("state", "frame_id", "Rcw", "ring_frame", "last_kf_slot"):
        assert torch.equal(getattr(own, name), getattr(tstates, name)), name
    tstf, touts, tfleet = trun(tstates, imgs)

    assert touts.Rcw.shape == (S, T, 3, 3) and touts.tcw.shape == (S, T, 3)
    assert touts.state.shape == (S, T) and touts.new_kf.shape == (S, T)
    np.testing.assert_array_equal(touts.state.numpy(), np.asarray(jouts.state))
    assert int(tfleet) == int(jfleet)
    assert (touts.state.numpy()[:, -1] >= 1).all()
    # the first frame's track table. Every stream leaves NOT_INITIALIZED on
    # frame 0 and stays INITIALIZING, which detects nothing new: the final
    # state still holds frame 0's detections as the tracks' birth
    # positions (the camera has no distortion), descriptors and levels,
    # and frame 0 makes no random draw
    assert touts.state.tolist() == [[ttr.INITIALIZING] * T] * S
    jt, tt = jstf.tracks, tstf.tracks
    born = np.asarray(jt.birth_frame) == 0
    np.testing.assert_array_equal(tt.birth_frame.numpy() == 0, born)
    assert born.sum(-1).min() >= 8
    np.testing.assert_allclose(tt.birth_xy_und.numpy()[born], np.asarray(jt.birth_xy_und)[born],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tt.desc.numpy()[born], np.asarray(jt.desc)[born])
    np.testing.assert_array_equal(tt.level.numpy()[born], np.asarray(jt.level)[born])
    # the two streams saw different scenes
    assert not np.array_equal(tt.birth_xy_und.numpy()[0], tt.birth_xy_und.numpy()[1])


@pytest.mark.slow
def test_batched_replay_vip_fleet_tracks():
    S, T, H, W = 4, 45, 240, 320
    seqs = [make_sequence(n_frames=T, H=H, W=W, n_points=3000, seed=20 + s, speed=1.2,
                          gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                          acc_bias=(0.0, 0.0, 0.0), depth_noise=0.02, z_amp=0.5)
            for s in range(S)]
    k = seqs[0].K
    cam = TCam.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=W, height=H)
    cfg = TVipConfig(n_tracks=160, min_init_tracks=50, local_window=6, gyr_noise_sd=0.01,
                     acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=6,
                     vio_init_min_time=1.0, imu_cap_per_kf=128)
    make_states, run = treplay.batched_replay_vip(cam, cfg, 32, 4096, device="cpu")
    stf, outs, fleet = run(make_states(S), treplay.fleet_bundles(seqs, device="cpu"))
    assert outs.Rcw.shape == (S, T, 3, 3)
    assert int(fleet[1]) > S // 2, (int(fleet[1]), outs.state[:, -1])
    st, vio = outs.state.numpy(), outs.vio_ok.numpy()
    ok_streams, ates = 0, []
    for s in range(S):
        if not vio[s].any():
            continue
        init_f = int(np.argmax(vio[s]))
        sel = np.asarray([i for i in range(T) if i >= init_f + 3 and st[s, i] == ttr.WORKING])
        if len(sel) < 8:
            continue
        Rs = outs.Rcw[s].double().numpy()
        ts = outs.tcw[s].double().numpy()
        C = np.stack([-Rs[i].T @ ts[i] for i in sel])
        rmse, _ = ate_rmse(C, seqs[s].positions_w[sel], align_scale=False)
        ates.append(rmse)
        span = np.linalg.norm(seqs[s].positions_w[-1] - seqs[s].positions_w[0])
        ok_streams += rmse < 0.12 * span
    assert ok_streams > S // 2, (ok_streams, int(fleet[1]), st[:, -1], ates)
