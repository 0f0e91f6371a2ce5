"""The port's two open parity questions, settled against the reference on
the CPU (both `slow`; neither counts toward the fast tier).

1. The revisit sequence at speed 1.4, 512x640 (the sequence of
   `chip_smoke.py` phase 10, whose loop spans 80 frames, at the speed of
   the reference's tests/test_loop_closer.py revisit test), through each
   package's mono device step for 30 frames. `motion="loop"` stretches
   the loop over `n_frames`, so the 80-frame sequence is rendered and its
   first 30 frames are run. Verdict: shared by the reference. Both lose
   tracking here, the reference at frame 23 and the port at frame 16 with
   their default draws, and over seeds 0-5 each on 5 of 6 draws (first
   LOST frames 10-23 in the reference, 14-21 in the port). Carried into the
   port, the reference's state before its loss goes the same way stage by
   stage: the propagation's anchor refinements agree to 1e-4 px, the
   F-RANSAC gate draws the same minimal samples, and the pose + local-map
   solve on the reference's propagated tracks gives the same inlier count,
   below `min_tracked`. The gate's float32 8-point solves (`nullvec_ls`,
   one algorithm in both packages) are what lose the frame: on these
   samples (sigma_8 / sigma_1 around 5e-4) few of either package's 200
   float32 hypotheses reach 100 inliers, where the float64 null vectors of
   the same samples mostly do, so which frame keeps its tracks follows the
   draws and the float32 rounding.
2. The VIP stream after a closure: the reference's 240x320 revisit with
   IMU and pressure (phase 11's noise), 120 frames, through both
   packages' `DeviceStream(mode="vip", loop_closing=True)`. Verdict:
   shared by the reference. Both initialize VIO at frame 20, neither
   closes a loop, and both miss phase 11's gate (5% of the trajectory's
   extent) already at frame 100 and more so at 120: the poor metric ATE
   of the VIP step on this sequence needs no closure, and the port's ATE
   stays below the reference's.

Each reference runs under `jax.enable_x64(False)`.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import device_tracker as jdt
from uvipslam_tpu.frontend import frame as jfr
from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.ops import klt as jklt
from uvipslam_tpu.ops import twoview as jtv
from uvipslam_torch import convert
from uvipslam_torch.frontend import device_tracker as tdt
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.io.synthetic import ate_rmse, make_sequence
from uvipslam_torch.models.camera import CameraModel as TCam
from uvipslam_torch.ops import twoview as ttv
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REVISIT = dict(n_frames=80, H=512, W=640, n_points=6000, seed=9, motion="loop", speed=1.4)
REVISIT_FRAMES = 30
MONO_CFG = dict(n_tracks=400, min_init_tracks=100, local_window=8)
FIRST_LOST = {"reference": 23, "port": 16}    # with each package's default draws
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _copy(tree):
    """A host copy of a reference tree (a later step may reuse the
    buffers that `np.asarray` views)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def revisit():
    seq = make_sequence(**REVISIT)
    K = seq.K
    with jax.enable_x64(False):
        jcam = JCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=640, height=512)
        jcfg = jtr.TrackerConfig(**MONO_CFG)
        _, jstep = jdt.build_tracker(jcam, jcfg, 64, 8192)
    tcam = TCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=640, height=512)
    return dict(seq=seq, jcam=jcam, jcfg=jcfg, jstep=jstep, tcam=tcam,
                tcfg=ttr.TrackerConfig(**MONO_CFG))


def _reference_labels(rv, seed, keep=False):
    """Labels of the reference's mono step over the revisit's first
    frames from a state seeded `seed`, and (keep) a copy of every state."""
    with jax.enable_x64(False):
        st = jdt.init_state(rv["jcfg"], 64, 8192, 512, 640, seed=seed)
        labels, kept = [], []
        for f in range(REVISIT_FRAMES):
            st, out = rv["jstep"](st, jnp.asarray(rv["seq"].images[f], jnp.float32))
            labels.append(int(out.state))
            if keep:
                kept.append(_copy(st))
    return labels, kept


def _port_labels(rv, seed):
    st, step = tdt.build_tracker(rv["tcam"], rv["tcfg"], 64, 8192, device="cpu", seed=seed)
    labels = []
    for f in range(REVISIT_FRAMES):
        st, out = step(st, torch.from_numpy(rv["seq"].images[f].astype(np.float32)))
        labels.append(int(out.state))
    return labels


def _first_lost(labels):
    return labels.index(ttr.LOST) if ttr.LOST in labels else None


def _hypothesis_inliers(Fs, Ta, Tb, xa, xb, ok):
    """Inlier count of each normalized-coordinate hypothesis, scored in
    float64 with the port's scorer."""
    F = torch.from_numpy(Tb.T[None] @ np.asarray(Fs, np.float64) @ Ta[None])
    d_a, d_b = ttv._epipolar_errors(F, torch.from_numpy(xa), torch.from_numpy(xb))
    _, inl = ttv._ransac_score(d_a, d_b, torch.from_numpy(ok), ttv.TH_F, 1.0)
    return inl.sum(-1).numpy()


def _float64_hypotheses(xan, xbn):
    """The 8-point hypotheses of samples [B, 8, 2] by float64 SVD: the null
    vector of each 8x9 system, projected to rank 2."""
    x1, y1, x2, y2 = xan[..., 0], xan[..., 1], xbn[..., 0], xbn[..., 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], -1)
    f = np.linalg.svd(A)[2][:, -1].reshape(-1, 3, 3)
    u, s, vt = np.linalg.svd(f)
    s[:, 2] = 0.0
    return u @ (s[..., None] * vt)


@pytest.mark.slow
def test_revisit_at_speed_1_4_is_lost_in_both_packages(revisit):
    rv = revisit
    seq, jcam, jcfg, tcam = rv["seq"], rv["jcam"], rv["jcfg"], rv["tcam"]
    ref, kept = _reference_labels(rv, 0, keep=True)
    port = _port_labels(rv, 0)
    print("reference", "".join(map(str, ref)), "\nport     ", "".join(map(str, port)))
    assert {"reference": _first_lost(ref), "port": _first_lost(port)} == FIRST_LOST

    # the reference's state before its loss, carried into the port
    fl = FIRST_LOST["reference"]
    src = kept[fl - 1]
    img = seq.images[fl].astype(np.float32)
    Rp = src.R_vel @ src.Rcw
    tp = src.R_vel @ src.tcw + src.t_vel
    with jax.enable_x64(False):
        jst = jax.tree_util.tree_map(jnp.asarray, src)
        _, sub = jax.random.split(jst.key)
        pyr = tuple(jklt.build_flow_pyramid(jnp.asarray(img), jcfg.n_levels_klt))
        guess, gok = jtr._motion_guess_jit(jst.tracks, jst.map, jnp.asarray(Rp), jnp.asarray(tp),
                                           jcam.fx, jcam.fy, jcam.cx, jcam.cy)
        jprop = _copy(jfr.propagate_tracks(jst.tracks, jst.pyr_prev, pyr, guess, gok, sub,
                                           win=jcfg.klt_win, iters=jcfg.klt_iters,
                                           levels=jcfg.n_levels_klt))
        # the gate's inputs and samples, as propagate_tracks forms them
        t = jst.tracks
        lvl = min(3, len(pyr) - 1)
        shift = jklt.global_shift(jst.pyr_prev[lvl], pyr[lvl], radius=8) * float(2 ** lvl)
        start = jnp.where(gok[:, None], guess, t.xy + shift[None, :])
        coarse, ok_c = jklt.anchor_refine_fast(pyr[1], t.tpl2, t.tpl2_gx, t.tpl2_gy, start / 2.0,
                                               t.valid, win=jfr.Tracks.TPL_WIN, iters=10,
                                               max_correction=5.0, max_residual=45.0)
        mid = jnp.where(ok_c[:, None], coarse * 2.0, start)
        nxt, ok_f = jklt.anchor_refine_fast(pyr[0], t.tpl, t.tpl_gx, t.tpl_gy, mid, t.valid,
                                            win=jfr.Tracks.TPL_WIN, max_correction=4.0,
                                            max_residual=32.0)
        ok = np.asarray(t.valid & ok_f)
        xan, Ta = jtv.normalize_points(t.xy, ok)
        xbn, Tb = jtv.normalize_points(nxt, ok)
        idx = np.asarray(jtv._sample_minimal(sub, 200, 8, ok))
        F_ref = np.asarray(jtv.fundamental_from_8pt(xan[idx], xbn[idx]))
        u = np.array(jax.random.uniform(sub, (200, MONO_CFG["n_tracks"]), jnp.float32,
                                        minval=np.finfo(np.float32).tiny, maxval=1.0))
        jt = dataclasses.replace(jax.tree_util.tree_map(jnp.asarray, jprop),
                                 xy_und=jcam.undistort_pixels(jnp.asarray(jprop.xy)))
        j_ml = _copy(jtr._pose_and_localmap_jit(
            jt, jst.map, jnp.asarray(Rp), jnp.asarray(tp), jcam.fx, jcam.fy, jcam.cx, jcam.cy,
            jnp.asarray(jcfg.scale_sigmas, jnp.float32)))
    assert j_ml[3] < jcfg.min_tracked            # the reference's loss, at the pose solve

    st = convert.tracker_state(src)
    step = tdt.MonoStep(tcam, rv["tcfg"], device="cpu")
    _, pyr_t = step._images(torch.from_numpy(img))
    st1 = dataclasses.replace(st, frame_id=st.frame_id + 1)
    # the propagation's stages on the same inputs: the same motion-model
    # guesses, refinements accepting the same tracks at the same
    # positions, and the F-RANSAC gate drawing the same minimal samples
    from uvipslam_torch.ops import klt as tklt

    gt, gok_t = ttr._motion_guess(st.tracks, st.map, torch.from_numpy(Rp), torch.from_numpy(tp),
                                  tcam.fx, tcam.fy, tcam.cx, tcam.cy)
    np.testing.assert_array_equal(gok_t.numpy(), np.asarray(gok))
    tr = st.tracks
    shift_t = tklt.global_shift(st.pyr_prev[lvl], pyr_t[lvl], radius=8) * float(2 ** lvl)
    start_t = torch.where(gok_t[:, None], gt, tr.xy + shift_t[None, :])
    np.testing.assert_allclose(start_t.numpy()[ok], np.asarray(start)[ok], atol=ATOL, rtol=0)
    coarse_t, okc_t = tklt.anchor_refine_fast(pyr_t[1], tr.tpl2, tr.tpl2_gx, tr.tpl2_gy,
                                              start_t / 2.0, tr.valid, win=jfr.Tracks.TPL_WIN,
                                              iters=10, max_correction=5.0, max_residual=45.0)
    mid_t = torch.where(okc_t[:, None], coarse_t * 2.0, start_t)
    nxt_t, okf_t = tklt.anchor_refine_fast(pyr_t[0], tr.tpl, tr.tpl_gx, tr.tpl_gy, mid_t,
                                           tr.valid, win=jfr.Tracks.TPL_WIN, max_correction=4.0,
                                           max_residual=32.0)
    ok_t = (tr.valid & okf_t).numpy()
    np.testing.assert_array_equal(okc_t.numpy(), np.asarray(ok_c))
    np.testing.assert_array_equal(ok_t, ok)
    np.testing.assert_allclose(nxt_t.numpy()[ok], np.asarray(nxt)[ok], atol=ATOL, rtol=0)
    idx_t = ttv._sample_minimal(None, 200, 8, torch.from_numpy(ok_t), u=torch.from_numpy(u))
    np.testing.assert_array_equal(np.sort(idx_t.numpy(), 1), np.sort(idx, 1))
    prop = step._propagate(st1, pyr_t, torch.from_numpy(u))
    survived = prop.valid.numpy() & np.asarray(jprop.valid)
    np.testing.assert_allclose(prop.xy.numpy()[survived], np.asarray(jprop.xy)[survived],
                               atol=ATOL, rtol=0)

    # the gate's float32 hypotheses in both packages against float64 ones
    xa64, xb64 = np.asarray(t.xy, np.float64), np.asarray(nxt, np.float64)
    Ta64, Tb64 = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    xan_s, xbn_s = np.asarray(xan)[idx], np.asarray(xbn)[idx]
    F_port = ttv.fundamental_from_8pt(torch.from_numpy(xan_s), torch.from_numpy(xbn_s)).numpy()
    F_64 = _float64_hypotheses(xan_s.astype(np.float64), xbn_s.astype(np.float64))
    good = {name: int((_hypothesis_inliers(F, Ta64, Tb64, xa64, xb64, ok) >= 100).sum())
            for name, F in (("reference", F_ref), ("port", F_port), ("float64", F_64))}
    print("hypotheses with >= 100 inliers of 200:", good)
    assert good["float64"] >= 100 and good["reference"] <= 20 and good["port"] <= 20, good

    # the pose + local-map solve on the reference's propagated tracks
    tt = convert.tracks(jprop)
    tt = dataclasses.replace(tt, xy_und=tcam.undistort_pixels(tt.xy))
    t_ml = ttr._pose_and_localmap(tt, st.map, torch.from_numpy(Rp), torch.from_numpy(tp),
                                  tcam.fx, tcam.fy, tcam.cx, tcam.cy,
                                  torch.tensor(jcfg.scale_sigmas, dtype=torch.float32))
    assert int(t_ml[3]) == int(j_ml[3])
    np.testing.assert_array_equal(t_ml[2].numpy(), j_ml[2])
    np.testing.assert_allclose(t_ml[0].numpy(), j_ml[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_ml[1].numpy(), j_ml[1], atol=ATOL, rtol=0)


@pytest.mark.slow
def test_revisit_at_speed_1_4_over_seeds(revisit):
    """Seeds 0-5 of each package's draws: each loses tracking in the
    first 30 frames on 5 of them (the port's draws with one torch thread;
    its float32 reductions round by the thread count)."""
    lost = {"reference": [], "port": []}
    for seed in range(6):
        lost["reference"].append(_first_lost(_reference_labels(revisit, seed)[0]))
        lost["port"].append(_first_lost(_port_labels(revisit, seed)))
    print(lost)
    assert lost == {"reference": [23, 10, None, 19, 18, 16], "port": [16, 21, 20, None, 14, 15]}


VIP_SEQ = dict(n_frames=120, H=240, W=320, n_points=3500, seed=9, motion="loop", speed=1.4,
               gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
               depth_noise=0.02, z_amp=0.5)
VIP_CFG = dict(n_tracks=200, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
               acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=6,
               vio_init_min_time=1.0, loop_closing=True)


def _stream_record(outs, seq, closures):
    """VIO-init frame, closures and the metric ATE (no alignment) over the
    WORKING frames from VIO init + 3 on, at frames 100 and 120, against
    phase 11's gate (5% of the trajectory's extent)."""
    states = np.asarray([int(o.state) for o in outs])
    vios = np.asarray([bool(o.vio_ok) for o in outs])
    C = np.asarray([-np.asarray(o.Rcw, np.float64).T @ np.asarray(o.tcw, np.float64)
                    for o in outs])
    init = int(np.argmax(vios)) if vios.any() else -1
    gt = seq.positions_w
    ate, gate = {}, {}
    for n in (100, 120):
        sel = [i for i in range(n) if init >= 0 and i >= init + 3 and states[i] == ttr.WORKING]
        ate[n] = float(ate_rmse(C[sel], gt[sel], align_scale=False)[0])
        gate[n] = 0.05 * float(np.linalg.norm(gt[:n] - gt[0], axis=1).max())
    return dict(init=init, closures=closures, ate=ate, gate=gate,
                labels="".join(str(s) for s in states))


def _watch_closures(ds, closures, frame_of):
    """Record (query frame, loop keyframe's frame, Sim3 scale) of every
    closure the stream's closer accepts."""
    real = ds.loop_closer.process_keyframe

    def process_keyframe(m, k):
        m2, stat = real(m, k)
        if stat.get("loop"):
            closures.append((ds.frame_id, frame_of(m2, stat["loop_kf"]), stat["scale"]))
        return m2, stat

    ds.loop_closer.process_keyframe = process_keyframe


@pytest.mark.slow
def test_vip_stream_ate_after_120_frames():
    from uvipslam_tpu.frontend import stream as jstream
    from uvipslam_tpu.frontend.device_vip import FrameBundle as JBundle
    from uvipslam_tpu.frontend.vip_tracker import VipConfig as JVipConfig
    from uvipslam_torch.frontend.device_vip import make_bundles
    from uvipslam_torch.frontend.stream import DeviceStream
    from uvipslam_torch.frontend.vip_tracker import VipConfig

    seq = make_sequence(**VIP_SEQ)
    K, n = seq.K, VIP_SEQ["n_frames"]
    runs = {}
    with jax.enable_x64(False):
        cam = JCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=320, height=240)
        ds = jstream.DeviceStream(cam, JVipConfig(**VIP_CFG), kf_cap=64, pt_cap=8192, mode="vip")
        closures = []
        _watch_closures(ds, closures, lambda m, k: int(m.kf_frame_id[k]))
        outs = []
        for f in range(n):
            outs.append(ds.process(JBundle(
                img=jnp.asarray(seq.images[f], jnp.float32),
                imu_omg=jnp.asarray(seq.imu_omg[f], jnp.float32),
                imu_acc=jnp.asarray(seq.imu_acc[f], jnp.float32),
                imu_dt=jnp.asarray(seq.imu_dt[f], jnp.float32),
                imu_mask=jnp.asarray(seq.imu_mask[f], jnp.float32),
                depth=jnp.asarray(seq.depth[f], jnp.float32),
                depth_valid=jnp.asarray(bool(seq.depth_valid[f])),
                timestamp=jnp.asarray(seq.timestamps[f], jnp.float32))))
        runs["reference"] = _stream_record(outs, seq, closures)
    cam = TCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=320, height=240)
    ds = DeviceStream(cam, VipConfig(**VIP_CFG), kf_cap=64, pt_cap=8192, mode="vip",
                      device="cpu")
    closures = []
    _watch_closures(ds, closures, lambda m, k: int(m.kf_frame_id[k]))
    outs = [ds.process(b) for b in make_bundles(seq, device="cpu")]
    runs["port"] = _stream_record(outs, seq, closures)
    for name, r in runs.items():
        print(name, r)
    ref, port = runs["reference"], runs["port"]
    assert ref["init"] == port["init"] == 20
    assert ref["closures"] == port["closures"] == []
    for r in (ref, port):
        # over phase 11's gate already at frame 100, and further at 120
        assert r["ate"][100] > r["gate"][100] and r["ate"][120] > r["ate"][100], r
    # not a port fault: the port's ATE at 120 frames within 1.5x the reference's
    assert port["ate"][120] < 1.5 * ref["ate"][120], runs
