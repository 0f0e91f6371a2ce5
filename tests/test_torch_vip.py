"""The whole VIP slice: the port's device VIP step against the reference's
`uvipslam_tpu.frontend.device_vip` on the same synthetic sequence with
IMU and pressure (120x160, 100 tracks, 40 frames, kf_cap 16, pt_cap
1024), and the VI stages started from the same carried-over state.

RANSAC draws differ between the frameworks (jax.random against a
torch.Generator), so the sequence-level checks compare outcomes: frame-0
tracks are equal, the VIO-init frames agree within 3, both steps are
WORKING on at least 80% of the frames, both metric ATEs (no scale
alignment, over the WORKING frames from VIO init + 3 on) are below 12%
of those frames' span (the bar of tests/test_device_vip.py), and the
two trajectories agree within 4% of the span after Sim3 alignment. The
pass with three black frames after VIO init (IMU recovery) is in
tests/test_torch_vip_blackout.py, so that two test workers share the two
sequence passes. The first-try lane of the VI solve is driven in the port
by a failing first solve. The carried-state checks feed both sides the
reference state just after VIO init (converted with uvipslam_torch.convert): the VI pose solve holds
poses at atol 1e-4 and inlier sets exactly; the VI window BA agrees to
1e-8 in float64, and in float32 on the final state (see
`test_carried_vi_ba` for why not on the state after init). The VIO init
itself runs on the state of the frame before its trigger: the gravity
alignment agrees within 1e-4 and the scale within 1e-3 (relative).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.core import preintegration as jpre
from uvipslam_tpu.frontend import device_vip as jdv
from uvipslam_tpu.frontend import vip_tracker as jvt
from uvipslam_tpu.io.synthetic import ate_rmse, make_sequence
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_torch import convert
from uvipslam_torch.core import preintegration as tpre
from uvipslam_torch.frontend import device_vip as tdv
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.models.camera import CameraModel as TCam
from tests.test_torch_step import _leaves
from tests.test_torch_threads import one_torch_thread, torch_threads  # noqa: F401

N_FRAMES = 40
H, W = 120, 160
KF_CAP, PT_CAP = 16, 1024
CFG = dict(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
           acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5, vio_init_min_time=1.0,
           imu_cap_per_kf=256)
ATOL = 1e-4
SCALE_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FRAMES, H=H, W=W, n_points=800, seed=3, speed=1.2,
                         gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                         depth_noise=0.02, z_amp=0.5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _centre(Rcw, tcw):
    return -np.asarray(Rcw, np.float64).T @ np.asarray(tcw, np.float64)


def _jbundle(seq, f):
    return jdv.FrameBundle(
        img=jnp.asarray(seq.images[f], jnp.float32),
        imu_omg=jnp.asarray(seq.imu_omg[f], jnp.float32),
        imu_acc=jnp.asarray(seq.imu_acc[f], jnp.float32),
        imu_dt=jnp.asarray(seq.imu_dt[f], jnp.float32),
        imu_mask=jnp.asarray(seq.imu_mask[f], jnp.float32),
        depth=jnp.asarray(seq.depth[f], jnp.float32),
        depth_valid=jnp.asarray(bool(seq.depth_valid[f])),
        timestamp=jnp.asarray(seq.timestamps[f], jnp.float32))


@pytest.fixture(scope="module")
def jax_run(seq):
    """The reference step, compiled once; per-frame outputs, the frame-0
    tracks, the state of every frame around VIO init as numpy trees, and
    the reference's own `try_init_vio` (a closure of its step)."""
    with jax.enable_x64(False):
        cam = JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                          height=H)
        st, step = jdv.build_vip_tracker(cam, jvt.VipConfig(**CFG), KF_CAP, PT_CAP)
        states, vios, C, kept = [], [], [], []
        for f in range(N_FRAMES):
            st, out = step(st, _jbundle(seq, f))
            states.append(int(out.state))
            vios.append(bool(out.vio_ok))
            C.append(_centre(out.Rcw, out.tcw))
            if f == 0:
                tracks0 = jax.tree_util.tree_map(np.asarray, st.tracks)
            if not any(vios[:-1]):
                # the last two states before (and at) VIO init
                kept = (kept + [jax.tree_util.tree_map(np.asarray, st)])[-2:]
        final = jax.tree_util.tree_map(np.asarray, st)
        raw = step.__wrapped__
        closure = dict(zip(raw.__code__.co_freevars, (c.cell_contents for c in raw.__closure__)))
        return dict(cam=cam, states=np.asarray(states), vios=np.asarray(vios),
                    C=np.asarray(C), tracks0=tracks0, pre_trigger=kept[0], post_init=kept[1],
                    final=final, try_init_vio=jax.jit(closure["try_init_vio"]))


def _port_run(seq, graphs):
    """The port's step over the sequence on the CPU, eager or graphed (the
    plain form of its captured segments): per-frame labels, VIO flags,
    centres, outputs and states."""
    cam = TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)
    st, step = tdv.build_vip_tracker(cam, tvt.VipConfig(**CFG), KF_CAP, PT_CAP, device="cpu",
                                     graphs=graphs)
    states, vios, C, outs, frames = [], [], [], [], []
    for f, b in enumerate(tdv.make_bundles(seq, device="cpu")):
        st, out = step(st, b)
        states.append(int(out.state))
        vios.append(bool(out.vio_ok))
        C.append(_centre(out.Rcw.numpy(), out.tcw.numpy()))
        outs.append(out)
        frames.append(st)
        if f == 0:
            tracks0 = st.tracks
    return dict(cam=cam, step=step, states=np.asarray(states), vios=np.asarray(vios),
                C=np.asarray(C), tracks0=tracks0, syncs=step.host_syncs, outs=outs,
                frames=frames)


@pytest.fixture(scope="module")
def torch_run(seq):
    return _port_run(seq, graphs=False)


@pytest.fixture(scope="module")
def torch_graph_run(seq):
    return _port_run(seq, graphs=True)


def _frame0_tracks_equal(jax_run, run):
    tj, tt = jax_run["tracks0"], run["tracks0"]
    for f in ("xy", "desc", "level", "valid", "pt_id", "birth_frame"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), getattr(tj, f), err_msg=f)
    for f in ("xy_und", "tpl", "tpl2"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), getattr(tj, f), atol=ATOL, rtol=0,
                                   err_msg=f)


def test_frame0_tracks_equal(jax_run, torch_run):
    _frame0_tracks_equal(jax_run, torch_run)


def test_vio_init_working_and_metric_ate(seq, jax_run, torch_run):
    _vio_init_working_and_metric_ate(seq, jax_run, torch_run)


def test_graphed_run_equals_eager_bit_for_bit(torch_run, torch_graph_run):
    """The graphed step (segments A-E in their plain CPU form) gives the
    eager step's outputs and states bit for bit on every frame, through
    VIO init and the VI keyframes, with the same host reads."""
    g = torch_graph_run
    assert g["step"].graphs and not torch_run["step"].graphs
    for f in range(N_FRAMES):
        for tree in ("outs", "frames"):
            for (name, a), (_, b) in zip(_leaves(torch_run[tree][f]), _leaves(g[tree][f])):
                assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                                   b.contiguous().view(-1).view(torch.uint8)), (f, tree, name)
    assert g["syncs"] == torch_run["syncs"]
    assert g["vios"].any() and ("D", True, True) in g["step"].segments.keys   # a VI keyframe


def test_graphed_run_against_reference(seq, jax_run, torch_graph_run):
    """The graphed run held to the reference as the eager run is."""
    _frame0_tracks_equal(jax_run, torch_graph_run)
    _vio_init_working_and_metric_ate(seq, jax_run, torch_graph_run)


def _vio_init_working_and_metric_ate(seq, jax_run, port):
    spans = {}
    for name, run in (("reference", jax_run), ("port", port)):
        assert run["vios"].any(), name
        working = run["states"] == ttr.WORKING
        assert working.sum() >= 0.8 * N_FRAMES, (name, run["states"])
        init_f = int(np.argmax(run["vios"]))
        sel = np.asarray([i for i in range(N_FRAMES) if i >= init_f + 3 and working[i]])
        assert len(sel) >= 8, (name, init_f, run["states"])
        gt = seq.positions_w[sel]
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        ate, _ = ate_rmse(run["C"][sel], gt, align_scale=False)
        assert ate < 0.12 * span, (name, ate, span)
        spans[name] = (init_f, sel)
    assert abs(spans["reference"][0] - spans["port"][0]) <= 3, spans
    both = np.intersect1d(spans["reference"][1], spans["port"][1])
    gt = seq.positions_w[both]
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    mutual, _ = ate_rmse(port["C"][both], jax_run["C"][both])
    assert mutual < 0.04 * span, (mutual, span)
    # one state read per frame plus the branch decisions
    assert N_FRAMES < port["syncs"] <= 4 * N_FRAMES


def test_first_try_lane_forces_a_keyframe(jax_run, torch_run, seq, monkeypatch):
    """When the normal VI solve fails, the second lane solves on the
    first-try projection associations of the last keyframe and, when it
    holds, forces a keyframe (one more host read)."""
    src = jax_run["post_init"]
    calls = []
    real = tdv._vi_track

    def lane0_fails(tracks, *a):
        out = real(tracks, *a)
        calls.append(int(out[2]))
        return out if len(calls) > 1 else out[:2] + (torch.zeros_like(out[2]),) + out[3:]

    monkeypatch.setattr(tdv, "_vi_track", lane0_fails)
    st = convert.vip_state(src)
    step = tdv.VipStep(torch_run["cam"], tvt.VipConfig(**CFG), KF_CAP, device="cpu")
    st, out = step(st, tdv.make_bundles(seq, device="cpu")[int(src.frame_id) + 1])
    assert len(calls) == 2 and calls[1] >= step.reloc_min, calls
    assert int(out.state) == ttr.WORKING
    assert int(out.new_kf) == int(src.map.n_kf)           # the forced keyframe


@pytest.mark.parametrize("outcome", ["holds", "fails"])
def test_lane1_frame_graphed_equals_eager(jax_run, torch_run, seq, monkeypatch, outcome):
    """The lane-1 frame of `test_first_try_lane_forces_a_keyframe` (the
    VI solve made to fail; failing too on the first-try associations for
    `fails`) through the graphed step (segment L up to the lane's read;
    holding, the forced keyframe through the VI keyframe frame's segments
    C, D and E; failing, the dead reckoning into IMU_RELOC and the ring in
    segment I; their plain CPU form) against `graphs=False`: output,
    state and host reads bit for bit equal."""
    src = jax_run["post_init"]
    b = tdv.make_bundles(seq, device="cpu")[int(src.frame_id) + 1]
    real = tdv._vi_track
    runs = {}
    for graphs in (False, True):
        calls = []

        def lane_fails(tracks, *a, calls=calls):
            out = real(tracks, *a)
            calls.append(int(out[2]))
            if outcome == "fails" or len(calls) == 1:
                out = out[:2] + (torch.zeros_like(out[2]),) + out[3:]
            return out

        monkeypatch.setattr(tdv, "_vi_track", lane_fails)
        step = tdv.VipStep(torch_run["cam"], tvt.VipConfig(**CFG), KF_CAP, device="cpu",
                           graphs=graphs)
        runs[graphs] = (step, *step(convert.vip_state(src), b), calls)
    (e_step, e_st, e_out, e_calls), (g_step, g_st, g_out, g_calls) = runs[False], runs[True]
    for tree in ("out", "st"):
        e, g = (e_out, g_out) if tree == "out" else (e_st, g_st)
        for (name, x), (_, y) in zip(_leaves(e), _leaves(g)):
            assert torch.equal(x.contiguous().view(-1).view(torch.uint8),
                               y.contiguous().view(-1).view(torch.uint8)), (tree, name)
    assert e_step.host_syncs == g_step.host_syncs and e_calls == g_calls
    assert len(e_calls) == 2 and e_step.segments.keys == set()
    if outcome == "holds":
        assert e_calls[1] >= e_step.reloc_min and int(e_out.state) == ttr.WORKING
        assert int(e_out.new_kf) == int(src.map.n_kf)
        assert ({("L",), ("C", True, True), ("D", True, True), ("E", True, False)}
                <= g_step.segments.keys)
    else:
        assert int(e_out.state) == ttr.IMU_RELOC and int(e_out.new_kf) == -1
        assert {("L",), ("I",)} <= g_step.segments.keys


def _vi_args(src, seq, cfg, f, convert_side):
    """Inputs of the VI pose solve for frame f from the carried state:
    the reference's IMU prediction over frame f's samples."""
    b = _jbundle(seq, f)
    pre = jax.tree_util.tree_map(np.asarray, jpre.preintegrate(
        b.imu_omg, b.imu_acc, b.imu_dt, b.imu_mask, jnp.asarray(src.ns.bg + src.ns.dbg),
        jnp.asarray(src.ns.ba + src.ns.dba), cfg.gyr_noise_sd, cfg.acc_noise_sd))
    g = np.asarray(cfg.gravity, np.float32)
    ns, dt = src.ns, pre.dt
    R = ns.R @ pre.dR
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    ns_pred = dataclasses.replace(
        ns, p=(ns.p + ns.v * dt + 0.5 * g * dt * dt + ns.R @ pre.dP).astype(np.float32),
        v=(ns.v + g * dt + ns.R @ pre.dV).astype(np.float32), R=(u @ vt).astype(np.float32))
    depth = np.float32(seq.depth[f])
    info = np.float32(1.0 / cfg.depth_noise_sd ** 2 if seq.depth_valid[f] else 0.0)
    return convert_side(ns_pred, pre, depth, info)


def test_carried_vi_track(seq, jax_run, torch_run):
    src = jax_run["post_init"]
    cfg_j, cfg_t = jvt.VipConfig(**CFG), tvt.VipConfig(**CFG)
    f = int(src.frame_id) + 1
    sig = np.asarray(cfg_j.scale_sigmas, np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    cj, ct = jax_run["cam"], torch_run["cam"]
    j = _vi_args(src, seq, cfg_j, f, lambda ns, pre, d, i: jvt._vi_track_jit(
        jax.tree_util.tree_map(jnp.asarray, src.tracks),
        jax.tree_util.tree_map(jnp.asarray, src.map), jax.tree_util.tree_map(jnp.asarray, ns),
        jax.tree_util.tree_map(jnp.asarray, src.ns), jax.tree_util.tree_map(jnp.asarray, pre),
        jnp.asarray(cfg_j.gravity, jnp.float32), cj.fx, cj.fy, cj.cx, cj.cy, jnp.asarray(sig),
        cfg_j.gyr_bias_rw2, cfg_j.acc_bias_rw2, jnp.asarray(d), jnp.asarray(i),
        jnp.asarray(src.H_prior), jnp.asarray(eye), jnp.asarray(zero)))
    j = jax.tree_util.tree_map(np.asarray, j)
    st = convert.vip_state(src)
    t = _vi_args(src, seq, cfg_j, f, lambda ns, pre, d, i: tvt._vi_track(
        st.tracks, st.map, convert.nav_state(ns), st.ns, convert.convert(tpre.PreintState, pre),
        torch.tensor(cfg_t.gravity, dtype=torch.float32), ct.fx, ct.fy, ct.cx, ct.cy,
        torch.from_numpy(sig), cfg_t.gyr_bias_rw2, cfg_t.acc_bias_rw2, torch.tensor(d),
        torch.tensor(i), st.H_prior, torch.from_numpy(eye), torch.from_numpy(zero)))
    for name in ("p", "v", "R", "dbg", "dba"):
        np.testing.assert_allclose(_np(getattr(t[0], name)), getattr(j[0], name), atol=ATOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(_np(t[1]), j[1])
    assert int(t[2]) == int(j[2]) >= 20
    np.testing.assert_array_equal(_np(t[3].pt_id), j[3].pt_id)
    # the next frame's prior: float32 products of entries up to ~1e6
    # the next frame's prior, a Schur marginal formed by cancellation of
    # float32 products: 1.0e-4 of its largest entry apart here
    np.testing.assert_allclose(_np(t[4]), j[4], rtol=0, atol=5e-4 * np.abs(j[4]).max())


def _vi_ba_both(src, cam_j, cam_t, npdt):
    """The VI window BA of both sides on carried state src, every float
    array in npdt."""
    cfg = jvt.VipConfig(**CFG)
    m = jax.tree_util.tree_map(lambda a: a.astype(npdt) if a.dtype == np.float32 else a, src.map)
    sig = np.asarray(cfg.scale_sigmas, npdt)
    eye, zero = np.eye(3, dtype=npdt), np.zeros(3, npdt)
    info = npdt(1.0 / cfg.depth_noise_sd ** 2)
    with jax.enable_x64(npdt == np.float64):
        jm = jax.tree_util.tree_map(np.asarray, jvt._vi_ba_jit(
            jax.tree_util.tree_map(jnp.asarray, m), np.asarray(cfg.gravity, npdt), cam_j.fx,
            cam_j.fy, cam_j.cx, cam_j.cy, sig, cfg.gyr_bias_rw2, cfg.acc_bias_rw2, info, eye,
            zero))
    tm = tvt._vi_ba(convert.map_state(m), torch.from_numpy(np.asarray(cfg.gravity, npdt)),
                    cam_t.fx, cam_t.fy, cam_t.cx, cam_t.cy, torch.from_numpy(sig),
                    cfg.gyr_bias_rw2, cfg.acc_bias_rw2, float(info), torch.from_numpy(eye),
                    torch.from_numpy(zero))
    return tm, jm


NAV_FIELDS = ("p", "v", "R", "bg", "ba", "dbg", "dba")


@pytest.mark.parametrize("case", ["post_init-f64", "final-f32"])
def test_carried_vi_ba(jax_run, torch_run, case):
    """In float64 the VI window BA of port and reference agree to 1e-8 on
    the state just after VIO init. In float32 the window BA of both sides
    accepts no LM step on the tracker's states (the float64 solve moves
    the keyframes by up to 0.09 and their velocities by up to 0.21), so
    on the final state both return the window as it came; on the state
    just after VIO init the port accepts steps that the reference rejects
    (a decision below float32 resolution), so that state is held in
    float64 only."""
    name, dkey = case.split("-")
    src = jax_run[name]
    npdt = np.float64 if dkey == "f64" else np.float32
    tm, jm = _vi_ba_both(src, jax_run["cam"], torch_run["cam"], npdt)
    atol = 1e-8 if dkey == "f64" else ATOL
    for f in NAV_FIELDS:
        np.testing.assert_allclose(_np(getattr(tm.kf_ns, f)), getattr(jm.kf_ns, f), atol=atol,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(_np(tm.pt_xyz), jm.pt_xyz, atol=atol, rtol=0)
    np.testing.assert_array_equal(_np(tm.kf_feat_pt), jm.kf_feat_pt)
    if dkey == "f64":
        assert np.abs(jm.kf_ns.p - src.map.kf_ns.p).max() > 1e-2   # the BA moved the window


def _scale_and_alignment(before, after):
    """(s, R_align) of a VIO init from its pose ring: ring_t' = s ring_t,
    ring_R' = ring_R R_align^T."""
    rt, rt2 = np.asarray(before.ring_t, np.float64), np.asarray(after.ring_t, np.float64)
    k = np.unravel_index(np.argmax(np.abs(rt)), rt.shape)
    R = np.asarray(before.ring_R[k[0]], np.float64)
    R2 = np.asarray(after.ring_R[k[0]], np.float64)
    return rt2[k] / rt[k], R2.T @ R


def test_try_init_vio_on_pre_trigger_state(jax_run, torch_run, one_torch_thread):
    _try_init_vio_against_reference(jax_run, torch_run["step"], one_torch_thread)


def _vio_init_agrees(src, a, b):
    """Two VIO inits of the state `src` agree within the bars the
    reference holds the port's to: the scale within SCALE_RTOL, the
    gravity direction within ATOL, the keyframe positions within 1e-3."""
    s_a, Ra_a = _scale_and_alignment(src, a)
    s_b, Ra_b = _scale_and_alignment(src, b)
    np.testing.assert_allclose(s_a, s_b, rtol=SCALE_RTOL)
    g = np.asarray(jvt.VipConfig(**CFG).gravity, np.float64)
    g /= np.linalg.norm(g)
    np.testing.assert_allclose(Ra_a.T @ g, Ra_b.T @ g, atol=ATOL)
    np.testing.assert_allclose(_np(a.map.kf_ns.p), _np(b.map.kf_ns.p), atol=1e-3)


def test_fleet_vio_init_through_lifted_scans(jax_run, torch_run, one_torch_thread):
    """The fleet's VIO init on the pre-trigger state stacked as two
    streams, its loops through the fleet's lifted scan: graphed (the
    plain form of one capture per loop and carry layout, replayed per
    iteration for both streams) equals `graphs=False` (the plain loops of
    the vmapped bodies) bit for bit, and that equals the old form (the
    plain loops run under the fleet's `vmap`) bit for bit on the CPU.
    Each stream agrees with the single step's VIO init within the bars of
    the reference (`_vio_init_agrees`); not bit for bit, since the
    fleet's batched products round otherwise (a free-gauge float32 BA
    inside)."""
    from uvipslam_torch.core.tree import over_streams, stack_streams, tree_map

    src = dataclasses.replace(convert.vip_state(jax_run["pre_trigger"]), gen=None)
    fleet_st = stack_streams([src, src])
    cam, cfg = torch_run["cam"], tvt.VipConfig(**CFG)
    runs = {}
    for form in ("graphed", "eager", "old"):
        fleet = tdv.VipFleetStep(cam, cfg, KF_CAP, device="cpu", graphs=form == "graphed")
        if form == "old":
            fleet.one.scan = fleet.one.segments.scan
        with torch_threads(one_torch_thread):
            runs[form] = over_streams(fleet.one._try_init_vio, fleet_st), fleet.segments
    for form in ("eager", "old"):
        for (name, a), (_, b) in zip(_leaves(runs["graphed"][0]), _leaves(runs[form][0])):
            assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                               b.contiguous().view(-1).view(torch.uint8)), (form, name)
    graphed = runs["graphed"][1]
    assert graphed.scan_steps > 0 and runs["eager"][1].scan_steps == 0
    assert {k[-1] for k in graphed.keys} == {"streams"}
    with torch_threads(one_torch_thread):
        single, ok1 = torch_run["step"]._try_init_vio(convert.vip_state(jax_run["pre_trigger"]))
    out, ok = runs["graphed"][0]
    assert bool(ok1) and ok.tolist() == [True, True]
    for i in range(2):
        _vio_init_agrees(src, tree_map(lambda a: a[i], out), single)


def test_try_init_vio_through_scans_on_pre_trigger_state(jax_run, torch_graph_run,
                                                         one_torch_thread):
    """The VIO init with its loops run through a graphed `Segments.scan`
    (its plain CPU form: a capture per loop, replayed per iteration) held
    to the reference as the plain loops are."""
    step = torch_graph_run["step"]
    steps = step.segments.scan_steps
    _try_init_vio_against_reference(jax_run, step, one_torch_thread)
    assert step.segments.scan_steps > steps


def test_graphed_step_through_pre_vio_keyframe_and_vio_init(seq, jax_run, torch_run):
    """From the reference's state before its VIO-init frame, that frame
    through the graphed step (the pre-VIO keyframe as segments D, E and R
    in their plain CPU form, the VIO init's loops through
    `Segments.scan`) against `graphs=False`: the frame makes a keyframe,
    its trigger fires and VIO initializes; output, state and host reads
    equal bit for bit."""
    src = jax_run["pre_trigger"]
    b = tdv.make_bundles(seq, device="cpu")[int(src.frame_id) + 1]
    runs = {}
    for graphs in (False, True):
        step = tdv.VipStep(torch_run["cam"], tvt.VipConfig(**CFG), KF_CAP, device="cpu",
                           graphs=graphs)
        runs[graphs] = step, *step(convert.vip_state(src), b)
    (e_step, e_st, e_out), (g_step, g_st, g_out) = runs[False], runs[True]
    assert int(e_out.new_kf) >= 0 and bool(e_out.vio_ok) and not bool(src.vio_ok)
    for tree in ("out", "st"):
        e, g = (e_out, g_out) if tree == "out" else (e_st, g_st)
        for (name, x), (_, y) in zip(_leaves(e), _leaves(g)):
            assert torch.equal(x.contiguous().view(-1).view(torch.uint8),
                               y.contiguous().view(-1).view(torch.uint8)), (tree, name)
    assert e_step.host_syncs == g_step.host_syncs
    assert {("D", False, True), ("E", False, False), ("R",)} <= g_step.segments.keys
    assert e_step.segments.scan_steps == 0 < g_step.segments.scan_steps


def _try_init_vio_against_reference(jax_run, step, one_torch_thread):
    src = jax_run["pre_trigger"]
    with jax.enable_x64(False):
        j = jax_run["try_init_vio"](jax.tree_util.tree_map(jnp.asarray, src))
        j = jax.tree_util.tree_map(np.asarray, j)
    st = convert.vip_state(src)
    # under torch's default thread pool, as the scale bar below was set:
    # the float32 full-map BA inside has a free scale gauge, and the
    # rounding of its reductions (split over the pool's threads) moves
    # where its LM stops (with one thread the scale lands 6.1e-3 apart)
    with torch_threads(one_torch_thread):
        t, ok = step._try_init_vio(st)
    assert bool(j.vio_ok) and bool(ok)
    s_j, Ra_j = _scale_and_alignment(src, j)
    s_t, Ra_t = _scale_and_alignment(src, t)
    assert 0.1 < s_j < 10.0
    # the scale rests on the float32 full-map BA inside, whose LM stops at
    # slightly different places in the two implementations (see
    # tests/test_torch_vi.py::test_global_ba_visual): 5.5e-4 apart here
    np.testing.assert_allclose(s_t, s_j, rtol=SCALE_RTOL)
    # the gravity direction the alignment rotates onto the configured one
    g = np.asarray(jvt.VipConfig(**CFG).gravity, np.float64)
    g /= np.linalg.norm(g)
    np.testing.assert_allclose(Ra_t.T @ g, Ra_j.T @ g, atol=ATOL)
    np.testing.assert_allclose(_np(t.map.kf_ns.p), j.map.kf_ns.p, atol=1e-3)


def test_convert_carries_every_field(jax_run):
    """The converter copies every field of the reference VIP state by name,
    the nested NavStates and preintegrations included; the PRNG key
    becomes a fresh generator."""
    src = jax_run["post_init"]
    ported = convert.vip_state(src)
    assert isinstance(ported.gen, torch.Generator)
    names = []
    for name, a in _leaves(ported):
        b = src
        for part in name.split("."):
            b = b[int(part)] if part.isdigit() else getattr(b, part)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.numpy().dtype == np.asarray(b).dtype, name
        names.append(name)
    for nested in ("ns.p", "rec_ns.bg", "preint_kf.cov", "rec_preint.J_R_bg", "map.kf_ns.v",
                   "map.kf_preint.dP", "tracks.tpl2", "pyr_prev.0"):
        assert nested in names, nested
    ref_fields = {f.name for f in dataclasses.fields(src)}
    assert ref_fields - {f.name for f in dataclasses.fields(ported)} == {"key"}
