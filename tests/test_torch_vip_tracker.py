"""The host VIP tracker: the port's `frontend.vip_tracker.VipTracker`
against the reference's `uvipslam_tpu.frontend.vip_tracker.VipTracker`.

The reference tracker runs once over a 120x160, 36-frame sequence with
IMU, pressure and the camera-in-body rig of tests/test_parity_harness.py
(Tbc != I: ~15 degrees, ~10 cm), recording its own state on entry to each
method under test and the result. On frame FIRST_TRY its first VI solve
is made to fail, so that the first-try relocalization tier fires (and
forces a keyframe after VIO init); frames BLACK are black, so that the VI
solve and its first try fail and the tracker enters IMU_RELOC, re-anchors
and comes back through the two-view recovery. Each method of the port
then runs on the entry state carried over by `convert.vip_tracker`, with
the reference's RANSAC samples injected where the reference draws them
(the propagation's F-RANSAC gate, the recovery's two-view), and is held
to the reference's result: integers, states and associations exactly,
poses and NavStates at 1e-4. The float32 window BAs can take other LM
steps than the reference's where an accept test falls below float32
resolution (ROADMAP Queue 3, shared by the reference), so each BA is held
in float64 at 1e-8 on the map the reference gave it, and its float32
result at 1e-4 wherever the reference's own float32 solve stays within
1e-4 of the float64 one. The VIO init (init modes 1 and 2, with the rig
and with Tbc = I) is held at the scale (1e-3 relative) and the gravity
alignment (1e-4), as tests/test_torch_vip.py holds the device step's.

The CLAHE trap is pinned: `enhance` applies to the frames of the mono
bootstrap only, in the reference and in the port. The port's
`VipTracker` against the port's device `VipStep` end to end is in
tests/test_torch_vip_tracker_e2e.py, so that two test workers share the
two halves (the reference's host run alone takes ~100 s on one CPU
worker).
"""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.frontend import vip_tracker as jvt
from uvipslam_tpu.io.synthetic import _so3_exp_np, make_sequence
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.ops import twoview as jtv
from uvipslam_torch import convert
from uvipslam_torch.frontend import frame as tframe
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.models.camera import CameraModel as TCam
from tests.test_torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 36
H, W = 120, 160
KF_CAP, PT_CAP = 16, 1024
TBC = np.eye(4)
TBC[:3, :3] = _so3_exp_np(np.array([0.15, -0.10, 0.20]))     # tests/test_parity_harness.py:163
TBC[:3, 3] = [0.08, -0.05, 0.07]
CFG = dict(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
           acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5, vio_init_min_time=1.0,
           Tbc=tuple(map(tuple, TBC.tolist())))
FIRST_TRY = 24          # the frame whose first VI solve is made to fail
BLACK = (28, 29, 30)
ATOL = 1e-4
ATOL64 = 1e-8
SCALE_RTOL = 1e-3
NAV = ("p", "v", "R", "bg", "ba", "dbg", "dba")


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _sequence():
    return make_sequence(n_frames=N_FRAMES, H=H, W=W, n_points=800, seed=3, speed=1.2,
                         gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                         acc_bias=(0.0, 0.0, 0.0), depth_noise=0.02, z_amp=0.5, Tbc=TBC)


@pytest.fixture(scope="module")
def seq():
    return _sequence()


def _inputs(seq, f):
    img = np.zeros_like(seq.images[f]) if f in BLACK else seq.images[f]
    return (img, seq.imu_omg[f], seq.imu_acc[f], seq.imu_dt[f], seq.imu_mask[f]), dict(
        depth=seq.depth[f], depth_valid=bool(seq.depth_valid[f]), timestamp=seq.timestamps[f])


def _snapshot(tr):
    s = copy.copy(tr)
    s.trajectory = list(tr.trajectory)
    s.loop_events = list(tr.loop_events)
    s.kf_imu = dict(tr.kf_imu)       # the reference's stash assigns into this dict
    s.calls = None
    return s


class Recording(jvt.VipTracker):
    """The reference tracker, recording (state on entry, arguments,
    result, state after) of every call of the methods under test."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = {}

    def _record(self, name, *args):
        before = _snapshot(self)
        out = getattr(jvt.VipTracker, name)(self, *args)
        self.calls.setdefault(name, []).append((before, args, out, _snapshot(self)))
        return out

    def _process_frame_vi(self, img, pre_frame):
        return self._record("_process_frame_vi", img, pre_frame)

    def _process_frame_recovery(self, img, pre_frame):
        return self._record("_process_frame_recovery", img, pre_frame)

    def _create_keyframe(self):
        return self._record("_create_keyframe")

    def _maybe_init_vio(self):
        return self._record("_maybe_init_vio")

    def _run_local_ba(self, m, fixed_slots=None):
        return self._record("_run_local_ba", m, fixed_slots)

    def _run_vi_ba(self, m):
        return self._record("_run_vi_ba", m)

    def _apply_world_sim3(self, s, R_align):
        return self._record("_apply_world_sim3", s, R_align)


def _jcam(seq):
    return JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)


def _tcam(seq):
    return TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)


def _failing_first_solve(module, name, zeros_like, when):
    """`module.name` (a VI solve) with its inlier count zeroed on its
    first call for which `when()` holds."""
    real = getattr(module, name)
    done = []

    def solve(*a):
        out = real(*a)
        if done or not when():
            return out
        done.append(True)
        return out[:2] + (zeros_like(out[2]),) + out[3:]

    return solve


@pytest.fixture(scope="module")
def jax_run(seq):
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        tr = Recording(_jcam(seq), jvt.VipConfig(**CFG), kf_cap=KF_CAP, pt_cap=PT_CAP)
        mp.setattr(jvt, "_vi_track_jit", _failing_first_solve(
            jvt, "_vi_track_jit", jnp.zeros_like, lambda: tr.frame_id == FIRST_TRY))
        status = []
        for f in range(N_FRAMES):
            a, kw = _inputs(seq, f)
            status.append(tr.process_frame_vip(*a, **kw))
        return dict(tr=tr, status=status)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0, err_msg=msg)


def _same_pose(t, j, atol=ATOL):
    _close(t.Rcw, j.Rcw, atol, "Rcw")
    _close(t.tcw, j.tcw, atol, "tcw")


def _same_ns(t_ns, j_ns, atol=ATOL):
    for f in NAV:
        _close(getattr(t_ns, f), getattr(j_ns, f), atol, f)


def _call(jax_run, name, pred=lambda before, args, out, after: True):
    found = [c for c in jax_run["tr"].calls.get(name, []) if pred(*c)]
    assert found, name
    return found


@pytest.fixture
def reference_samples(monkeypatch):
    """Inject the reference's RANSAC samples into a port replay that
    starts from `before`: the propagation's F-RANSAC gate (the first key
    the reference splits off) and, in recovery, the two-view's (the
    second)."""

    def inject(before):
        k0, k_prop = jax.random.split(before.key)
        k_tv = jax.random.split(k0)[1]
        real_ff, real_tv = tframe.find_fundamental, tvt.initialize_two_view

        def sample(key, k, valid, n_iters):
            return torch.from_numpy(np.asarray(jtv._sample_minimal(
                key, n_iters, k, jnp.asarray(valid.numpy())))).long()

        def find_fundamental(gen, xa, xb, valid, sigma=1.0, n_iters=200, idx=None, u=None):
            return real_ff(gen, xa, xb, valid, sigma, n_iters, idx=sample(k_prop, 8, valid,
                                                                          n_iters))

        def initialize_two_view(gen, xa, xb, valid, K, sigma=1.0, n_iters=200):
            kf_, kh_ = jax.random.split(k_tv)
            return real_tv(gen, xa, xb, valid, K, sigma, n_iters,
                           idx_f=sample(kf_, 8, valid, n_iters),
                           idx_h=sample(kh_, 4, valid, n_iters))

        monkeypatch.setattr(tframe, "find_fundamental", find_fundamental)
        monkeypatch.setattr(tvt, "initialize_two_view", initialize_two_view)

    return inject


def _pre_frame(before, args):
    """The port's copy of the frame's preintegration the reference
    passed in."""
    from uvipslam_torch.core.preintegration import PreintState
    return convert.convert(PreintState, jax.tree_util.tree_map(np.asarray, args[1]))


# ---------------------------------------------------------------------------
# float64 window BAs on the maps the reference gave them
# ---------------------------------------------------------------------------


def _as(m, npdt):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(npdt) if np.asarray(a).dtype == np.float32
        else np.asarray(a), m)


def _local_ba64(pre, cam_j, cam_t):
    """The mono window BA (`_run_local_ba`'s gauge) of both sides in
    float64."""
    m = _as(pre, np.float64)
    idx = np.arange(m.kf_valid.shape[0])
    n_kf = int(m.n_kf)
    fixed = m.kf_valid & ~((idx >= max(0, n_kf - CFG["local_window"])) & (idx < n_kf))
    fixed[0] = True
    fixed[1] = m.kf_valid[1]
    sig = np.asarray(jvt.VipConfig().scale_sigmas, np.float64)
    with jax.enable_x64(True):
        j = jax.tree_util.tree_map(np.asarray, jtr._local_ba_jit(
            jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(fixed), cam_j.fx, cam_j.fy,
            cam_j.cx, cam_j.cy, jnp.asarray(sig)))
    t = ttr._window_ba(convert.map_state(m), cam_t, CFG["local_window"], torch.from_numpy(sig))
    return t, j


def _vi_ba64(pre, cam_j, cam_t):
    """The VI(P) window BA of both sides in float64, through the rig."""
    cfg = jvt.VipConfig(**CFG)
    m = _as(pre, np.float64)
    sig = np.asarray(cfg.scale_sigmas, np.float64)
    Rcb = TBC[:3, :3].T.copy()
    tcb = -Rcb @ TBC[:3, 3]
    info = 1.0 / cfg.depth_noise_sd ** 2
    g = np.asarray(cfg.gravity, np.float64)
    with jax.enable_x64(True):
        j = jax.tree_util.tree_map(np.asarray, jvt._vi_ba_jit(
            jax.tree_util.tree_map(jnp.asarray, m), g, cam_j.fx, cam_j.fy, cam_j.cx, cam_j.cy,
            sig, cfg.gyr_bias_rw2, cfg.acc_bias_rw2, np.float64(info), Rcb, tcb))
    t = tvt._vi_ba(convert.map_state(m), torch.from_numpy(g), cam_t.fx, cam_t.fy, cam_t.cx,
                   cam_t.cy, torch.from_numpy(sig), cfg.gyr_bias_rw2, cfg.acc_bias_rw2, info,
                   torch.from_numpy(Rcb), torch.from_numpy(tcb))
    return t, j


def _ba_holds(ba64, pre, j_out, t_out, fields):
    """A window BA: float64 port == float64 reference at 1e-8; returns
    whether the reference's float32 result stays within ATOL of its
    float64 solve (the float32 results are compared only then)."""
    t64, j64 = ba64
    for f in fields:
        _close(getattr(t64.kf_ns, f), getattr(j64.kf_ns, f), ATOL64, f)
    _close(t64.pt_xyz, j64.pt_xyz, ATOL64, "pt_xyz")
    np.testing.assert_array_equal(_np(t64.kf_feat_pt), j64.kf_feat_pt)
    return all(np.abs(_np(getattr(j_out.kf_ns, f)) - getattr(j64.kf_ns, f)).max() < ATOL
               for f in fields) and np.abs(_np(j_out.pt_xyz) - j64.pt_xyz).max() < ATOL


# ---------------------------------------------------------------------------
# the recorded run
# ---------------------------------------------------------------------------


def test_reference_run_covers_every_branch(jax_run):
    """The recorded run reaches VIO init, fires the first-try tier on
    FIRST_TRY, enters IMU_RELOC on the blackout and re-initializes."""
    st = [s.get("state") for s in jax_run["status"]]
    tr = jax_run["tr"]
    assert tr.vio_ok and st[-1] == "WORKING", st
    assert jax_run["status"][FIRST_TRY].get("first_try_reloc"), jax_run["status"][FIRST_TRY]
    assert st[BLACK[0]] == "IMU_RELOC", st
    assert any(s.get("recovery") == "re-initialized" for s in jax_run["status"]), st
    inits = [c for c in tr.calls["_maybe_init_vio"] if not c[0].vio_ok and c[3].vio_ok]
    assert len(inits) == 1


def test_convert_carries_the_vip_tracker(jax_run):
    """convert.vip_tracker copies the reference tracker's state: the mono
    part (tracks, map, poses, ring, trajectory, host fields), the inertial
    state and the recovery anchor."""
    from tests.test_torch_step import _leaves

    src = jax_run["tr"]
    t = convert.vip_tracker(src)
    for name, a in _leaves(t.map):
        b = src.map
        for part in name.split("."):
            b = getattr(b, part)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for f in ("Rcw", "tcw", "R_vel", "t_vel", "ring_R", "ring_t", "ring_frame", "H_prior",
              "accw_sum", "cur_depth", "Rbc", "tbc", "Rcb", "tcb", "gravity_w"):
        np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(src, f)), err_msg=f)
    for f in NAV:
        for ns in ("ns", "ns_prev", "rec_anchor_ns"):
            np.testing.assert_array_equal(_np(getattr(getattr(t, ns), f)),
                                          np.asarray(getattr(getattr(src, ns), f)))
    for k in ("omg", "acc", "dt", "mask", "n"):
        np.testing.assert_array_equal(_np(t.kf_imu[k]), np.asarray(src.kf_imu[k]), err_msg=k)
        np.testing.assert_array_equal(_np(t.rec_anchor_imu[k]), np.asarray(src.rec_anchor_imu[k]))
    for f in dataclasses.fields(t.preint_kf):
        np.testing.assert_array_equal(_np(getattr(t.preint_kf, f.name)),
                                      np.asarray(getattr(src.preint_kf, f.name)))
    for f in ("state", "frame_id", "last_kf_slot", "last_kf_frame", "n_ref_tracked", "vio_ok",
              "cur_depth_valid", "frame_time", "has_extrinsics", "rec_anchor_frame",
              "rec_anchor_time", "_reloc_bias_after_kf"):
        assert getattr(t, f) == getattr(src, f), f
    assert t.has_extrinsics
    assert [f for f, _, _ in t.trajectory] == [f for f, _, _ in src.trajectory]
    np.testing.assert_allclose(t.trajectory_positions(), src.trajectory_positions(), atol=1e-5)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(src.cfg)


# ---------------------------------------------------------------------------
# the methods on carried states
# ---------------------------------------------------------------------------


def _vi_frame(name):
    return {"vi": lambda b, a, o, af: (b.frame_id + 1 not in (FIRST_TRY,) + BLACK
                                       and af.last_kf_frame != b.frame_id + 1),
            "first_try": lambda b, a, o, af: b.frame_id + 1 == FIRST_TRY,
            "imu_reloc": lambda b, a, o, af: b.frame_id + 1 == BLACK[0]}[name]


@pytest.mark.parametrize("case", ["vi", "first_try", "imu_reloc"])
def test_process_frame_vi_on_carried_states(jax_run, reference_samples, monkeypatch, case):
    """A VI frame on the reference's entry state: the IMU prediction, the
    propagation (with the reference's F-RANSAC samples), the VI solve and
    what follows. `first_try`: the first solve fails (made to, on both
    sides), the first-try associations hold and force a keyframe;
    `imu_reloc`: a black frame, both tiers fail and IMU_RELOC begins from
    the dead-reckoned state with a fresh detection."""
    calls = _call(jax_run, "_process_frame_vi", _vi_frame(case))
    before, args, out, after = calls[0]
    t = convert.vip_tracker(before)
    reference_samples(before)
    if case == "first_try":
        monkeypatch.setattr(tvt, "_vi_track", _failing_first_solve(
            tvt, "_vi_track", torch.zeros_like, lambda: True))
        t_vi_ba = []
        real_ba = t._run_vi_ba
        t._run_vi_ba = lambda m: t_vi_ba.append(m) or real_ba(m)
    st = t._process_frame_vi(torch.from_numpy(np.array(args[0])), _pre_frame(before, args))
    assert st == out, (st, out)
    assert t.state == after.state and t.frame_id == after.frame_id
    np.testing.assert_array_equal(_np(t.tracks.valid), np.asarray(after.tracks.valid))
    np.testing.assert_array_equal(_np(t.tracks.pt_id), np.asarray(after.tracks.pt_id))
    np.testing.assert_array_equal(_np(t.tracks.birth_frame), np.asarray(after.tracks.birth_frame))
    _close(t.tracks.xy, after.tracks.xy, 1e-3, "xy")
    np.testing.assert_array_equal(_np(t.ring_frame), np.asarray(after.ring_frame))
    assert t.last_kf_slot == after.last_kf_slot and t.n_ref_tracked == after.n_ref_tracked
    assert int(t.map.n_kf) == int(after.map.n_kf) and int(t.map.n_pt) == int(after.map.n_pt)
    assert [f for f, _, _ in t.trajectory] == [f for f, _, _ in after.trajectory]
    if case == "imu_reloc":
        assert out["state"] == "IMU_RELOC"
        assert t.rec_anchor_frame == after.rec_anchor_frame == after.frame_id
        _same_ns(t.rec_anchor_ns, after.rec_anchor_ns)
        _same_ns(t.ns, after.ns)
        _same_pose(t, after)
        _close(t.H_prior, after.H_prior, 0.0, "H_prior")
        assert int(t.kf_imu["n"]) == int(after.kf_imu["n"]) == 0
        assert int(t.rec_anchor_imu["n"]) == int(after.rec_anchor_imu["n"]) > 0
        # the solve and the first try's matches (too few on a black frame
        # for its solve)
        assert t.host_syncs == 2
        return
    assert out["state"] == "WORKING" and out.get("vio")
    if case == "vi":
        _same_ns(t.ns, after.ns)
        _same_ns(t.ns_prev, after.ns_prev, 0.0)
        _same_pose(t, after)
        # the capped Schur marginal: float32 products by cancellation
        _close(t.H_prior, after.H_prior, 5e-4 * np.abs(np.asarray(after.H_prior)).max())
        assert t.host_syncs == 1
        return
    # first_try: the forced keyframe after VIO init and its VI window BA
    assert out.get("first_try_reloc") and t.last_kf_frame == after.last_kf_frame == FIRST_TRY
    pre_ba = [c for c in jax_run["tr"].calls["_run_vi_ba"] if c[0].frame_id == FIRST_TRY][0][1][0]
    if _ba_holds(_vi_ba64(pre_ba, jax_run["tr"].cam, t.cam), pre_ba, after.map, t.map, NAV):
        _same_ns(t.ns, after.ns)
        _same_pose(t, after)
    assert t.host_syncs == 4                   # solve, matches, solve, keyframe


def test_create_keyframe_before_vio(jax_run):
    """The keyframes of the mono bootstrap phase (camera-as-body states,
    the since-keyframe IMU window, frame time and depth stored), up to
    the VIO-init attempt, whose entry state the reference records: the
    same slot, landmarks, associations and stored inertial data; the mono
    window BA as the module docstring holds it."""
    tr = jax_run["tr"]
    calls = _call(jax_run, "_create_keyframe", lambda b, a, o, af: not b.vio_ok)
    inits = tr.calls["_maybe_init_vio"]
    bas = [c for c in tr.calls["_run_local_ba"] if c[1][1] is None]   # not the bootstrap's
    assert len(calls) >= 4 and len(inits) == len(calls) == len(bas)
    n_agree = 0
    for (before, _, _, _), (at_init, _, _, _), (_, (pre, _), j_out, _) in zip(calls, inits, bas):
        t = convert.vip_tracker(before)
        t._maybe_init_vio = lambda: None
        t._create_keyframe()
        assert t.host_syncs == 1
        k = t.last_kf_slot
        assert k == at_init.last_kf_slot == int(before.map.n_kf)
        assert t.n_ref_tracked == at_init.n_ref_tracked
        assert int(t.map.n_pt) == int(at_init.map.n_pt)
        np.testing.assert_array_equal(_np(t.map.pt_valid), np.asarray(at_init.map.pt_valid))
        np.testing.assert_array_equal(_np(t.tracks.pt_id), np.asarray(at_init.tracks.pt_id))
        for f in ("kf_imu_omg", "kf_imu_acc", "kf_imu_dt", "kf_imu_mask", "kf_depth",
                  "kf_depth_valid", "kf_time", "kf_frame_id", "kf_prev"):
            np.testing.assert_array_equal(_np(getattr(t.map, f))[k],
                                          np.asarray(getattr(at_init.map, f))[k], err_msg=f)
        _close(t.map.kf_preint.dP[k], at_init.map.kf_preint.dP[k], 0.0, "preint")
        assert int(t.kf_imu["n"]) == 0 and float(t.preint_kf.dt) == 0.0
        if _ba_holds(_local_ba64(pre, tr.cam, t.cam), pre, j_out, t.map, ("p", "R")):
            _same_pose(t, at_init)
            for f in ("p", "R"):
                _close(getattr(t.map.kf_ns, f), getattr(at_init.map.kf_ns, f), ATOL, f)
            n_agree += 1
    assert n_agree >= len(calls) - 2, (n_agree, len(calls))


def test_create_keyframe_after_vio(jax_run):
    """The keyframe after VIO init (the one the first try forces): the
    since-keyframe window re-integrated at the current bias, body NavState
    stored, the VI window BA (float64 at 1e-8), the state adopted from the
    keyframe and the marginal prior restarted."""
    tr = jax_run["tr"]
    before, _, _, after = _call(jax_run, "_create_keyframe", lambda b, a, o, af: b.vio_ok)[0]
    t = convert.vip_tracker(before)
    t._create_keyframe()
    assert t.host_syncs == 1
    k = t.last_kf_slot
    assert k == after.last_kf_slot and t.n_ref_tracked == after.n_ref_tracked
    assert int(t.map.n_pt) == int(after.map.n_pt)
    np.testing.assert_array_equal(_np(t.tracks.pt_id), np.asarray(after.tracks.pt_id))
    for f in dataclasses.fields(t.map.kf_preint):
        _close(getattr(t.map.kf_preint, f.name)[k], np.asarray(getattr(after.map.kf_preint,
                                                                       f.name))[k],
               1e-5 * max(1.0, np.abs(np.asarray(getattr(after.map.kf_preint, f.name))[k]).max()),
               f.name)
    _close(t.H_prior, after.H_prior, 0.0, "H_prior")
    pre = [c for c in tr.calls["_run_vi_ba"] if c[0].frame_id == before.frame_id][0][1][0]
    if _ba_holds(_vi_ba64(pre, tr.cam, t.cam), pre, after.map, t.map, NAV):
        _same_ns(t.ns, after.ns)
        _same_pose(t, after)


def _init_state(jax_run, init_mode, rig):
    """The reference's state on entry to its successful VIO init, as
    recorded or with another init mode / identity extrinsics, ready to
    rerun (its own call record empty)."""
    before = [c for c in jax_run["tr"].calls["_maybe_init_vio"]
              if not c[0].vio_ok and c[3].vio_ok][0][0]
    src = _snapshot(before)
    src.calls = {}
    src.cfg = dataclasses.replace(before.cfg, init_mode=init_mode)
    if not rig:
        src.cfg = dataclasses.replace(src.cfg, Tbc=jvt.VipConfig().Tbc)
        eye, z3 = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
        src.Rbc, src.tbc, src.Rcb, src.tcb = eye, z3, eye, z3
        src.has_extrinsics = False
    return src


@pytest.mark.parametrize("init_mode,rig", [(2, True), (1, True), (2, False)])
def test_maybe_init_vio(jax_run, monkeypatch, init_mode, rig):
    """The host TryInitVIO on the reference's entry state, downstream of
    its full-map visual BA (the port is handed the reference's BA output:
    in float32 that BA's free scale gauge stops the two LMs at scales 1.3%
    apart on this state, and `test_init_global_ba_float64` holds it in
    float64): the same outcome, the world Sim3's scale within 1e-3
    (relative) and its gravity alignment within 1e-4, the keyframe table
    (positions, velocities, rotations, biases) and the adopted state, and
    every host decision one read."""
    from uvipslam_tpu.solver import global_ba as jgba

    j = _init_state(jax_run, init_mode, rig)
    t = convert.vip_tracker(j)
    real = jgba.global_ba_visual
    bas = []
    monkeypatch.setattr(jgba, "global_ba_visual", lambda *a, **kw: bas.append(real(*a, **kw))
                        or bas[-1])
    jvt.VipTracker._maybe_init_vio(j)
    ba_out = convert.map_state(jax.tree_util.tree_map(np.asarray, bas[0]))
    monkeypatch.setattr(tvt, "global_ba_visual", lambda *a, **kw: ba_out)
    seen = []
    real_t = t._apply_world_sim3
    t._apply_world_sim3 = lambda s, R: seen.append((float(s), _np(R).astype(np.float64))) or \
        real_t(s, R)
    t._maybe_init_vio()
    assert j.vio_ok and t.vio_ok
    assert t.host_syncs == (2 if init_mode == 1 else 3)
    (s_t, R_t), = seen
    (_, (s_j, R_j), _, _), = j.calls["_apply_world_sim3"]
    s_j, R_j = float(np.asarray(s_j)), np.asarray(R_j, np.float64)
    assert 0.1 < s_j < 10.0
    np.testing.assert_allclose(s_t, s_j, rtol=SCALE_RTOL)
    g = np.asarray(jvt.VipConfig().gravity, np.float64)
    g /= np.linalg.norm(g)
    np.testing.assert_allclose(R_t.T @ g, R_j.T @ g, atol=ATOL)
    tol = SCALE_RTOL * max(1.0, float(np.abs(np.asarray(j.map.kf_ns.p)).max()))
    for f in ("p", "v"):
        _close(getattr(t.map.kf_ns, f), getattr(j.map.kf_ns, f), tol, f)
    for f in ("R", "bg", "ba"):
        _close(getattr(t.map.kf_ns, f), getattr(j.map.kf_ns, f), ATOL, f)
    _close(t.map.pt_xyz, j.map.pt_xyz, tol, "pt_xyz")
    _same_ns(t.ns, j.ns, tol)
    _same_ns(t.ns_prev, t.ns, 0.0)
    _same_pose(t, j, tol)
    _close(t.H_prior, j.H_prior, 0.0, "H_prior")


def test_init_global_ba_float64(jax_run):
    """The full-map visual BA that opens the VIO init, on the map the
    reference gave it, in float64: keyframe poses and the landmarks seen
    five times or more to 1e-8; the landmarks seen two to four times
    converge slowly along their depth and stop within 1e-4 of each other
    (2e-5 on this map)."""
    from uvipslam_tpu.solver import global_ba as jgba
    from uvipslam_torch.solver import global_ba as tgba

    src = _init_state(jax_run, 2, True)
    m = _as(src.map, np.float64)
    fx, fy, cx, cy = (float(np.asarray(getattr(src.cam, k))) for k in ("fx", "fy", "cx", "cy"))
    sig = np.asarray(src.cfg.scale_sigmas, np.float64)
    with jax.enable_x64(True):
        j = jax.tree_util.tree_map(np.asarray, jgba.global_ba_visual(
            jax.tree_util.tree_map(jnp.asarray, m), fx, fy, cx, cy, jnp.asarray(sig)))
    t = tgba.global_ba_visual(convert.map_state(m), fx, fy, cx, cy, torch.from_numpy(sig))
    for f in ("p", "R"):
        _close(getattr(t.kf_ns, f), getattr(j.kf_ns, f), ATOL64, f)
    seen = (m.kf_feat_pt[:, :, None] == np.arange(m.pt_cap)[None, None]) \
        & (m.kf_feat_valid & m.kf_valid[:, None])[:, :, None]
    well = seen.sum((0, 1)) >= 5
    _close(_np(t.pt_xyz)[well], j.pt_xyz[well], ATOL64, "well-seen landmarks")
    _close(t.pt_xyz, j.pt_xyz, ATOL, "pt_xyz")
    np.testing.assert_array_equal(_np(t.kf_feat_pt), j.kf_feat_pt)
    assert np.abs(j.kf_ns.p - m.kf_ns.p).max() > 1e-3       # the BA moved the keyframes


def test_process_frame_recovery_reinitializes(jax_run, reference_samples):
    """The recovery frame that re-initializes, on the reference's entry
    state (with its propagation and two-view samples): the anchor and
    current keyframes, the landmarks at the IMU baseline's scale, the VI
    BA (float64 at 1e-8), the adopted state, the ring and the scheduled
    bias recompute."""
    tr = jax_run["tr"]
    before, args, out, after = _call(jax_run, "_process_frame_recovery",
                                     lambda b, a, o, af: o.get("recovery") == "re-initialized")[0]
    t = convert.vip_tracker(before)
    reference_samples(before)
    st = t._process_frame_recovery(torch.from_numpy(np.array(args[0])), _pre_frame(before, args))
    assert st == out, (st, out)
    assert t.state == after.state == jtr.WORKING
    assert t.host_syncs == 3                   # tracks and baseline, two-view, the keyframes
    for f in ("last_kf_slot", "last_kf_frame", "n_ref_tracked", "_reloc_bias_after_kf"):
        assert getattr(t, f) == getattr(after, f), f
    assert int(t.map.n_kf) == int(after.map.n_kf) and int(t.map.n_pt) == int(after.map.n_pt)
    np.testing.assert_array_equal(_np(t.tracks.pt_id), np.asarray(after.tracks.pt_id))
    np.testing.assert_array_equal(_np(t.ring_frame), np.asarray(after.ring_frame))
    for f in ("kf_frame_id", "kf_prev", "kf_depth_valid", "kf_imu_mask", "kf_feat_pt"):
        np.testing.assert_array_equal(_np(getattr(t.map, f)), np.asarray(getattr(after.map, f)),
                                      err_msg=f)
    assert int(t.kf_imu["n"]) == 0
    pre = [c for c in tr.calls["_run_vi_ba"] if c[0].frame_id == after.frame_id][0][1][0]
    if _ba_holds(_vi_ba64(pre, tr.cam, t.cam), pre, after.map, t.map, NAV):
        _same_ns(t.ns, after.ns)
        _same_pose(t, after)
        # the new landmarks: far points of a narrow-baseline float32
        # two-view triangulation at the IMU baseline's scale, within 5e-4
        # of their own size (2.1e-4 on this sequence)
        np.testing.assert_allclose(_np(t.map.pt_xyz), np.asarray(after.map.pt_xyz), rtol=5e-4,
                                   atol=ATOL)


@pytest.mark.parametrize("when", ["after_recovery", "final"])
def test_recompute_bias_after_recovery(jax_run, when):
    """The post-recovery gyro-bias recompute on the state just after the
    re-initialization and on the final state: the same decision, bias and
    re-integrated keyframe preintegrations."""
    if when == "final":
        src = _snapshot(jax_run["tr"])
    else:
        src = _call(jax_run, "_process_frame_recovery",
                    lambda b, a, o, af: o.get("recovery") == "re-initialized")[0][3]
    src.calls = {}
    t = convert.vip_tracker(src)
    jvt.VipTracker._recompute_bias_after_recovery(src)
    t._recompute_bias_after_recovery()
    assert t.host_syncs in (1, 2)
    _same_ns(t.ns, src.ns, 1e-5)
    for f in NAV:
        _close(getattr(t.map.kf_ns, f), getattr(src.map.kf_ns, f), 1e-5, f)
    for f in dataclasses.fields(t.map.kf_preint):
        a = np.asarray(getattr(src.map.kf_preint, f.name))
        _close(getattr(t.map.kf_preint, f.name), a, 1e-5 * max(1.0, np.abs(a).max()), f.name)
    moved = np.abs(np.asarray(src.map.kf_ns.bg) - np.asarray(jax_run["tr"].map.kf_ns.bg)).max()
    assert (t.host_syncs == 2) == (moved > 0 or when == "final"), (t.host_syncs, moved)


def test_apply_world_sim3(jax_run):
    """x' = s R x on the keyframe table, the landmarks, the pose, the
    motion model and the ring, from the reference's own arguments."""
    (before, (s, R), _, after), = jax_run["tr"].calls["_apply_world_sim3"]
    t = convert.vip_tracker(before)
    t._apply_world_sim3(torch.tensor(float(np.asarray(s))), torch.from_numpy(np.asarray(R)))
    for f in ("p", "v", "R"):
        _close(getattr(t.map.kf_ns, f), getattr(after.map.kf_ns, f), 1e-5, f)
    _close(t.map.pt_xyz, after.map.pt_xyz, 1e-5, "pt_xyz")
    for f in ("Rcw", "tcw", "t_vel", "ring_R", "ring_t"):
        _close(getattr(t, f), getattr(after, f), 1e-5, f)


def test_maybe_close_loop_after_vio(jax_run):
    """The loop-closing hook after VIO init with a closure (the closer's
    pass stubbed on both sides to close onto keyframe 0): the closer gets
    the extrinsics, its polish is the NavState global BA with the
    tracker's gravity, extrinsics and noise, and the corrected keyframe's
    state is re-adopted into the VI filter. Both polishes run on the final
    map in float64 and agree to 1e-8 over one LM iteration; further
    iterations part along the weakly observed accelerometer-bias deltas
    (2.2e-7 after two, 1e-2 after the solve's 8 iterations of 2 rounds, on
    this map), so the whole solve is not held."""
    from uvipslam_tpu.loop.closer import LoopCloser as JLC
    from uvipslam_tpu.solver import global_ba as jgba
    from uvipslam_torch.loop.closer import LoopCloser as TLC
    from uvipslam_torch.solver import global_ba as tgba

    src = _snapshot(jax_run["tr"])
    src.calls = {}
    cam = src.cam
    src.loop_closer = JLC(cam.fx, cam.fy, cam.cx, cam.cy)
    t = convert.vip_tracker(src)
    k = src.last_kf_slot
    polish = {}

    def closing(side):
        def process_keyframe(self, m, kf):
            polish[side] = self.post_ba
            return m, {"loop": True, "loop_kf": 0}
        return process_keyframe

    def one_iteration(real):
        def ba(*a, **kw):
            return real(*a, **dict(kw, n_iters=1, rounds=1))
        return ba

    m64 = _as(jax_run["tr"].map, np.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLC, "process_keyframe", closing("reference"))
        mp.setattr(TLC, "process_keyframe", closing("port"))
        mp.setattr(jgba, "local_ba_navstate", one_iteration(jgba.local_ba_navstate))
        mp.setattr(tgba, "local_ba_navstate", one_iteration(tgba.local_ba_navstate))
        # a fresh trace, so that the reference's solve sees the patch
        mp.setattr(jgba, "global_ba_navstate", jax.jit(jgba.global_ba_navstate.__wrapped__))
        jvt.VipTracker._maybe_close_loop(src, k)
        t._maybe_close_loop(k)
        with jax.enable_x64(True):
            j = jax.tree_util.tree_map(np.asarray, polish["reference"](
                jax.tree_util.tree_map(jnp.asarray, m64)))
        tm = polish["port"](convert.map_state(m64))
    for f in ("Rcb", "tcb", "Rbc", "tbc"):
        _close(getattr(t.loop_closer, f), getattr(src.loop_closer, f), 0.0, f)
    _same_ns(t.ns, src.ns, 0.0)
    _same_ns(t.ns_prev, src.ns, 0.0)
    _same_pose(t, src, 1e-6)
    _close(t.R_vel, np.eye(3), 0.0)
    _close(t.H_prior, src.H_prior, 0.0)
    assert t.loop_events == src.loop_events == [(src.frame_id, 0)]
    for f in NAV:
        _close(getattr(tm.kf_ns, f), getattr(j.kf_ns, f), ATOL64, f)
    _close(tm.pt_xyz, j.pt_xyz, ATOL64, "pt_xyz")
    assert np.abs(j.kf_ns.p - m64.kf_ns.p).max() > 1e-3       # the polish moved the map


def test_clahe_before_vio_only(jax_run, seq, monkeypatch):
    """`enhance` runs CLAHE on the frames of the mono bootstrap only: the
    reference's VI and recovery frames never call it (its device step
    does, on every frame); the port keeps the reference's behaviour."""
    counts = {"reference": 0, "port": 0}

    def counted(side, real):
        def clahe(img):
            counts[side] += 1
            return real(img)
        return clahe

    monkeypatch.setattr(jtr, "clahe", counted("reference", jtr.clahe))
    monkeypatch.setattr(ttr, "clahe", counted("port", ttr.clahe))
    tr = jax_run["tr"]
    picks = {"mono": tr.calls["_create_keyframe"][0][0],
             "vi": _call(jax_run, "_process_frame_vi", _vi_frame("vi"))[0][0]}
    for name, before in picks.items():
        f = before.frame_id + 1
        a, kw = _inputs(seq, f)
        for side in ("reference", "port"):
            src = _snapshot(before)
            src.calls = {}
            src.cfg = dataclasses.replace(src.cfg, enhance=True)
            runner = src if side == "reference" else convert.vip_tracker(src)
            n0 = counts[side]
            runner.process_frame_vip(*a, **kw) if side == "port" else \
                jvt.VipTracker.process_frame_vip(runner, *a, **kw)
            assert counts[side] - n0 == (1 if name == "mono" else 0), (name, side)
