"""The host mono tracker: the port's `frontend.tracker.MonoTracker`
against the reference's `uvipslam_tpu.frontend.tracker.MonoTracker`.

Each method is held against the reference's on states carried over from
the reference (`uvipslam_torch.convert.mono_tracker`): the reference
tracker records its own state on entry to `_track_frame`,
`_create_keyframe` and `_relocalize` and the result, the port's method
runs on the converted entry state. `_track_frame` holds poses at 1e-4,
the inlier count and the landmark associations exactly; `_need_keyframe`
decides exactly as the reference; `_create_keyframe` holds keyframe poses
at 1e-4 and landmarks at tests/test_torch_step.py's float32 window-BA
bound (1e-3: the last LM accept test there is a tie below float32
resolution), the keyframe slot and reference track count exactly;
`_relocalize` is fed the reference's own PnP samples (as
tests/test_torch_reloc.py does) and then agrees on the outcome, the pose
(1e-4) and the associations.

The whole 120x160, 40-frame parity sequence (seed 3, 800 points) then runs
through both trackers: RANSAC draws differ between the frameworks, so the
outcomes are compared: both are WORKING on at least 80% of the frames,
both Sim3-aligned ATEs are below 2% of the span, and the two trajectories
agree within 4% of the span after Sim3 alignment (the bar of
tests/test_torch_vip.py).
"""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.io.synthetic import ate_rmse, make_sequence
from uvipslam_tpu.loop import reloc as jreloc
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.ops import twoview as jtv
from uvipslam_torch import convert
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.loop import reloc as treloc
from uvipslam_torch.models.camera import CameraModel as TCam
from tests.test_torch_step import BA_PT_ATOL_F32
from tests.test_torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 40
H, W = 120, 160
CFG = dict(n_tracks=100, min_init_tracks=60, local_window=8)
KF_CAP, PT_CAP = 16, 1024
WARMUP = 16          # frames tracked before the blackout
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FRAMES, H=H, W=W, n_points=800, seed=3, speed=1.2)


def _snapshot(tr):
    s = copy.copy(tr)
    s.trajectory = list(tr.trajectory)
    s.calls = None
    return s


class Recording(jtr.MonoTracker):
    """The reference tracker, recording (state on entry, arguments,
    result, state after) of every call of the methods under test."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = {}

    def _record(self, name, *args):
        before = _snapshot(self)
        out = getattr(jtr.MonoTracker, name)(self, *args)
        self.calls.setdefault(name, []).append((before, args, out, _snapshot(self)))
        return out

    def _track_frame(self):
        return self._record("_track_frame")

    def _create_keyframe(self):
        return self._record("_create_keyframe")

    def _run_local_ba(self, m, fixed_slots=None):
        return self._record("_run_local_ba", m, fixed_slots)

    def _relocalize(self, img):
        return self._record("_relocalize", img)


def _jcam(seq):
    return JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)


@pytest.fixture(scope="module")
def jax_run(seq):
    with jax.enable_x64(False):
        tr = Recording(_jcam(seq), jtr.TrackerConfig(**CFG), kf_cap=KF_CAP, pt_cap=PT_CAP)
        status = [tr.process_frame(seq.images[f]) for f in range(N_FRAMES)]
        return dict(tr=tr, status=status, C=tr.trajectory_positions(),
                    frames=[f for f, _, _ in tr.trajectory])


@pytest.fixture(scope="module")
def jax_blackout(seq):
    """WARMUP frames, three black frames (LOST), then the last keyframe's
    image until the reference relocalizes (three frames at most)."""
    with jax.enable_x64(False):
        tr = Recording(_jcam(seq), jtr.TrackerConfig(**CFG), kf_cap=KF_CAP, pt_cap=PT_CAP)
        for f in range(WARMUP):
            tr.process_frame(seq.images[f])
        black = np.zeros_like(seq.images[0])
        states = [tr.process_frame(black)["state"] for _ in range(3)]
        kf_frame = int(tr.map.kf_frame_id[int(tr.map.n_kf) - 1])
        for _ in range(3):
            states.append(tr.process_frame(seq.images[kf_frame])["state"])
            if states[-1] == "WORKING":
                break
        return dict(tr=tr, states=states)


@pytest.fixture(scope="module")
def torch_run(seq):
    cam = TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)
    tr = ttr.MonoTracker(cam, ttr.TrackerConfig(**CFG), kf_cap=KF_CAP, pt_cap=PT_CAP,
                         device="cpu")
    status = [tr.process_frame(seq.images[f]) for f in range(N_FRAMES)]
    return dict(tr=tr, status=status, C=tr.trajectory_positions(),
                frames=[f for f, _, _ in tr.trajectory])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_pose(t, j):
    np.testing.assert_allclose(_np(t.Rcw), _np(j.Rcw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(t.tcw), _np(j.tcw), atol=ATOL, rtol=0)


def test_sequence_outcomes_agree(seq, jax_run, torch_run):
    spans = {}
    for name, run in (("reference", jax_run), ("port", torch_run)):
        states = [s["state"] for s in run["status"]]
        assert states.count("WORKING") >= 0.8 * N_FRAMES, (name, states)
        assert any(s.get("initialized") for s in run["status"]), name
        gt = seq.positions_w[run["frames"]]
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        ate, _ = ate_rmse(run["C"], gt, align_scale=True)
        assert ate < 0.02 * span, (name, ate, span)
        spans[name] = span
    both = sorted(set(jax_run["frames"]) & set(torch_run["frames"]))
    assert len(both) >= 0.75 * N_FRAMES
    pick = {name: [run["frames"].index(f) for f in both]
            for name, run in (("reference", jax_run), ("port", torch_run))}
    gt = seq.positions_w[both]
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    mutual, _ = ate_rmse(torch_run["C"][pick["port"]], jax_run["C"][pick["reference"]])
    assert mutual < 0.04 * span, (mutual, span)
    for run in (jax_run, torch_run):
        m = run["tr"].map
        assert int(m.n_kf) >= 5 and int(m.pt_valid.sum()) >= 100, (int(m.n_kf), m.pt_valid.sum())
    tr = torch_run["tr"]
    # one read per frame, one more per keyframe or two-view attempt
    assert N_FRAMES <= tr.host_syncs <= 3 * N_FRAMES


def test_track_frame_on_carried_states(jax_run):
    calls = jax_run["tr"].calls["_track_frame"]
    assert len(calls) >= 30
    for before, _, n_j, after in calls[::6]:
        t = convert.mono_tracker(before)
        n_t = t._track_frame()
        assert n_t == int(n_j) >= 20
        _same_pose(t, after)
        np.testing.assert_allclose(_np(t.R_vel), _np(after.R_vel), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(t.t_vel), _np(after.t_vel), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(_np(t.tracks.pt_id), _np(after.tracks.pt_id))
        assert t.host_syncs == 1


def test_need_keyframe_decides_as_reference(jax_run):
    calls = jax_run["tr"].calls["_track_frame"]
    decided = set()
    for _, _, _, after in calls:
        t = convert.mono_tracker(after)
        for n_in in (0, 10, 40, int(0.9 * max(after.n_ref_tracked, 1)),
                     int(0.9 * max(after.n_ref_tracked, 1)) + 1, 100):
            d = t._need_keyframe(n_in)
            assert d == after._need_keyframe(n_in), (after.frame_id, n_in)
            decided.add(d)
    assert decided == {True, False}


def _reference_ba64(pre, cam):
    """The reference's window BA (`_run_local_ba`'s gauge) on map `pre`
    in float64."""
    m = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float64) if np.asarray(
        a).dtype == np.float32 else np.asarray(a), pre)
    idx = np.arange(m.kf_valid.shape[0])
    n_kf = int(m.n_kf)
    fixed = m.kf_valid & ~((idx >= max(0, n_kf - CFG["local_window"])) & (idx < n_kf))
    fixed[0] = True
    fixed[1] = m.kf_valid[1]
    sig = np.asarray(jtr.TrackerConfig().scale_sigmas, np.float64)
    with jax.enable_x64(True):
        out = jtr._local_ba_jit(jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(fixed),
                                cam.fx, cam.fy, cam.cx, cam.cy, jnp.asarray(sig))
        return m, jax.tree_util.tree_map(np.asarray, out)


def test_create_keyframe_on_carried_states(jax_run):
    """Triangulation, insertion and hygiene exactly as the reference; the
    window BA as tests/test_torch_step.py holds it. In float64 the port's
    window BA equals the reference's to 1e-9 on every keyframe's pre-BA
    map. In float32 its LM accept tests can fall below float32
    resolution (ROADMAP Queue 3, shared by the reference): the port's
    keyframe poses agree with the reference's at 1e-4 and its landmarks
    at BA_PT_ATOL_F32 on every keyframe but where the reference's own
    float32 BA strays from the float64 solve by more than that (two of
    the seven here, frames 19 and 23: the reference 0.077 off on
    landmarks, the port 0.22, poses 2.4e-3 and 3.6e-3)."""
    tr = jax_run["tr"]
    calls = tr.calls["_create_keyframe"]
    # the window BAs run inside the keyframe calls (the first is the
    # two-view initialization's)
    bas = tr.calls["_run_local_ba"][1:]
    assert len(calls) >= 4 and len(bas) == len(calls)
    n_agree = 0
    for (before, _, _, after), (_, (pre, _), _, _) in zip(calls, bas):
        t = convert.mono_tracker(before)
        t._create_keyframe()
        assert t.host_syncs == 1
        assert t.last_kf_slot == after.last_kf_slot == int(before.map.n_kf)
        assert t.last_kf_frame == after.last_kf_frame
        assert int(t.map.n_kf) == int(after.map.n_kf)
        assert int(t.map.n_pt) == int(after.map.n_pt)
        np.testing.assert_array_equal(_np(t.map.pt_valid), _np(after.map.pt_valid))
        np.testing.assert_array_equal(_np(t.tracks.pt_id), _np(after.tracks.pt_id))
        assert t.n_ref_tracked == after.n_ref_tracked

        pre64, j64 = _reference_ba64(pre, tr.cam)
        t64 = ttr._window_ba(convert.map_state(pre64), t.cam, CFG["local_window"],
                             torch.tensor(t.cfg.scale_sigmas, dtype=torch.float64))
        for f in ("R", "p"):
            np.testing.assert_allclose(_np(getattr(t64.kf_ns, f)), getattr(j64.kf_ns, f),
                                       atol=1e-9, rtol=0, err_msg=f)
        np.testing.assert_allclose(_np(t64.pt_xyz), j64.pt_xyz, atol=1e-9, rtol=0)
        np.testing.assert_array_equal(_np(t64.kf_feat_pt), j64.kf_feat_pt)

        agree = (np.abs(_np(t.Rcw) - _np(after.Rcw)).max() < ATOL
                 and np.abs(_np(t.tcw) - _np(after.tcw)).max() < ATOL
                 and all(np.abs(_np(getattr(t.map.kf_ns, f))
                                - _np(getattr(after.map.kf_ns, f))).max() < ATOL
                         for f in ("R", "p"))
                 and np.abs(_np(t.map.pt_xyz) - _np(after.map.pt_xyz)).max() < BA_PT_ATOL_F32)
        ref_off = np.abs(_np(after.map.pt_xyz) - j64.pt_xyz).max() > BA_PT_ATOL_F32
        # a float32 disagreement only where the reference itself strays
        # from the float64 solve
        assert agree or ref_off, int(before.frame_id)
        n_agree += agree
    assert n_agree >= len(calls) - 2, (n_agree, len(calls))


def test_relocalize_with_the_reference_samples(jax_blackout, monkeypatch):
    """The reference's relocalization of the last keyframe's image after
    the blackout, rerun by the port with the reference's PnP samples."""
    assert jax_blackout["states"][2] == "LOST" and jax_blackout["states"][-1] == "WORKING"
    calls = jax_blackout["tr"].calls["_relocalize"]
    before, (img,), ok_j, after = calls[-1]
    assert ok_j and after.state == jtr.WORKING
    # the key the reference's _relocalize split off for relocalize_frame
    key = jax.random.split(before.key)[1]
    keys = jax.random.split(key, treloc.N_CANDIDATES)

    def with_reference_samples(tracks, m, gen, fx, fy, cx, cy):
        top = treloc.relocalize_frame(tracks, m, torch.Generator().manual_seed(0),
                                      fx, fy, cx, cy)[4]
        idx = []
        for c in range(treloc.N_CANDIDATES):
            _, _, cand = treloc.candidate_matches(tracks, m, top[c])
            idx.append(torch.from_numpy(np.asarray(jtv._sample_minimal(
                keys[c], treloc.PNP_ITERS, 6, jnp.asarray(cand.numpy())))))
        return treloc.relocalize_frame(tracks, m, None, fx, fy, cx, cy, idx=torch.stack(idx))

    monkeypatch.setattr(ttr, "relocalize_frame", with_reference_samples)
    t = convert.mono_tracker(before)
    assert t.state == ttr.LOST
    assert t._relocalize(torch.from_numpy(np.array(img))) is True
    assert t.state == ttr.WORKING and t.host_syncs == 2
    _same_pose(t, after)
    np.testing.assert_array_equal(_np(t.tracks.pt_id), _np(after.tracks.pt_id))
    np.testing.assert_array_equal(_np(t.tracks.valid), _np(after.tracks.valid))
    assert int((_np(t.tracks.pt_id) >= 0).sum()) >= 20
    np.testing.assert_allclose(_np(t.R_vel), np.eye(3), atol=0)


def test_convert_carries_the_tracker(jax_run):
    """convert.mono_tracker copies the reference tracker's state: tracks,
    map, poses, ring, pyramid, trajectory and host fields."""
    from tests.test_torch_step import _leaves

    src = jax_run["tr"]
    t = convert.mono_tracker(src)
    for name, a in _leaves(t.map):
        b = src.map
        for part in name.split("."):
            b = getattr(b, part)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for f in ("Rcw", "tcw", "R_vel", "t_vel", "ring_R", "ring_t", "ring_frame"):
        np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(src, f)), err_msg=f)
    for a, b in zip(t.pyr_prev, src.pyr_prev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("state", "frame_id", "init_frame_id", "last_kf_slot", "last_kf_frame",
              "n_ref_tracked"):
        assert getattr(t, f) == getattr(src, f), f
    assert [f for f, _, _ in t.trajectory] == [f for f, _, _ in src.trajectory]
    np.testing.assert_allclose(t.trajectory_positions(), src.trajectory_positions(), atol=1e-5)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(src.cfg) | {}
