"""The host trackers' segments: `MonoTracker` and `VipTracker` with
`graphs=True` (on the CPU the plain form of each capture: the same
copies into static buffers and out of them, the function replayed on
the buffers) against `graphs=False` (the eager form), bit for bit.

Each tracker runs the 120x160 sequences of tests/test_torch_mono_tracker.py
(its first 24 frames; the graphed run with `enhance` on, the app's
default, and the eager run fed each frame's CLAHE image with `enhance`
off, which is what `enhance` means: a stage that read the raw frame
would part the two) and tests/test_torch_vip_tracker.py (36 frames, IMU,
pressure and the camera-in-body rig; frame FIRST_TRY's lane-0 VI solve
made to fail so that the first-try tier holds and forces a keyframe,
frames BLACK black so that both tiers fail, IMU_RELOC re-anchors and the
two-view recovery re-initializes). The runs cover the bootstrap, the
keyframes, a mono relocalization, the VIO init (whose loops run through
`Segments.scan`), the first-try frame and the blackout's recovery. After
every frame both forms hold the same bits in every tensor attribute (the
generator's state among them), the same host values, status dict and
host reads; the graphed tracker's captures stop growing over
keyframe-free WORKING frames once the layouts settle (a per-frame Python
value in a segment's key would capture every frame), and no key takes
more than two input layouts.

Parity with the JAX package follows from the host trackers' own tests
(tests/test_torch_mono_tracker.py, `enhance` on in
`test_enhanced_stages_read_the_clahe_image`; tests/test_torch_vip_tracker.py,
tests/test_torch_vip_tracker_e2e.py, tests/test_torch_app.py), which
run the eager form. About 60 s on one CPU worker: each tracker's eager
run once (a module fixture) and its graphed run once.
"""

import numpy as np
import pytest
import torch

from uvipslam_torch.core.tree import attr_state
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.io.synthetic import _so3_exp_np, make_sequence
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops.clahe import clahe
from tests.test_torch_threads import one_torch_thread  # noqa: F401

H, W = 120, 160
KF_CAP, PT_CAP = 16, 1024
MONO_FRAMES, VIP_FRAMES = 24, 36     # the mono run: the first 24 of 40 frames
MONO_CFG = dict(n_tracks=100, min_init_tracks=60, local_window=8)
TBC = np.eye(4)
TBC[:3, :3] = _so3_exp_np(np.array([0.15, -0.10, 0.20]))
TBC[:3, 3] = [0.08, -0.05, 0.07]
VIP_CFG = dict(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
               acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
               vio_init_min_time=1.0, Tbc=tuple(map(tuple, TBC.tolist())))
FIRST_TRY = 24
BLACK = (28, 29, 30)


def _snapshot(tr):
    """Every tensor attribute's bytes (by name; the generator's state
    among them), and the host values with the trajectory's frame ids."""
    leaves, host = attr_state(tr, tr.NOT_STATE)
    bits = {k: [t.contiguous().reshape(-1).view(torch.uint8).clone() for t in ts]
            for k, ts in leaves.items()}
    host["trajectory"] = [f for f, *_ in tr.trajectory]
    return bits, host


def _cam(seq):
    return CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                              height=H)


@pytest.fixture(scope="module")
def mono_seq():
    return make_sequence(n_frames=40, H=H, W=W, n_points=800, seed=3, speed=1.2)


@pytest.fixture(scope="module")
def vip_seq():
    return make_sequence(n_frames=VIP_FRAMES, H=H, W=W, n_points=800, seed=3, speed=1.2,
                         gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                         acc_bias=(0.0, 0.0, 0.0), depth_noise=0.02, z_amp=0.5, Tbc=TBC)


def _run_mono(seq, graphs):
    """Graphed: `enhance` on (the app's default), fed the frames. Eager:
    `enhance` off, fed each frame's CLAHE image, which is what `enhance`
    means (the reference's `img = clahe(img)` ahead of every stage), so a
    stage that read the raw frame would part the two runs."""
    cfg = ttr.TrackerConfig(enhance=graphs, **MONO_CFG)
    tr = ttr.MonoTracker(_cam(seq), cfg, kf_cap=KF_CAP, pt_cap=PT_CAP, device="cpu",
                         graphs=graphs)
    frames = []
    for f in range(MONO_FRAMES):
        img = torch.from_numpy(seq.images[f].astype(np.float32))
        st = tr.process_frame(img if graphs else clahe(img))
        frames.append(_frame(tr, st))
    return dict(tr=tr, frames=frames)


def _frame(tr, status):
    bits, host = _snapshot(tr)
    return dict(status=status, bits=bits, host=host, syncs=tr.host_syncs,
                captures=tr.segments.captures, kf=tr.last_kf_frame == tr.frame_id,
                vio=bool(getattr(tr, "vio_ok", False)))


def _run_vip(seq, graphs):
    tr = tvt.VipTracker(_cam(seq), tvt.VipConfig(**VIP_CFG), kf_cap=KF_CAP, pt_cap=PT_CAP,
                        device="cpu", graphs=graphs)
    real, done = tvt._vi_track, []

    def lane0_fails_once(*a):
        # frame FIRST_TRY's first VI solve (lane 0, in segment B) loses its
        # inliers; the first try's solve (segment L2) is the real one
        out = real(*a)
        if done or tr.frame_id != FIRST_TRY:
            return out
        done.append(True)
        return out[:2] + (torch.zeros_like(out[2]),) + out[3:]

    frames = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvt, "_vi_track", lane0_fails_once)
        for f in range(VIP_FRAMES):
            img = np.zeros_like(seq.images[f]) if f in BLACK else seq.images[f]
            st = tr.process_frame_vip(img, seq.imu_omg[f], seq.imu_acc[f], seq.imu_dt[f],
                                      seq.imu_mask[f], depth=seq.depth[f],
                                      depth_valid=bool(seq.depth_valid[f]),
                                      timestamp=seq.timestamps[f])
            frames.append(_frame(tr, st))
    return dict(tr=tr, frames=frames)


@pytest.fixture(scope="module")
def mono_eager(mono_seq):
    return _run_mono(mono_seq, False)


@pytest.fixture(scope="module")
def mono_graphed(mono_seq):
    return _run_mono(mono_seq, True)


@pytest.fixture(scope="module")
def vip_eager(vip_seq):
    return _run_vip(vip_seq, False)


@pytest.fixture(scope="module")
def vip_graphed(vip_seq):
    return _run_vip(vip_seq, True)


def _runs(request, kind):
    return (request.getfixturevalue(f"{kind}_eager"),
            request.getfixturevalue(f"{kind}_graphed"))


def _assert_same_frames(eager, graphed):
    for f, (e, g) in enumerate(zip(eager["frames"], graphed["frames"])):
        assert g["status"] == e["status"], (f, e["status"], g["status"])
        assert g["syncs"] == e["syncs"], (f, e["syncs"], g["syncs"])
        assert g["host"] == e["host"], f
        assert g["bits"].keys() == e["bits"].keys(), f
        for k, leaves in e["bits"].items():
            assert len(g["bits"][k]) == len(leaves), (f, k)
            assert all(torch.equal(a, b) for a, b in zip(leaves, g["bits"][k])), (f, k)


@pytest.mark.parametrize("kind", ["mono", "vip"])
def test_graphed_tracker_equals_eager(request, kind):
    """Every frame: the same bits in every tensor attribute, host values,
    status dict and host reads."""
    eager, graphed = _runs(request, kind)
    assert eager["tr"].segments.captures == 0 and graphed["tr"].segments.captures > 0
    assert len(graphed["frames"]) == len(eager["frames"])
    _assert_same_frames(eager, graphed)


def test_runs_cover_the_trackers_branches(vip_eager, mono_eager):
    """The sequences reach what the graphed trackers must hold: the
    bootstrap, keyframes, a mono relocalization, the VIO init, a holding
    first try, IMU_RELOC and the two-view recovery."""
    for run in (mono_eager, vip_eager):
        st = [fr["status"] for fr in run["frames"]]
        assert any(s.get("initialized") for s in st)
        assert sum(fr["kf"] for fr in run["frames"]) >= 4
        assert st[-1]["state"] == "WORKING"
    assert any(fr["status"].get("relocalized") for fr in mono_eager["frames"])
    st = [fr["status"] for fr in vip_eager["frames"]]
    assert any(fr["vio"] for fr in vip_eager["frames"][:FIRST_TRY])
    assert st[FIRST_TRY].get("first_try_reloc") and vip_eager["frames"][FIRST_TRY]["kf"]
    assert st[BLACK[0]]["state"] == "IMU_RELOC"
    assert any(s.get("recovery") == "re-initialized" for s in st[BLACK[0]:])


def test_graphed_segments_cover_every_stage(vip_graphed):
    """The VIP run's graphed tracker went through every segment and the
    VIO init's and the recovery's loops through its scans."""
    seg = vip_graphed["tr"].segments
    names = {k[0] for k in seg.keys}
    assert {"A", "F", "T", "C", "K", "R", "B", "L", "L2", "I", "Q", "N"} <= names, names
    scans = {k[1] for k in seg.keys if k[0] == "scan"}
    assert {"ba_se3", "gyro_bias", "preint"} <= scans, scans
    assert seg.scan_steps > 0


@pytest.mark.parametrize("kind", ["mono", "vip"])
def test_captures_settle(request, kind):
    """Once a keyframe-free WORKING frame of one kind (before or after
    VIO init) has followed another, the next such frames capture nothing:
    a per-frame value in a key would capture every frame, a drifting
    layout every few. No key takes more than two input layouts."""
    _, graphed = _runs(request, kind)
    fr = graphed["frames"]
    plain = [f for f in range(1, len(fr)) if all(
        fr[g]["status"]["state"] == "WORKING" and not fr[g]["kf"]
        and "recovery" not in fr[g]["status"] and fr[g]["vio"] == fr[f]["vio"]
        for g in (f - 1, f))]
    seen, settled = set(), []
    for f in plain:
        if fr[f]["vio"] in seen:
            settled.append(f)
        seen.add(fr[f]["vio"])
    assert len(settled) >= (8 if kind == "mono" else 4), settled
    grew = [f for f in settled if fr[f]["captures"] != fr[f - 1]["captures"]]
    assert not grew, grew
    per_key = graphed["tr"].segments.graphs_per_key()
    assert max(per_key.values()) <= 2, per_key
