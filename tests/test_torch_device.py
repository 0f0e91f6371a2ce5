"""The port's entry points run on the card unless the caller names the
CPU: without a CUDA device, building a step with no `device` raises and
never falls back to the CPU."""

import pytest
import torch

from uvipslam_torch.frontend import device_tracker, device_vip
from uvipslam_torch.frontend.stream import DeviceStream
from uvipslam_torch.frontend.tracker import MonoTracker, TrackerConfig
from uvipslam_torch.frontend.vip_tracker import VipConfig, VipTracker
from uvipslam_torch.loop.closer import LoopCloser
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.parallel import replay
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CAM = CameraModel.create(100.0, 100.0, 80.0, 60.0, width=160, height=120)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["build_tracker", "build_vip_tracker", "run_sequence",
                                   "stream_mono", "stream_vip", "loop_closer",
                                   "batched_replay", "batched_replay_vip", "fleet_bundles",
                                   "mono_tracker", "vip_tracker"])
def test_default_device_is_the_card(no_card, entry):
    cfg = TrackerConfig(n_tracks=16, min_init_tracks=8)
    calls = {
        "build_tracker": lambda: device_tracker.build_tracker(CAM, cfg, 4, 64),
        "build_vip_tracker": lambda: device_vip.build_vip_tracker(
            CAM, VipConfig(n_tracks=16, min_init_tracks=8), 4, 64),
        "run_sequence": lambda: device_tracker.run_sequence(
            CAM, cfg, torch.zeros((1, 120, 160)), kf_cap=4, pt_cap=64),
        "stream_mono": lambda: DeviceStream(CAM, cfg, kf_cap=4, pt_cap=64, mode="mono"),
        "stream_vip": lambda: DeviceStream(
            CAM, VipConfig(n_tracks=16, min_init_tracks=8, loop_closing=True), 4, 64),
        "loop_closer": lambda: LoopCloser(100.0, 100.0, 80.0, 60.0),
        "batched_replay": lambda: replay.batched_replay(CAM, cfg, 4, 64),
        "batched_replay_vip": lambda: replay.batched_replay_vip(
            CAM, VipConfig(n_tracks=16, min_init_tracks=8), 4, 64),
        "fleet_bundles": lambda: replay.fleet_bundles([]),
        "mono_tracker": lambda: MonoTracker(CAM, cfg, kf_cap=4, pt_cap=64),
        "vip_tracker": lambda: VipTracker(CAM, VipConfig(n_tracks=16, min_init_tracks=8),
                                          kf_cap=4, pt_cap=64),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_on_request(no_card):
    st, step = device_tracker.build_tracker(
        CAM, TrackerConfig(n_tracks=16, min_init_tracks=8), 4, 64, device="cpu")
    assert step.device.type == "cpu" and st.tracks.xy.device.type == "cpu"
    ds = DeviceStream(CAM, TrackerConfig(n_tracks=16, min_init_tracks=8, loop_closing=True),
                      kf_cap=4, pt_cap=64, mode="mono", device="cpu")
    assert ds.device.type == "cpu" and ds.st.map.pt_xyz.device.type == "cpu"
    assert ds.loop_closer.device.type == "cpu" and ds.loop_closer.gen.device.type == "cpu"
    tr = VipTracker(CAM, VipConfig(n_tracks=16, min_init_tracks=8, loop_closing=True), kf_cap=4,
                    pt_cap=64, device="cpu")
    assert tr.device.type == "cpu" and tr.map.pt_xyz.device.type == "cpu"
    assert tr.ns.p.device.type == "cpu" and tr.kf_imu["n"].device.type == "cpu"
    assert tr.loop_closer.device.type == "cpu"


def test_batched_replay_on_the_cpu_on_request(no_card):
    """A fleet of two streams, two frames, on the CPU: state and outputs
    with a leading stream dimension, one generator per stream beside the
    state and none in it."""
    cfg = TrackerConfig(n_tracks=16, min_init_tracks=8, n_levels_klt=3, px_distance=6)
    make_states, run = replay.batched_replay(CAM, cfg, 4, 64, device="cpu", seed=3)
    st0 = make_states(2)
    assert st0.gen is None and st0.state.shape == (2,) and st0.tracks.xy.shape == (2, 16, 2)
    imgs = torch.rand((2, 2, 120, 160), generator=torch.Generator().manual_seed(0)) * 255
    stf, outs, fleet = run(st0, imgs)
    assert outs.state.shape == (2, 2) and outs.Rcw.shape == (2, 2, 3, 3)
    assert stf.frame_id.tolist() == [1, 1] and stf.tracks.xy.device.type == "cpu"
    assert int(fleet) == 0 and run.step.host_syncs >= 2
