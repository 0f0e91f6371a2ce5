"""The port's entry points run on the card unless the caller names the
CPU: without a CUDA device, building a step with no `device` raises and
never falls back to the CPU."""

import pytest
import torch

from uvipslam_torch.frontend import device_tracker, device_vip
from uvipslam_torch.frontend.tracker import TrackerConfig
from uvipslam_torch.frontend.vip_tracker import VipConfig
from uvipslam_torch.models.camera import CameraModel

CAM = CameraModel.create(100.0, 100.0, 80.0, 60.0, width=160, height=120)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["build_tracker", "build_vip_tracker", "run_sequence"])
def test_default_device_is_the_card(no_card, entry):
    cfg = TrackerConfig(n_tracks=16, min_init_tracks=8)
    calls = {
        "build_tracker": lambda: device_tracker.build_tracker(CAM, cfg, 4, 64),
        "build_vip_tracker": lambda: device_vip.build_vip_tracker(
            CAM, VipConfig(n_tracks=16, min_init_tracks=8), 4, 64),
        "run_sequence": lambda: device_tracker.run_sequence(
            CAM, cfg, torch.zeros((1, 120, 160)), kf_cap=4, pt_cap=64),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_on_request(no_card):
    st, step = device_tracker.build_tracker(
        CAM, TrackerConfig(n_tracks=16, min_init_tracks=8), 4, 64, device="cpu")
    assert step.device.type == "cpu" and st.tracks.xy.device.type == "cpu"
