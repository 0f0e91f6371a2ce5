"""IMU recovery of the VIP slice: the port's device VIP step against the
reference's on tests/test_torch_vip.py's sequence (120x160, 100 tracks,
40 frames), with three black frames after VIO init. Both steps fail the
VI solve and its first-try lane, dead-reckon in IMU_RELOC, and come back
to WORKING by two-view re-anchoring within two frames of each other.

This pass was the second half of tests/test_torch_vip.py's module
fixtures; it lives in a file of its own so that two test workers share
the two sequence passes.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import device_vip as jdv
from uvipslam_tpu.frontend import vip_tracker as jvt
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_torch.frontend import device_vip as tdv
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.models.camera import CameraModel as TCam
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_vip import CFG, H, KF_CAP, N_FRAMES, PT_CAP, W, _jbundle, seq  # noqa: F401

BLACK = (28, 29, 30)     # black frames after VIO init (frame 23 in both)


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jax_blackout(seq):
    with jax.enable_x64(False):
        cam = JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                          height=H)
        st, step = jdv.build_vip_tracker(cam, jvt.VipConfig(**CFG), KF_CAP, PT_CAP)
        states = []
        for f in range(N_FRAMES):
            b = _jbundle(seq, f)
            if f in BLACK:
                b = dataclasses.replace(b, img=jnp.zeros_like(b.img))
            st, out = step(st, b)
            states.append(int(out.state))
    return np.asarray(states)


@pytest.fixture(scope="module")
def torch_blackout(seq):
    cam = TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)
    st, step = tdv.build_vip_tracker(cam, tvt.VipConfig(**CFG), KF_CAP, PT_CAP, device="cpu")
    states = []
    for f, b in enumerate(tdv.make_bundles(seq, device="cpu")):
        if f in BLACK:
            b = dataclasses.replace(b, img=torch.zeros_like(b.img))
        st, out = step(st, b)
        states.append(int(out.state))
    return np.asarray(states)


def test_vi_blackout_enters_and_leaves_imu_recovery(jax_blackout, torch_blackout):
    """Black frames after VIO init: the VI solve and its first-try lane
    fail, both steps dead-reckon in IMU_RELOC, capture a fresh anchor and
    re-anchor by two-view reconstruction back to WORKING. Before the
    blackout the port's states are the reference's."""
    runs = {"reference": jax_blackout, "port": torch_blackout}
    first = {}
    for name, states in runs.items():
        assert (states[:BLACK[0]] == jax_blackout[:BLACK[0]]).all(), (name, states)
        assert states[BLACK[0]] == ttr.IMU_RELOC, (name, states)
        rec = np.nonzero(states[BLACK[0]:] == ttr.WORKING)[0]
        assert len(rec) and (states[BLACK[0] + rec[0]:] == ttr.WORKING).all(), (name, states)
        first[name] = BLACK[0] + int(rec[0])
    assert abs(first["reference"] - first["port"]) <= 2, (first, runs)
