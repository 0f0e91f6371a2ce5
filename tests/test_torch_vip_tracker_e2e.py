"""The host VIP tracker end to end: the port's
`frontend.vip_tracker.VipTracker` against the port's device `VipStep`
on tests/test_torch_vip_tracker.py's sequence (120x160, 36 frames, IMU,
pressure and the camera-in-body rig Tbc != I), with the bars of
tests/test_device_vip.py::test_device_vip_matches_host_trajectory: each
metric ATE over the frames both track with VIO up (from VIO init + 3)
below 12% of the span, and the two trajectories within 4% of the span
after Sim3 alignment. The reference's own host VIP tracker is not the
comparison here: its end-to-end tests are red (tests/test_vip_tracker.py),
so the port is held to it method by method in
tests/test_torch_vip_tracker.py.
"""

import numpy as np
import pytest

from uvipslam_torch.frontend import device_vip as tdv
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.io.synthetic import ate_rmse
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_vip_tracker import CFG, KF_CAP, N_FRAMES, PT_CAP, _tcam, seq  # noqa: F401


@pytest.fixture(scope="module")
def port_runs(seq):
    """The port's VipTracker and the port's device VipStep over the
    sequence without the blackout."""
    cam = _tcam(seq)
    cfg = tvt.VipConfig(**CFG)
    tr = tvt.VipTracker(cam, cfg, kf_cap=KF_CAP, pt_cap=PT_CAP, device="cpu")
    host = {}
    for f in range(N_FRAMES):
        st = tr.process_frame_vip(seq.images[f], seq.imu_omg[f], seq.imu_acc[f], seq.imu_dt[f],
                                  seq.imu_mask[f], depth=seq.depth[f],
                                  depth_valid=bool(seq.depth_valid[f]),
                                  timestamp=seq.timestamps[f])
        if st.get("state") == "WORKING" and tr.vio_ok:
            host[f] = -(tr.Rcw.T.double() @ tr.tcw.double()).numpy()
    st, step = tdv.build_vip_tracker(cam, cfg, KF_CAP, PT_CAP, device="cpu")
    dev = {}
    for f, b in enumerate(tdv.make_bundles(seq, device="cpu")):
        st, out = step(st, b)
        if int(out.state) == ttr.WORKING and bool(out.vio_ok):
            dev[f] = -(out.Rcw.T.double() @ out.tcw.double()).numpy()
    return dict(tr=tr, host=host, dev=dev)


def test_host_tracker_against_the_device_step(seq, port_runs):
    """End to end: both metric ATEs over the frames both track with VIO
    up (from VIO init + 3) below 12% of the span, and the two
    trajectories within 4% of the span after Sim3 alignment."""
    host, dev = port_runs["host"], port_runs["dev"]
    assert len(host) >= 8 and len(dev) >= 8, (sorted(host), sorted(dev))
    start = max(min(host), min(dev)) + 3
    both = [f for f in sorted(host) if f in dev and f >= start]
    assert len(both) >= 8, both
    gt = seq.positions_w[both]
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    H_ = np.stack([host[f] for f in both])
    D_ = np.stack([dev[f] for f in both])
    for name, C in (("host", H_), ("device", D_)):
        ate, _ = ate_rmse(C, gt, align_scale=False)
        assert ate < 0.12 * span, (name, ate, span)
    mutual, _ = ate_rmse(H_, D_)
    assert mutual < 0.04 * span, (mutual, span)
    tr = port_runs["tr"]
    # one read per decision: about one per frame, a few per keyframe
    assert N_FRAMES <= tr.host_syncs <= 3 * N_FRAMES, tr.host_syncs
