"""The VIP configuration's entry into the program: `VipStep.__call__` from
`build_vip_tracker` for one stream, `VipFleetStep.__call__` for a fleet.

One step object serves every dive of a run (its captured graphs with it);
each dive starts from a fresh state. `load` takes the run's dives;
`start` takes the dives of the streams (one per stream) and returns a
fresh state and the dive's frame function.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.frontend.device_vip import (FrameBundle, VipFleetStep, build_vip_tracker,
                                                init_vip_state)
from uvipslam_torch.frontend.vip_tracker import VipConfig
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.parallel.replay import batched_replay_vip, stream_generators

VIO = True


def _bundles(dives, device):
    """Per dive the FrameBundle leaves [T, ...] on the card, uploaded once
    (the images are there already)."""
    out = []
    for d in dives:
        def up(a, dtype=torch.float32):
            return torch.from_numpy(a).to(dtype).to(device)

        out.append(FrameBundle(img=d.images, imu_omg=up(d.imu_omg), imu_acc=up(d.imu_acc),
                               imu_dt=up(d.imu_dt), imu_mask=up(d.imu_mask),
                               depth=up(d.depth), depth_valid=torch.from_numpy(
                                   d.depth_valid).to(device),
                               timestamp=up(d.timestamps)))
    return out


class Entry:
    def __init__(self, conf: dict, streams: int, K, device):
        seq, caps = conf["sequence"], conf["caps"]
        self.cam = CameraModel.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=int(seq["W"]),
                                      height=int(seq["H"]))
        self.cfg = VipConfig(**conf["tracker"])
        self.kf_cap, self.pt_cap = int(caps["kf_cap"]), int(caps["pt_cap"])
        self.streams, self.device = streams, device
        if streams == 1:
            _, self.step = build_vip_tracker(self.cam, self.cfg, self.kf_cap, self.pt_cap,
                                             device=device)
        else:
            self.make_states = batched_replay_vip(self.cam, self.cfg, self.kf_cap, self.pt_cap,
                                                  device=device)[0]
            self.step = VipFleetStep(self.cam, self.cfg, self.kf_cap, device=device)

    def load(self, dives):
        """The run's dives, uploaded once."""
        self.feeds = _bundles(dives, self.device)
        if self.streams > 1:
            self.every = tree_map(lambda *a: torch.stack(a), *self.feeds)   # [n, T, ...]

    def start(self, dive_ids):
        """A fresh state over the dives `dive_ids` (one per stream), each
        stream's tracker generator seeded 0 as bench.py's runs are, and a
        function frame(state, f) -> (state, out)."""
        if self.streams == 1:
            st = init_vip_state(self.cfg, self.kf_cap, self.pt_cap, self.cam.height,
                                self.cam.width, device=self.device)
            fb = self.feeds[dive_ids[0]]
            feed = [FrameBundle(**{k.name: getattr(fb, k.name)[f]
                                   for k in dataclasses.fields(FrameBundle)})
                    for f in range(fb.img.shape[0])]
            return st, lambda s, f: self.step(s, feed[f])
        st = self.make_states(self.streams)
        ix = torch.as_tensor(list(dive_ids), device=self.device)
        stacked = tree_map(lambda a: a[ix], self.every)
        gens = [stream_generators(1, 0, self.device)[0] for _ in dive_ids]
        return st, lambda s, f: self.step(s, tree_map(lambda a: a[:, f], stacked), gens)

    def host_syncs(self) -> int:
        return self.step.host_syncs

    @property
    def segments(self):
        return self.step.segments
