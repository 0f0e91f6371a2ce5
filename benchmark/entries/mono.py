"""The mono configuration's entry into the program: `MonoStep.__call__`
from `build_tracker` for one stream, `MonoFleetStep.__call__` for a fleet.

One step object serves every dive of a run (its captured graphs with it);
each dive starts from a fresh state. `load` takes the run's dives;
`start` takes the dives of the streams (one per stream) and returns a
fresh state and the dive's frame function.
"""

from __future__ import annotations

import torch

from uvipslam_torch.frontend.device_tracker import MonoFleetStep, build_tracker, init_state
from uvipslam_torch.frontend.tracker import TrackerConfig
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.parallel.replay import batched_replay, stream_generators

VIO = False


class Entry:
    def __init__(self, conf: dict, streams: int, K, device):
        seq, caps = conf["sequence"], conf["caps"]
        self.cam = CameraModel.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=int(seq["W"]),
                                      height=int(seq["H"]))
        self.cfg = TrackerConfig(**conf["tracker"])
        self.kf_cap, self.pt_cap = int(caps["kf_cap"]), int(caps["pt_cap"])
        self.streams, self.device = streams, device
        if streams == 1:
            _, self.step = build_tracker(self.cam, self.cfg, self.kf_cap, self.pt_cap,
                                         device=device)
        else:
            self.make_states = batched_replay(self.cam, self.cfg, self.kf_cap, self.pt_cap,
                                              device=device)[0]
            self.step = MonoFleetStep(self.cam, self.cfg, device=device)

    def load(self, dives):
        """The run's dives (their images are on the card already)."""
        self.images = [d.images for d in dives]
        if self.streams > 1:
            self.every = torch.stack(self.images)                 # [n, T, H, W]

    def start(self, dive_ids):
        """A fresh state over the dives `dive_ids` (one per stream), each
        stream's tracker generator seeded 0 as bench.py's runs are, and a
        function frame(state, f) -> (state, out)."""
        if self.streams == 1:
            st = init_state(self.cfg, self.kf_cap, self.pt_cap, self.cam.height,
                            self.cam.width, device=self.device)
            imgs = self.images[dive_ids[0]]
            return st, lambda s, f: self.step(s, imgs[f])
        st = self.make_states(self.streams)
        imgs = self.every[torch.as_tensor(list(dive_ids), device=self.device)]
        gens = [stream_generators(1, 0, self.device)[0] for _ in dive_ids]
        return st, lambda s, f: self.step(s, imgs[:, f], gens)

    def host_syncs(self) -> int:
        return self.step.host_syncs

    @property
    def segments(self):
        return self.step.segments
