"""Batched replay: a fleet of S independent SLAM streams in lockstep on
one card.

Counterpart of `uvipslam_tpu/parallel/replay.py`. The reference maps its
branch-free step over streams with `jax.vmap` and scans it over time;
here the fleet steps (`frontend.device_tracker.MonoFleetStep`,
`frontend.device_vip.VipFleetStep`) carry a leading stream dimension on
every state leaf, read one flag table per frame, group the streams by
branch and run each stage once over the streams that take it. The
streams share every kernel launch, so a batched frame issues about as
many launches as a single stream's frame while the device work grows
S-fold.

    make_states, run = batched_replay_vip(cam, cfg, kf_cap, pt_cap)
    states0 = make_states(n_streams)
    stf, outs, fleet = run(states0, bundles)      # bundles leaves [S, T, ...]

Randomness: one `torch.Generator` per stream, stream i seeded `seed + i`
(the reference folds i into its key), made anew by every `run` and held
beside the batched state, whose own `gen` field is None. Stream i draws
what a single-stream run seeded `seed + i` draws, in the same order.

The reference's mesh argument (the stream axis sharded over devices) has
no counterpart yet: the fleet lives on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core.tree import stack_streams, tree_map
from uvipslam_torch.frontend.device_tracker import MonoFleetStep, StepOut, init_state, step_device
from uvipslam_torch.frontend.device_vip import (FrameBundle, VipFleetStep, VipStepOut,
                                                init_vip_state)
from uvipslam_torch.frontend.tracker import WORKING


def stream_generators(n_streams: int, seed: int, device) -> list:
    """One generator per stream, stream i seeded `seed + i`."""
    gens = []
    for i in range(n_streams):
        g = torch.Generator(device=device)
        g.manual_seed(seed + i)
        gens.append(g)
    return gens


def _fleet_of(st0, n_streams: int):
    """One initial state repeated into a fleet (the generator left out)."""
    return stack_streams([dataclasses.replace(st0, gen=None)] * n_streams)


def _over_time(outs, out_type):
    """Per-frame outputs (leaves [S, ...]) -> one with leaves [S, T, ...]."""
    return out_type(*(torch.stack([getattr(o, f.name) for o in outs], dim=1)
                      for f in dataclasses.fields(out_type)))


def batched_replay(cam, cfg, kf_cap: int, pt_cap: int, device="cuda", seed: int = 0):
    """The mono device tracker over a fleet, on the card unless `device`
    names another. Returns (make_states, run):

      states0 = make_states(n_streams)        # TrackerState, leaves [S, ...]
      stf, outs, fleet = run(states0, imgs)   # imgs [S, T, H, W]

    `outs` is a `StepOut` with leaves [S, T, ...]; `fleet` the total count
    of WORKING frames (a device scalar). `run.step` is the fleet step of
    the last call (its `host_syncs`)."""
    device = step_device(device)

    def make_states(n_streams: int):
        return _fleet_of(init_state(cfg, kf_cap, pt_cap, cam.height, cam.width, device=device),
                         n_streams)

    def run(states, imgs):
        step = run.step = MonoFleetStep(cam, cfg, device=device)
        gens = stream_generators(states.state.shape[0], seed, device)
        imgs = torch.as_tensor(imgs).to(device)
        st, outs = states, []
        for f in range(imgs.shape[1]):
            st, out = step(st, imgs[:, f], gens)
            outs.append(out)
        outs = _over_time(outs, StepOut)
        return st, outs, torch.sum((outs.state == WORKING).to(torch.int32))

    return make_states, run


def batched_replay_vip(cam, cfg, kf_cap: int, pt_cap: int, device="cuda", seed: int = 0):
    """The VIP device tracker over a fleet: each stream runs the complete
    step (mono bootstrap, VIO init with the pressure scale, VI(P)
    tracking, VI window BA, recovery). Returns (make_states, run):

      states0 = make_states(n_streams)
      stf, outs, fleet = run(states0, bundles)   # FrameBundle leaves [S, T, ...]

    `outs` is a `VipStepOut` with leaves [S, T, ...]; `fleet` = (total
    WORKING frames, streams with VIO initialized), device scalars."""
    device = step_device(device)

    def make_states(n_streams: int):
        return _fleet_of(init_vip_state(cfg, kf_cap, pt_cap, cam.height, cam.width,
                                        device=device), n_streams)

    def run(states, bundles: FrameBundle):
        step = run.step = VipFleetStep(cam, cfg, kf_cap, device=device)
        gens = stream_generators(states.state.shape[0], seed, device)
        bundles = tree_map(lambda a: a.to(device), bundles)
        st, outs = states, []
        for f in range(bundles.img.shape[1]):
            st, out = step(st, tree_map(lambda a: a[:, f], bundles), gens)
            outs.append(out)
        outs = _over_time(outs, VipStepOut)
        fleet = (torch.sum((outs.state == WORKING).to(torch.int32)),
                 torch.sum(st.vio_ok.to(torch.int32)))
        return st, outs, fleet

    return make_states, run


def fleet_bundles(seqs, device="cuda") -> FrameBundle:
    """Synthetic sequences of one length, one per stream, as a
    `FrameBundle` with leaves [S, T, ...] uploaded to `device` (the card
    unless named)."""
    import numpy as np
    device = step_device(device)

    def up(name, dtype=torch.float32):
        return torch.from_numpy(np.stack([getattr(s, name) for s in seqs])).to(dtype).to(device)

    return FrameBundle(img=up("images"), imu_omg=up("imu_omg"), imu_acc=up("imu_acc"),
                       imu_dt=up("imu_dt"), imu_mask=up("imu_mask"), depth=up("depth"),
                       depth_valid=up("depth_valid", torch.bool), timestamp=up("timestamps"))
