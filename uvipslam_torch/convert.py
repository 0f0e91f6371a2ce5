"""Carry reference state into the port.

Turns a reference `TrackerState`, `VipTrackerState`, `MapState`, `Tracks`
or `NavState` whose leaves are numpy arrays (on the reference side:
`jax.tree_util.tree_map(np.asarray, state)`) into the port's dataclass of
tensors on a given device. Fields are read by name, so this module needs
nothing from the reference package. The reference's PRNG key has no
torch counterpart: a converted tracker state gets a fresh generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uvipslam_torch.core.preintegration import PreintState
from uvipslam_torch.core.state import NavState
from uvipslam_torch.frontend.device_tracker import TrackerState
from uvipslam_torch.frontend.device_vip import VipTrackerState
from uvipslam_torch.frontend.frame import Tracks
from uvipslam_torch.mapstate.map import MapState

_NESTED = {"kf_ns": NavState, "kf_preint": PreintState, "tracks": Tracks,
           "map": MapState, "ns": NavState, "rec_ns": NavState, "preint_kf": PreintState,
           "rec_preint": PreintState}


def to_tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def convert(cls, src, device=None, seed: int = 0):
    """Build the port's `cls` from the same-named fields of `src`."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "gen":
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            kw["gen"] = gen
            continue
        v = getattr(src, f.name)
        if f.name in _NESTED:
            kw[f.name] = convert(_NESTED[f.name], v, device)
        elif f.name == "pyr_prev":
            kw[f.name] = tuple(to_tensor(a, device) for a in v)
        else:
            kw[f.name] = to_tensor(v, device)
    return cls(**kw)


def tracker_state(src, device=None, seed: int = 0) -> TrackerState:
    return convert(TrackerState, src, device, seed)


def vip_state(src, device=None, seed: int = 0) -> VipTrackerState:
    return convert(VipTrackerState, src, device, seed)


def map_state(src, device=None) -> MapState:
    return convert(MapState, src, device)


def tracks(src, device=None) -> Tracks:
    return convert(Tracks, src, device)


def nav_state(src, device=None) -> NavState:
    return convert(NavState, src, device)
