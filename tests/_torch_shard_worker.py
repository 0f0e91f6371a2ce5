"""One rank of a sharded replay on the CPU, for tests/test_torch_shard.py.

The test spawns `main` once per rank. This module imports only torch,
numpy and the port, since a spawned child re-imports the module of the
function it runs, and the test module imports jax.

Each rank joins a gloo process group, loads the whole fleet's input from
the job's npz file, takes its rows with `shard_stream_axis`, runs the
replay with the mesh and saves what it returned (and the seeds of the
generators `run` made) to `rank<r>.pt` in the job's directory.
"""

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from uvipslam_torch.frontend.device_vip import FrameBundle
from uvipslam_torch.frontend.tracker import TrackerConfig
from uvipslam_torch.frontend.vip_tracker import VipConfig
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.parallel import replay

BUNDLE_BOOL = ("depth_valid",)


def main(rank: int, world: int, port: int, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        _run(rank, job)
    finally:
        dist.destroy_process_group()


def _run(rank: int, job: dict) -> None:
    data = np.load(job["inputs"])
    K = data["K"]
    cam = CameraModel.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=job["W"], height=job["H"])
    mesh = replay.make_mesh(job["world"], device="cpu")

    seeds = []
    make_gens = replay.stream_generators

    def recording(n, seed, device, first=0):
        gens = make_gens(n, seed, device, first)
        seeds.extend(g.initial_seed() for g in gens)
        return gens

    replay.stream_generators = recording
    if job["kind"] == "mono":
        make_states, run = replay.batched_replay(cam, TrackerConfig(**job["cfg"]), job["kf_cap"],
                                                 job["pt_cap"], seed=job["seed"], mesh=mesh)
        feeds = torch.from_numpy(data["images"])
    else:
        make_states, run = replay.batched_replay_vip(cam, VipConfig(**job["cfg"]), job["kf_cap"],
                                                     job["pt_cap"], seed=job["seed"], mesh=mesh)
        feeds = FrameBundle(**{f.name: torch.from_numpy(data[f.name]).to(
            torch.bool if f.name in BUNDLE_BOOL else torch.float32)
            for f in dataclasses.fields(FrameBundle)})
    stf, outs, fleet = run(make_states(job["S"]), replay.shard_stream_axis(mesh, feeds))
    fleet = fleet if isinstance(fleet, tuple) else (fleet,)
    torch.save({"outs": {f.name: getattr(outs, f.name) for f in dataclasses.fields(outs)},
                "fleet": torch.stack([f.reshape(()) for f in fleet]),
                "seeds": torch.tensor(seeds), "local_state": stf.state,
                "host_syncs": run.step.host_syncs},
               os.path.join(job["dir"], f"rank{rank}.pt"))
