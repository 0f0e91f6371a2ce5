"""Batched replay: a fleet of S independent SLAM streams in lockstep,
on one card or sharded over processes.

Counterpart of `uvipslam_tpu/parallel/replay.py`. The reference maps its
branch-free step over streams with `jax.vmap` and scans it over time;
here the fleet steps (`frontend.device_tracker.MonoFleetStep`,
`frontend.device_vip.VipFleetStep`) carry a leading stream dimension on
every state leaf, read one flag table per frame, group the streams by
branch and run each stage once over the streams that take it. The
streams share every kernel launch, so a batched frame runs about as many
kernels as a single stream's frame while the device work grows S-fold.

The reference compiles the whole replay into one program
(`jax.jit(vmap(scan(step)))`). Here `graphs` (on by default on a CUDA
device, off on the CPU) replays each batched frame as captured CUDA
graphs, cut at the fleet's host reads and per-stream branches
(`frontend.device_tracker.Fleet`): the host issues a few graph launches
where the eager fleet issues every operation. A graph is keyed by the
size of each stream group and never by its members, whose index tensors
enter as inputs, so a replay of S streams captures a few graphs per
branch and group size and replays them. `graphs=False` runs the same
segments eagerly, bit for bit alike.

    make_states, run = batched_replay_vip(cam, cfg, kf_cap, pt_cap)
    states0 = make_states(n_streams)
    stf, outs, fleet = run(states0, bundles)      # bundles leaves [S, T, ...]

Randomness: one `torch.Generator` per stream, stream i seeded `seed + i`
(the reference folds i into its key), made anew by every `run` and held
beside the batched state, whose own `gen` field is None. Stream i draws
what a single-stream run seeded `seed + i` draws, in the same order.

Sharding (the reference's `mesh` argument). The reference runs one SPMD
program over a `jax.sharding.Mesh`; the port runs one process per card
(or per share of one card) in a `torch.distributed` process group:

    torch.distributed.init_process_group("gloo", init_method=..., rank=r, world_size=W)
    mesh = make_mesh(W)                      # this rank's StreamMesh
    make_states, run = batched_replay_vip(cam, cfg, kf_cap, pt_cap, mesh=mesh)
    stf, outs, fleet = run(make_states(S), shard_stream_axis(mesh, bundles))

Rank r owns the global streams [r S/W, (r+1) S/W); stream i keeps the
generator seeded `seed + i` whatever its rank, so a sharded replay runs
each stream as the one-process fleet does. `run` steps the local fleet
(graphed by default, each rank its own graphs of its rows) with no
collective per frame, then makes two outside any graph: one all-reduce
(sum) of `fleet`, the reference's `psum`, and one all-gather of `outs`
in stream order, so every rank returns the same global `fleet` and
`outs` with leaves [S, T, ...]. `stf` stays the rank's own rows.

The collectives use gloo on host copies, not NCCL: they run once per
replay, so their cost does not matter; NCCL refuses two ranks on one
device, which is how a machine with one card runs a sharded replay; and
an NCCL path would need several cards to be tested at all. gloo's
all-gather needs equal shapes (every rank holds S/W streams) and is
given one byte buffer, so flags cross it as bytes.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core.tree import stack_streams, tree_leaves, tree_map, tree_unflatten
from uvipslam_torch.frontend.device_tracker import MonoFleetStep, StepOut, init_state, step_device
from uvipslam_torch.frontend.device_vip import (FrameBundle, VipFleetStep, VipStepOut,
                                                init_vip_state)
from uvipslam_torch.frontend.tracker import WORKING


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """This process's place in a sharded replay: its rank among `world`
    processes, the stream axis' name, the device its fleet runs on and
    the gloo process group of the two collectives."""
    rank: int
    world: int
    axis: str
    device: torch.device
    group: object


def make_mesh(n_devices: int | None = None, axis: str = "stream",
              device="cuda") -> StreamMesh:
    """This rank's `StreamMesh` over the default process group, which the
    caller has initialized with a gloo backend. `n_devices`, when given,
    must equal the world size (a group cannot run a subset of itself).
    `device="cuda"` means card `rank % device_count` and raises without
    a card; the CPU tests pass "cpu"."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a default process group: call "
                           "torch.distributed.init_process_group first")
    if "gloo" not in dist.get_backend():
        raise RuntimeError(f"the replay's collectives run on gloo; the default process group "
                           f"uses {dist.get_backend()}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(f"a mesh of {n_devices} asked for in a process group of {world}")
    dev = step_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return StreamMesh(rank=rank, world=world, axis=axis, device=dev, group=dist.group.WORLD)


def _local_rows(mesh: StreamMesh, n: int):
    if n % mesh.world:
        raise ValueError(f"{n} streams do not split evenly over {mesh.world} ranks")
    k = n // mesh.world
    return mesh.rank * k, (mesh.rank + 1) * k


def shard_stream_axis(mesh: StreamMesh, tree):
    """This rank's rows of every tensor leaf's leading stream dimension S,
    [rank S/W, (rank+1) S/W), moved to `mesh.device` (a `FrameBundle`,
    images [S, T, H, W], any tree of `core.tree`). Raises when S does
    not split evenly, as `jax.device_put` onto a sharding does."""
    def put(x):
        lo, hi = _local_rows(mesh, x.shape[0])
        return x[lo:hi].to(mesh.device)
    return tree_map(put, tree)


def stream_generators(n_streams: int, seed: int, device, first: int = 0) -> list:
    """One generator per stream, global stream i seeded `seed + i`, for
    the streams first .. first + n_streams - 1."""
    gens = []
    for i in range(first, first + n_streams):
        g = torch.Generator(device=device)
        g.manual_seed(seed + i)
        gens.append(g)
    return gens


def _replay_device(device, mesh):
    return step_device(device) if mesh is None else mesh.device


def _n_local(mesh, n_streams: int) -> int:
    """The streams this process's fleet holds."""
    if mesh is None:
        return n_streams
    lo, hi = _local_rows(mesh, n_streams)
    return hi - lo


def _first_stream(mesh, n_local: int) -> int:
    return 0 if mesh is None else mesh.rank * n_local


def _check_local(states, feeds_s: int):
    n = states.state.shape[0]
    if feeds_s != n:
        raise ValueError(f"{feeds_s} streams of input for a fleet of {n}: a sharded replay "
                         f"takes this rank's rows (shard_stream_axis)")


def _all_reduce_fleet(mesh, fleet):
    """The global sums of the fleet's counts (device scalars), on every
    rank: one all-reduce of a host copy."""
    import torch.distributed as dist

    counts = torch.stack([c.reshape(()).to(torch.int64) for c in fleet]).cpu()
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.group)
    return tuple(counts[i].to(c.dtype).to(c.device) for i, c in enumerate(fleet))


def _all_gather_streams(mesh, tree):
    """Every rank's rows of each tensor leaf, concatenated in rank order
    (stream order), on every rank: the leaves packed into one byte buffer
    for one all-gather of host copies."""
    import torch.distributed as dist

    leaves = tree_leaves(tree)
    host = [a.detach().contiguous().cpu() for a in leaves]
    flat = torch.cat([h.reshape(-1).view(torch.uint8) for h in host])
    parts = [torch.empty_like(flat) for _ in range(mesh.world)]
    dist.all_gather(parts, flat, group=mesh.group)
    out, off = [], 0
    for a, h in zip(leaves, host):
        n = h.numel() * h.element_size()
        # a copy starts at offset 0, aligned for any dtype
        rows = [p[off:off + n].clone().view(h.dtype).reshape(h.shape) for p in parts]
        out.append(torch.cat(rows, dim=0).to(a.device))
        off += n
    return tree_unflatten(tree, out)


def _fleet_of(st0, n_streams: int):
    """One initial state repeated into a fleet (the generator left out)."""
    return stack_streams([dataclasses.replace(st0, gen=None)] * n_streams)


def _over_time(outs, out_type):
    """Per-frame outputs (leaves [S, ...]) -> one with leaves [S, T, ...]."""
    return out_type(*(torch.stack([getattr(o, f.name) for o in outs], dim=1)
                      for f in dataclasses.fields(out_type)))


def batched_replay(cam, cfg, kf_cap: int, pt_cap: int, device="cuda", seed: int = 0,
                   mesh: StreamMesh | None = None, graphs: bool | None = None):
    """The mono device tracker over a fleet, on the card unless `device`
    names another. Returns (make_states, run):

      states0 = make_states(n_streams)        # TrackerState, leaves [S, ...]
      stf, outs, fleet = run(states0, imgs)   # imgs [S, T, H, W]

    `outs` is a `StepOut` with leaves [S, T, ...]; `fleet` the total count
    of WORKING frames (a device scalar). `run.step` is the fleet step of
    the last call (its `host_syncs`, its `segments`). `graphs` as the fleet
    step takes it: on by default on a CUDA device, off on the CPU.

    With a `mesh` the fleet runs on `mesh.device` (`device` is not used):
    `make_states(n_streams)` builds this rank's n_streams / world rows,
    `run` takes this rank's rows of the images (`shard_stream_axis`) and
    returns the global `outs` and `fleet`, and `stf` of its own rows."""
    device = _replay_device(device, mesh)

    def make_states(n_streams: int):
        return _fleet_of(init_state(cfg, kf_cap, pt_cap, cam.height, cam.width, device=device),
                         _n_local(mesh, n_streams))

    def run(states, imgs):
        step = run.step = MonoFleetStep(cam, cfg, device=device, graphs=graphs)
        imgs = torch.as_tensor(imgs).to(device)
        n = states.state.shape[0]
        _check_local(states, imgs.shape[0])
        gens = stream_generators(n, seed, device, _first_stream(mesh, n))
        st, outs = states, []
        for f in range(imgs.shape[1]):
            st, out = step(st, imgs[:, f], gens)
            outs.append(out)
        outs = _over_time(outs, StepOut)
        fleet = torch.sum((outs.state == WORKING).to(torch.int32))
        if mesh is not None:
            (fleet,) = _all_reduce_fleet(mesh, (fleet,))
            outs = _all_gather_streams(mesh, outs)
        return st, outs, fleet

    return make_states, run


def batched_replay_vip(cam, cfg, kf_cap: int, pt_cap: int, device="cuda", seed: int = 0,
                       mesh: StreamMesh | None = None, graphs: bool | None = None):
    """The VIP device tracker over a fleet: each stream runs the complete
    step (mono bootstrap, VIO init with the pressure scale, VI(P)
    tracking, VI window BA, recovery). Returns (make_states, run):

      states0 = make_states(n_streams)
      stf, outs, fleet = run(states0, bundles)   # FrameBundle leaves [S, T, ...]

    `outs` is a `VipStepOut` with leaves [S, T, ...]; `fleet` = (total
    WORKING frames, streams with VIO initialized), device scalars. With a
    `mesh`, as `batched_replay`: this rank's rows in, the global `outs`
    and `fleet` out, `stf` of this rank's rows. `graphs` as
    `batched_replay` takes it."""
    device = _replay_device(device, mesh)

    def make_states(n_streams: int):
        return _fleet_of(init_vip_state(cfg, kf_cap, pt_cap, cam.height, cam.width,
                                        device=device), _n_local(mesh, n_streams))

    def run(states, bundles: FrameBundle):
        step = run.step = VipFleetStep(cam, cfg, kf_cap, device=device, graphs=graphs)
        bundles = tree_map(lambda a: a.to(device), bundles)
        n = states.state.shape[0]
        _check_local(states, bundles.img.shape[0])
        gens = stream_generators(n, seed, device, _first_stream(mesh, n))
        st, outs = states, []
        for f in range(bundles.img.shape[1]):
            st, out = step(st, tree_map(lambda a: a[:, f], bundles), gens)
            outs.append(out)
        outs = _over_time(outs, VipStepOut)
        fleet = (torch.sum((outs.state == WORKING).to(torch.int32)),
                 torch.sum(st.vio_ok.to(torch.int32)))
        if mesh is not None:
            fleet = _all_reduce_fleet(mesh, fleet)
            outs = _all_gather_streams(mesh, outs)
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
