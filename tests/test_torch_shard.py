"""The fleet's stream axis sharded over processes (`parallel/replay.py`:
`make_mesh`, `shard_stream_axis`, the `mesh` argument of the replays),
on the CPU with gloo.

Two ranks are spawned (tests/_torch_shard_worker.py, which imports no
jax) and each runs half the fleet. At the size of the reference's
CPU-mesh test (S = 4, T = 3, 64x80, 32 tracks) the two ranks give, on
both ranks, the outputs of the one-process port fleet stream by stream
(labels and keyframe slots exactly, poses within 1e-3 as in
tests/test_torch_replay_ops.py) and the reference's `batched_replay` on a
2-device CPU mesh (labels and `fleet`); global stream i draws from the
generator seeded `seed + i`. The argument checks raise as the reference
does or as the process group requires. Marked slow: the reference dry
run's VIP fleet (`__graft_entry__.dryrun_multichip`: 240x320, 45 frames,
seeds 20 + s) over 2 ranks x 2 streams, with its gates.
"""

import dataclasses
import multiprocessing
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import _torch_shard_worker as worker
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.parallel import replay as jreplay
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.io.synthetic import ate_rmse, make_sequence
from uvipslam_torch.models.camera import CameraModel as TCam
from uvipslam_torch.parallel import replay as treplay

WORLD = 2
S, T, H, W = 4, 3, 64, 80
CFG = dict(n_tracks=32, min_init_tracks=8, local_window=2, n_levels_klt=3, px_distance=6)
SEED = 3


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(job: dict, deadline: float) -> list:
    """Run `worker.main` on WORLD spawned ranks; every rank must exit 0
    within `deadline` seconds. Returns what each rank saved."""
    ctx = multiprocessing.get_context("spawn")
    job = dict(job, world=WORLD, timeout=int(deadline))
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, job["port"], job))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {deadline} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    return [torch.load(os.path.join(job["dir"], f"rank{r}.pt")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """The sharded mono fleet's saved results and its input."""
    d = tmp_path_factory.mktemp("shard_mono")
    seqs = [make_sequence(n_frames=T, H=H, W=W, n_points=300, seed=s, speed=1.0)
            for s in range(S)]
    imgs = np.stack([s.images for s in seqs]).astype(np.float32)
    np.savez(d / "inputs.npz", images=imgs, K=seqs[0].K)
    job = dict(kind="mono", S=S, H=H, W=W, cfg=CFG, kf_cap=8, pt_cap=256, seed=SEED,
               inputs=str(d / "inputs.npz"), dir=str(d), port=_free_port())
    return spawn_ranks(job, deadline=240.0), imgs, seqs[0].K


def test_sharded_mono_fleet_equals_one_process_fleet(mono):
    ranks, imgs, K = mono
    cam = TCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H)
    make_states, run = treplay.batched_replay(cam, ttr.TrackerConfig(**CFG), 8, 256,
                                              device="cpu", seed=SEED)
    _, outs, fleet = run(make_states(S), imgs)
    for r in ranks:
        got = r["outs"]
        assert got["Rcw"].shape == (S, T, 3, 3) and got["state"].shape == (S, T)
        assert torch.equal(got["state"], outs.state)
        assert torch.equal(got["new_kf"], outs.new_kf)
        assert torch.allclose(got["Rcw"], outs.Rcw, atol=1e-3)
        assert torch.allclose(got["tcw"], outs.tcw, atol=1e-3)
        assert r["fleet"].tolist() == [int(fleet)]
    for f in ("state", "new_kf", "Rcw", "tcw", "n_inliers"):
        assert torch.equal(ranks[0]["outs"][f], ranks[1]["outs"][f]), f
    assert (outs.state[:, -1] >= 1).all()


def test_sharded_mono_fleet_matches_reference_mesh(mono):
    ranks, imgs, K = mono
    mesh = jreplay.make_mesh(WORLD, platform="cpu")
    jcam = JCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H)
    jmake, jrun = jreplay.batched_replay(jcam, jtr.TrackerConfig(**CFG), 8, 256, mesh)
    _, jouts, jfleet = jrun(jmake(S), jreplay.shard_stream_axis(mesh, jnp.asarray(imgs)))
    for r in ranks:
        np.testing.assert_array_equal(r["outs"]["state"].numpy(), np.asarray(jouts.state))
        assert r["fleet"].tolist() == [int(jfleet)]


def test_sharded_streams_keep_their_seeds(mono):
    """Rank r's fleet holds global streams 2r and 2r + 1, their generators
    seeded SEED + 2r and SEED + 2r + 1, and its final rows are those
    streams' rows of the gathered outputs."""
    ranks, _, _ = mono
    n = S // WORLD
    for rank, r in enumerate(ranks):
        assert r["seeds"].tolist() == [SEED + rank * n + j for j in range(n)]
        assert torch.equal(r["local_state"], r["outs"]["state"][rank * n:(rank + 1) * n, -1])


def _fake_mesh(rank=0, world=WORLD):
    return treplay.StreamMesh(rank=rank, world=world, axis="stream", device=torch.device("cpu"),
                              group=None)


def test_shard_stream_axis_takes_rows_and_refuses_uneven_split():
    x = torch.arange(8 * 3).reshape(8, 3)
    one = treplay.shard_stream_axis(_fake_mesh(1), [x, x[:, :1]])
    assert torch.equal(one[0], x[4:]) and torch.equal(one[1], x[4:, :1])
    assert torch.equal(treplay.shard_stream_axis(_fake_mesh(0), x), x[:4])
    with pytest.raises(ValueError, match="evenly"):
        treplay.shard_stream_axis(_fake_mesh(), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        jreplay.shard_stream_axis(jreplay.make_mesh(WORLD, platform="cpu"), jnp.zeros((3, 4)))


def test_sharded_run_refuses_the_global_input():
    """A rank's `run` takes its own rows: the whole fleet's images raise
    before any collective."""
    seq = make_sequence(n_frames=1, H=H, W=W, n_points=300, seed=0, speed=1.0)
    K = seq.K
    cam = TCam.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H)
    make_states, run = treplay.batched_replay(cam, ttr.TrackerConfig(**CFG), 8, 256,
                                              mesh=_fake_mesh())
    states = make_states(S)
    assert states.state.shape == (S // WORLD,)
    with pytest.raises(ValueError, match="shard_stream_axis"):
        run(states, np.repeat(seq.images[None], S, 0))
    with pytest.raises(ValueError, match="evenly"):
        make_states(3)


def test_make_mesh_needs_a_gloo_process_group_of_its_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        treplay.make_mesh()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = treplay.make_mesh(1, device="cpu")
        assert (mesh.rank, mesh.world, mesh.axis, mesh.device) == (0, 1, "stream",
                                                                   torch.device("cpu"))
        with pytest.raises(RuntimeError, match="process group of 1"):
            treplay.make_mesh(2, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                treplay.make_mesh(1)
        with pytest.raises(dataclasses.FrozenInstanceError):
            mesh.rank = 1
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_sharded_vip_fleet_passes_the_dry_run_gates(tmp_path):
    """`__graft_entry__.py:83-143` over 2 ranks x 2 streams."""
    SV, TV, HV, WV = 4, 45, 240, 320
    seqs = [make_sequence(n_frames=TV, H=HV, W=WV, n_points=3000, seed=20 + s, speed=1.2,
                          gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                          acc_bias=(0.0, 0.0, 0.0), depth_noise=0.02, z_amp=0.5)
            for s in range(SV)]
    np.savez(tmp_path / "inputs.npz", K=seqs[0].K, img=np.stack([s.images for s in seqs]),
             **{f: np.stack([getattr(s, g) for s in seqs]) for f, g in (
                 ("imu_omg", "imu_omg"), ("imu_acc", "imu_acc"), ("imu_dt", "imu_dt"),
                 ("imu_mask", "imu_mask"), ("depth", "depth"), ("depth_valid", "depth_valid"),
                 ("timestamp", "timestamps"))})
    cfg = dict(n_tracks=160, min_init_tracks=50, local_window=6, gyr_noise_sd=0.01,
               acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=6, vio_init_min_time=1.0,
               imu_cap_per_kf=128)
    job = dict(kind="vip", S=SV, H=HV, W=WV, cfg=cfg, kf_cap=32, pt_cap=4096, seed=0,
               inputs=str(tmp_path / "inputs.npz"), dir=str(tmp_path), port=_free_port())
    ranks = spawn_ranks(job, deadline=1500.0)
    assert torch.equal(ranks[0]["fleet"], ranks[1]["fleet"])
    outs = ranks[0]["outs"]
    st, vio = outs["state"].numpy(), outs["vio_ok"].numpy()
    n_working, n_vio = ranks[0]["fleet"].tolist()
    assert n_working == int((st == ttr.WORKING).sum()) > 0
    assert n_vio > SV // 2, (n_vio, st[:, -1])
    ok_streams, ates = 0, []
    for s in range(SV):
        if not vio[s].any():
            continue
        init_f = int(np.argmax(vio[s]))
        sel = np.asarray([i for i in range(TV) if i >= init_f + 3 and st[s, i] == ttr.WORKING])
        if len(sel) < 8:
            continue
        Rs, ts = outs["Rcw"][s].double().numpy(), outs["tcw"][s].double().numpy()
        C = np.stack([-Rs[i].T @ ts[i] for i in sel])
        rmse, _ = ate_rmse(C, seqs[s].positions_w[sel], align_scale=False)
        ates.append(rmse)
        ok_streams += rmse < 0.12 * np.linalg.norm(seqs[s].positions_w[-1]
                                                   - seqs[s].positions_w[0])
    assert ok_streams > SV // 2, (ok_streams, n_vio, st[:, -1], ates)
