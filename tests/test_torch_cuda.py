"""The port's CUDA kernels (csrc/extract_patches.cu, csrc/anchor_refine.cu)
against their plain torch versions on the card.

Needs an NVIDIA GPU and nvcc; skipped without a CUDA device. This file
imports no jax, so it also runs on a machine without the reference's
dependencies (tests/conftest.py imports jax, hence `--noconftest`):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from uvipslam_torch.ops import klt

H, W = 512, 640


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _points(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 2), generator=g) * torch.tensor([float(W), float(H)])
    pts[:8] = torch.tensor([[0.0, 0.0], [W - 1e-3, H - 1e-3], [-9.0, 4.0], [W + 3.0, 7.0],
                            [float("nan"), 1.0], [float("inf"), 2.0], [3.0, float("-inf")],
                            [5.0, -1e12]])
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("psize", [19, 25, 27, 35])
def test_extract_patches_kernel_matches_plain(cuda_device, psize):
    img = torch.rand((H, W), generator=torch.Generator().manual_seed(1)) * 255.0
    pts = _points()
    plain, local_plain = klt._extract_patches(img, pts, psize)
    before = (klt.patch_launches, klt.refine_launches)
    kern, local_kern = klt.extract_patches_any(img.to(cuda_device), pts.to(cuda_device), psize)
    torch.cuda.synchronize()
    assert (klt.patch_launches, klt.refine_launches) == (before[0] + 1, before[1])
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.nan_to_num(local_kern.cpu()), torch.nan_to_num(local_plain))


def _wave_image(h, w, sx=0.0, sy=0.0):
    """A smooth textured image, shifted by (sx, sy) pixels."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64) - sy,
                            torch.arange(w, dtype=torch.float64) - sx, indexing="ij")
    v = (128 + 40 * torch.sin(0.21 * xs + 0.13 * ys) + 30 * torch.cos(0.17 * ys - 0.11 * xs)
         + 20 * torch.sin(0.091 * xs + 0.29 * ys) + 15 * torch.cos(0.31 * xs - 0.05 * ys))
    return v.float().contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("size,iters,max_correction,max_residual",
                         [((256, 320), 10, 5.0, 45.0), ((512, 640), 8, 4.0, 32.0)])
def test_anchor_refine_kernel_matches_plain(cuda_device, size, iters, max_correction,
                                            max_residual):
    """The fused kernel against `_anchor_refine_plain` on the card at the
    two main-path settings (psize 27 and 25): accept equal except where
    the plain version lies within 1e-3 of a threshold, out within 1e-3 px
    where both accept (float32 sums in another order), rejected and
    non-finite tracks keep their start point, one counted launch."""
    h, w = size
    a = _wave_image(h, w).to(cuda_device)
    b = _wave_image(h, w, 0.7, -0.4).to(cuda_device)
    pts = _points()
    pts = pts * torch.tensor([w / W, h / H])
    T, Tx, Ty = klt.extract_templates_fast(a, torch.nan_to_num(pts).to(cuda_device))
    valid = torch.rand(pts.shape[0], generator=torch.Generator().manual_seed(2)) > 0.05
    args = (b, T, Tx, Ty, pts.to(cuda_device), valid.to(cuda_device))
    kw = dict(win=13, iters=iters, max_correction=max_correction, max_residual=max_residual)
    plain_out, plain_acc = klt._anchor_refine_plain(*args, **kw)
    before = (klt.patch_launches, klt.refine_launches)
    out, acc = klt.anchor_refine_fast(*args, **kw)
    torch.cuda.synchronize()
    assert (klt.patch_launches, klt.refine_launches) == (before[0], before[1] + 1)
    _, _, _, resid, corr = klt._refine_terms(*args[:5], 13, iters, max_correction)
    near = ((corr - max_correction).abs() < 1e-3) | ((resid - max_residual).abs() < 1e-3)
    assert torch.equal(acc[~near], plain_acc[~near])
    assert int(plain_acc.sum()) >= 0.9 * int(valid[8:].sum())
    both = acc & plain_acc
    assert (out[both] - plain_out[both]).abs().max().item() <= 1e-3
    assert torch.equal(torch.nan_to_num(out[~acc]).cpu(), torch.nan_to_num(pts[~acc.cpu()]))


@pytest.mark.cuda
@pytest.mark.parametrize("psize", [19, 35])
def test_extract_patches_kernel_serves_a_fleet_in_one_launch(cuda_device, psize):
    """S = 4 streams, each with its own image and its own border, outside
    and non-finite points: one launch, equal to the plain gather and to
    the single-stream launches, also through the vmap rule."""
    S = 4
    img = torch.rand((S, H, W), generator=torch.Generator().manual_seed(2)) * 255.0
    pts = torch.stack([torch.roll(_points(seed=s), 5 * s, 0) for s in range(S)])
    plain, local_plain = klt._extract_patches(img, pts, psize)
    ci, cp = img.to(cuda_device), pts.to(cuda_device)
    before = klt.patch_launches
    kern, local_kern = klt.extract_patches_any(ci, cp, psize)
    torch.cuda.synchronize()
    assert klt.patch_launches == before + 1
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.nan_to_num(local_kern.cpu()), torch.nan_to_num(local_plain))
    one, _ = klt.extract_patches_any(ci[2], cp[2], psize)
    assert torch.equal(one, kern[2])
    mapped, _ = torch.func.vmap(lambda i, p: klt.extract_patches_any(i, p, psize))(ci, cp)
    assert klt.patch_launches == before + 3 and torch.equal(mapped, kern)


@pytest.mark.cuda
def test_anchor_refine_kernel_serves_a_fleet_in_one_launch(cuda_device):
    S, n, win = 4, 400, 13
    a = torch.stack([_wave_image(H, W, 0.3 * s, -0.2 * s) for s in range(S)])
    b = torch.stack([_wave_image(H, W, 0.3 * s + 0.7, -0.2 * s - 0.4) for s in range(S)])
    pts = torch.stack([torch.roll(_points(n, seed=10 + s), 5 * s, 0) for s in range(S)])
    T, Tx, Ty = klt.extract_templates_fast(a, torch.nan_to_num(pts), win)
    valid = torch.rand((S, n), generator=torch.Generator().manual_seed(3)) > 0.05
    kw = dict(win=win, iters=8, max_correction=4.0, max_residual=32.0)
    p_out, p_acc = klt._anchor_refine_plain(b, T, Tx, Ty, pts, valid, **kw)
    args = [t.to(cuda_device) for t in (b, T, Tx, Ty, pts, valid)]
    before = klt.refine_launches
    out, acc = klt.anchor_refine_fast(*args, **kw)
    torch.cuda.synchronize()
    assert klt.refine_launches == before + 1
    both = acc.cpu() & p_acc
    assert int((acc.cpu() != p_acc).sum()) <= 2 and int(both.sum()) > 0.8 * S * n
    assert float((out.cpu()[both] - p_out[both]).abs().max()) <= 1e-3
    one = klt.anchor_refine_fast(*(t[1] for t in args), **kw)
    assert torch.equal(torch.nan_to_num(one[0]), torch.nan_to_num(out[1]))
    assert torch.equal(one[1], acc[1])
    mapped = torch.func.vmap(lambda *x: klt.anchor_refine_fast(*x, **kw))(*args)
    assert klt.refine_launches == before + 3
    assert torch.equal(torch.nan_to_num(mapped[0]), torch.nan_to_num(out))


@pytest.mark.cuda
def test_extract_patches_kernel_rejects_cpu_tensors(cuda_device):
    with pytest.raises(ValueError):
        klt.extract_patches_cuda(torch.zeros((40, 50)), torch.zeros((3, 2)), 19)


@pytest.mark.cuda
def test_anchor_refine_kernel_rejects_cpu_tensors(cuda_device):
    z = torch.zeros((3, 169))
    with pytest.raises(ValueError):
        klt.anchor_refine_cuda(torch.zeros((40, 50)), z, z, z, torch.zeros((3, 2)),
                               torch.ones(3, dtype=torch.bool))


@pytest.mark.cuda
def test_vip_frame_on_card_matches_cpu(cuda_device):
    """The first frame of the VIP step on the card and on the CPU: the same
    detections (set-wise: a float32 sum on a resized pyramid level may
    land on a FAST threshold, so >= 95% of the card's tracks are CPU
    tracks with the same descriptor), with the patch kernel launched on
    the card; then the next frame's inertial accumulation (both running
    integrals in one batched loop, the raw-sample stash) from the same
    state agrees to float32 rounding."""
    from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    seq = make_sequence(n_frames=2, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6)
    out = {}
    for dev in ("cpu", cuda_device):
        st, step = build_vip_tracker(cam, cfg, 16, 1024, device=dev)
        bundles = make_bundles(seq, device=dev)
        before = klt.patch_launches
        st, _ = step(st, bundles[0])
        torch.cuda.synchronize()
        launched = klt.patch_launches - before
        st1, pre_frame = step._accumulate(st, bundles[1])
        out[str(dev)] = (st, launched, st1, pre_frame)
    cpu, card = out["cpu"][0], out[str(cuda_device)][0]
    assert out["cpu"][1] == 0 and out[str(cuda_device)][1] > 0
    at = {tuple(p): i for i, p in enumerate(cpu.tracks.xy.tolist())}
    same = 0
    for j, p in enumerate(card.tracks.xy.cpu().tolist()):
        i = at.get(tuple(p))
        same += i is not None and torch.equal(cpu.tracks.desc[i], card.tracks.desc[j].cpu())
    assert same >= 0.95 * card.tracks.xy.shape[0]
    _, _, cpu1, cpu_pre = out["cpu"]
    _, _, card1, card_pre = out[str(cuda_device)]
    assert int(card1.kf_n) == int(cpu1.kf_n) == int(seq.imu_mask[1].sum()) > 0
    torch.testing.assert_close(card1.kf_acc.cpu(), cpu1.kf_acc, atol=0, rtol=0)
    for f in ("dP", "dV", "dR", "cov", "dt"):
        for a, b in ((card1.preint_kf, cpu1.preint_kf), (card_pre, cpu_pre)):
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_app_synthetic_mono_device_on_card(cuda_device, tmp_path):
    """`python -m uvipslam_torch.app --synthetic 45 --mode 0 --device` on
    the card: the sim3 ATE gate of the reference's app tests, and two runs
    write byte-equal TUM files (runs repeat bit for bit on the card; the
    card's and the CPU's generators draw different RANSAC samples, so no
    pose-by-pose comparison with the CPU)."""
    from uvipslam_torch.app import main
    from uvipslam_torch.io.evaluate import save_tum_groundtruth
    from uvipslam_torch.io.synthetic import make_sequence

    seq = make_sequence(n_frames=45, H=240, W=320, n_points=4000, speed=1.2, z_amp=0.5,
                        depth_noise=0.02)
    gt = str(tmp_path / "gt.txt")
    save_tum_groundtruth(gt, seq.timestamps, seq.positions_w)
    outs = [str(tmp_path / f"est_{i}.txt") for i in range(2)]
    for out in outs:
        res = main(["--synthetic", "45", "--mode", "0", "--device", "--gt", gt, "--out", out])
        assert res["n_matched"] >= 8 and res["ate_rmse_m"] < 0.05 * res["gt_span_m"], res
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.cuda
def test_host_vip_tracker_on_card(cuda_device):
    """The host `VipTracker` on the card over the first frames of a
    120x160 sequence: the same states frame by frame as the CPU run (the
    card's and the CPU's generators draw different RANSAC samples, so the
    inlier counts may differ), both hand kernels launched on the card and
    none on the CPU, and as many host reads as the CPU run makes."""
    from uvipslam_torch.frontend.vip_tracker import VipConfig, VipTracker
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    n = 8
    seq = make_sequence(n_frames=36, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0)
    runs = {}
    for dev in ("cpu", cuda_device):
        tr = VipTracker(cam, cfg, kf_cap=16, pt_cap=1024, device=dev)
        before = (klt.patch_launches, klt.refine_launches)
        states = []
        for f in range(n):
            st = tr.process_frame_vip(seq.images[f], seq.imu_omg[f], seq.imu_acc[f],
                                      seq.imu_dt[f], seq.imu_mask[f], depth=seq.depth[f],
                                      depth_valid=bool(seq.depth_valid[f]),
                                      timestamp=seq.timestamps[f])
            states.append(st["state"])
        torch.cuda.synchronize()
        launched = (klt.patch_launches - before[0], klt.refine_launches - before[1])
        runs[str(dev)] = (states, launched, tr)
    cpu_states, cpu_launched, cpu_tr = runs["cpu"]
    card_states, card_launched, card_tr = runs[str(cuda_device)]
    assert card_states == cpu_states and cpu_states[-1] == "WORKING", (card_states, cpu_states)
    assert cpu_launched == (0, 0) and min(card_launched) > 0, card_launched
    assert card_tr.host_syncs == cpu_tr.host_syncs
    assert card_tr.map.pt_xyz.is_cuda and card_tr.ns.p.is_cuda
    assert torch.isfinite(torch.stack([t for _, _, t in card_tr.trajectory])).all()


@pytest.mark.cuda
def test_vip_blackout_on_card_matches_cpu(cuda_device, monkeypatch):
    """The VIP step's post-init blackout (the run of
    tests/test_torch_vip_blackout.py: 120x160, 100 tracks, 40 frames,
    frames 28-30 black after VIO init) on the card and on the CPU: the
    same label on every frame, through the failing first-try lane,
    IMU_RELOC's dead reckoning and the two-view re-anchor. Each run
    draws its RANSAC samples from one CPU generator seeded 0 (the card's
    and the CPU's generators draw different numbers), so both runs see
    the same draws; both hand kernels launch on the card only."""
    import dataclasses

    from uvipslam_torch.frontend import device_vip
    from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, WORKING
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel
    from uvipslam_torch.ops import twoview

    black = (28, 29, 30)
    seq = make_sequence(n_frames=40, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0, imu_cap_per_kf=256)
    runs = {}
    for dev in ("cpu", cuda_device):
        draws = torch.Generator().manual_seed(0)

        def draw_uniform(gen, n_iters, n, device):
            return torch.rand((n_iters, n), generator=draws).to(device)

        monkeypatch.setattr(twoview, "draw_uniform", draw_uniform)
        monkeypatch.setattr(device_vip, "draw_uniform", draw_uniform)
        st, step = build_vip_tracker(cam, cfg, 16, 1024, device=dev)
        before = (klt.patch_launches, klt.refine_launches)
        labels = []
        for f, b in enumerate(make_bundles(seq, device=dev)):
            if f in black:
                b = dataclasses.replace(b, img=torch.zeros_like(b.img))
            st, out = step(st, b)
            labels.append(int(out.state))
        torch.cuda.synchronize()
        runs[str(dev)] = labels, (klt.patch_launches - before[0],
                                  klt.refine_launches - before[1])
    (cpu, cpu_launched), (card, card_launched) = runs["cpu"], runs[str(cuda_device)]
    assert card == cpu, (card, cpu)
    assert cpu[black[0]] == IMU_RELOC and cpu[-1] == WORKING, cpu
    assert cpu_launched == (0, 0) and min(card_launched) > 0, card_launched
