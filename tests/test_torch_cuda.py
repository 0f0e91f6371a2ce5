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
@pytest.mark.parametrize("psize", [7, 19, 35])
@pytest.mark.parametrize("n", [1, 3, 401])
def test_extract_patches_kernel_exact_at_any_count(cuda_device, psize, n):
    """One block per feature at any count: N 1, 3 and 401, with the
    smallest block (psize 7: one warp, two loads per thread, most of them
    past the end) and the main path's (psize 19 and 35)."""
    img = torch.rand((H, W), generator=torch.Generator().manual_seed(4)) * 255.0
    pts = _points(401)[:n].contiguous()
    plain, local_plain = klt._extract_patches(img, pts, psize)
    kern, local_kern = klt.extract_patches_cuda(img.to(cuda_device), pts.to(cuda_device), psize)
    torch.cuda.synchronize()
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.nan_to_num(local_kern.cpu()), torch.nan_to_num(local_plain))


def _refine_inputs(device, S=None, n=400, win=13, seed=0):
    """Templates from a smooth image, refined on it shifted by (0.7, -0.4)
    px, at the probe points (5% invalid); [S, ...] with S streams."""
    lead = () if S is None else (S,)
    shifts = [(0.3 * s, -0.2 * s) for s in range(S or 1)]
    a = torch.stack([_wave_image(H, W, *sh) for sh in shifts])
    b = torch.stack([_wave_image(H, W, sh[0] + 0.7, sh[1] - 0.4) for sh in shifts])
    pts = torch.stack([torch.roll(_points(n, seed=seed + s), 5 * s, 0) for s in range(S or 1)])
    T, Tx, Ty = klt.extract_templates_fast(a, torch.nan_to_num(pts), win)
    valid = torch.rand((S or 1, n), generator=torch.Generator().manual_seed(seed)) > 0.05
    args = [t.reshape(lead + tuple(t.shape[1:])) for t in (b, T, Tx, Ty, pts, valid)]
    return [t.to(device) for t in args]


def _same(a, b):
    return torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["extract_patches", "anchor_refine"])
def test_kernels_capture_into_a_cuda_graph(cuda_device, kernel):
    """Each kernel's raw launch captured into a torch.cuda.CUDAGraph: the
    replay writes what the eager call returns (the capture needs the
    launch on the current stream, which a ctypes call takes from torch)."""
    if kernel == "extract_patches":
        img = (torch.rand((H, W), generator=torch.Generator().manual_seed(5)) * 255.0).to(
            cuda_device)
        pts = _points().to(cuda_device)
        eager = klt.extract_patches_cuda(img, pts, 35)
        outs = [torch.empty_like(t) for t in eager]

        def launch():
            klt.launch_extract_patches(img, pts, 35, *outs)
    else:
        args = _refine_inputs(cuda_device)
        kw = dict(win=13, iters=8, max_correction=4.0, max_residual=32.0)
        eager = klt.anchor_refine_cuda(*args, **kw)
        outs = [torch.empty_like(t) for t in eager]

        def launch():
            klt.launch_anchor_refine(*args, *kw.values(), *outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    for t in outs:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(outs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [None, 8])
def test_anchor_refine_kernel_repeats_bit_for_bit(cuda_device, S):
    """No atomics and a fixed reduction order: three launches on the same
    inputs give the same bits, one stream or eight in one launch."""
    args = _refine_inputs(cuda_device, S)
    kw = dict(win=13, iters=10, max_correction=5.0, max_residual=45.0)
    runs = [klt.anchor_refine_cuda(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    for out, acc in runs[1:]:
        assert _same(out, runs[0][0]) and torch.equal(acc, runs[0][1])
    assert int(runs[0][1].sum()) > 0.8 * runs[0][1].numel()


@pytest.mark.cuda
def test_anchor_refine_kernel_at_the_psize_limit(cuda_device):
    """psize 55 (win 13, max_correction 19) is the largest patch the
    kernel keeps in shared memory: it runs and agrees with the plain form
    with the main-path tolerances; psize 56 (win 14) is refused before
    any launch."""
    args = _refine_inputs(cuda_device)
    kw = dict(win=13, iters=8, max_correction=19.0, max_residual=32.0)
    assert klt.refine_psize(13, 19.0) == klt.MAX_REFINE_PSIZE == 55
    plain_out, plain_acc = klt._anchor_refine_plain(*args, **kw)
    out, acc = klt.anchor_refine_cuda(*args, **kw)
    _, _, _, resid, corr = klt._refine_terms(*args[:5], 13, 8, 19.0)
    torch.cuda.synchronize()
    near = ((corr - 19.0).abs() < 1e-3) | ((resid - 32.0).abs() < 1e-3)
    assert torch.equal(acc[~near], plain_acc[~near])
    both = acc & plain_acc
    assert int(both.sum()) > 0.8 * acc.numel()
    assert (out[both] - plain_out[both]).abs().max().item() <= 1e-3
    assert _same(out[~acc], args[4][~acc])
    T = torch.zeros((400, 14 * 14), device=cuda_device)
    before = klt.refine_launches
    with pytest.raises(ValueError, match="above 55"):
        klt.anchor_refine_cuda(args[0], T, T, T, args[4], args[5], win=14, iters=8,
                               max_correction=19.0)
    assert klt.refine_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("win,max_correction", [(17, 4.0), (13, 20.0)])
def test_anchor_refine_outside_the_kernel_limits(cuda_device, win, max_correction):
    """psize 29 at win 17 (win^2 > 256) and psize 57 at max_correction 20
    (above 55): the card takes the wide route, one patch launch and no
    refinement launch per call (one for a fleet, also through the vmap
    rule), and agrees with the CPU plain form with the tolerances of
    `test_anchor_refine_kernel_matches_plain` (the same loop, float32
    sums in the card's order; a fleet's stream need not equal the single
    stream's bits, as `bmm` over more matrices may round otherwise)."""
    cpu = _refine_inputs("cpu", S=2, win=win)
    args = [t.to(cuda_device) for t in cpu]
    kw = dict(win=win, iters=8, max_correction=max_correction, max_residual=32.0)
    plain_out, plain_acc = klt._anchor_refine_plain(*cpu, **kw)
    _, _, _, resid, corr = klt._refine_terms(*cpu[:5], win, 8, max_correction)
    near = ((corr - max_correction).abs() < 1e-3) | ((resid - 32.0).abs() < 1e-3)
    before = (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls)
    one = klt.anchor_refine_fast(*(t[0] for t in args), **kw)
    fleet = klt.anchor_refine_fast(*args, **kw)
    mapped = torch.func.vmap(lambda *x: klt.anchor_refine_fast(*x, **kw))(*args)
    torch.cuda.synchronize()
    assert (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls) == (
        before[0] + 3, before[1], before[2] + 3)
    for res, sel in ((fleet, slice(None)), (one, 0)):
        out, acc = res[0].cpu(), res[1].cpu()
        assert torch.equal(acc[~near[sel]], plain_acc[sel][~near[sel]])
        both = acc & plain_acc[sel]
        assert int(both.sum()) > 0.8 * acc.numel()
        assert (out[both] - plain_out[sel][both]).abs().max().item() <= 1e-3
        assert _same(out[~acc], cpu[4][sel][~acc])
    assert _same(mapped[0], fleet[0]) and torch.equal(mapped[1], fleet[1])


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


def _tracker_bits(tr):
    """Every tensor attribute of a host tracker (its generator's state
    among them), each as the host bytes of its leaves, and its host
    values."""
    from uvipslam_torch.core.tree import attr_state

    leaves, host = attr_state(tr, tr.NOT_STATE)
    return {k: torch.cat([t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                          for t in ts]) for k, ts in leaves.items()}, host


@pytest.mark.cuda
@pytest.mark.parametrize("lane0_fails", [False, True])
def test_graphed_host_vip_tracker_equals_eager_on_card(cuda_device, lane0_fails):
    """The host `VipTracker` graphed (its default on the card: the frames'
    segments replayed as CUDA graphs, the VIO init's loops through
    `Segments.scan`) against `graphs=False` over the first 26 frames of
    the 120x160 sequence (the bootstrap, pre-VIO keyframes, the VIO init
    and VI frames): after every frame the same bits in every tensor
    attribute, the same host values, statuses, host reads and hand-kernel
    launches; the graphed tracker captured and replayed, the eager one
    did neither. With `lane0_fails` every VI frame's lane-0 solve loses
    its inliers (a patch of segment B that a capture records), so the VI
    frames run the first try's segments L and L2, captured on the first
    and replayed on the next."""
    from uvipslam_torch.frontend.vip_tracker import VipConfig, VipTracker
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    n = 26
    seq = make_sequence(n_frames=36, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0)
    runs = {}
    for graphs in (False, True):
        tr = VipTracker(cam, cfg, kf_cap=16, pt_cap=1024, device=cuda_device, graphs=graphs)
        if lane0_fails:
            def vi_front(*a, real=tr._vi_front, **kw):
                new, (pyr, pred, sol) = real(*a, **kw)
                return new, (pyr, pred, sol[:2] + (torch.zeros_like(sol[2]),) + sol[3:])

            tr._vi_front = vi_front
        before = (klt.patch_launches, klt.refine_launches)
        frames = []
        for f in range(n):
            st = tr.process_frame_vip(seq.images[f], seq.imu_omg[f], seq.imu_acc[f],
                                      seq.imu_dt[f], seq.imu_mask[f], depth=seq.depth[f],
                                      depth_valid=bool(seq.depth_valid[f]),
                                      timestamp=seq.timestamps[f])
            torch.cuda.synchronize()
            frames.append((st, tr.host_syncs, (klt.patch_launches - before[0],
                                               klt.refine_launches - before[1]),
                           *_tracker_bits(tr)))
        runs[graphs] = frames, tr
    (eager, e_tr), (graphed, g_tr) = runs[False], runs[True]
    assert e_tr.segments.captures == 0 and g_tr.segments.captures > 0
    assert g_tr.segments.scan_steps > 0 and g_tr.vio_ok
    if lane0_fails:
        assert {("L",), ("L2",)} <= g_tr.segments.keys
        assert any(e[0].get("first_try_reloc") for e in eager)
    for f, (e, g) in enumerate(zip(eager, graphed)):
        assert g[:3] == e[:3], (f, e[:3], g[:3])
        assert g[3].keys() == e[3].keys()
        bad = [k for k in e[3] if not torch.equal(e[3][k], g[3][k])]
        assert not bad, (f, bad)
        assert g[4] == e[4], f
    assert min(eager[-1][2]) > 0


@pytest.mark.cuda
def test_graphed_host_mono_tracker_equals_eager_on_card(cuda_device):
    """The host `MonoTracker` with `enhance` on (the app's default) graphed
    against `graphs=False` over the first 24 frames of the 120x160 mono
    sequence (the bootstrap, keyframes, a relocalization): after every
    frame the same bits in every tensor attribute, host values, statuses,
    host reads and hand-kernel launches; the graphed tracker's segment F
    captured CLAHE on the card."""
    from uvipslam_torch.frontend.tracker import MonoTracker, TrackerConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    seq = make_sequence(n_frames=40, H=120, W=160, n_points=800, seed=3, speed=1.2)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = TrackerConfig(n_tracks=100, min_init_tracks=60, local_window=8, enhance=True)
    runs = {}
    for graphs in (False, True):
        tr = MonoTracker(cam, cfg, kf_cap=16, pt_cap=1024, device=cuda_device, graphs=graphs)
        before = (klt.patch_launches, klt.refine_launches)
        frames = []
        for f in range(24):
            st = tr.process_frame(seq.images[f])
            torch.cuda.synchronize()
            frames.append((st, tr.host_syncs, (klt.patch_launches - before[0],
                                               klt.refine_launches - before[1]),
                           *_tracker_bits(tr)))
        runs[graphs] = frames, tr
    (eager, e_tr), (graphed, g_tr) = runs[False], runs[True]
    assert e_tr.segments.captures == 0 and g_tr.segments.replays > 0
    assert e_tr.state == 2 and sum(e[0].get("initialized", False) for e in eager) == 1
    for f, (e, g) in enumerate(zip(eager, graphed)):
        assert g[:3] == e[:3], (f, e[:3], g[:3])
        assert g[3].keys() == e[3].keys()
        bad = [k for k in e[3] if not torch.equal(e[3][k], g[3][k])]
        assert not bad, (f, bad)
        assert g[4] == e[4], f
    assert min(eager[-1][2]) > 0


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


def _bits(tree):
    """Every tensor leaf of a state or output as one flat byte tensor."""
    from uvipslam_torch.core.tree import tree_leaves

    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tree_leaves(tree)])


def _graph_runs(mode, device, record=False):
    """The parity sequences of tests/test_torch_vip.py (40 frames, VIO init
    and VI keyframes) and tests/test_torch_step.py (20 frames) at 120x160
    on the card, eager and graphed (and with `record` graphed again with
    the step's recorder timing its replays, stopped after the run): per
    form the per-frame outputs and states, the step and the hand-kernel
    counters."""
    import numpy as np

    from uvipslam_torch.frontend import device_tracker, device_vip
    from uvipslam_torch.frontend.tracker import TrackerConfig
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    if mode == "vip":
        seq = make_sequence(n_frames=40, H=120, W=160, n_points=800, seed=3, speed=1.2,
                            gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                            depth_noise=0.02, z_amp=0.5)
        cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                        acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                        vio_init_min_time=1.0, imu_cap_per_kf=256)
        feeds = device_vip.make_bundles(seq, device=device)
    else:
        seq = make_sequence(n_frames=20, H=120, W=160, n_points=800, seed=3, speed=1.2)
        cfg = TrackerConfig(n_tracks=100, min_init_tracks=60, local_window=8)
        feeds = torch.from_numpy(seq.images.astype(np.float32)).to(device)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    build = device_vip.build_vip_tracker if mode == "vip" else device_tracker.build_tracker
    runs = {}
    forms = (("eager", False), ("graphed", None)) + ((("recorded", None),) if record else ())
    for form, graphs in forms:
        st, step = build(cam, cfg, 16, 1024, device=device, graphs=graphs)
        if form == "recorded":
            step.spans.start(events=True)
        before = (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls)
        outs, states = [], []
        for x in feeds:
            st, out = step(st, x)
            outs.append(out)
            states.append(st)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(
            (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls), before))
        if form == "recorded":
            step.records = step.spans.stop()
        runs[form] = (outs, states, step, counts)
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["vip", "mono"])
def test_graphed_step_equals_eager_on_card(cuda_device, mode):
    """The step's WORKING segments replayed from captured CUDA graphs (the
    default on the card) against `graphs=False` on the 120x160 parity
    sequences: every frame's output and state bit for bit equal, the
    same host reads and hand-kernel launches, no wide-route refinement;
    the graphed run captured and replayed, and its returned states did
    not change under later frames."""
    from uvipslam_torch.frontend.tracker import WORKING

    runs = _graph_runs(mode, cuda_device)
    (e_outs, e_states, e_step, e_counts) = runs["eager"]
    (g_outs, g_states, g_step, g_counts) = runs["graphed"]
    assert not e_step.graphs and g_step.graphs
    for f in range(len(e_outs)):
        assert torch.equal(_bits(e_outs[f]), _bits(g_outs[f])), f
        assert torch.equal(_bits(e_states[f]), _bits(g_states[f])), f
    assert e_step.host_syncs == g_step.host_syncs
    assert e_counts == g_counts and min(e_counts[:2]) > 0 and e_counts[2] == 0, (e_counts,
                                                                                 g_counts)
    labels = [int(o.state) for o in g_outs]
    assert labels[-1] == WORKING
    if mode == "vip":
        assert any(bool(o.vio_ok) for o in g_outs)
        assert ("D", True, True) in g_step.segments.keys     # a VI keyframe was graphed
    seg = g_step.segments
    assert seg.captures == len(seg.graphs) >= len(seg.keys) > 0 and seg.replays > len(g_outs)


@pytest.mark.cuda
def test_graphed_vip_step_through_vio_init_equals_eager_on_card(cuda_device):
    """The 120x160 VIP parity sequence on the card, graphed (the default)
    against `graphs=False`, through the pre-VIO keyframes (segments D, E
    and R before VIO init) and the VIO-init frame, whose loops replay
    captured graphs (`Segments.scan`): every frame's output and state bit
    for bit equal, the same host reads, scan steps on the VIO-init frame
    alone; then `global_ba_navstate` on the final map with its loops
    replayed from graphs against the plain loops, bit for bit."""
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.solver.global_ba import global_ba_navstate

    runs = _graph_runs("vip", cuda_device)
    (e_outs, e_states, e_step, _), (g_outs, g_states, g_step, _) = runs["eager"], runs["graphed"]
    for f in range(len(e_outs)):
        assert torch.equal(_bits(e_outs[f]), _bits(g_outs[f])), f
        assert torch.equal(_bits(e_states[f]), _bits(g_states[f])), f
    assert e_step.host_syncs == g_step.host_syncs
    seg = g_step.segments
    assert e_step.segments.scan_steps == 0 and seg.scan_steps > 0
    keys = seg.keys
    assert {("D", False, True), ("E", False, False), ("R",), ("scan", "gyro_bias")} <= keys, keys
    assert any(k[:2] == ("scan", "ba_se3") for k in keys)
    assert sum(k[:2] == ("scan", "preint") for k in keys) == 2      # strided, all windows

    m, cfg = g_states[-1].map, VipConfig(gyr_noise_sd=0.01, acc_noise_sd=0.1,
                                         depth_noise_sd=0.05)
    cam = g_step.cam

    def ba(scan):
        return _bits(global_ba_navstate(
            m, g_step.gravity, g_step.Rcb, g_step.tcb, cam.fx, cam.fy, cam.cx, cam.cy,
            cfg.gyr_noise_sd, cfg.acc_noise_sd, cfg.gyr_bias_rw2, cfg.acc_bias_rw2,
            g_step.depth_info, g_step.scale_sigmas, scan=scan))

    steps = seg.scan_steps
    plain = ba(None)
    assert torch.equal(ba(seg.scan), plain) and torch.equal(ba(seg.scan), plain)
    assert seg.scan_steps - steps == 2 * (256 + 2 * 8)     # preintegration + 2 rounds of 8


@pytest.mark.cuda
def test_recorder_timing_replays_changes_nothing_on_card(cuda_device):
    """The graphed VIP step through its VIO init with the recorder on and
    every replay timed by events (outside the graphs) against the same
    run with it off: every frame's output and state bit for bit, the same
    host reads, launches, captures and graphs per key; each replay has a
    device time, and the captures' span matches `capture_seconds`."""
    runs = _graph_runs("vip", cuda_device, record=True)
    (g_outs, g_states, g_step, g_counts) = runs["graphed"]
    (r_outs, r_states, r_step, r_counts) = runs["recorded"]
    for f in range(len(g_outs)):
        assert torch.equal(_bits(g_outs[f]), _bits(r_outs[f])), f
        assert torch.equal(_bits(g_states[f]), _bits(r_states[f])), f
    assert g_step.host_syncs == r_step.host_syncs and g_counts == r_counts
    gs, rs = g_step.segments, r_step.segments
    assert gs.captures == rs.captures and gs.graphs_per_key() == rs.graphs_per_key()
    assert gs.replays == rs.replays and gs.scan_steps == rs.scan_steps > 0
    replays = [x for x in r_step.records if x.name.startswith("step.graph.")
               and x.name != "step.graph.capture"]
    assert len(replays) == rs.replays + rs.scan_steps
    assert all(x.device_ns is not None and x.device_ns > 0 for x in replays)
    tot = r_step.spans.totals()
    assert tot["step.call"]["count"] == len(r_outs)
    assert abs(tot["step.graph.capture"]["host_ns"] / 1e9 - rs.capture_seconds) < 1e-3


@pytest.mark.cuda
def test_scan_body_with_a_host_read_raises_on_card(cuda_device):
    """A scan body that reads a value to the host cannot be captured: the
    scan raises SegmentError naming its key and runs no plain loop."""
    from uvipslam_torch.utils.graphs import SegmentError, Segments

    seg = Segments(cuda_device)
    x = torch.arange(3.0, device=cuda_device)
    with pytest.raises(SegmentError, match="'bad'"):
        seg.scan(("bad",), lambda c, _: c * float(c.sum()), x, length=3)
    assert seg.scan_steps == 0 and not any(k[:2] == ("scan", "bad") for k in seg.keys)
    y = seg.scan(("good",), lambda c, _, k: c * k, x, length=3, consts=(x,))
    assert torch.equal(y, x * x * x * x) and seg.scan_steps == 3


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["host_read", "host_to_device_copy"])
def test_graph_capture_of_a_syncing_segment_raises(cuda_device, fault):
    """A segment that reads a value to the host, or makes a tensor from
    host memory, cannot be captured: the helper raises naming the key,
    and the device stays usable."""
    from uvipslam_torch.utils.graphs import SegmentError, Segments

    seg = Segments(cuda_device)

    def fn(x):
        if fault == "host_read":
            return x * float(x.sum())
        return x + torch.tensor([1.0, 2.0, 3.0], device=x.device)

    x = torch.arange(3.0, device=cuda_device)
    with pytest.raises(SegmentError, match="'bad'"):
        seg.run(("bad", fault), fn, x)
    assert not seg.graphs and seg.captures == 0
    y = seg.run(("good",), lambda t: t * 2.0, x)
    assert torch.equal(y, x * 2.0) and seg.replays == 1


@pytest.mark.cuda
def test_graphed_step_raises_on_a_syncing_stage(cuda_device, monkeypatch):
    """A stage of segment B that makes a host read fails the step's
    capture loudly (SegmentError naming the key); nothing carries on
    eagerly."""
    from uvipslam_torch.frontend import device_tracker
    from uvipslam_torch.frontend.tracker import TrackerConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel
    from uvipslam_torch.utils.graphs import SegmentError

    seq = make_sequence(n_frames=6, H=120, W=160, n_points=800, seed=3, speed=1.2)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    st, step = device_tracker.build_tracker(cam, TrackerConfig(n_tracks=100, min_init_tracks=60),
                                            16, 1024, device=cuda_device)
    real = step._working_solve

    def syncing(s):
        int(s.frame_id)            # a host read
        return real(s)

    monkeypatch.setattr(step, "_working_solve", syncing)
    with pytest.raises(SegmentError, match=r"\('B',\)"):
        for img in seq.images:
            st, _ = step(st, torch.from_numpy(img.astype("float32")).to(cuda_device))
    assert ("B",) not in step.segments.keys


# the graphed fleets (their segments replayed as captured CUDA graphs,
# the default on the card) against graphs=False, at the sizes of
# tests/test_torch_replay_ops.py
FLEET_CFG = dict(n_tracks=96, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                 acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                 vio_init_min_time=1.0)
FLEET_KF_CAP, FLEET_PT_CAP, FLEET_MONO_F, FLEET_VI_F, FLEET_FRAMES = 16, 1024, 12, 26, 6


@pytest.fixture(scope="module")
def card_fleet_runs():
    """The `mixed` streams of tests/test_torch_replay_ops.py on the card
    (two single-stream VIP runs at 120x160: stream 0 at its first frame,
    stream 1 at frame 12 before VIO init, stream 2 at frame 20 after it),
    through the eager fleet (a fresh step per order) and the graphed one
    (one step for both orders, from fresh states, so [2, 0, 1] replays
    [0, 1, 2]'s graphs for a VI-lane group of the same size with another
    member). Per form and order: per-frame outputs, the final state, host
    reads, hand-kernel launches and the graphs per key after the run."""
    import dataclasses

    from uvipslam_torch.core.tree import stack_streams
    from uvipslam_torch.frontend import device_vip as dv
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = VipConfig(**FLEET_CFG)
    runs = []
    for seed in (3, 4):
        seq = make_sequence(n_frames=FLEET_VI_F + 8, H=120, W=160, n_points=800, seed=seed,
                            speed=1.2, gyr_noise=0.005, acc_noise=0.05,
                            gyr_bias=(0.004, -0.006, 0.003), depth_noise=0.02, z_amp=0.5)
        cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                                 height=120)
        st, step = dv.build_vip_tracker(cam, cfg, FLEET_KF_CAP, FLEET_PT_CAP, device=dev,
                                        seed=seed)
        bundles = dv.make_bundles(seq, device=dev)
        states = [dataclasses.replace(st, gen=None)]
        for b in bundles[:FLEET_VI_F]:
            st, _ = step(st, b)
            states.append(dataclasses.replace(st, gen=None))
        runs.append((states, bundles))
    (sa, ba), (sb, bb) = runs
    n = FLEET_FRAMES
    streams = [(sa[0], ba, 0), (sb[FLEET_MONO_F], bb, FLEET_MONO_F),
               (sa[FLEET_VI_F - n], ba, FLEET_VI_F - n)]
    out = {}
    for graphs in (False, None):
        fleet = None
        for order in ([0, 1, 2], [2, 0, 1]):
            if fleet is None or graphs is False:
                fleet = dv.VipFleetStep(cam, cfg, FLEET_KF_CAP, device=dev, graphs=graphs)
            syncs = fleet.host_syncs
            st = stack_streams([streams[i][0] for i in order])
            gens = [torch.Generator(device=dev) for _ in order]
            for g, i in zip(gens, order):
                g.manual_seed(100 + i)
            before = (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls)
            outs = []
            for f in range(n):
                st, o = fleet(st, stack_streams([streams[i][1][streams[i][2] + f]
                                                 for i in order]), gens)
                outs.append(o)
            torch.cuda.synchronize()
            out[graphs, tuple(order)] = dict(
                outs=outs, st=st, host_syncs=fleet.host_syncs - syncs, step=fleet,
                launches=tuple(a - b for a, b in zip(
                    (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls), before)),
                per_key=dict(fleet.segments.graphs_per_key()))
    return out


def _check_fleet_forms(e, g):
    for a, b in zip(e["outs"] + [e["st"]], g["outs"] + [g["st"]]):
        assert torch.equal(_bits(a), _bits(b))
    assert e["host_syncs"] == g["host_syncs"]
    assert e["launches"] == g["launches"] and min(e["launches"][:2]) > 0 \
        and e["launches"][2] == 0, (e["launches"], g["launches"])


@pytest.mark.cuda
def test_graphed_vip_fleet_equals_eager_on_card(card_fleet_runs):
    """The VIP fleet over the `mixed` streams, S = 3: the graphed fleet
    (the default on the card) gives the eager fleet's outputs on every
    frame and its final state bit for bit, with the same host reads and
    hand-kernel launches, having captured and replayed its segments."""
    e, g = card_fleet_runs[False, (0, 1, 2)], card_fleet_runs[None, (0, 1, 2)]
    assert not e["step"].graphs and g["step"].graphs
    _check_fleet_forms(e, g)
    seg = g["step"].segments
    assert {"A", "B", "C"} <= {k[0] for k in seg.keys}
    assert seg.captures == len(seg.graphs) and seg.replays > 3 * FLEET_FRAMES


@pytest.mark.cuda
def test_graphed_vip_fleet_replays_another_composition_on_card(card_fleet_runs):
    """The trap of grouped graphs on the card: the graphed step that ran
    [0, 1, 2] runs [2, 0, 1] from fresh states; its VI lane takes stream
    {0} where the first run's took {2}. It captures no new graph for B or
    C (it replays the first run's) and still equals the eager fleet of
    [2, 0, 1] bit for bit."""
    first = card_fleet_runs[None, (0, 1, 2)]
    second = card_fleet_runs[None, (2, 0, 1)]
    _check_fleet_forms(card_fleet_runs[False, (2, 0, 1)], second)
    vi_keys = [k for k in first["per_key"] if k[0] in ("B", "C") and ("vi", "rows") in k]
    assert vi_keys
    for k in vi_keys:
        assert second["per_key"][k] == first["per_key"][k], k


@pytest.mark.cuda
def test_graphed_mono_fleet_equals_eager_on_card(cuda_device):
    """`batched_replay` over two scenes at 120x160, 14 frames: graphed
    (the default on the card) against `graphs=False`, outputs and final
    state bit for bit, the same host reads and hand-kernel launches."""
    import numpy as np

    from uvipslam_torch.frontend.tracker import TrackerConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel
    from uvipslam_torch.parallel.replay import batched_replay

    seqs = [make_sequence(n_frames=14, H=120, W=160, n_points=800, seed=s, speed=1.2)
            for s in (3, 4)]
    k = seqs[0].K
    cam = CameraModel.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=160, height=120)
    cfg = TrackerConfig(n_tracks=96, min_init_tracks=60, local_window=8)
    imgs = torch.from_numpy(np.stack([s.images for s in seqs]).astype(np.float32))
    res = {}
    for graphs in (False, None):
        make_states, run = batched_replay(cam, cfg, FLEET_KF_CAP, FLEET_PT_CAP,
                                          device=cuda_device, seed=5, graphs=graphs)
        before = (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls)
        stf, outs, fleet = run(make_states(2), imgs)
        torch.cuda.synchronize()
        res[graphs] = dict(outs=[outs], st=stf, host_syncs=run.step.host_syncs, step=run.step,
                           launches=tuple(a - b for a, b in zip(
                               (klt.patch_launches, klt.refine_launches,
                                klt.refine_wide_calls), before)))
    assert not res[False]["step"].graphs and res[None]["step"].graphs
    _check_fleet_forms(res[False], res[None])
    seg = res[None]["step"].segments
    assert {"A", "B", "C"} <= {k[0] for k in seg.keys} and seg.replays > 2 * 14


@pytest.fixture(scope="module")
def card_vip_states():
    """The VIP parity sequence at 120x160 through the eager single step on
    the card: the step, the bundles, the state before the VIO-init frame
    and the state one frame after it (the frame index it was kept at)."""
    import dataclasses

    from uvipslam_torch.frontend import device_vip
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    seq = make_sequence(n_frames=40, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0, imu_cap_per_kf=256)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    st, step = device_vip.build_vip_tracker(cam, cfg, 16, 1024, device=dev, graphs=False)
    bundles = device_vip.make_bundles(seq, device=dev)
    pre = None
    for f, b in enumerate(bundles):
        before = st
        st, out = step(st, b)
        if pre is None and bool(out.vio_ok):
            pre = dataclasses.replace(before, gen=None)
        elif pre is not None:
            return dict(step=step, bundles=bundles, pre_trigger=pre, post_init=st, post_frame=f)
    pytest.fail("VIO never initialized on the parity sequence")


@pytest.mark.cuda
def test_fleet_vio_init_through_lifted_scans_on_card(card_vip_states):
    """The fleet's VIO init on the card, the pre-trigger state stacked as
    two streams: its loops replayed from graphs captured over the stream
    axis (`Segments.lifted_scan`) equal the plain loops of the vmapped
    bodies (`graphs=False`) bit for bit, twice (the second call replays
    the first's graphs on fresh constants)."""
    from uvipslam_torch.core.tree import over_streams, stack_streams
    from uvipslam_torch.frontend import device_vip

    step = card_vip_states["step"]
    fleet_st = stack_streams([card_vip_states["pre_trigger"]] * 2)
    eager = device_vip.VipFleetStep(step.cam, step.cfg, 16, device="cuda", graphs=False)
    graphed = device_vip.VipFleetStep(step.cam, step.cfg, 16, device="cuda")
    want = _bits(over_streams(eager.one._try_init_vio, fleet_st))
    seg, counts = graphed.segments, []
    for n in (1, 2):
        assert torch.equal(_bits(over_streams(graphed.one._try_init_vio, fleet_st)), want), n
        counts.append((seg.captures, seg.scan_steps))
    assert eager.segments.scan_steps == 0 and counts[0][1] > 0
    assert counts[1] == (counts[0][0], 2 * counts[0][1])      # the second call replays
    assert {k[-1] for k in seg.keys} == {"streams"} and seg.captures == len(seg.graphs)


def _lane1_frame(card_vip_states, graphs, fails):
    """The frame after `post_init` with the VI solve's inliers zeroed
    (inside segment B, so a capture records it), lane 1 holding, or
    failing with its gate raised past any count: twice through one step
    (graphed: a capture, then a replay). Returns per call (the output's
    bits, the state's, the label, the new keyframe slot), and the step."""
    import dataclasses

    from uvipslam_torch.core.tree import tree_map
    from uvipslam_torch.frontend import device_vip

    src = card_vip_states["step"]
    step = device_vip.VipStep(src.cam, src.cfg, 16, device="cuda", graphs=graphs)
    real = step._vi_lane0

    def lane0_fails(st, b, ns_pred, pre_frame):
        out, (_, need) = real(st, b, ns_pred, pre_frame)
        out = out[:2] + (torch.zeros_like(out[2]),) + out[3:]
        return out, (out[2] >= step.cfg.min_tracked, need)

    step._vi_lane0 = lane0_fails
    if fails:
        step.reloc_min = 1 << 30
    post = card_vip_states["post_init"]
    b = card_vip_states["bundles"][card_vip_states["post_frame"] + 1]
    bits = []
    for _ in range(2):
        gen = torch.Generator(device="cuda")
        gen.set_state(post.gen.get_state())
        st, out = step(dataclasses.replace(tree_map(torch.clone, post), gen=gen), b)
        bits.append((_bits(out), _bits(st), int(out.state), int(out.new_kf)))
    return bits, step


@pytest.mark.cuda
@pytest.mark.parametrize("fails", [False, True])
def test_lane1_frame_graphed_equals_eager_on_card(card_vip_states, fails):
    """A lane-1 frame on the card (the VI solve made to fail): graphed,
    its capturing call and its replay give `graphs=False`'s output and
    state bit for bit with the same host reads; holding it makes the
    forced keyframe through segments L, C, D, E, failing it enters
    IMU_RELOC through segments L and I."""
    from uvipslam_torch.frontend.tracker import IMU_RELOC, WORKING

    (e_bits, e_step), (g_bits, g_step) = (_lane1_frame(card_vip_states, g, fails)
                                          for g in (False, True))
    for x in e_bits + g_bits:
        assert torch.equal(x[0], e_bits[0][0]) and torch.equal(x[1], e_bits[0][1])
    assert e_step.host_syncs == g_step.host_syncs
    n_kf = int(card_vip_states["post_init"].map.n_kf)
    assert e_bits[0][2:] == ((IMU_RELOC, -1) if fails else (WORKING, n_kf))
    keys = g_step.segments.keys
    assert ({("L",), ("I",)} if fails else {("L",), ("C", True, True), ("E", True, False)}) <= keys
    assert g_step.segments.captures == len(g_step.segments.graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("fails", [False, True])
def test_fleet_lane1_group_graphed_equals_eager_on_card(card_vip_states, fails):
    """Lane 1 of a fleet over two copies of the lane-1 frame's stream (the
    VI solve made to fail in both): segment L over the group of two, one
    read of its flags, then segment I. The graphed fleet's capturing call
    and its replay give the eager fleet's outputs and states bit for bit
    with the same host reads and hand-kernel launches, and both rows the
    single step's label and keyframe slot."""
    import dataclasses

    from uvipslam_torch.core.tree import stack_streams, tree_map
    from uvipslam_torch.frontend import device_vip
    from uvipslam_torch.frontend.tracker import IMU_RELOC, WORKING

    src, post = card_vip_states["step"], card_vip_states["post_init"]
    b = card_vip_states["bundles"][card_vip_states["post_frame"] + 1]
    fleet_st = stack_streams([dataclasses.replace(post, gen=None)] * 2)
    runs = {}
    for graphs in (False, True):
        fleet = device_vip.VipFleetStep(src.cam, src.cfg, 16, device="cuda", graphs=graphs)
        one, real = fleet.one, fleet.one._vi_lane0

        def lane0_fails(st, b_, ns_pred, pre_frame, real=real, one=one):
            out, (_, need) = real(st, b_, ns_pred, pre_frame)
            out = out[:2] + (torch.zeros_like(out[2]),) + out[3:]
            return out, (out[2] >= one.cfg.min_tracked, need)

        one._vi_lane0 = lane0_fails
        if fails:
            one.reloc_min = 1 << 30
        calls = []
        for _ in range(2 if graphs else 1):
            gens = []
            for _ in range(2):
                gens.append(torch.Generator(device="cuda"))
                gens[-1].set_state(post.gen.get_state())
            before = (fleet.host_syncs, klt.patch_launches, klt.refine_launches)
            st, out = fleet(tree_map(torch.clone, fleet_st), stack_streams([b, b]), gens)
            torch.cuda.synchronize()
            calls.append((_bits(out), _bits(st), out.state.tolist(), out.new_kf.tolist(),
                          tuple(a - c for a, c in zip(
                              (fleet.host_syncs, klt.patch_launches, klt.refine_launches),
                              before))))
        runs[graphs] = calls, fleet
    (eager,), e_fleet = runs[False]
    graphed, g_fleet = runs[True]
    for x in graphed:
        assert torch.equal(x[0], eager[0]) and torch.equal(x[1], eager[1]) and x[4] == eager[4]
    n_kf = int(post.map.n_kf)
    want = ([IMU_RELOC] * 2, [-1] * 2) if fails else ([WORKING] * 2, [n_kf] * 2)
    assert eager[2:4] == want, eager[2:4]
    keys = g_fleet.segments.keys
    assert ("L", ("g", "all")) in keys and any(k[0] == "I" for k in keys), keys
    assert g_fleet.segments.captures == len(g_fleet.segments.graphs)


@pytest.mark.cuda
def test_recovery_frame_graphed_equals_eager_on_card(cuda_device):
    """The recovery frame of the post-init blackout (120x160, frames 28-30
    black after VIO init) on the card, from the eager run's state before
    it: the graphed step's capturing call and its replay give
    `graphs=False`'s output and state bit for bit with the same host
    reads and hand-kernel launches. Graphed, its two stored windows'
    re-integration replays one graph per sample (`Segments.scan`) and its
    window BA tail runs as segments BA and E."""
    import dataclasses

    from uvipslam_torch.core.tree import tree_map
    from uvipslam_torch.frontend.device_vip import VipStep, build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, WORKING
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    seq = make_sequence(n_frames=40, H=120, W=160, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = VipConfig(n_tracks=100, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0, imu_cap_per_kf=256)

    def copy(st):
        gen = torch.Generator(device=cuda_device)
        gen.set_state(st.gen.get_state())
        return dataclasses.replace(tree_map(torch.clone, st), gen=gen)

    st, step = build_vip_tracker(cam, cfg, 16, 1024, device=cuda_device, graphs=False)
    before = frame = None
    for f, b in enumerate(make_bundles(seq, device=cuda_device)):
        if f in (28, 29, 30):
            b = dataclasses.replace(b, img=torch.zeros_like(b.img))
        prev = copy(st) if int(st.state) == IMU_RELOC else None
        st, out = step(st, b)
        if prev is not None and int(out.state) == WORKING:
            before, frame = prev, b
            break
    assert before is not None, "no recovery on the blackout sequence"
    runs = {}
    for graphs in (False, True):
        step = VipStep(cam, cfg, 16, device=cuda_device, graphs=graphs)
        calls = []
        for _ in range(2 if graphs else 1):
            seg = step.segments
            c0 = (step.host_syncs, klt.patch_launches, klt.refine_launches, seg.scan_steps)
            st, out = step(copy(before), frame)
            torch.cuda.synchronize()
            calls.append((_bits(out), _bits(st), int(out.state), tuple(a - c for a, c in zip(
                (step.host_syncs, klt.patch_launches, klt.refine_launches, seg.scan_steps), c0))))
        runs[graphs] = calls, step
    (eager,), _ = runs[False]
    graphed, g_step = runs[True]
    assert eager[2] == WORKING and eager[3][3] == 0
    for x in graphed:
        assert torch.equal(x[0], eager[0]) and torch.equal(x[1], eager[1])
        assert x[3][:3] == eager[3][:3] and x[3][3] > 0
    assert {("BA", True, False), ("scan", "preint", (2, 256))} <= g_step.segments.keys


@pytest.mark.cuda
def test_static_input_pool_on_card(cuda_device):
    """One static-input pool per Segments on the card: two segments of one
    input layout, captured into CUDA graphs and replayed in turn on
    changing inputs, equal their eager calls; a graph's two inputs of one
    layout take two buffers; a scan's carry stays private while its
    constants come from the pool, and a segment replayed between two
    scans leaves the second scan's result the plain loop's."""
    from uvipslam_torch.utils.graphs import Segments, plain_scan

    seg = Segments(cuda_device)
    fa, fb = (lambda t, u: t * 2.0 + u), (lambda t, u: t.flip(0) - u)
    for k in range(3):
        x = torch.arange(256.0, device=cuda_device) + k
        y = torch.full((256,), 0.5 * k, device=cuda_device)
        assert torch.equal(seg.run(("a",), fa, x, y), fa(x, y))
        assert torch.equal(seg.run(("b",), fb, y, x), fb(y, x))
    ga, gb = (next(g for (key, _), g in seg.graphs.items() if key == (n,)) for n in "ab")
    assert ga.static_in[0] is gb.static_in[0] and ga.static_in[0] is not ga.static_in[1]
    mem = seg.memory()
    assert mem["static_in"] == 2 * 256 * 4 and mem["unpooled_in"] == 4 * 256 * 4

    c0, kc = torch.ones(256, device=cuda_device), torch.full((256,), 0.5, device=cuda_device)
    body = lambda c, _, a: c * a + 1.0          # noqa: E731
    want = plain_scan(None, body, c0, length=4, consts=(kc,))
    assert torch.equal(seg.scan(("s",), body, c0, length=4, consts=(kc,)), want)
    seg.run(("a",), fa, kc, c0)
    assert torch.equal(seg.scan(("s",), body, c0, length=4, consts=(kc,)), want)
    pooled = {id(t) for ts in seg.buffers.values() for t in ts}
    scans = [g for g in seg.graphs.values() if g.then is not None]
    assert scans and all(id(g.static_in[0]) not in pooled and id(g.static_in[1]) in pooled
                         for g in scans)
