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
