"""The port's CUDA kernels against their plain torch versions on the card.

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
    before = klt.launches
    kern, local_kern = klt.extract_patches_any(img.to(cuda_device), pts.to(cuda_device), psize)
    torch.cuda.synchronize()
    assert klt.launches == before + 1
    assert torch.equal(kern.cpu(), plain)
    assert torch.equal(torch.nan_to_num(local_kern.cpu()), torch.nan_to_num(local_plain))


@pytest.mark.cuda
def test_extract_patches_kernel_rejects_cpu_tensors(cuda_device):
    with pytest.raises(ValueError):
        klt.extract_patches_cuda(torch.zeros((40, 50)), torch.zeros((3, 2)), 19)


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
        before = klt.launches
        st, _ = step(st, bundles[0])
        torch.cuda.synchronize()
        launched = klt.launches - before
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
