"""Anchor-template feature refinement and its patch pull.

Counterpart of the parts of `uvipslam_tpu/ops/klt.py` on the tracking
path: the flow pyramid, the FFT global shift, patch extraction,
separable interpolation-matmul patch sampling, `anchor_refine_fast` and
`extract_templates_fast`. The gather-based `klt_track`, `anchor_refine`
and `extract_templates` are on no path of the reference and are not
ported.

Two hand-written CUDA kernels take the place of the reference's one TPU
kernel (`_extract_patches_pallas`), each dispatched by device: a CPU
tensor takes the plain torch version, a CUDA tensor launches the kernel
and raises if it cannot.

- `extract_patches_any`: `csrc/extract_patches.cu`, or the plain gather
  `_extract_patches`. Both emit the slab contract of the reference's
  `_extract_patches` ([N, psize, psize] patches, `local` relative to the
  clipped corner), never the TPU kernel's [N, R, 128] layout (R rows),
  whose different patch shape changes the clamp bounds of
  `anchor_refine_fast`. The template and ORB pulls use it.
- `anchor_refine_fast`: `csrc/anchor_refine.cu`, the patch pull fused
  with the whole Gauss-Newton loop, or `_anchor_refine_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from uvipslam_torch import kernels
from uvipslam_torch.ops.image import pyr_down

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1

# kernel launches on CUDA tensors: csrc/extract_patches.cu by
# `extract_patches_cuda`, csrc/anchor_refine.cu by `anchor_refine_cuda`
patch_launches = 0
refine_launches = 0


def build_flow_pyramid(img: torch.Tensor, levels: int = 5) -> list:
    """[H, W] -> list of `levels` images, each 2x downsampled."""
    pyr = [img]
    for _ in range(1, levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def global_shift(img_a: torch.Tensor, img_b: torch.Tensor, radius: int = 8):
    """Dominant integer translation a->b by SSD over (2r+1)^2 shifts,
    SSD(d) = sum(a^2) - 2 corr(b, a)[d] + boxsum(b^2)[d], with the
    correlation by FFT and the box sums by an integral image.
    Returns (dx, dy) such that features move by +d."""
    H, W = img_a.shape
    r = min(radius, (min(H, W) - 2) // 2)
    n = 2 * r + 1
    Hc, Wc = H - 2 * r, W - 2 * r
    a = img_a[r:H - r, r:W - r]

    shape = tuple(img_b.shape)
    fb = torch.fft.rfft2(img_b)
    fa = torch.fft.rfft2(a, s=shape)
    corr = torch.fft.irfft2(fb * torch.conj(fa), s=shape)[:n, :n]

    b2 = img_b * img_b
    ii = torch.nn.functional.pad(torch.cumsum(torch.cumsum(b2, dim=0), dim=1), (1, 0, 1, 0))
    box = (ii[Hc:Hc + n, Wc:Wc + n] - ii[Hc:Hc + n, :n]
           - ii[:n, Wc:Wc + n] + ii[:n, :n])

    costs = box - 2.0 * corr
    k = torch.argmin(costs.reshape(-1))
    dy = k // n - r
    dx = k % n - r
    return torch.stack([dx, dy]).to(img_a.dtype)


def _interp_operator(off: torch.Tensor, size_out: int, size_in: int) -> torch.Tensor:
    """[N] fractional start offsets -> [N, size_out, size_in] separable
    bilinear sampling operators (hat-function rows)."""
    j = torch.arange(size_out, dtype=off.dtype, device=off.device)[None, :, None]
    k = torch.arange(size_in, dtype=off.dtype, device=off.device)[None, None, :]
    x = off[:, None, None] + j
    return torch.clamp(1.0 - torch.abs(x - k), 0.0, 1.0)


def _floor_to_int32(v: torch.Tensor) -> torch.Tensor:
    """floor(v) cast to int32 with XLA's saturating conversion (NaN -> 0,
    +inf and overflow -> INT32_MAX, -inf and underflow -> INT32_MIN),
    returned in int64 so later int32 arithmetic can wrap explicitly."""
    f = torch.floor(v).to(torch.float64)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return f.clamp(INT32_MIN, INT32_MAX).to(torch.int64)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wraparound of an int64 tensor."""
    return ((v - INT32_MIN) % (2 ** 32)) + INT32_MIN


def patch_corners(pts: torch.Tensor, H: int, W: int, psize: int):
    """The reference's clipped top-left corners (x0, y0) [N] int32 and the
    point's fractional position `local` [N, 2] inside its patch:
    clip(int32(floor(pt)) - psize//2, 0, dim - psize)."""
    half = psize // 2
    x0 = _wrap_int32(_floor_to_int32(pts[:, 0]) - half).clamp(0, W - psize)
    y0 = _wrap_int32(_floor_to_int32(pts[:, 1]) - half).clamp(0, H - psize)
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    local = pts - torch.stack([x0, y0], -1).to(pts.dtype)
    return x0, y0, local


def _extract_patches(img: torch.Tensor, pts: torch.Tensor, psize: int):
    """Plain torch patch pull: per-feature [psize, psize] windows at the
    clipped corners (one gather). Returns (patches [N, P, P], local)."""
    H, W = img.shape
    x0, y0, local = patch_corners(pts, H, W, psize)
    d = torch.arange(psize, device=img.device)
    rows = y0.long()[:, None, None] + d[None, :, None]
    cols = x0.long()[:, None, None] + d[None, None, :]
    return img[rows, cols], local


def _check_patch_args(img: torch.Tensor, pts: torch.Tensor, psize: int):
    if img.dim() != 2 or pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"expected img [H, W] and pts [N, 2], got "
                         f"{tuple(img.shape)} and {tuple(pts.shape)}")
    if img.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError(f"expected float32, got {img.dtype} and {pts.dtype}")
    if img.device != pts.device:
        raise ValueError(f"img on {img.device}, pts on {pts.device}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous (row-major [H, W])")
    H, W = img.shape
    if not 0 < psize <= min(H, W) or psize > 127:
        raise ValueError(f"psize {psize} outside (0, min(H, W)={min(H, W)}] "
                         f"or above 127")


def _require_cuda(name: str, img: torch.Tensor):
    if img.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {img.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch_extract_patches(img: torch.Tensor, pts: torch.Tensor, psize: int,
                           out: torch.Tensor, local: torch.Tensor) -> None:
    """Raw launch of csrc/extract_patches.cu on the current stream of
    img's device (made the current device for the launch): contiguous
    CUDA img [H, W] f32 and pts [N, 2] f32, outputs out [N, psize, psize]
    and local [N, 2] f32, all on one device. Not counted."""
    H, W = img.shape
    N = pts.shape[0]
    if N == 0:
        return
    if not (pts.device == out.device == local.device == img.device):
        raise ValueError("img, pts, out and local must be on one device")
    lib = kernels.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.uvip_extract_patches(_ptr(img), H, W, _ptr(pts), N, psize, _ptr(out),
                                       _ptr(local), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"extract_patches kernel launch failed: cudaError {err}")


def extract_patches_cuda(img: torch.Tensor, pts: torch.Tensor, psize: int):
    """The kernel path of `extract_patches_any` on CUDA tensors: one
    counted launch that computes the corners, `local` and the patches."""
    global patch_launches
    _check_patch_args(img, pts, psize)
    _require_cuda("extract_patches_cuda", img)
    N = pts.shape[0]
    out = torch.empty((N, psize, psize), dtype=torch.float32, device=img.device)
    local = torch.empty((N, 2), dtype=torch.float32, device=img.device)
    if N > 0:
        launch_extract_patches(img, pts.contiguous(), psize, out, local)
        patch_launches += 1
    return out, local


def extract_patches_any(img: torch.Tensor, pts: torch.Tensor, psize: int):
    """Device dispatch: the CUDA kernel for CUDA tensors, the plain gather
    for CPU tensors."""
    if img.device.type == "cuda":
        return extract_patches_cuda(img, pts, psize)
    if img.device.type != "cpu":
        raise ValueError(f"no patch extraction for device {img.device}")
    _check_patch_args(img, pts, psize)
    return _extract_patches(img, pts, psize)


def _sample_patch(patches: torch.Tensor, center: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear-sample a [win, win] window centered at fractional `center`
    [N, 2] (patch coords) from [N, Py, Px] patches: two interpolation
    matmuls. Returns [N, win, win]."""
    Py = patches.shape[-2]
    Px = patches.shape[-1]
    r = win // 2
    Wy = _interp_operator(center[:, 1] - r, win, Py)   # [N, win, Py]
    Wx = _interp_operator(center[:, 0] - r, win, Px)   # [N, win, Px]
    tmp = torch.bmm(Wy, patches)
    return torch.bmm(tmp, Wx.transpose(1, 2))


def refine_psize(win: int, max_correction: float) -> int:
    """The patch side `anchor_refine_fast` pulls: the window plus a margin
    of int(max_correction) + 2 on each side."""
    return win + 2 * (int(max_correction) + 2)


def _refine_terms(img, T, Tx, Ty, pts, win: int, iters: int, max_correction: float):
    """The plain form's Gauss-Newton loop: returns the refined patch
    position p, `local`, good_G, the mean absolute residual and the
    correction norm, each per track."""
    N = pts.shape[0]
    psize = refine_psize(win, max_correction)
    _check_patch_args(img, pts, psize)
    patches, local = _extract_patches(img, pts, psize)

    Gxx = torch.sum(Tx * Tx, dim=1)
    Gxy = torch.sum(Tx * Ty, dim=1)
    Gyy = torch.sum(Ty * Ty, dim=1)
    det = Gxx * Gyy - Gxy * Gxy
    safe_det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    good_G = det > 1e-9

    # clamp bounds from the patch shape (slab contract: [psize, psize])
    r = win // 2
    lo = float(r)
    hi_x = float(patches.shape[-1] - r - 2)
    hi_y = float(patches.shape[-2] - r - 2)

    p = local
    for _ in range(iters):
        I = _sample_patch(patches, p, win).reshape(N, -1)
        err = I - T
        bx = torch.sum(err * Tx, dim=1)
        by = torch.sum(err * Ty, dim=1)
        dx = -(Gyy * bx - Gxy * by) / safe_det
        dy = -(-Gxy * bx + Gxx * by) / safe_det
        step = torch.clamp(torch.stack([dx, dy], dim=-1), -3.0, 3.0)
        p2 = p + torch.where(good_G[:, None], step, torch.zeros_like(step))
        p2 = torch.clamp(p2, min=lo)
        p = torch.stack([p2[:, 0].clamp(max=hi_x), p2[:, 1].clamp(max=hi_y)], dim=-1)
    resid = torch.sum(torch.abs(_sample_patch(patches, p, win).reshape(N, -1) - T),
                      dim=1) / (win * win)
    corr = torch.linalg.vector_norm(p - local, dim=-1)
    return p, local, good_G, resid, corr


def _anchor_refine_plain(img, T, Tx, Ty, pts, valid, win: int = 13, iters: int = 8,
                         max_correction: float = 4.0, max_residual: float = 32.0):
    """Plain torch form of `anchor_refine_fast` (the reference's
    arithmetic: a patch gather, then interpolation-matmul sampling in each
    Gauss-Newton iteration)."""
    p, local, good_G, resid, corr = _refine_terms(img, T, Tx, Ty, pts, win, iters,
                                                  max_correction)
    accept = valid & good_G & (corr <= max_correction) & (resid < max_residual)
    out_pts = pts + (p - local)
    out = torch.where(accept[:, None], out_pts, pts)
    return out, accept


def _check_refine_args(img, T, Tx, Ty, pts, valid, win: int, iters: int,
                       max_correction: float):
    _check_patch_args(img, pts, refine_psize(win, max_correction))
    N = pts.shape[0]
    for name, t in (("T", T), ("Tx", Tx), ("Ty", Ty)):
        if t.shape != (N, win * win) or t.dtype != torch.float32 or t.device != img.device:
            raise ValueError(f"{name} must be float32 [{N}, {win * win}] on {img.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if valid.shape != (N,) or valid.dtype != torch.bool or valid.device != img.device:
        raise ValueError(f"valid must be bool [{N}] on {img.device}")
    if not 0 < win * win <= 256 or iters < 0 or not 0.0 <= max_correction < 1e6:
        raise ValueError(f"win {win} (win^2 <= 256), iters {iters} or max_correction "
                         f"{max_correction} out of range")
    if refine_psize(win, max_correction) > 55:
        raise ValueError(f"patch side {refine_psize(win, max_correction)} above 55")


def launch_anchor_refine(img, T, Tx, Ty, pts, valid, win: int, iters: int,
                         max_correction: float, max_residual: float,
                         out: torch.Tensor, accept: torch.Tensor) -> None:
    """Raw launch of csrc/anchor_refine.cu on the current stream of img's
    device: contiguous CUDA inputs as `anchor_refine_fast` takes them,
    outputs out [N, 2] f32 and accept [N] bool. Not counted."""
    H, W = img.shape
    N = pts.shape[0]
    if N == 0:
        return
    lib = kernels.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.uvip_anchor_refine(
            _ptr(img), H, W, _ptr(T), _ptr(Tx), _ptr(Ty), _ptr(pts), _ptr(valid), N, win,
            iters, max_correction, max_residual, _ptr(out), _ptr(accept),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"anchor_refine kernel launch failed: cudaError {err}")


def anchor_refine_cuda(img, T, Tx, Ty, pts, valid, win: int = 13, iters: int = 8,
                       max_correction: float = 4.0, max_residual: float = 32.0):
    """The kernel path of `anchor_refine_fast` on CUDA tensors: one counted
    launch that pulls each patch and runs the whole refinement."""
    global refine_launches
    _check_refine_args(img, T, Tx, Ty, pts, valid, win, iters, max_correction)
    _require_cuda("anchor_refine_cuda", img)
    N = pts.shape[0]
    out = torch.empty((N, 2), dtype=torch.float32, device=img.device)
    accept = torch.empty((N,), dtype=torch.bool, device=img.device)
    if N > 0:
        launch_anchor_refine(img, T.contiguous(), Tx.contiguous(), Ty.contiguous(),
                             pts.contiguous(), valid.contiguous(), win, iters,
                             max_correction, max_residual, out, accept)
        refine_launches += 1
    return out, accept


def anchor_refine_fast(img, T, Tx, Ty, pts, valid, win: int = 13,
                       iters: int = 8, max_correction: float = 4.0,
                       max_residual: float = 32.0):
    """Refine [N, 2] start positions against [N, win*win] birth templates:
    one patch pull per track, then fixed inverse-compositional GN
    iterations with bilinear sampling. CUDA tensors take the fused kernel,
    CPU tensors the plain torch form.
    Returns (pts_refined [N, 2], accepted [N] bool)."""
    kw = dict(win=win, iters=iters, max_correction=max_correction, max_residual=max_residual)
    if img.device.type == "cuda":
        return anchor_refine_cuda(img, T, Tx, Ty, pts, valid, **kw)
    if img.device.type != "cpu":
        raise ValueError(f"no anchor refinement for device {img.device}")
    return _anchor_refine_plain(img, T, Tx, Ty, pts, valid, **kw)


def extract_templates_fast(img: torch.Tensor, pts: torch.Tensor, win: int = 13):
    """Template + central-difference gradients per feature: patch pull +
    interpolation-matmul sampling of a (win+2) window.
    Returns (T, Tx, Ty), each [N, win*win]."""
    N = pts.shape[0]
    psize = win + 6
    patches, local = extract_patches_any(img, pts, psize)
    big = _sample_patch(patches, local, win + 2)
    T = big[:, 1:-1, 1:-1]
    Tx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    Ty = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    return T.reshape(N, -1), Tx.reshape(N, -1), Ty.reshape(N, -1)
