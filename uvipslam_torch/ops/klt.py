"""Anchor-template feature refinement and its patch pull.

Counterpart of `uvipslam_tpu/ops/klt.py`: the flow pyramid, the FFT
global shift, patch extraction, separable interpolation-matmul patch
sampling, `anchor_refine_fast` and `extract_templates_fast` (the tracking
path), and the gather-based forms that no tracker calls: pyramidal
`klt_track` and the slow `extract_templates` / `anchor_refine`, plain
torch over `bilinear_sample` on whatever device their tensors are on.

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

Every function here that takes an image takes a fleet of them as well:
img [S, H, W] with pts [S, N, 2] (and T/Tx/Ty [S, N, win^2], valid
[S, N]), one stream per leading index, each stream's corners clipped to
its own image. On the card the S streams share one kernel launch; the
plain versions map themselves over the leading dimension. Under
`torch.func.vmap` (how the fleet's stages get their stream dimension) the
two wrappers batch through `_PatchOp` / `_RefineOp`, whose vmap rules
hand the stacked tensors to the same single launch.
"""

from __future__ import annotations

import ctypes

import torch

from uvipslam_torch import kernels
from uvipslam_torch.ops.image import bilinear_sample, pyr_down, scharr_gradients

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


def _patch_coords(win: int, dtype, device):
    r = win // 2
    d = torch.arange(-r, r + 1, device=device)
    ys, xs = torch.meshgrid(d, d, indexing="ij")
    return xs.reshape(-1).to(dtype), ys.reshape(-1).to(dtype)


def _window_sample(img, centers, px, py):
    """Bilinear samples [N, win*win] of the window around each centre
    (out of bounds 0)."""
    return bilinear_sample(img, torch.stack([centers[:, 0:1] + px[None],
                                             centers[:, 1:2] + py[None]], dim=-1))


def _gauss_newton_step(err, Tx, Ty, Gxx, Gxy, Gyy, safe_det):
    """The inverse-compositional update (dx, dy) [N, 2] for residuals
    `err` against the template gradients."""
    bx = torch.sum(err * Tx, dim=1)
    by = torch.sum(err * Ty, dim=1)
    dx = -(Gyy * bx - Gxy * by) / safe_det
    dy = -(-Gxy * bx + Gxx * by) / safe_det
    return torch.stack([dx, dy], dim=-1)


def _normal_matrix(Tx, Ty):
    Gxx = torch.sum(Tx * Tx, dim=1)
    Gxy = torch.sum(Tx * Ty, dim=1)
    Gyy = torch.sum(Ty * Ty, dim=1)
    det = Gxx * Gyy - Gxy * Gxy
    safe_det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    return Gxx, Gxy, Gyy, det, safe_det


def klt_track(pyr_prev, pyr_next, pts_prev: torch.Tensor, pts_guess: torch.Tensor,
              valid: torch.Tensor, win: int = 21, iters: int = 10, levels: int = 5,
              min_eig_threshold: float = 1e-4, max_residual: float = 20.0):
    """Pyramidal inverse-compositional Lucas-Kanade from the previous
    frame's pyramid to the next's, coarse to fine, a fixed `iters`
    Gauss-Newton steps per level (each clipped to +-win px).
    Returns (pts_next [N, 2], ok [N] bool): ok = valid, inside the image
    by win//2, the gradient matrix's smaller eigenvalue per pixel above
    `min_eig_threshold` on every level, and the level-0 mean absolute
    residual below `max_residual`."""
    dtype, dev = pts_prev.dtype, pts_prev.device
    px, py = _patch_coords(win, dtype, dev)
    n_px = win * win
    flow = (pts_guess - pts_prev) / (2.0 ** (levels - 1))
    min_eig_ok = torch.ones_like(valid)
    resid = torch.zeros(pts_prev.shape[0], dtype=dtype, device=dev)

    for l in range(levels - 1, -1, -1):
        imA, imB = pyr_prev[l], pyr_next[l]
        gx, gy = scharr_gradients(imA)
        p_l = pts_prev / (2.0 ** l)
        T = _window_sample(imA, p_l, px, py)
        Tx = _window_sample(gx, p_l, px, py)
        Ty = _window_sample(gy, p_l, px, py)
        Gxx, Gxy, Gyy, det, safe_det = _normal_matrix(Tx, Ty)
        tr = Gxx + Gyy
        min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5 / n_px
        good_G = min_eig > min_eig_threshold
        if l != levels - 1:
            flow = flow * 2.0
        for _ in range(iters):
            err = _window_sample(imB, p_l + flow, px, py) - T
            step = torch.clamp(_gauss_newton_step(err, Tx, Ty, Gxx, Gxy, Gyy, safe_det),
                               -win, win)
            flow = flow + torch.where(good_G[:, None], step, torch.zeros_like(step))
        min_eig_ok = min_eig_ok & good_G
        if l == 0:
            resid = torch.sum(torch.abs(_window_sample(imB, p_l + flow, px, py) - T),
                              dim=1) / n_px

    pts_next = pts_prev + flow
    H, W = pyr_next[0].shape
    r = win // 2
    inb = ((pts_next[:, 0] >= r) & (pts_next[:, 0] < W - r)
           & (pts_next[:, 1] >= r) & (pts_next[:, 1] < H - r))
    return pts_next, valid & inb & min_eig_ok & (resid < max_residual)


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
    clipped corners (one gather). Returns (patches [N, P, P], local); with
    a leading stream dimension on both inputs, on both outputs too."""
    if img.dim() == 3:
        return torch.func.vmap(lambda i, p: _extract_patches(i, p, psize))(img, pts)
    H, W = img.shape
    x0, y0, local = patch_corners(pts, H, W, psize)
    d = torch.arange(psize, device=img.device)
    rows = y0.long()[:, None, None] + d[None, :, None]
    cols = x0.long()[:, None, None] + d[None, None, :]
    return img[rows, cols], local


def _check_patch_args(img: torch.Tensor, pts: torch.Tensor, psize: int):
    if (img.dim() not in (2, 3) or pts.dim() != img.dim() or pts.shape[-1] != 2
            or pts.shape[:-2] != img.shape[:-2]):
        raise ValueError(f"expected img [H, W] and pts [N, 2], or [S, H, W] and [S, N, 2], "
                         f"got {tuple(img.shape)} and {tuple(pts.shape)}")
    if img.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError(f"expected float32, got {img.dtype} and {pts.dtype}")
    if img.device != pts.device:
        raise ValueError(f"img on {img.device}, pts on {pts.device}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous (row-major [H, W])")
    H, W = img.shape[-2:]
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
    and local [N, 2] f32, all on one device; or all four with a leading
    [S], one launch for the S streams. Not counted."""
    H, W = img.shape[-2:]
    N = pts.shape[-2]
    S = img.shape[0] if img.dim() == 3 else 1
    if N == 0 or S == 0:
        return
    if not (pts.device == out.device == local.device == img.device):
        raise ValueError("img, pts, out and local must be on one device")
    lib = kernels.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.uvip_extract_patches(_ptr(img), S, H, W, _ptr(pts), N, psize, _ptr(out),
                                       _ptr(local), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"extract_patches kernel launch failed: cudaError {err}")


def extract_patches_cuda(img: torch.Tensor, pts: torch.Tensor, psize: int):
    """The kernel path of `extract_patches_any` on CUDA tensors: one
    counted launch that computes the corners, `local` and the patches,
    for one stream or for all S of a fleet."""
    global patch_launches
    _check_patch_args(img, pts, psize)
    _require_cuda("extract_patches_cuda", img)
    lead = tuple(pts.shape[:-1])
    out = torch.empty(lead + (psize, psize), dtype=torch.float32, device=img.device)
    local = torch.empty(lead + (2,), dtype=torch.float32, device=img.device)
    if out.numel() > 0:
        launch_extract_patches(img, pts.contiguous(), psize, out, local)
        patch_launches += 1
    return out, local


class _PatchOp(torch.autograd.Function):
    """`_patches_by_device` as one operation that `torch.func.vmap` can
    batch: the rule stacks the streams and makes the one call."""

    @staticmethod
    def forward(img, pts, psize):
        return _patches_by_device(img, pts, psize)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, img, pts, psize):
        img, pts = _stream_first(info, in_dims[:2], (img, pts))
        return _PatchOp.apply(img.contiguous(), pts, psize), (0, 0)


def _stream_first(info, in_dims, tensors):
    """The vmapped dimension of each tensor moved to the front (a tensor
    the map does not cover is repeated for every stream)."""
    return tuple(t.unsqueeze(0).expand((info.batch_size,) + tuple(t.shape)) if d is None
                 else t.movedim(d, 0) for t, d in zip(tensors, in_dims))


def extract_patches_any(img: torch.Tensor, pts: torch.Tensor, psize: int):
    """Device dispatch: the CUDA kernel for CUDA tensors, the plain gather
    for CPU tensors."""
    return _PatchOp.apply(img, pts, psize)


def _patches_by_device(img: torch.Tensor, pts: torch.Tensor, psize: int):
    if img.device.type == "cuda":
        return extract_patches_cuda(img, pts, psize)
    if img.device.type != "cpu":
        raise ValueError(f"no patch extraction for device {img.device}")
    _check_patch_args(img, pts, psize)
    return _extract_patches(img, pts, psize)


def _sample_patch(patches: torch.Tensor, center: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear-sample a [win, win] window centered at fractional `center`
    [N, 2] (patch coords) from [N, Py, Px] patches: two interpolation
    matmuls. Returns [N, win, win]. A leading stream dimension on both
    inputs is kept."""
    if patches.dim() == 4:
        S, N = patches.shape[:2]
        return _sample_patch(patches.reshape((S * N,) + tuple(patches.shape[2:])),
                             center.reshape(S * N, 2), win).reshape(S, N, win, win)
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
    if img.dim() == 3:
        return torch.func.vmap(lambda *a: _refine_terms(*a, win, iters, max_correction))(
            img, T, Tx, Ty, pts)
    N = pts.shape[0]
    psize = refine_psize(win, max_correction)
    _check_patch_args(img, pts, psize)
    patches, local = _extract_patches(img, pts, psize)

    Gxx, Gxy, Gyy, det, safe_det = _normal_matrix(Tx, Ty)
    good_G = det > 1e-9

    # clamp bounds from the patch shape (slab contract: [psize, psize])
    r = win // 2
    lo = float(r)
    hi_x = float(patches.shape[-1] - r - 2)
    hi_y = float(patches.shape[-2] - r - 2)

    p = local
    for _ in range(iters):
        err = _sample_patch(patches, p, win).reshape(N, -1) - T
        step = torch.clamp(_gauss_newton_step(err, Tx, Ty, Gxx, Gxy, Gyy, safe_det), -3.0, 3.0)
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
    out = torch.where(accept[..., None], out_pts, pts)
    return out, accept


def _check_refine_args(img, T, Tx, Ty, pts, valid, win: int, iters: int,
                       max_correction: float):
    _check_patch_args(img, pts, refine_psize(win, max_correction))
    lead = tuple(pts.shape[:-1])        # (N,) or (S, N)
    for name, t in (("T", T), ("Tx", Tx), ("Ty", Ty)):
        if (tuple(t.shape) != lead + (win * win,) or t.dtype != torch.float32
                or t.device != img.device):
            raise ValueError(f"{name} must be float32 {list(lead) + [win * win]} on "
                             f"{img.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(valid.shape) != lead or valid.dtype != torch.bool or valid.device != img.device:
        raise ValueError(f"valid must be bool {list(lead)} on {img.device}")
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
    outputs out [N, 2] f32 and accept [N] bool; or every tensor with a
    leading [S], one launch for the S streams. Not counted."""
    H, W = img.shape[-2:]
    N = pts.shape[-2]
    S = img.shape[0] if img.dim() == 3 else 1
    if N == 0 or S == 0:
        return
    lib = kernels.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.uvip_anchor_refine(
            _ptr(img), S, H, W, _ptr(T), _ptr(Tx), _ptr(Ty), _ptr(pts), _ptr(valid), N, win,
            iters, max_correction, max_residual, _ptr(out), _ptr(accept),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"anchor_refine kernel launch failed: cudaError {err}")


def anchor_refine_cuda(img, T, Tx, Ty, pts, valid, win: int = 13, iters: int = 8,
                       max_correction: float = 4.0, max_residual: float = 32.0):
    """The kernel path of `anchor_refine_fast` on CUDA tensors: one counted
    launch that pulls each patch and runs the whole refinement, for one
    stream or for all S of a fleet."""
    global refine_launches
    _check_refine_args(img, T, Tx, Ty, pts, valid, win, iters, max_correction)
    _require_cuda("anchor_refine_cuda", img)
    lead = tuple(pts.shape[:-1])
    out = torch.empty(lead + (2,), dtype=torch.float32, device=img.device)
    accept = torch.empty(lead, dtype=torch.bool, device=img.device)
    if accept.numel() > 0:
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
    return _RefineOp.apply(img, T, Tx, Ty, pts, valid, win, iters, max_correction,
                           max_residual)


def _refine_by_device(img, T, Tx, Ty, pts, valid, win, iters, max_correction, max_residual):
    kw = dict(win=win, iters=iters, max_correction=max_correction, max_residual=max_residual)
    if img.device.type == "cuda":
        return anchor_refine_cuda(img, T, Tx, Ty, pts, valid, **kw)
    if img.device.type != "cpu":
        raise ValueError(f"no anchor refinement for device {img.device}")
    return _anchor_refine_plain(img, T, Tx, Ty, pts, valid, **kw)


class _RefineOp(torch.autograd.Function):
    """`_refine_by_device` as one operation that `torch.func.vmap` can
    batch (see `_PatchOp`)."""

    @staticmethod
    def forward(img, T, Tx, Ty, pts, valid, win, iters, max_correction, max_residual):
        return _refine_by_device(img, T, Tx, Ty, pts, valid, win, iters, max_correction,
                                 max_residual)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, img, T, Tx, Ty, pts, valid, *consts):
        img, T, Tx, Ty, pts, valid = _stream_first(info, in_dims[:6],
                                                   (img, T, Tx, Ty, pts, valid))
        return _RefineOp.apply(img.contiguous(), T, Tx, Ty, pts, valid, *consts), (0, 0)


def extract_templates_fast(img: torch.Tensor, pts: torch.Tensor, win: int = 13):
    """Template + central-difference gradients per feature: patch pull +
    interpolation-matmul sampling of a (win+2) window.
    Returns (T, Tx, Ty), each [N, win*win] ([S, N, win*win] for a fleet)."""
    lead = tuple(pts.shape[:-1])
    psize = win + 6
    patches, local = extract_patches_any(img, pts, psize)
    big = _sample_patch(patches, local, win + 2)
    T = big[..., 1:-1, 1:-1]
    Tx = 0.5 * (big[..., 1:-1, 2:] - big[..., 1:-1, :-2])
    Ty = 0.5 * (big[..., 2:, 1:-1] - big[..., :-2, 1:-1])
    return (T.reshape(lead + (-1,)), Tx.reshape(lead + (-1,)), Ty.reshape(lead + (-1,)))


def extract_templates(img: torch.Tensor, pts: torch.Tensor, win: int = 21):
    """Template patches and their Scharr gradients per feature by
    bilinear gathers. Returns (T, Tx, Ty), each [N, win*win]."""
    px, py = _patch_coords(win, pts.dtype, pts.device)
    gx, gy = scharr_gradients(img)
    return tuple(_window_sample(im, pts, px, py) for im in (img, gx, gy))


def anchor_refine(img: torch.Tensor, T: torch.Tensor, Tx: torch.Tensor, Ty: torch.Tensor,
                  pts: torch.Tensor, valid: torch.Tensor, win: int = 21, iters: int = 8,
                  max_correction: float = 2.5, max_residual: float = 12.0):
    """The gather form of `anchor_refine_fast`: fixed inverse-
    compositional Gauss-Newton steps (each clipped to +-3 px) against the
    birth templates, sampling the image directly, no patch and no clamp.
    A track keeps its start unless its gradient matrix is well
    conditioned, its correction is at most `max_correction` and its mean
    absolute residual below `max_residual`.
    Returns (pts_refined [N, 2], refined [N] bool)."""
    px, py = _patch_coords(win, pts.dtype, pts.device)
    Gxx, Gxy, Gyy, det, safe_det = _normal_matrix(Tx, Ty)
    good_G = det > 1e-9
    p = pts
    for _ in range(iters):
        err = _window_sample(img, p, px, py) - T
        step = torch.clamp(_gauss_newton_step(err, Tx, Ty, Gxx, Gxy, Gyy, safe_det), -3.0, 3.0)
        p = p + torch.where(good_G[:, None], step, torch.zeros_like(step))
    resid = torch.sum(torch.abs(_window_sample(img, p, px, py) - T), dim=1) / (win * win)
    corr = torch.linalg.vector_norm(p - pts, dim=-1)
    accept = valid & good_G & (corr <= max_correction) & (resid < max_residual)
    return torch.where(accept[:, None], p, pts), accept
