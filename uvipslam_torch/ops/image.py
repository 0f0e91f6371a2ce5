"""Basic image filtering primitives (separable filters, resize, gradients).

Counterpart of `uvipslam_tpu/ops/image.py`. Images are [H, W] float32.
Separable filters are k shifted slices times scalar taps over a
reflect-101 padded copy (the reference's `_conv1d` form, same order of
accumulation). `resize_bilinear` reproduces `jax.image.resize(...,
"linear")` including its antialiasing triangle filter on downscale: the
same separable weight matrices, applied as two products.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 padded axis (numpy 'reflect')."""
    idx = np.pad(np.arange(n), pad, mode="reflect")
    return torch.as_tensor(idx, device=device)


def _pad_reflect(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    return img.index_select(axis, _reflect101_index(img.shape[axis], pad, img.device))


def _conv1d(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Convolve [H, W] along one axis with reflect-101 padding; `kernel`
    is a sequence of Python floats (taps rounded to float32)."""
    k = len(kernel)
    pad = k // 2
    img_p = _pad_reflect(img, pad, axis)
    size = img.shape[axis]
    out = torch.zeros_like(img)
    for i in range(k):
        out = out + _f32(kernel[i]) * img_p.narrow(axis, i, size)
    return out


def _f32(x) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_np(ksize: int, sigma: float) -> tuple:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = ksize // 2
    xs = [float(i - half) for i in range(ksize)]
    vals = [math.exp(-0.5 * (x / sigma) ** 2) for x in xs]
    s = sum(vals)
    return tuple(v / s for v in vals)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur, reflect-101 padding."""
    k = _gaussian_kernel_np(ksize, sigma)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def sobel_gradients(img: torch.Tensor):
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    gy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return gx, gy


def scharr_gradients(img: torch.Tensor):
    smooth = tuple(np.float32([3.0, 10.0, 3.0]) / np.float32(16.0))
    diff = tuple(np.float32([-1.0, 0.0, 1.0]) / np.float32(2.0))
    gx = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    gy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return gx, gy


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    k = tuple(np.ones((ksize,), np.float32) / np.float32(ksize))
    return _conv1d(_conv1d(img, k, 0), k, 1)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of jax.image's linear resize along one axis
    (triangle kernel, widened by the inverse scale when downsampling),
    computed in float32 as jax does with x64 off."""
    f32 = np.float32
    # jax forms 1/scale in Python double and rounds it once to float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    tot = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    return torch.as_tensor(_resize_weights_np(n_in, n_out), device=device)


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize to (H', W'), with jax.image.resize's antialiasing
    on downscale: out = Wy^T @ img @ Wx."""
    H, W = img.shape
    Ho, Wo = int(out_hw[0]), int(out_hw[1])
    out = img
    if Ho != H:
        wy = _resize_weights(H, Ho, img.device)
        out = wy.T @ out
    if Wo != W:
        wx = _resize_weights(W, Wo, img.device)
        out = out @ wx
    return out


_PYR_TAPS = tuple(np.float32([1.0, 4.0, 6.0, 4.0, 1.0]) / np.float32(16.0))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown-style 5-tap Gaussian + 2x decimation, the decimation
    folded into the tap slices."""
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    img_p = _pad_reflect(img, 2, 0)
    v = torch.zeros((Ho, W), dtype=img.dtype, device=img.device)
    for i in range(5):
        v = v + float(_PYR_TAPS[i]) * img_p[i:i + 2 * Ho - 1:2, :]
    v_p = _pad_reflect(v, 2, 1)
    out = torch.zeros((Ho, Wo), dtype=img.dtype, device=img.device)
    for j in range(5):
        out = out + float(_PYR_TAPS[j]) * v_p[:, j:j + 2 * Wo - 1:2]
    return out


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    pad_value: float = 0.0) -> torch.Tensor:
    """Sample [H, W] at continuous (x, y) [..., 2]; out of bounds ->
    pad_value."""
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()

    def at(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid, v, torch.full_like(v, pad_value))

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def nearest_sample(img: torch.Tensor, xy: torch.Tensor,
                   pad_value: float = 0.0) -> torch.Tensor:
    H, W = img.shape
    xi = torch.round(xy[..., 0]).long()
    yi = torch.round(xy[..., 1]).long()
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(valid, v, torch.full_like(v, pad_value))
