"""Camera intrinsics and undistortion.

Counterpart of `uvipslam_tpu/models/camera.py` as the tracking step uses
it: pinhole intrinsics with radtan (plumb-bob) or Kannala-Brandt
(equidistant fisheye) distortion, undistorted by a fixed-iteration solve.
Projection through the distortion waits for the slice that needs it. Intrinsics are Python floats
(rounded through float32 like the reference's numpy scalars), so they
enter tensor arithmetic as scalars on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

RADTAN = 0
FISHEYE = 1

_UNDISTORT_ITERS = 40


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """dist is (k1, k2, p1, p2) for radtan and (k1, k2, k3, k4) for
    fisheye, as in the reference."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0)
    kind: int = RADTAN
    width: int = 640
    height: int = 512

    @staticmethod
    def create(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), kind=RADTAN,
               width=640, height=512) -> "CameraModel":
        return CameraModel(
            fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
            dist=tuple(_f32(d) for d in dist), kind=kind,
            width=int(width), height=int(height))

    @property
    def K(self) -> np.ndarray:
        return np.asarray([[self.fx, 0.0, self.cx],
                           [0.0, self.fy, self.cy],
                           [0.0, 0.0, 1.0]], np.float32)

    def undistort_normalized(self, xd: torch.Tensor) -> torch.Tensor:
        """Invert distortion on normalized coords (fixed-iteration);
        zero coefficients skip the iterations as in the reference."""
        if not any(self.dist):
            return xd
        if self.kind == FISHEYE:
            return _fisheye_undistort(xd, self.dist)
        return _radtan_undistort(xd, self.dist)

    def undistort_pixels(self, uv: torch.Tensor) -> torch.Tensor:
        """Distorted pixels -> undistorted pixels (same K)."""
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], dim=-1)
        xn = self.undistort_normalized(xd)
        return torch.stack([self.fx * xn[..., 0] + self.cx,
                            self.fy * xn[..., 1] + self.cy], dim=-1)



def _radtan_undistort(xd, d):
    """Fixed-point iteration, same scheme as cv::undistortPoints."""
    k1, k2, p1, p2 = d
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


def _fisheye_undistort(xd, d):
    """Newton inversion of theta_d(theta) (fixed count), then rescale."""
    k1, k2, k3, k4 = d
    x, y = xd[..., 0], xd[..., 1]
    theta_d = torch.sqrt(x * x + y * y)
    small = theta_d < 1e-8
    safe_td = torch.where(small, torch.ones_like(theta_d), theta_d)
    theta = safe_td
    for _ in range(_UNDISTORT_ITERS):
        t2 = theta * theta
        f = theta * (1.0 + k1 * t2 + k2 * t2 * t2 + k3 * t2 * t2 * t2
                     + k4 * t2 * t2 * t2 * t2) - safe_td
        fp = (1.0 + 3 * k1 * t2 + 5 * k2 * t2 * t2 + 7 * k3 * t2 * t2 * t2
              + 9 * k4 * t2 * t2 * t2 * t2)
        theta = theta - f / torch.where(torch.abs(fp) < 1e-8, torch.ones_like(fp), fp)
    scale = torch.where(small, torch.ones_like(theta), torch.tan(theta) / safe_td)
    return torch.stack([x * scale, y * scale], dim=-1)
