"""Camera models; counterpart of cmax_slam_tpu/calib.py.

The pinhole calibration, undistortion and bearing LUT are a host-only numpy
copy of the JAX package's (float64 on the host, shipped to the device as
float32). The equirectangular panorama camera projects and lifts torch
tensors and is differentiable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class CameraCalibration:
    """Pinhole calibration in ROS CameraInfo convention.

    K: 3x3 raw intrinsics; D: plumb_bob (k1,k2,p1,p2,k3); R: rectification;
    P: 3x4 projection (used for ray lifting, as image_geometry does).
    """

    width: int
    height: int
    K: np.ndarray
    D: np.ndarray = field(default_factory=lambda: np.zeros(5))
    R: Optional[np.ndarray] = None
    P: Optional[np.ndarray] = None

    @property
    def projection(self) -> np.ndarray:
        """Effective projection intrinsics (P if present else K)."""
        if self.P is not None:
            return self.P[:3, :3]
        return self.K


def undistort_points(
    pts: np.ndarray, K: np.ndarray, D: np.ndarray, num_iters: int = 20
) -> np.ndarray:
    """Iterative plumb_bob undistortion (fixed-point, as cv::undistortPoints).

    pts: (N, 2) raw pixel coords. Returns (N, 2) normalized (canonical) coords.
    """
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = (list(D) + [0.0] * 5)[:5]

    x0 = (pts[:, 0] - cx) / fx
    y0 = (pts[:, 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    for _ in range(num_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], axis=-1)


def bearing_lut(calib: CameraCalibration, unit: bool = True) -> np.ndarray:
    """Per-pixel bearing vectors, row-major (H*W, 3) float32.

    Reproduces CMaxSLAM::precomputeBearingVectors (reference
    src/cmax_slam.cpp:106-120): rectify each raw pixel with (K, D, R), then
    lift to a 3D ray. Lifting through P after projecting through P is the
    identity on directions, so P does not enter.
    """
    H, W = calib.height, calib.width
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    raw = np.stack([xs.ravel(), ys.ravel()], axis=-1)

    norm = undistort_points(raw, calib.K, calib.D)
    rays = np.concatenate([norm, np.ones((norm.shape[0], 1))], axis=-1)
    if calib.R is not None:
        rays = rays @ calib.R.T  # rectification rotation
    if unit:
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays.astype(np.float32)


@dataclass(frozen=True)
class EquirectCamera:
    """Equirectangular panorama camera (dvs::EquirectangularCamera with
    hfov=360, vfov=180: fx = W/(2*pi), fy = H/pi)."""

    width: int
    height: int

    @property
    def fx(self) -> float:
        return self.width / (2.0 * math.pi)

    @property
    def fy(self) -> float:
        return self.height / math.pi

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0

    def project(self, P: torch.Tensor) -> torch.Tensor:
        """Project (..., 3) rays to (..., 2) panorama pixels:
        phi = atan2(x, z), theta = asin(y / |P|)."""
        x, y, z = P.unbind(-1)
        rho = torch.sqrt(x * x + y * y + z * z)
        phi = torch.atan2(x, z)
        theta = torch.asin(torch.clamp(y / rho, -1.0, 1.0))
        return torch.stack([self.cx + phi * self.fx, self.cy + theta * self.fy], dim=-1)

    def lift(self, uv: torch.Tensor) -> torch.Tensor:
        """Inverse projection: pixels -> unit rays."""
        phi = (uv[..., 0] - self.cx) / self.fx
        theta = (uv[..., 1] - self.cy) / self.fy
        cos_t = torch.cos(theta)
        return torch.stack(
            [cos_t * torch.sin(phi), torch.sin(theta), cos_t * torch.cos(phi)], dim=-1
        )
