"""Gaussian blur matching cv::GaussianBlur(src, Size(0,0), sigma); counterpart
of cmax_slam_tpu/ops/blur.py.

The reference blurs every IWE before the contrast reduction
(local_image_warped_events.cpp:32-38, event_pano_warper.cpp:217-230).
OpenCV semantics: kernel size ``round(sigma * 8 + 1) | 1``, weights
``exp(-i^2 / (2 sigma^2))`` normalized to 1, border BORDER_REFLECT_101.

Up to 2^21 pixels (which includes the ijrr 512x1024 panorama) the separable
blur is two matmuls ``B_h @ I @ B_w^T`` with banded matrices that fold the
reflection into the band. Those matrices are not symmetric at the borders,
so the blur's adjoint is ``B^T``, which autograd through the matmuls gives
by construction. On a card, float32 matmuls run in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set; the port leaves it at its
default, False.

Above 2^21 pixels (the ECRot 2048x4096 panorama) a dense band matrix costs
O(H^2 W + H W^2) multiply-adds and a 4096x4096 float32 matrix; there the
blur is the same separable reflect-101 Gaussian written as reflect padding
and a tap-weighted sum of shifted slices along each axis, O(ksize H W),
as the JAX package's ``_blur_conv`` does. Autograd goes through the slices
and the padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import to_device

# Above this many pixels the blur is shift-and-add instead of band matmuls
# (the JAX package's threshold, cmax_slam_tpu/ops/blur.py:74).
SHIFT_ADD_MIN_PIXELS = 1 << 21


def opencv_ksize(sigma: float) -> int:
    """Automatic kernel size for float images (OpenCV createGaussianFilter)."""
    k = int(round(sigma * 8 + 1))
    return k | 1


def gaussian_kernel(sigma: float, ksize: int | None = None) -> np.ndarray:
    """1-D Gaussian kernel identical to cv::getGaussianKernel(ksize, sigma)."""
    if ksize is None:
        ksize = opencv_ksize(sigma)
    half = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


@functools.lru_cache(maxsize=64)
def _blur_matrix(size: int, sigma: float) -> np.ndarray:
    """(size, size) float32 matrix applying a reflect-101 Gaussian along one axis."""
    kernel = gaussian_kernel(sigma)
    half = len(kernel) // 2
    mat = np.zeros((size, size), dtype=np.float64)
    for i in range(size):
        for t, kv in enumerate(kernel):
            j = i + t - half
            # BORDER_REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...
            while j < 0 or j >= size:
                if j < 0:
                    j = -j
                if j >= size:
                    j = 2 * (size - 1) - j
            mat[i, j] += kv
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_tensor(size: int, sigma: float, device: str) -> torch.Tensor:
    """The band matrix resident on ``device`` (uploaded once per shape)."""
    return to_device(_blur_matrix(size, sigma), device)


def blur_path(height: int, width: int) -> str:
    """The path gaussian_blur takes for a height x width image: "bands" (two
    band matmuls) or "shift_add"."""
    return "shift_add" if height * width > SHIFT_ADD_MIN_PIXELS else "bands"


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur a (..., H, W) image stack; no-op when sigma <= 0."""
    if sigma <= 0:
        return image
    H, W = image.shape[-2], image.shape[-1]
    if blur_path(H, W) == "shift_add":
        return _blur_shift_add(image, float(sigma))
    dev = str(image.device)
    bh = _blur_tensor(H, float(sigma), dev)
    bw = _blur_tensor(W, float(sigma), dev)
    return torch.matmul(torch.matmul(bh, image), bw.T)


def _blur_shift_add(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable reflect-101 Gaussian as shift-and-add passes:
    out = sum_t k[t] * padded[..., t:t+H, :], then the same along W.
    ``F.pad(mode="reflect")`` is BORDER_REFLECT_101 (the edge is not
    repeated)."""
    k = gaussian_kernel(sigma)
    half = len(k) // 2
    H, W = image.shape[-2], image.shape[-1]
    lead = image.shape[:-2]
    x = F.pad(image.reshape(-1, H, W), (0, 0, half, half), mode="reflect")
    out = sum(float(k[t]) * x[:, t:t + H, :] for t in range(len(k)))
    x = F.pad(out, (half, half), mode="reflect")
    out = sum(float(k[t]) * x[:, :, t:t + W] for t in range(len(k)))
    return out.reshape(*lead, H, W)
