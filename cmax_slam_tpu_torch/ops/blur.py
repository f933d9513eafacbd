"""Gaussian blur matching cv::GaussianBlur(src, Size(0,0), sigma); counterpart
of cmax_slam_tpu/ops/blur.py.

The reference blurs every IWE before the contrast reduction
(local_image_warped_events.cpp:32-38, event_pano_warper.cpp:217-230).
OpenCV semantics: kernel size ``round(sigma * 8 + 1) | 1``, weights
``exp(-i^2 / (2 sigma^2))`` normalized to 1, border BORDER_REFLECT_101.

The separable blur is two matmuls ``B_h @ I @ B_w^T`` with banded matrices
that fold the reflection into the band. Those matrices are not symmetric at
the borders, so the blur's adjoint is ``B^T``, which autograd through the
matmuls gives by construction. On a card, float32 matmuls run in full
float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set; the port
leaves it at its default, False.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
    return torch.as_tensor(_blur_matrix(size, sigma), device=device)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur a (..., H, W) image stack; no-op when sigma <= 0."""
    if sigma <= 0:
        return image
    H, W = image.shape[-2], image.shape[-1]
    dev = str(image.device)
    bh = _blur_tensor(H, float(sigma), dev)
    bw = _blur_tensor(W, float(sigma), dev)
    return torch.matmul(torch.matmul(bh, image), bw.T)
