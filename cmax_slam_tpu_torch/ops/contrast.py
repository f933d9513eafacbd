"""Contrast (focus) objectives over images of warped events; counterpart of
cmax_slam_tpu/ops/contrast.py.

Reference: src/frontend/local_focus_funcs.cpp:9-120 and
src/backend/global_focus_funcs.cpp:11-80. Every reduction is over the last
two (image) dimensions, so a (M, H, W) stack gives M values: one per rung of
a vector-ladder sweep.
"""

from __future__ import annotations

import torch

from ..config import (
    IMAGE_GRADIENT_MAGNITUDE_CONTRAST,
    MEAN_SQUARE_CONTRAST,
)

_IMG = (-2, -1)


def variance(image: torch.Tensor) -> torch.Tensor:
    """Population variance of pixel intensities (cv::meanStdDev semantics;
    local_focus_funcs.cpp:26-44)."""
    mean = torch.mean(image, dim=_IMG, keepdim=True)
    return torch.mean(torch.square(image - mean), dim=_IMG)


def mean_square(image: torch.Tensor) -> torch.Tensor:
    """Mean of squared intensities (local_focus_funcs.cpp:9-24)."""
    return torch.mean(torch.square(image), dim=_IMG)


def _reflect101(n: int, device) -> torch.Tensor:
    """Indices of a one-pixel BORDER_REFLECT_101 pad: [1, 0, 1, ..., n-1, n-2]."""
    return torch.cat([torch.tensor([1]), torch.arange(n), torch.tensor([n - 2])]).to(device)


def _sobel(image: torch.Tensor, axis: int) -> torch.Tensor:
    """3x3 Sobel with BORDER_REFLECT_101, matching cv::Sobel defaults."""
    H, W = image.shape[-2], image.shape[-1]
    p = image[..., _reflect101(H, image.device), :][..., _reflect101(W, image.device)]
    # Separable: derivative [-1, 0, 1] along `axis`, smoothing [1, 2, 1] along the other.
    if axis == 1:  # d/dx (columns)
        d = p[..., :, 2:] - p[..., :, :-2]
        return d[..., :-2, :] + 2.0 * d[..., 1:-1, :] + d[..., 2:, :]
    d = p[..., 2:, :] - p[..., :-2, :]  # d/dy (rows)
    return d[..., :, :-2] + 2.0 * d[..., :, 1:-1] + d[..., :, 2:]


def gradient_magnitude(image: torch.Tensor) -> torch.Tensor:
    """Mean squared Sobel-gradient magnitude (local_focus_funcs.cpp:47-73)."""
    gx = _sobel(image, axis=1)
    gy = _sobel(image, axis=0)
    return torch.mean(gx * gx + gy * gy, dim=_IMG)


def contrast(image: torch.Tensor, measure: int) -> torch.Tensor:
    """Dispatch on the contrast measure (computeContrast,
    local_focus_funcs.cpp:82-120)."""
    if measure == MEAN_SQUARE_CONTRAST:
        return mean_square(image)
    if measure == IMAGE_GRADIENT_MAGNITUDE_CONTRAST:
        return gradient_magnitude(image)
    return variance(image)


# ---------------------------------------------------------------------------
# Sufficient-statistics form: every measure above is a function of image-wide
# sums, so the back-end FOV-crop objective (warp_pano.make_crop_objective)
# evaluates the crop's sums per iteration and folds in per-window-constant
# sums for the untouched remainder — the measure over the full panorama.
# ---------------------------------------------------------------------------

def region_stats(image: torch.Tensor, mask: torch.Tensor, measure: int):
    """(s1, s2) sums of the measure's integrand over ``mask`` pixels.

    variance: s1 = sum(I), s2 = sum(I^2); mean_square: s1 = 0, s2 = sum(I^2);
    grad-mag: s1 = 0, s2 = sum(|Sobel I|^2) (Sobel over the whole crop,
    masked afterwards; the caller's halo keeps masked-in stencils inside)."""
    if measure == IMAGE_GRADIENT_MAGNITUDE_CONTRAST:
        gx = _sobel(image, axis=1)
        gy = _sobel(image, axis=0)
        s2 = torch.sum((gx * gx + gy * gy) * mask, dim=_IMG)
        return torch.zeros_like(s2), s2
    s2 = torch.sum(torch.square(image) * mask, dim=_IMG)
    if measure == MEAN_SQUARE_CONTRAST:
        return torch.zeros_like(s2), s2
    return torch.sum(image * mask, dim=_IMG), s2


def full_stats(image: torch.Tensor, measure: int):
    """(s1, s2) over every pixel: region_stats with the whole image as mask."""
    return region_stats(image, 1.0, measure)


def contrast_from_stats(s1, s2, n_pixels: int, measure: int) -> torch.Tensor:
    """Measure value from summed statistics over ``n_pixels`` total pixels."""
    if measure in (MEAN_SQUARE_CONTRAST, IMAGE_GRADIENT_MAGNITUDE_CONTRAST):
        return s2 / n_pixels
    mean = s1 / n_pixels
    return s2 / n_pixels - mean * mean
