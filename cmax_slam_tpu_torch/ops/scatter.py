"""Bilinear vote accumulation; counterpart of cmax_slam_tpu/ops/scatter.py and
of the Pallas kernels in cmax_slam_tpu/ops/pallas_iwe.py.

Every event e with warped pixel coordinates (px, py) and weight w votes

    w * (1 - dx) * (1 - dy)  into (cy,     cx)
    w * dx       * (1 - dy)  into (cy,     cx + 1)
    w * (1 - dx) * dy        into (cy + 1, cx)
    w * dx       * dy        into (cy + 1, cx + 1)

with (cx, cy) = floor(p) and (dx, dy) = p - floor(p), as the reference's hot
loops do (local_image_warped_events.cpp:137-151, event_pano_warper.cpp:289-311).
A vote is dropped unless ``1 <= floor(px) < W-2``, ``1 <= floor(py) < H-2``
and ``w != 0``; dropped events are sanitized to coordinate -2 and weight 0
before any multiply, so a NaN or infinite coordinate cannot leak through
``0 * NaN``.

The gradient is the floor-parametrized one: only the fractions are
differentiated (the floor is constant), which is the reference's one-sided
"Kronecker delta" derivative and stays correct at integer coordinates, where
the zero-motion warp of quantized events lands every event (the cold start
at omega = 0).

``vote`` is the one entry point. A CPU tensor goes to the plain PyTorch
version below; a CUDA tensor goes to the hand-written kernels of
ops/cuda_iwe.py or raises. Every shape takes leading batch dimensions:
(..., N) coordinates give (..., H, W) images, so one call serves a whole
vector-ladder sweep or the old/new split. ``tangent_vote`` is the vote's
forward-mode derivative along T coordinate tangents at once (the derivative
images), dispatched the same way (K3 on the card).
"""

from __future__ import annotations

import torch

from . import cuda_iwe


def inbounds_mask(px: torch.Tensor, py: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Reference in-bounds test on the *floored* warped point."""
    fx = torch.floor(px)
    fy = torch.floor(py)
    return (fx >= 1) & (fx < width - 2) & (fy >= 1) & (fy < height - 2)


def bilinear_accumulate(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                        height: int, width: int) -> torch.Tensor:
    """Plain PyTorch vote: (..., N) events -> (..., height, width) float32.

    Differentiable through autograd: the floor is detached, and the four
    taps go through ``index_add``, whose backward is the bilinear gather.
    This is the reference version the kernels are held against."""
    px, py, weights = torch.broadcast_tensors(px, py, weights)
    lead = px.shape[:-1]
    if px.shape[-1] == 0:
        return torch.zeros(*lead, height, width, dtype=torch.float32, device=px.device)
    valid = inbounds_mask(px, py, height, width) & (weights != 0)
    px = torch.where(valid, px, -2.0).float()
    py = torch.where(valid, py, -2.0).float()
    w = torch.where(valid, weights, 0.0).float()
    fx = torch.floor(px).detach()
    fy = torch.floor(py).detach()
    dx = px - fx
    dy = py - fy
    ix = torch.where(valid, fx, 0.0).long()
    iy = torch.where(valid, fy, 0.0).long()
    nb = px[..., 0].numel()
    b = torch.arange(nb, device=px.device).reshape(*lead, 1)
    flat = (b * height + iy) * width + ix
    idx = torch.cat([flat, flat + 1, flat + width, flat + width + 1], dim=-1)
    vals = torch.cat([
        w * (1 - dx) * (1 - dy),
        w * dx * (1 - dy),
        w * (1 - dx) * dy,
        w * dx * dy,
    ], dim=-1)
    img = torch.zeros(nb * height * width, dtype=torch.float32, device=px.device)
    img = img.index_add(0, idx.reshape(-1), vals.reshape(-1))
    return img.reshape(*lead, height, width)


def vote(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
         height: int, width: int) -> torch.Tensor:
    """Bilinear vote, dispatched on the tensor's device: CPU -> the plain
    version, CUDA -> the hand-written kernels (ops/cuda_iwe.py). There is no
    fallback between the two."""
    if px.device.type == "cuda":
        return cuda_iwe.bilinear_accumulate_cuda(px, py, weights, height, width)
    if px.device.type != "cpu":
        raise RuntimeError(f"no vote implementation for device {px.device}")
    return bilinear_accumulate(px, py, weights, height, width)


def bilinear_accumulate_jvp(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                            tpx: torch.Tensor, tpy: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """Plain PyTorch tangent vote: (N,) events and (T, N) coordinate
    tangents -> (T, height, width), the derivative of ``bilinear_accumulate``
    along each tangent (the floor held constant): per kept event

        w * (-tpx (1-dy) - tpy (1-dx))  into (cy,     cx)
        w * ( tpx (1-dy) - tpy dx)       into (cy,     cx + 1)
        w * (-tpx dy + tpy (1-dx))       into (cy + 1, cx)
        w * ( tpx dy + tpy dx)           into (cy + 1, cx + 1)

    and nothing for a dropped one. The version K3 is held against."""
    T = tpx.shape[0]
    valid = inbounds_mask(px, py, height, width) & (weights != 0)
    px = torch.where(valid, px, -2.0).float()
    py = torch.where(valid, py, -2.0).float()
    w = torch.where(valid, weights, 0.0).float()
    tx = torch.where(valid, tpx, 0.0).float()
    ty = torch.where(valid, tpy, 0.0).float()
    fx, fy = torch.floor(px), torch.floor(py)
    dx, dy = px - fx, py - fy
    ix = torch.where(valid, fx, 0.0).long()
    iy = torch.where(valid, fy, 0.0).long()
    b = torch.arange(T, device=px.device)[:, None]
    flat = (b * height + iy) * width + ix
    idx = torch.cat([flat, flat + 1, flat + width, flat + width + 1], dim=-1)
    vals = torch.cat([
        w * (-tx * (1 - dy) - ty * (1 - dx)),
        w * (tx * (1 - dy) - ty * dx),
        w * (-tx * dy + ty * (1 - dx)),
        w * (tx * dy + ty * dx),
    ], dim=-1)
    img = torch.zeros(T * height * width, dtype=torch.float32, device=px.device)
    img = img.index_add(0, idx.reshape(-1), vals.reshape(-1))
    return img.reshape(T, height, width)


def tangent_vote(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor, tpx: torch.Tensor,
                 tpy: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The vote's tangent images along T coordinate tangents: (N,) events,
    (T, N) tangents -> (T, height, width), dispatched on the tensor's
    device: CPU -> the plain version, CUDA -> K3 (ops/cuda_iwe.py), one
    launch for all T."""
    if px.device.type == "cuda":
        ops = [t.reshape(1, -1).float().contiguous() for t in (px, py, weights)]
        return cuda_iwe.vote_jvp(*ops, tpx.float().contiguous(), tpy.float().contiguous(),
                                 height, width, tpx.shape[0])
    if px.device.type != "cpu":
        raise RuntimeError(f"no vote implementation for device {px.device}")
    return bilinear_accumulate_jvp(px, py, weights, tpx, tpy, height, width)


def bilinear_accumulate_two(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                            select_second: torch.Tensor, height: int, width: int):
    """Votes split into two images by a per-event select bit (IL_old /
    IL_new, event_pano_warper.cpp:296-311): one batched vote of B = 2 with
    weights ``w * (1 - sel)`` and ``w * sel``."""
    sel = select_second.to(torch.float32)
    w2 = torch.stack([weights * (1.0 - sel), weights * sel])
    both = vote(px, py, w2, height, width)
    return both[0], both[1]


def bilinear_sample(image: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of an (H, W) ``image`` at (px, py), the vote's
    adjoint (a rendering and parity utility)."""
    H, W = image.shape
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, H - 2)
    dx, dy = px - x0, py - y0
    return (image[y0, x0] * (1 - dx) * (1 - dy) + image[y0, x0 + 1] * dx * (1 - dy)
            + image[y0 + 1, x0] * (1 - dx) * dy + image[y0 + 1, x0 + 1] * dx * dy)
