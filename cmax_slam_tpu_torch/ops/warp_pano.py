"""Back-end global warp: events -> panoramic image of warped events through a
continuous-time SO(3) spline; counterpart of cmax_slam_tpu/ops/warp_pano.py.

Reference: EventWarper (src/backend/event_pano_warper.cpp:167-336). All
events of an ``event_batch_size`` batch share the spline pose at the batch
midpoint (:238-251); rotation and equirectangular projection are
component-wise tensor expressions; votes go through ops/scatter.vote; the
gradient with respect to the 3K knot increments comes from one autograd
pass, so the reference's 3K derivative images are never materialized.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import lie, spline
from ..calib import EquirectCamera
from . import contrast as contrast_mod
from .blur import gaussian_blur
from .contrast import contrast
from .scatter import bilinear_accumulate_two, vote
from .warp_local import value_and_grad


class PanoWindow(NamedTuple):
    """Device inputs for one back-end window.

    bearings: (3, N) per-event camera-frame rays, component-major.
    batch_times: (B,) spline-evaluation times relative to the window's
                 spline origin (B = N / event_batch_size).
    weights: (N,) vote weights (0 = padding or decimated).
    is_old: (N,) bool, True if the event leaves the window on the next
            slide (ts < t_next_win_beg; event_pano_warper.cpp:298).
    knots: (K, 4) window sub-trajectory control poses.
    free_mask: (K,) 1.0 for knots optimized this window, 0.0 for frozen.
    t0: time of knots[0] on the batch_times clock; dt_knots: knot spacing.
    ig_prime: (H, W) global-map term IG' (zeros on the first window).
    alpha: map-alignment weight (event_pano_warper.cpp:134-165), 0-dim.
    """

    bearings: torch.Tensor
    batch_times: torch.Tensor
    weights: torch.Tensor
    is_old: torch.Tensor
    knots: torch.Tensor
    free_mask: torch.Tensor
    t0: float
    dt_knots: float
    ig_prime: torch.Tensor
    alpha: torch.Tensor


def warp_to_pano(drotv: torch.Tensor, win: PanoWindow, pano: EquirectCamera, order: int):
    """Warp all events through the (perturbed) trajectory; returns (px, py)."""
    knots = spline.apply_masked_increments(win.knots, drotv, win.free_mask)
    R = spline.evaluate_rotmats(knots, win.batch_times, win.t0, win.dt_knots, order)
    B = win.batch_times.shape[0]
    bx = win.bearings[0].reshape(B, -1)
    by = win.bearings[1].reshape(B, -1)
    bz = win.bearings[2].reshape(B, -1)

    def comp(i):
        return R[i][0][:, None] * bx + R[i][1][:, None] * by + R[i][2][:, None] * bz

    x, y, z = comp(0), comp(1), comp(2)
    # Equirectangular projection (equirectangular_camera.h:25-26)
    rho = torch.sqrt(x * x + y * y + z * z)
    phi = torch.atan2(x, z)
    theta = torch.asin(torch.clamp(y / rho, -1.0, 1.0))
    px = (pano.cx + phi * pano.fx).reshape(-1)
    py = (pano.cy + theta * pano.fy).reshape(-1)
    return px, py


def pano_objective_image(drotv, win: PanoWindow, pano: EquirectCamera, order: int,
                         blur_sigma: float):
    """(IL, blur(IL + alpha * IG')): the total vote and the optimization
    image (EventWarper::computeImageOfWarpedEvents,
    event_pano_warper.cpp:167-231)."""
    px, py = warp_to_pano(drotv, win, pano, order)
    il = vote(px, py, win.weights, pano.height, pano.width)
    return il, gaussian_blur(il + win.alpha * win.ig_prime, blur_sigma)


def pano_il_split(drotv, win: PanoWindow, pano: EquirectCamera, order: int):
    """IL_old / IL_new at a given trajectory (feeds updateIG,
    event_pano_warper.cpp:296-311)."""
    px, py = warp_to_pano(drotv, win, pano, order)
    return bilinear_accumulate_two(px, py, win.weights, ~win.is_old,
                                   pano.height, pano.width)


def make_pano_objective(win: PanoWindow, pano: EquirectCamera, order: int,
                        blur_sigma: float, measure: int):
    """Negative-contrast objective over flattened knot increments R^{3K}
    (global_contrast_fdf, global_optim_contrast_gsl_analytical.cpp:17-68)
    and its value_and_grad."""
    K = win.knots.shape[0]

    def f(flat_drotv):
        _, image = pano_objective_image(flat_drotv.reshape(K, 3), win, pano, order,
                                        blur_sigma)
        return -contrast(image, measure)

    return f, value_and_grad(f)


# ---------------------------------------------------------------------------
# FOV-crop objective (see cmax_slam_tpu/ops/warp_pano.py for the geometry
# invariants): the solver votes into a crop around the window's footprint
# and evaluates the contrast of the full panorama from the crop interior's
# sums plus per-window-constant sums elsewhere. Exact while the warped events
# stay inside the crop margin; the back-end checks and re-solves otherwise.
# ---------------------------------------------------------------------------

def interior_mask(height: int, width: int, bounds, device) -> torch.Tensor:
    """(H, W) float mask of the interior [vy0, vy1) x [vx0, vx1)."""
    vy0, vy1, vx0, vx1 = (int(v) for v in bounds)
    m = torch.zeros((height, width), dtype=torch.float32, device=device)
    m[vy0:vy1, vx0:vx1] = 1.0
    return m


def warp_bbox(drotv, win: PanoWindow, pano: EquirectCamera, order: int) -> torch.Tensor:
    """(min px, max px, min py, max py) over valid events; +-inf when empty."""
    px, py = warp_to_pano(drotv, win, pano, order)
    valid = win.weights > 0
    inf = float("inf")
    return torch.stack([
        torch.where(valid, px, inf).amin(), torch.where(valid, px, -inf).amax(),
        torch.where(valid, py, inf).amin(), torch.where(valid, py, -inf).amax(),
    ])


def make_crop_objective(win: PanoWindow, pano: EquirectCamera, order: int,
                        blur_sigma: float, measure: int, crop_hw: tuple,
                        x0f: float, y0f: float, a_crop: torch.Tensor,
                        mask: torch.Tensor, out_s1, out_s2):
    """Crop-decomposed negative-contrast objective over R^{3K}, equal to
    make_pano_objective's value under the crop invariants. a_crop is the
    constant alpha * blur(IG') under the crop; out_s1/out_s2 the constant
    stats of that term outside the valid interior."""
    K = win.knots.shape[0]
    Hc, Wc = crop_hw
    n_total = pano.height * pano.width

    def f(flat_drotv):
        px, py = warp_to_pano(flat_drotv.reshape(K, 3), win, pano, order)
        il = vote(px - x0f, py - y0f, win.weights, Hc, Wc)
        image = gaussian_blur(il, blur_sigma) + a_crop
        s1, s2 = contrast_mod.region_stats(image, mask, measure)
        return -contrast_mod.contrast_from_stats(s1 + out_s1, s2 + out_s2, n_total, measure)

    return f, value_and_grad(f)


def crop_window_constants(win: PanoWindow, pano: EquirectCamera, order: int,
                          blur_sigma: float, measure: int, crop_hw: tuple, crop_ints):
    """Per-window constants of the crop objective: alpha from the
    zero-increment IL (its full-image density equals its crop density), the
    a_crop slice, the interior mask and the outside stats. ``crop_ints`` =
    [y0, x0, vy0, vy1, vx0, vx1] host ints. Returns (win_with_alpha, x0f,
    y0f, a_crop, mask, out_s1, out_s2)."""
    Hc, Wc = crop_hw
    y0, x0 = int(crop_ints[0]), int(crop_ints[1])
    x0f, y0f = float(x0), float(y0)
    K = win.knots.shape[0]
    zeros = torch.zeros((K, 3), dtype=torch.float32, device=win.knots.device)
    px0, py0 = warp_to_pano(zeros, win, pano, order)
    il0 = vote(px0 - x0f, py0 - y0f, win.weights, Hc, Wc)
    alpha = compute_alpha(il0, win.ig_prime)

    a_full = alpha * gaussian_blur(win.ig_prime, blur_sigma)
    a_crop = a_full[y0:y0 + Hc, x0:x0 + Wc]
    mask = interior_mask(Hc, Wc, crop_ints[2:6], win.knots.device)
    s1_full, s2_full = contrast_mod.full_stats(a_full, measure)
    s1_v, s2_v = contrast_mod.region_stats(a_crop, mask, measure)
    return (win._replace(alpha=alpha), x0f, y0f, a_crop, mask,
            s1_full - s1_v, s2_full - s2_v)


def event_density(image: torch.Tensor, lam0: float = 1.0) -> torch.Tensor:
    """sum(I) / aggregated support area (Gallego CVPR'19 measure used by
    updateAlpha, event_pano_warper.cpp:142-159)."""
    area = torch.sum(1.0 - torch.exp(-image / lam0))
    return torch.sum(image) / torch.clamp(area, min=1e-12)


def compute_alpha(il: torch.Tensor, ig_prime: torch.Tensor) -> torch.Tensor:
    """alpha = density(IL) / density(IG'); 0 when the global map is empty
    (event_pano_warper.cpp:134-165)."""
    nonzero = torch.count_nonzero(ig_prime)
    ratio = event_density(il) / event_density(ig_prime)
    return torch.where(nonzero < 1, torch.zeros_like(ratio), ratio)


def fov_mask(q_poses: torch.Tensor, sensor_lut: torch.Tensor, pano: EquirectCamera,
             radius: int = 3) -> torch.Tensor:
    """Union of sensor-FOV footprints on the pano for a set of poses, dilated
    by ``radius`` (setUpdateTimesIG, event_pano_warper.cpp:81-107).

    q_poses: (P, 4); sensor_lut: (H*W, 3). Returns (Hp, Wp) int32 0/1: an
    amax scatter of the projected rays, then a (2r+1)^2 max filter with SAME
    padding."""
    R = lie.to_matrix(q_poses)  # (P, 3, 3)
    rays = torch.einsum("pij,nj->pni", R, sensor_lut).reshape(-1, 3)
    uv = pano.project(rays)
    ix = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, pano.width - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, pano.height - 1)
    hits = torch.zeros(pano.height * pano.width, dtype=torch.float32, device=uv.device)
    hits = hits.index_fill(0, iy * pano.width + ix, 1.0)
    k = 2 * radius + 1
    mask = F.max_pool2d(hits.reshape(1, 1, pano.height, pano.width), k, stride=1,
                        padding=radius)
    return mask.reshape(pano.height, pano.width).to(torch.int32)


def accumulate_global_map(ig: torch.Tensor, il_old: torch.Tensor,
                          update_times: torch.Tensor, max_updates: int) -> torch.Tensor:
    """IG += IL_old wherever the per-pixel update count is still at most the
    saturation limit (updateIG, event_pano_warper.cpp:109-126)."""
    return torch.where(update_times <= max_updates, ig + il_old, ig)
