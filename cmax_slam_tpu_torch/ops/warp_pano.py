"""Back-end global warp: events -> panoramic image of warped events through a
continuous-time SO(3) spline; counterpart of cmax_slam_tpu/ops/warp_pano.py.

Reference: EventWarper (src/backend/event_pano_warper.cpp:167-336). All
events of an ``event_batch_size`` batch share the spline pose at the batch
midpoint (:238-251); rotation and equirectangular projection are
component-wise tensor expressions; votes go through ops/scatter.vote. The
solver's objectives (make_pano_objective, make_crop_objective) take the
whole chain from knot increments to image through ``pano_vote``: on the
card one kernel forward (K4) and one backward (K5, ops/cuda_pano_vote.py),
on the CPU ``pano_vote_plain`` with autograd. The gradient with respect to
the 3K knot increments comes from one backward pass, so the reference's 3K
derivative images are never materialized on the solver's path.
``derivative_images`` gives them for inspection
(saveDerivativeImages): the warp's tangents by forward mode, then one
tangent vote (K3 on the card) and the blur.
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
from . import cuda_pano_vote
from .scatter import bilinear_accumulate, bilinear_accumulate_two, tangent_vote, vote
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


def warp_to_pano(drotv: torch.Tensor, win: PanoWindow, pano: EquirectCamera, order: int,
                 basis=None):
    """Warp all events through the (perturbed) trajectory; returns (px, py).
    ``drotv`` is (..., K, 3); a batch of M increments gives (M, N) each.
    ``basis``: the window's ``spline.segment_basis``, if computed already."""
    lead = drotv.shape[:-2]
    knots = spline.apply_masked_increments(win.knots, drotv, win.free_mask)
    R = spline.evaluate_rotmats(knots, win.batch_times, win.t0, win.dt_knots, order, basis)
    B = win.batch_times.shape[0]
    bx = win.bearings[0].reshape(B, -1)
    by = win.bearings[1].reshape(B, -1)
    bz = win.bearings[2].reshape(B, -1)

    def comp(i):
        return (R[i][0][..., None] * bx + R[i][1][..., None] * by
                + R[i][2][..., None] * bz)

    x, y, z = comp(0), comp(1), comp(2)
    # Equirectangular projection (equirectangular_camera.h:25-26)
    rho = torch.sqrt(x * x + y * y + z * z)
    phi = torch.atan2(x, z)
    theta = torch.asin(torch.clamp(y / rho, -1.0, 1.0))
    px = (pano.cx + phi * pano.fx).reshape(*lead, -1)
    py = (pano.cy + theta * pano.fy).reshape(*lead, -1)
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


def pano_iwe(drotv, win: PanoWindow, pano: EquirectCamera, order: int, blur_sigma: float):
    """(IL_old, IL_new, blur(IL_old + IL_new + alpha * IG')): the split and
    the blended, blurred optimization image at a trajectory."""
    il_old, il_new = pano_il_split(drotv, win, pano, order)
    image = gaussian_blur(il_old + il_new + win.alpha * win.ig_prime, blur_sigma)
    return il_old, il_new, image


def derivative_images(win: PanoWindow, pano: EquirectCamera, order: int,
                      blur_sigma: float) -> torch.Tensor:
    """Per-parameter derivative images d(image)/d(knot increments) of
    ``pano_iwe`` at zero increments: (K, 3, H, W), as the JAX package's
    ``jax.jacfwd`` of it gives them (the reference's saveDerivativeImages,
    src/utils/image_utils.cpp:41-62). One forward pass: the (3K, N) tangents
    of the warped coordinates by ``torch.func.jacfwd`` of ``warp_to_pano``
    (plain torch ops), one tangent vote of all 3K images (K3 on the card;
    the old and new halves of the split share the coordinates and their
    weights sum to the window's, so one vote gives the tangent of IL_old +
    IL_new), then the blur, which is linear (alpha and IG' are constants)."""
    K = win.knots.shape[0]
    zeros = torch.zeros((K, 3), dtype=torch.float32, device=win.knots.device)

    def coords(drotv):
        return torch.stack(warp_to_pano(drotv, win, pano, order))

    with torch.no_grad():
        px, py = warp_to_pano(zeros, win, pano, order)
    J = torch.func.jacfwd(coords)(zeros).detach()  # (2, N, K, 3)
    tangents = J.reshape(2, -1, 3 * K).transpose(1, 2)  # (2, 3K, N)
    timg = tangent_vote(px, py, win.weights, tangents[0], tangents[1], pano.height,
                        pano.width)
    return gaussian_blur(timg, blur_sigma).reshape(K, 3, pano.height, pano.width)


def _warp_from(drotv, win: PanoWindow, pano: EquirectCamera, order: int, origin, basis):
    px, py = warp_to_pano(drotv, win, pano, order, basis)
    if origin is not None:
        px, py = px - origin[0], py - origin[1]
    return px, py


def pano_vote_plain(drotv, win: PanoWindow, pano: EquirectCamera, order: int, hw: tuple,
                    origin=None, basis=None) -> torch.Tensor:
    """The images of the window's events warped by (..., K, 3) increments,
    on an (H, W) = ``hw`` image whose origin lies at ``origin`` = (x0, y0) of
    the panorama (a (2,) tensor; None: the panorama itself), in plain torch:
    ``warp_to_pano``, then the plain vote, with autograd for the gradient.
    The version K4 and K5 are held against, and the CPU's."""
    return bilinear_accumulate(*_warp_from(drotv, win, pano, order, origin, basis),
                               win.weights, *hw)


def pano_vote_composed(drotv, win: PanoWindow, pano: EquirectCamera, order: int, hw: tuple,
                       origin=None, basis=None) -> torch.Tensor:
    """``pano_vote_plain`` with the vote dispatched by ``scatter.vote`` (K1
    and K2 on the card): the objectives' route before K4 and K5, kept as
    chip_smoke's yardstick for them."""
    return vote(*_warp_from(drotv, win, pano, order, origin, basis), win.weights, *hw)


def pano_vote(drotv, win: PanoWindow, pano: EquirectCamera, order: int, hw: tuple,
              origin=None, basis=None) -> torch.Tensor:
    """``pano_vote_plain``'s function, dispatched on the tensor's device:
    CPU -> the plain version, CUDA -> K4 forward and K5 backward
    (ops/cuda_pano_vote.py). There is no fallback between the two."""
    if drotv.device.type == "cuda":
        if basis is None:
            basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots,
                                         win.knots.shape[0], order)
        return cuda_pano_vote.pano_vote_cuda(drotv, win, basis, pano, order, hw, origin)
    if drotv.device.type != "cpu":
        raise RuntimeError(f"no vote implementation for device {drotv.device}")
    return pano_vote_plain(drotv, win, pano, order, hw, origin, basis)


def make_pano_objective(win: PanoWindow, pano: EquirectCamera, order: int,
                        blur_sigma: float, measure: int, *, basis=None):
    """Negative-contrast objective over flattened knot increments R^{3K}
    (global_contrast_fdf, global_optim_contrast_gsl_analytical.cpp:17-68)
    and its value_and_grad. f takes (3K,) or a (M, 3K) batch (one batched
    vote for the vector and grid ladders). The window's spline basis is
    computed here, unless ``basis`` holds it (a window program's buffers,
    rewritten per window)."""
    K = win.knots.shape[0]
    if basis is None:
        basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)

    def f(flat_drotv):
        drotv = flat_drotv.reshape(*flat_drotv.shape[:-1], K, 3)
        il = pano_vote(drotv, win, pano, order, (pano.height, pano.width), None, basis)
        image = gaussian_blur(il + win.alpha * win.ig_prime, blur_sigma)
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
    """(H, W) float mask of the interior [vy0, vy1) x [vx0, vx1); ``bounds``
    may be host ints or a device tensor (nothing is read on the host)."""
    vy0, vy1, vx0, vx1 = torch.as_tensor(bounds, device=device).to(torch.int64).unbind()
    r = torch.arange(height, device=device)[:, None]
    c = torch.arange(width, device=device)[None, :]
    return ((r >= vy0) & (r < vy1) & (c >= vx0) & (c < vx1)).to(torch.float32)


def bbox_of(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(min px, max px, min py, max py) over events of non-zero weight;
    +-inf when there are none."""
    valid = weights > 0
    inf = float("inf")
    return torch.stack([
        torch.where(valid, px, inf).amin(), torch.where(valid, px, -inf).amax(),
        torch.where(valid, py, inf).amin(), torch.where(valid, py, -inf).amax(),
    ])


def warp_bbox(drotv, win: PanoWindow, pano: EquirectCamera, order: int) -> torch.Tensor:
    """bbox_of the events warped by ``drotv``."""
    px, py = warp_to_pano(drotv, win, pano, order)
    return bbox_of(px, py, win.weights)


def make_crop_objective(win: PanoWindow, pano: EquirectCamera, order: int,
                        blur_sigma: float, measure: int, crop_hw: tuple,
                        x0f, y0f, a_crop: torch.Tensor,
                        mask: torch.Tensor, out_s1, out_s2, *, origin=None, basis=None):
    """Crop-decomposed negative-contrast objective over R^{3K}, equal to
    make_pano_objective's value under the crop invariants. x0f, y0f are the
    crop origin (numbers or 0-dim device tensors, read here), unless
    ``origin``, a (2,) device tensor (x0, y0), is given: it is read at every
    evaluation (a window program's buffer, rewritten per window); a_crop is
    the constant alpha * blur(IG') under the crop; out_s1/out_s2 the
    constant stats of that term outside the valid interior. ``basis`` as
    make_pano_objective's. f takes (3K,) or a (M, 3K) batch."""
    K = win.knots.shape[0]
    n_total = pano.height * pano.width
    dev = win.knots.device
    if origin is None:
        origin = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                              for v in (x0f, y0f)])
    if basis is None:
        basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)

    def f(flat_drotv):
        drotv = flat_drotv.reshape(*flat_drotv.shape[:-1], K, 3)
        il = pano_vote(drotv, win, pano, order, tuple(crop_hw), origin, basis)
        image = gaussian_blur(il, blur_sigma) + a_crop
        s1, s2 = contrast_mod.region_stats(image, mask, measure)
        return -contrast_mod.contrast_from_stats(s1 + out_s1, s2 + out_s2, n_total, measure)

    return f, value_and_grad(f)


def crop_window_constants(win: PanoWindow, pano: EquirectCamera, order: int,
                          blur_sigma: float, measure: int, crop_hw: tuple, crop_ints, *,
                          basis=None):
    """Per-window constants of the crop objective: alpha from the
    zero-increment IL (its full-image density equals its crop density), the
    a_crop slice, the interior mask and the outside stats. ``crop_ints`` =
    [y0, x0, vy0, vy1, vx0, vx1], host ints or a device tensor: the crop is
    placed on the device, as the JAX package reads it there, and nothing is
    read on the host. ``basis`` as make_pano_objective's. Returns
    (win_with_alpha, x0f, y0f, a_crop, mask, out_s1, out_s2); x0f and y0f
    are 0-dim device tensors."""
    Hc, Wc = crop_hw
    dev = win.knots.device
    ints = torch.as_tensor(crop_ints, device=dev).to(torch.int64)
    x0f, y0f = ints[1].to(torch.float32), ints[0].to(torch.float32)
    alpha = zero_increment_alpha(win, pano, order, crop_hw, torch.stack([x0f, y0f]), basis)

    a_full = alpha * gaussian_blur(win.ig_prime, blur_sigma)
    rows = ints[0] + torch.arange(Hc, device=dev)
    cols = ints[1] + torch.arange(Wc, device=dev)
    a_crop = a_full[rows[:, None], cols[None, :]]
    mask = interior_mask(Hc, Wc, ints[2:6], dev)
    s1_full, s2_full = contrast_mod.full_stats(a_full, measure)
    s1_v, s2_v = contrast_mod.region_stats(a_crop, mask, measure)
    return (win._replace(alpha=alpha), x0f, y0f, a_crop, mask,
            s1_full - s1_v, s2_full - s2_v)


def zero_increment_alpha(win: PanoWindow, pano: EquirectCamera, order: int, hw: tuple,
                         origin=None, basis=None) -> torch.Tensor:
    """compute_alpha of the window's image at zero increments against its
    map term IG', the image on ``hw`` at ``origin`` as ``pano_vote`` places
    it: the function every evaluation of the window's objective computes
    (K4 on the card)."""
    zeros = torch.zeros((win.knots.shape[0], 3), dtype=torch.float32, device=win.knots.device)
    return compute_alpha(pano_vote(zeros, win, pano, order, tuple(hw), origin, basis),
                         win.ig_prime)


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
