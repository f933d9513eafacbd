"""Event-parallel bundle adjustment: ONE window's CMax objective with its
events split over a device list; counterpart of
cmax_slam_tpu/parallel/window_shard.py.

The reference's back-end is strictly single-threaded (SURVEY.md section 2.3);
the segmented replay (parallel/replay.py) parallelizes across TIME. This
module parallelizes WITHIN one window: each device takes its shard of the
window's event batches through the single-device objective's own spline,
warp and vote (warp_pano.pano_vote: K4 on the card, the plain version on
the CPU) into a partial (H, W) image; the partials are summed on the first
device, where the blend, blur and contrast run. The gradient flows back
through the ``.to()`` copies and K5 on every shard. This is the
single-process form of the JAX package's ``shard_map`` + ``psum``: one
(H, W) float32 image crosses from each device per evaluation.
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from .. import spline
from ..calib import EquirectCamera
from ..ops import warp_pano
from ..ops.blur import gaussian_blur
from ..ops.contrast import contrast
from ..ops.warp_local import value_and_grad
from ..ops.warp_pano import PanoWindow
from ..utils.device import resolve_devices


def shard_window_events(win: PanoWindow, devices) -> List[PanoWindow]:
    """Pad the window's event-batch axis to a multiple of the device count
    and split it: one PanoWindow per device, holding a contiguous range of
    event batches on that device (knots, mask and map replicated).

    Padding batches carry weight 0, so they vote nothing. Their bearings are
    the constant ray (1, 1, 1), NOT zeros: the equirect projection divides
    by the ray's norm and a zero ray gives arcsin(0/0) = NaN, which a weight-0
    vote would still turn into 0 * NaN (the NaN regression of the JAX
    package at B=1300 on 8 devices). Their batch time 0 falls in a spline
    segment of the window like any other (segment_basis clamps it), and K5
    skips an event of weight 0, so they add exactly 0 to the gradient.

    Each shard owns a copy of the knots: K4 and K5 read them as 16-byte
    quaternions, and on a list that repeats a device ``.to()`` would hand
    every shard the window's own tensor, wherever it lies."""
    devices = resolve_devices(devices)
    n_dev = len(devices)
    B = win.batch_times.shape[0]
    E = win.weights.shape[0] // B
    pad_b = (-B) % n_dev
    if pad_b:
        pe = pad_b * E
        win = win._replace(
            bearings=F.pad(win.bearings, (0, pe), value=1.0),
            batch_times=F.pad(win.batch_times, (0, pad_b)),
            weights=F.pad(win.weights, (0, pe)),
            is_old=F.pad(win.is_old, (0, pe)),
        )
    nb = (B + pad_b) // n_dev
    shards = []
    for i, dev in enumerate(devices):
        ev = slice(i * nb * E, (i + 1) * nb * E)
        shards.append(PanoWindow(
            bearings=win.bearings[:, ev].to(dev).contiguous(),
            batch_times=win.batch_times[i * nb:(i + 1) * nb].to(dev),
            weights=win.weights[ev].to(dev),
            is_old=win.is_old[ev].to(dev),
            knots=win.knots.to(dev, copy=True), free_mask=win.free_mask.to(dev),
            t0=win.t0, dt_knots=win.dt_knots,
            ig_prime=win.ig_prime.to(dev), alpha=win.alpha.to(dev)))
    return shards


def make_sharded_pano_objective(devices, win: List[PanoWindow], pano: EquirectCamera,
                                order: int, blur_sigma: float, measure: int):
    """(f, value_and_grad) over flattened knot increments R^{3K}, equal to
    warp_pano.make_pano_objective's on the unsharded window but with the
    spline, warp and vote of each shard of ``win`` (from
    shard_window_events) on its device, through warp_pano.pano_vote with
    the shard's spline basis (computed here, once), and one sum of the
    partial images on ``devices[0]``. f takes (3K,) or a (M, 3K) batch of
    candidates."""
    devices = resolve_devices(devices)
    if len(win) != len(devices) or any(
            w.weights.device != d for w, d in zip(win, devices)):
        raise ValueError("win must be shard_window_events(window, devices)")
    K = win[0].knots.shape[0]
    home = win[0]
    hw = (pano.height, pano.width)
    bases = [spline.segment_basis(w.batch_times, w.t0, w.dt_knots, K, order) for w in win]

    def f(flat_drotv):
        drotv = flat_drotv.reshape(*flat_drotv.shape[:-1], K, 3)
        il = None
        for shard, dev, basis in zip(win, devices, bases):
            part = warp_pano.pano_vote(drotv.to(dev), shard, pano, order, hw, None,
                                       basis).to(devices[0])
            il = part if il is None else il + part
        image = gaussian_blur(il + home.alpha * home.ig_prime, blur_sigma)
        return -contrast(image, measure)

    return f, value_and_grad(f)
