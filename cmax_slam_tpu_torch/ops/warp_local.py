"""Front-end local warp: events -> image of warped events under a candidate
angular velocity; counterpart of cmax_slam_tpu/ops/warp_local.py.

Reference: src/frontend/local_image_warped_events.cpp:10-170. Each event's
bearing is rotated to first order, ``b' = b + (omega * dt) x b``, projected
canonically, mapped through K, and voted bilinearly into the camera-frame
IWE (ops/scatter.vote). ``omega`` may carry a leading batch dimension: a
(M, 3) stack of candidates gives (M, H, W) images from ONE vote launch, which
is how the vector ladder evaluates all its rungs at once. A packet may carry
a leading lane axis too (P independent packets, parallel/batched.py): with
omega (P, 3) or (P, M, 3) the images are (P, [M,] H, W), still from one
vote launch of B = P * M images.

All events of a ``event_batch_size`` batch share the batch midpoint time
(local_image_warped_events.cpp:59-76); that per-event dt does not depend on
omega, so it is computed once per packet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_iwe, cuda_packet
from .blur import gaussian_blur
from .contrast import contrast
from .scatter import vote


class CameraParams(NamedTuple):
    """Static pinhole parameters used by the warp."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class EventPacket(NamedTuple):
    """Fixed-size event packet on the device.

    bearings: (N, 3) unit rays of each event's pixel (LUT gather).
    dts:      (N,) effective warp dt (batch midpoint minus packet reference
              time), seconds, float32.
    weights:  (N,) vote weight; 0 marks padding.
    Every field may carry the same leading lane dimensions: (P, N, 3),
    (P, N), (P, N) for a stack of P packets.
    """

    bearings: torch.Tensor
    dts: torch.Tensor
    weights: torch.Tensor


def batch_midpoint_dts(ts: torch.Tensor, valid: torch.Tensor, batch_size: int,
                       t_ref) -> torch.Tensor:
    """Per-event effective dt with batch-shared midpoint semantics: every
    event of a ``batch_size`` batch warps with dt = (t_first + t_last)/2 -
    t_ref over the batch's valid events (local_image_warped_events.cpp:67-75).
    ``ts`` must be padded to a multiple of batch_size; ``t_ref`` is a number
    or a 0-dim float32 tensor (a device scalar inside a captured solve)."""
    if ts.shape[0] % batch_size:
        raise ValueError("pad the packet to a multiple of event_batch_size")
    tsb = ts.reshape(-1, batch_size)
    vb = valid.reshape(-1, batch_size)
    big = torch.finfo(ts.dtype).max
    t_first = torch.where(vb, tsb, big).amin(dim=1)
    t_last = torch.where(vb, tsb, -big).amax(dim=1)
    mid = t_first + 0.5 * (t_last - t_first)
    dt = torch.where(vb.any(dim=1), mid - t_ref, 0.0)
    return dt.repeat_interleave(batch_size)


def make_packet(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                lut: torch.Tensor, cam: CameraParams, batch_size: int, t_ref) -> EventPacket:
    """An EventPacket from raw event arrays and the bearing LUT; invalid
    lanes gather pixel 0 and weigh 0."""
    idx = torch.where(valid, ys.to(torch.int64) * cam.width + xs.to(torch.int64), 0)
    return EventPacket(bearings=lut[idx], dts=batch_midpoint_dts(ts, valid, batch_size, t_ref),
                       weights=valid.to(torch.float32))


def _align(omega: torch.Tensor, packet: EventPacket) -> EventPacket:
    """Give the packet a singleton axis for every candidate axis that omega
    has beyond the packet's lane axes: (P, N) with omega (P, M, 3) becomes
    (P, 1, N), so each lane's events meet that lane's M candidates."""
    extra = omega.dim() - packet.dts.dim()
    if extra <= 0:
        return packet
    shape = packet.dts.shape[:-1] + (1,) * extra + packet.dts.shape[-1:]
    return EventPacket(packet.bearings.reshape(*shape, 3), packet.dts.reshape(shape),
                       packet.weights.reshape(shape))


def warp_events(omega: torch.Tensor, packet: EventPacket, cam: CameraParams):
    """First-order rotational warp; omega (..., 3) -> pixel coords (..., N)
    each (lanes: see EventPacket). Reference math: rotatePoint3DFirstOrder +
    canonicalProjection + applyIntrinsics (src/utils/image_geom_util.cpp:7-58)."""
    packet = _align(omega, packet)
    d = [packet.dts * omega[..., k, None] for k in range(3)]
    bx, by, bz = packet.bearings.unbind(-1)
    rx = bx + (d[1] * bz - d[2] * by)
    ry = by + (d[2] * bx - d[0] * bz)
    rz = bz + (d[0] * by - d[1] * bx)
    inv_z = 1.0 / rz
    px = cam.fx * (rx * inv_z) + cam.cx
    py = cam.fy * (ry * inv_z) + cam.cy
    return px, py


def local_iwe(omega: torch.Tensor, packet: EventPacket, cam: CameraParams,
              blur_sigma: float = 1.0) -> torch.Tensor:
    """Blurred image of warped events for a packet under omega (..., 3)
    (AngVelEstimator::computeImageOfWarpedEvents,
    local_image_warped_events.cpp:10-57)."""
    px, py = warp_events(omega, packet, cam)
    iwe = vote(px, py, _align(omega, packet).weights, cam.height, cam.width)
    return gaussian_blur(iwe, blur_sigma)


def value_and_grad(f):
    """x -> (f(x), df/dx) by autograd, both detached. A non-scalar f (one
    value per lane of independent problems) gets each lane's gradient."""

    def vg(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            val = f(xr)
            (g,) = torch.autograd.grad(val, xr, torch.ones_like(val))
        return val.detach(), g

    return vg


def objective_route(packet: EventPacket, cam: CameraParams, blur_sigma: float,
                    measure: int) -> str:
    """The route of a packet objective, by shape alone: "fused" (K6,
    ops/cuda_packet.py: the whole value and gradient in one launch) where
    its planner takes one packet's events on the card, else "chain"
    (warp_events, the vote, the blur, the measure, autograd). A CPU packet,
    or one with a lane axis, always takes the chain."""
    if packet.dts.device.type != "cuda" or packet.dts.dim() != 1:
        return "chain"
    smem = cuda_iwe.device_attrs(packet.dts.device)[1]
    return cuda_packet.plan_packet_vg(1, packet.dts.shape[0], cam.height, cam.width,
                                      blur_sigma, measure, smem).route


def make_local_objective(packet: EventPacket, cam: CameraParams, blur_sigma: float,
                         measure: int, *, route: str | None = None):
    """Negative-contrast objective f(omega) and its value_and_grad (the GSL
    callback triple {f, df, fdf}, src/frontend/local_optim_contrast_gsl.cpp:
    20-70). f takes (3,) or a (M, 3) batch; on a lane packet, (P, 3) or
    (P, M, 3). ``route`` is the objective's route as objective_route gives
    it (None: ask it; chip_smoke forces either): on the chain df is by
    autograd, and on the card each evaluation is counted in
    cuda_iwe.LAUNCHES["packet_chain"]; K6 (ops/cuda_packet.py) counts its
    own launches, and its f is forward only."""
    route = route or objective_route(packet, cam, blur_sigma, measure)
    if route == "fused":
        return cuda_packet.make_fused_objective(packet, cam, blur_sigma, measure)
    if route != "chain":
        raise ValueError(f"unknown objective route {route!r}")

    def f(omega):
        return -contrast(local_iwe(omega, packet, cam, blur_sigma), measure)

    vg = value_and_grad(f)
    if packet.dts.device.type != "cuda":
        return f, vg
    shape = (packet.dts.shape[-1], cam.height, cam.width)

    def counted(fn, form):
        def evaluate(omega):
            cuda_iwe._launched("packet_chain", form, (omega[..., 0].numel(), *shape))
            return fn(omega)

        return evaluate

    return counted(f, "f"), counted(vg, "vg")
