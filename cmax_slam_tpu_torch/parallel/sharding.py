"""Data-parallel CMax over a device list; counterpart of
cmax_slam_tpu/parallel/sharding.py.

The reference has no distributed execution (SURVEY.md section 2.3). The one
distributed axis that matters is data parallelism over independent packets:
many angular-velocity solves run at once, split across devices, with no
communication in the hot loop. The JAX package expresses that as a ``Mesh``
and ``jax.jit`` shardings under one controller; here a list of
``torch.device`` plays the mesh, and one host thread per shard drives its
device (each solve syncs the host once per step, so one thread could not
keep two devices busy). The results are gathered on the first device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import torch

from ..config import OptimOptions
from ..ops import optim, warp_local
from ..ops.contrast import contrast
from ..utils.device import resolve_device, resolve_devices


def make_mesh(n_devices: int, device) -> List[torch.device]:
    """``n_devices`` entries of ``device``: the list that stands in for a
    mesh of that many chips (``make_mesh(8, "cpu")`` is the CPU tests'
    8-device mesh, ``make_mesh(2, "cuda:0")`` two devices on one card). A
    list of distinct cards is written out: ``["cuda:0", "cuda:1"]``."""
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    return [resolve_device(device)] * n_devices


def map_shards(devices: Sequence[torch.device], fn: Callable, shards: Sequence) -> list:
    """fn(device, shard) for each (device, shard) pair, one host thread per
    pair; results in order. Worker errors re-raise here."""
    if len(devices) == 1:
        return [fn(devices[0], shards[0])]
    with ThreadPoolExecutor(len(devices)) as ex:
        return list(ex.map(fn, devices, shards))


def lane_objective(bearings, dts, weights, cam: warp_local.CameraParams,
                   blur_sigma: float, measure: int):
    """f(omegas) over P packets: (P, 3) -> (P,) and (P, M, 3) -> (P, M);
    each lane is the negative contrast of its own packet's IWE."""
    packet = warp_local.EventPacket(bearings, dts, weights)

    def f(omega):
        return -contrast(warp_local.local_iwe(omega, packet, cam, blur_sigma), measure)

    return f


def cg_body(f, opt: OptimOptions, dim: int = 3):
    """The lane-batched CG iteration for objective f with the options of opt."""
    return optim.make_cg_body(
        warp_local.value_and_grad(f), f, dim=dim,
        line_search_tol=opt.line_search_tol, grad_tol=opt.grad_tol, fun_tol=opt.fun_tol,
        max_fevals_per_linesearch=opt.max_fevals_per_linesearch,
        stagnation_patience=opt.stagnation_patience, initial_step=opt.initial_step,
        ladder=opt.ladder, cg_variant=opt.cg_variant,
        secant_refine_evals=opt.secant_refine_evals)


def batched_packet_solve(
    cam: warp_local.CameraParams,
    blur_sigma: float = 1.0,
    measure: int = 0,
    opt: OptimOptions = OptimOptions(),
):
    """Returns solve(bearings (P,S,3), dts (P,S), weights (P,S), omega0s (P,3))
    -> (omegas (P,3), costs (P,), iters (P,)): P whole CMax solves in
    lockstep on the inputs' device, the unit of data parallelism. Every lane
    runs until its own stop; the loop runs until the slowest lane stops."""

    def solve(bearings, dts, weights, omega0s):
        with torch.no_grad():
            f = lane_objective(bearings, dts, weights, cam, blur_sigma, measure)
            st = optim.cg_init(warp_local.value_and_grad(f), omega0s, opt.initial_step)
            st = optim.cg_run_rounds(cg_body(f, opt), st, opt.max_line_searches,
                                     opt.max_line_searches)
            res = optim.cg_finalize(st, opt.max_line_searches)
        return res.x, res.fun, res.iters

    return solve


def make_dp_cmax_step(
    devices,
    cam: warp_local.CameraParams,
    blur_sigma: float = 1.0,
    measure: int = 0,
    opt: OptimOptions = OptimOptions(),
):
    """The batched solve with the lane axis split over ``devices``: inputs
    with a leading axis divisible by the device count; each device solves
    its contiguous share locally (no communication in the hot loop) and the
    results are gathered on ``devices[0]``."""
    devices = resolve_devices(devices)
    solve = batched_packet_solve(cam, blur_sigma, measure, opt)
    n = len(devices)

    def step(bearings, dts, weights, omega0s):
        P = bearings.shape[0]
        if P % n:
            raise ValueError(f"lane count {P} not divisible by {n} devices")
        shards = list(zip(*(t.chunk(n) for t in (bearings, dts, weights, omega0s))))
        outs = map_shards(devices, lambda dev, sh: solve(*(t.to(dev) for t in sh)), shards)
        home = devices[0]
        return tuple(torch.cat([o[i].to(home) for o in outs]) for i in range(3))

    return step
