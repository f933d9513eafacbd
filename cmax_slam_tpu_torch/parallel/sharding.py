"""Data-parallel CMax over a device list; counterpart of
cmax_slam_tpu/parallel/sharding.py.

The reference has no distributed execution (SURVEY.md section 2.3). The one
distributed axis that matters is data parallelism over independent packets:
many angular-velocity solves run at once, split across devices, with no
communication in the hot loop. The JAX package expresses that as a ``Mesh``
and ``jax.jit`` shardings under one controller; here a list of
``torch.device`` plays the mesh, and one host thread per shard drives its
device. The results are gathered on the first device.

Every lane-batched solve is a device program (``LaneSolver``: the JAX
package's vmapped ``while_loop`` of ``batched_packet_solve`` and the
vmapped ``fori_loop`` rounds of ``track_batched_compacted``), taken from
the module-level pool (ops/program_pool.py): one program per device and
lane shape, leased to one solve or shard at a time, so concurrent shards on
one card get programs of their own and a later call captures nothing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import torch

from ..config import OptimOptions
from ..ops import device_loop, optim, program_pool, warp_local
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


def _cg_options(opt: OptimOptions) -> dict:
    return dict(line_search_tol=opt.line_search_tol, grad_tol=opt.grad_tol,
                fun_tol=opt.fun_tol, max_fevals_per_linesearch=opt.max_fevals_per_linesearch,
                stagnation_patience=opt.stagnation_patience, initial_step=opt.initial_step,
                ladder=opt.ladder, cg_variant=opt.cg_variant,
                secant_refine_evals=opt.secant_refine_evals)


def cg_body(f, opt: OptimOptions, dim: int = 3):
    """The lane-batched CG iteration for objective f with the options of
    opt, its gates read on the host (optim.make_cg_body): the eager
    reference of LaneSolver's programs."""
    return optim.make_cg_body(warp_local.value_and_grad(f), f, dim=dim, **_cg_options(opt))


class LaneSolver:
    """P packets of S events solved as lanes of one device program over
    static buffers (``bearings``, ``dts``, ``weights``; optim.LaneCG with
    ``max_iters`` = max_line_searches, no trust radius). With ``rounds``
    the program resumes the CG state loaded into ``cg.s`` for up to
    ``round_iters`` line searches (JAX's ``_run_round``: a fixed-trip
    masked ``fori_loop``, here stopping early once no lane moves) and its
    ``out`` is each lane's status and line-search count, what the host
    reads to compact the lanes; without, it is a whole solve from ``x0``
    (JAX's vmapped ``while_loop``) and ``out`` is x, f and the count."""

    def __init__(self, P: int, S: int, cam: warp_local.CameraParams, blur_sigma: float,
                 measure: int, opt: OptimOptions, device, rounds: bool):
        dev = torch.device(device)

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.bearings, self.dts, self.weights = buf(P, S, 3), buf(P, S), buf(P, S)
        f = lane_objective(self.bearings, self.dts, self.weights, cam, blur_sigma, measure)
        self.cg = cg = optim.LaneCG(warp_local.value_and_grad(f), f, P, 3, dev,
                                    max_iters=opt.max_line_searches, **_cg_options(opt))
        self.round_iters = buf(1, dtype=torch.int32)
        self.x0 = buf(P, 3)

        def finish():
            s = cg.s
            vals = ([s.status.float(), s.it.float()] if rounds
                    else [s.x.reshape(-1), s.f, s.it.float()])
            self.program.out.copy_(torch.cat(vals))

        def build(b):
            if rounds:
                cg.rounds(b, self.round_iters)
            else:
                cg.solve(b, self.x0)
            b.seg(finish)

        self.program = device_loop.Program(build, (2 if rounds else 5) * P, dev,
                                           name="batched.round" if rounds else "batched.solve")

    def load(self, packets, sel=None) -> None:
        """The packets ((P', S, 3), (P', S), (P', S) on the program's device)
        into the buffers: rows ``sel`` of them (an int64 device index), else
        all of them."""
        for buf, t in zip((self.bearings, self.dts, self.weights), packets):
            if sel is None:
                buf.copy_(t)
            else:
                torch.index_select(t, 0, sel, out=buf)


def lane_solver(owner, cam: warp_local.CameraParams, blur_sigma: float, measure: int,
                opt: OptimOptions, device, P: int, S: int, rounds: bool) -> LaneSolver:
    """The LaneSolver of this shape from the pool entry ``owner`` leases
    for these options on ``device``."""
    device = torch.device(device)
    entry = program_pool.lease(("lanes", program_pool.device_key(device), cam, float(blur_sigma),
                                int(measure), opt), owner)
    return entry.program((P, S, rounds),
                         lambda: LaneSolver(P, S, cam, blur_sigma, measure, opt, device, rounds))


def batched_packet_solve(
    cam: warp_local.CameraParams,
    blur_sigma: float = 1.0,
    measure: int = 0,
    opt: OptimOptions = OptimOptions(),
):
    """Returns solve(bearings (P,S,3), dts (P,S), weights (P,S), omega0s (P,3))
    -> (omegas (P,3), costs (P,), iters (P,)): P whole CMax solves in
    lockstep on the inputs' device, the unit of data parallelism. Every lane
    runs until its own stop; the loop runs until the slowest lane stops.
    Each call is one launch of a pooled LaneSolver program (a WHILE loop
    on the device) and one host wait for it; the results stay on the
    device."""

    def solve(bearings, dts, weights, omega0s):
        P, S = dts.shape
        owner = program_pool.Owner()
        prog = lane_solver(owner, cam, blur_sigma, measure, opt, bearings.device, P, S,
                           rounds=False)
        with torch.no_grad():
            prog.load((bearings, dts, weights))
            prog.x0.copy_(omega0s)
            prog.program.run().fetch()
            s = prog.cg.s
            return s.x.clone(), s.f.clone(), s.it.clone()

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
