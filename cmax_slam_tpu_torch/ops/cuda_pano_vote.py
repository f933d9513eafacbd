"""Hand-written CUDA kernels of the back-end window objective's event chain
and their autograd wrapper: K4 ``pano_vote_fwd`` and K5 ``pano_vote_bwd``.

From the (M, K, 3) knot increments to the (M, H, W) images of warped events
in one kernel, and from dL/dimage back to dL/dincrements in another: the
masked knot increments (spline.apply_masked_increments), the spline's
rotation per event batch (spline.evaluate_rotmats, order 2 or 4), the
rotation and equirectangular projection of every event
(warp_pano.warp_to_pano), the crop origin (warp_pano.make_crop_objective)
and the bilinear vote with the Pallas drop rule. The JAX package's
counterparts are its warp_to_pano, make_pano_objective and
make_crop_objective (cmax_slam_tpu/ops/warp_pano.py), which XLA fuses
around the Pallas vote (pallas_iwe._fwd_impl, _vjp_bwd). The source, with
the design notes, is csrc/pano_vote.cu; the plain version is
warp_pano.pano_vote_plain, and ops/warp_pano.pano_vote routes every CUDA
tensor here.

A block of either kernel takes a run of consecutive events, a thread each
(``fwd_events``, ``bwd_events``), across batch boundaries, and touches at
most MAX_BATCHES batches. K5 is two launches: the blocks' partials, then
their sum in a fixed order (deterministic).

The per-window constants, each batch's spline segment (int32) and blending
coefficients (spline.segment_basis), come in as operands, and so does the
crop origin, a (2,) device tensor (x0, y0) read by the kernels at every
launch: a captured window program rewrites it per window, so it is never
read on the host. The wrapper allocates through torch (the images, K5's
per-block partials) and reads nothing on the host, so it captures into
device programs (ops/device_loop.py).

The library is built at first use with nvcc into ``_build/`` (ops/nvcc.py),
keyed by a hash of the source and flags, with -fmad=false: the forward
chain rounds as the plain version's separate elementwise ops do, so that
the coordinates, and every floor and drop decision, match it on the card.
Nothing is imported or compiled when this module is imported. There is no
fallback: a build or launch that fails raises.

Launches are counted in cuda_iwe.LAUNCHES (``"pano_fwd"``, ``"pano_bwd"``,
and by spline order ``"pano_fwd_o2"``, ``"pano_fwd_o4"``, ...), per
execution inside captured graphs, through cuda_iwe's recorder.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_iwe, nvcc

SOURCE = nvcc.CSRC / "pano_vote.cu"
ORDERS = (2, 4)
MAX_KNOTS = 128            # kMaxKnots in csrc/pano_vote.cu
MAX_BATCHES = 16           # kMaxBatches: batches a block touches
FWD_EVENTS = (512, 256)    # K4: events per block with one wave of 512 or more
BWD_EVENTS = 192           # K5: events per block
BWD_EVENTS_MAX = 288       # 32 x kEventWarpsMax

_loaded: dict = {}
_lock = threading.Lock()


class PanoOperands(NamedTuple):
    """What K4 and K5 read: the increments (M, K, 3), the window's knots
    (K, 4) and free mask (K,), each batch's segment (B,) int32 and blending
    coefficients (B, order), the bearings (3, N) and weights (N,) with
    N = B x events per batch, the crop origin (2,) (x0, y0) or None for the
    full panorama, the spline order and the panorama's (cx, cy, fx, fy) as
    float32 values."""

    delta: torch.Tensor
    knots: torch.Tensor
    free: torch.Tensor
    seg: torch.Tensor
    coeff: torch.Tensor
    bearings: torch.Tensor
    weights: torch.Tensor
    origin: Optional[torch.Tensor]
    order: int
    geometry: tuple


def nvcc_flags() -> tuple:
    return (*nvcc.NVCC_FLAGS, "-fmad=false")


def library_path():
    return nvcc.library_path(SOURCE, nvcc_flags(), "libpano_vote")


def build_job() -> tuple:
    """(source, flags, library) for nvcc.compile_all."""
    return SOURCE, nvcc_flags(), library_path()


def build():
    """Compile csrc/pano_vote.cu (once per source hash and flags) and load
    it; returns the ctypes library. Raises with nvcc's output if the build
    fails."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        import ctypes

        nvcc.compile_all([build_job()])
        lib = ctypes.CDLL(str(library_path()))
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        common = [p, p, p, p, p, p, p, p, i64, i32, i64, i32, i32, f32, f32, f32, f32, i32, i32,
                  i32]
        lib.iwe_pano_vote_fwd.argtypes = [*common, p, p]
        lib.iwe_pano_vote_fwd.restype = i32
        lib.iwe_pano_vote_bwd.argtypes = [*common, p, p, p, p]
        lib.iwe_pano_vote_bwd.restype = i32
        lib.iwe_pano_error_string.argtypes = [i32]
        lib.iwe_pano_error_string.restype = ctypes.c_char_p
        _loaded["lib"] = lib
        return lib


def geometry(pano) -> tuple:
    """The panorama's (cx, cy, fx, fy) as the plain version's elementwise
    ops use them: Python floats rounded to float32."""
    return tuple(float(np.float32(v)) for v in (pano.cx, pano.cy, pano.fx, pano.fy))


def prepare(drotv: torch.Tensor, win, basis, pano, order: int,
            origin: Optional[torch.Tensor]) -> PanoOperands:
    """The kernels' operands from the objective's: (..., K, 3) increments
    as (M, K, 3) (M = 1 for one candidate), every operand contiguous and of
    the kernels' type. On operands already in that form (the window
    programs' buffers) nothing is copied, so nothing is added to a
    captured graph."""
    K = win.knots.shape[-2]
    seg, coeff = basis
    return PanoOperands(
        delta=drotv.reshape(-1, K, 3).float().contiguous(),
        knots=win.knots.float().contiguous(), free=win.free_mask.float().contiguous(),
        seg=seg.to(torch.int32).contiguous(), coeff=coeff.float().contiguous(),
        bearings=win.bearings.float().contiguous(), weights=win.weights.float().contiguous(),
        origin=None if origin is None else origin.float().contiguous(), order=order,
        geometry=geometry(pano))


def check_operands(ops: PanoOperands, device_type: str = "cuda") -> tuple:
    """Validates the operands as the kernels read them; returns (M, K, B,
    events per batch)."""
    dev = ops.delta.device
    tensors = [t for t in ops[:8] if t is not None]
    if any(t.device != dev or t.device.type != device_type or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"operands must be contiguous tensors on one {device_type} device")
    if ops.order not in ORDERS:
        raise ValueError(f"spline order must be one of {ORDERS}, got {ops.order}")
    M, K, _ = ops.delta.shape
    B = ops.seg.shape[0]
    N = ops.weights.shape[0]
    floats = [ops.delta, ops.knots, ops.free, ops.coeff, ops.bearings, ops.weights]
    if ops.origin is not None:
        floats.append(ops.origin)
    if any(t.dtype != torch.float32 for t in floats) or ops.seg.dtype != torch.int32:
        raise ValueError("operands must be float32, segments int32")
    if not (ops.delta.shape[2] == 3 and ops.knots.shape == (K, 4) and ops.free.shape == (K,)
            and ops.coeff.shape == (B, ops.order) and ops.bearings.shape == (3, N)
            and (ops.origin is None or ops.origin.shape == (2,))):
        raise ValueError("operand shapes disagree: delta (M, K, 3), knots (K, 4), free (K,), "
                         "coeff (B, order), bearings (3, N), origin (2,)")
    if B == 0 or N % B:
        raise ValueError(f"{N} events do not split into {B} batches")
    if not (ops.order <= K <= MAX_KNOTS) or M > 65535:
        raise ValueError(f"K = {K} knots (at least the order, at most {MAX_KNOTS}) and at most "
                         f"65535 candidates (M = {M})")
    if ops.knots.data_ptr() % 16:
        raise ValueError("knots are read as 16-byte quaternions: 16-byte alignment needed")
    return M, K, B, N // B


def events_cap(ebs: int) -> int:
    """The most events a block takes for batches of ``ebs`` events: it
    touches at most (events + ebs - 2) // ebs + 1 batches, and at most
    MAX_BATCHES of them."""
    return (MAX_BATCHES - 1) * ebs + 1


def fwd_events(ebs: int, events: int, sm_count: int) -> int:
    """K4's events per block for ``events`` (M x N) in all on a card of
    ``sm_count`` SMs: 512 while blocks of 512 (two per SM) take them in one
    wave, else 256 (tools/tune_pano_vote.py)."""
    one_wave = events <= 2 * sm_count * FWD_EVENTS[0]
    return min(FWD_EVENTS[0] if one_wave else FWD_EVENTS[1], events_cap(ebs))


def bwd_events(ebs: int) -> int:
    """K5's events per block (tools/tune_pano_vote.py)."""
    return min(BWD_EVENTS, events_cap(ebs))


def _args(ops: PanoOperands, M: int, K: int, B: int, ebs: int, height: int, width: int,
          per_block: int) -> list:
    return [ops.delta.data_ptr(), ops.knots.data_ptr(), ops.free.data_ptr(),
            ops.seg.data_ptr(), ops.coeff.data_ptr(), ops.bearings.data_ptr(),
            ops.weights.data_ptr(), None if ops.origin is None else ops.origin.data_ptr(),
            M, K, B, ebs, ops.order, *ops.geometry, height, width, per_block]


def _check(name: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.iwe_pano_error_string(err).decode()}")


def launch_fwd(ops: PanoOperands, out: torch.Tensor, height: int, width: int,
               per_block: Optional[int] = None) -> None:
    """One raw K4 launch into ``out`` ((M, height, width), zeroed by the
    caller), on the current stream, with ``per_block`` events per block
    (None: fwd_events'); not counted and allocating nothing (chip_smoke
    times the kernel with it)."""
    M, K, B, ebs = check_operands(ops)
    if per_block is None:
        per_block = fwd_events(ebs, M * B * ebs, cuda_iwe.device_attrs(ops.delta.device)[0])
    lib = build()
    with torch.cuda.device(ops.delta.device):
        stream = torch.cuda.current_stream(ops.delta.device).cuda_stream
        err = lib.iwe_pano_vote_fwd(*_args(ops, M, K, B, ebs, height, width, per_block),
                                    out.data_ptr(), stream)
    _check("iwe_pano_vote_fwd launch", err, lib)


def bwd_scratch(ops: PanoOperands, per_block: Optional[int] = None) -> torch.Tensor:
    """K5's scratch for these operands: the partials of its blocks of
    ``per_block`` events (None: bwd_events'), (M, blocks, 3K)."""
    M, K, _ = ops.delta.shape
    N = ops.weights.shape[0]
    per_block = per_block or bwd_events(N // ops.seg.shape[0])
    return torch.empty((M, -(-N // per_block), 3 * K), dtype=torch.float32,
                       device=ops.delta.device)


def launch_bwd(ops: PanoOperands, g: torch.Tensor, part: torch.Tensor, out: torch.Tensor,
               per_block: Optional[int] = None) -> None:
    """One raw K5 launch (its two kernels) with ``per_block`` events per
    block (None: bwd_events'): dL/ddelta into ``out`` (M, K, 3) from ``g``
    (M, H, W), with ``part`` from bwd_scratch(ops, per_block), on the
    current stream; not counted and allocating nothing."""
    M, K, B, ebs = check_operands(ops)
    if (g.device != ops.delta.device or g.dtype != torch.float32 or not g.is_contiguous()
            or g.dim() != 3 or g.shape[0] != M):
        raise ValueError("g must be a contiguous float32 (M, H, W) tensor beside the operands")
    per_block = per_block or bwd_events(ebs)
    if part.shape != (M, -(-B * ebs // per_block), 3 * K) or not part.is_contiguous():
        raise ValueError("part does not match the launch: use bwd_scratch(ops, per_block)")
    lib = build()
    with torch.cuda.device(ops.delta.device):
        stream = torch.cuda.current_stream(ops.delta.device).cuda_stream
        err = lib.iwe_pano_vote_bwd(
            *_args(ops, M, K, B, ebs, g.shape[1], g.shape[2], per_block), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), stream)
    _check("iwe_pano_vote_bwd launch", err, lib)


def pano_vote_fwd(ops: PanoOperands, height: int, width: int) -> torch.Tensor:
    """K4: the (M, height, width) images of the window's events warped by
    each candidate's increments."""
    M = ops.delta.shape[0]
    out = torch.zeros((M, height, width), dtype=torch.float32, device=ops.delta.device)
    launch_fwd(ops, out, height, width)
    cuda_iwe._launched("pano_fwd", f"o{ops.order}",
                       (M, ops.weights.shape[0], height, width))
    return out


def pano_vote_bwd(ops: PanoOperands, g: torch.Tensor) -> torch.Tensor:
    """K5: dL/ddelta (M, K, 3) from g = dL/dimage (M, H, W)."""
    part = bwd_scratch(ops)
    out = torch.empty_like(ops.delta)
    launch_bwd(ops, g, part, out)
    cuda_iwe._launched("pano_bwd", f"o{ops.order}",
                       (g.shape[0], ops.weights.shape[0], g.shape[1], g.shape[2]))
    return out


class PanoVote(torch.autograd.Function):
    """K4 forward, K5 backward; only the increments get a gradient."""

    @staticmethod
    def forward(ctx, delta, knots, free, seg, coeff, bearings, weights, origin, order, geometry,
                height, width):
        ops = PanoOperands(delta, knots, free, seg, coeff, bearings, weights, origin, order,
                           geometry)
        ctx.save_for_backward(delta, knots, free, seg, coeff, bearings, weights, origin)
        ctx.order, ctx.geometry = order, geometry
        return pano_vote_fwd(ops, height, width)

    @staticmethod
    def backward(ctx, g):
        ddelta = None
        if ctx.needs_input_grad[0]:
            ops = PanoOperands(*ctx.saved_tensors, ctx.order, ctx.geometry)
            ddelta = pano_vote_bwd(ops, g.contiguous())
        return (ddelta, *(None,) * 11)


def pano_vote_cuda(drotv: torch.Tensor, win, basis, pano, order: int, hw: tuple,
                   origin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., K, 3) increments on the card -> (..., H, W) images, through K4
    (and K5 for the gradient)."""
    lead = drotv.shape[:-2]
    ops = prepare(drotv, win, basis, pano, order, origin)
    return PanoVote.apply(*ops, *hw).reshape(*lead, *hw)
