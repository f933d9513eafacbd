"""K6, the front-end's packet objective as one hand-written CUDA kernel:
warp, vote, blur, contrast and the gradient of each candidate's image in
one cluster of blocks, each holding a run of its rows (csrc/packet.cu, with
the design notes).

``plan_packet_vg`` picks the objective's route by shape alone: "fused" (K6)
where a block's opt-in shared memory holds its two buffers (its rows and
their halos), each block of the cluster has rows enough for its halos, the
measure is variance or mean square and the blur is the 9-tap Gaussian K6
compiles in; else "chain", the composed objective of
ops/warp_local (warp_events, the vote's K1/K2, the blur's band matmuls, the
measure, autograd). ``make_fused_objective`` builds the pair (f,
value_and_grad) of the fused route; ops/warp_local.make_local_objective
takes it where the planner says so.

K6 reads the blur's band matrices (ops/blur._blur_matrix, the float32
matrices the chain multiplies by) as tables of their nine diagonals, and
their transposes for the gradient, uploaded when the objective is built.

The library is built at first use with nvcc into ``_build/``
(ops/nvcc.py), keyed by a hash of the source and flags; nothing is imported
or compiled when this module is imported, and nothing is built for an
objective on the CPU. There is no fallback: a build or launch that fails
raises.

Launches are counted in cuda_iwe.LAUNCHES as kernel ``"packet"`` with the
forms ``"packet_vg"`` (value and gradient) and ``"packet_f"`` (value),
per execution inside captured graphs, through cuda_iwe's recorder; the
chain's evaluations of an objective on the card are counted beside them as
``"packet_chain"`` (``"packet_chain_vg"``, ``"packet_chain_f"``), one per
evaluation (each is a chain of launches), so that the share of evaluations
K6 serves is ``packet / (packet + packet_chain)``.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..config import MEAN_SQUARE_CONTRAST, VARIANCE_CONTRAST
from ..utils.device import to_device
from . import blur, cuda_iwe, nvcc

SOURCE = nvcc.CSRC / "packet.cu"
THREADS = 1024   # kThreads in csrc/packet.cu
CLUSTER = 8      # kCluster: the blocks of one image, each a run of its rows
HALF = 4         # kHalf: the rows of halo on each side of a block's, and the zero columns
TAPS = 2 * HALF + 1  # kTaps: the blur K6 compiles in (sigma about 1, OpenCV's automatic size)
SLOTS = 5        # kSlots: the cluster's sums
WARPS = THREADS // 32
MEASURES = (VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST)  # kMeasure 0 and 1

_loaded: dict = {}
_lock = threading.Lock()
_smem_ready: set = set()


class PacketPlan(NamedTuple):
    """The route of one packet objective ("fused" or "chain"), the rows of
    each of a K6 block's two buffers (its most rows and both halos), the
    events a block can list (those with taps in its rows), and a block's
    dynamic shared memory (all 0 for the chain)."""

    route: str
    buf_rows: int
    cap: int
    smem_bytes: int


def plan_packet_vg(b: int, n: int, height: int, width: int, sigma: float, measure: int,
                   smem_optin: int) -> PacketPlan:
    """The route of a packet objective over b candidates of n events on a
    height x width image, blurred with ``sigma`` under ``measure``, on a
    card with ``smem_optin`` bytes of shared memory per block: "fused" (K6,
    a cluster of CLUSTER blocks per candidate, each holding a run of rows)
    where a block's buffers fit its shared memory, every block has at least
    HALF rows, the measure is variance or mean square and the blur is the
    9-tap Gaussian; else "chain". ``b`` and ``n`` do not move the choice
    (any count of candidates is as many clusters, any count of events is
    streamed); the lists of a block's events (a list a warp) take what
    shared memory is left, up to the events a warp warps (past it the warp
    votes at once and the block's gather reads every event again)."""
    pitch = width + 2 * HALF
    buf_rows = -(-height // CLUSTER) + 2 * HALF
    while buf_rows * pitch % 4:
        buf_rows += 1
    fixed = 4 * (2 * buf_rows * pitch + SLOTS * CLUSTER + 3 * WARPS + 3 + 4 * TAPS + WARPS)
    fused = (measure in MEASURES and sigma > 0 and blur.opencv_ksize(sigma) == TAPS
             and height >= HALF * CLUSTER and width >= TAPS
             and blur.blur_path(height, width) == "bands" and fixed <= smem_optin
             and 1 <= b and b * CLUSTER < 1 << 31 and n < 1 << 31)
    if not fused:
        return PacketPlan("chain", 0, 0, 0)
    # an index, a pixel and a weight each; as many as a warp warps (its 32
    # lanes' events, one in THREADS each)
    cap = min(32 * -(-n // THREADS), (smem_optin - fixed) // (16 * WARPS)) * WARPS
    return PacketPlan("fused", buf_rows, cap, fixed + 16 * cap)


def band_table(mat: np.ndarray) -> tuple:
    """A band matrix of half-width TAPS // 2 as K6 reads it: (rows, TAPS)
    with row i holding mat[i, i + d - TAPS // 2] (0 outside the matrix),
    and the margin, the rows at each end that are not the interior taps (a
    folded reflection)."""
    half = TAPS // 2
    n = mat.shape[0]
    tab = np.zeros((n, TAPS), np.float32)
    for d in range(TAPS):
        lo, hi = max(0, half - d), min(n, n + half - d)
        rows = np.arange(lo, hi)
        tab[rows, d] = mat[rows, rows + d - half]
    mid = tab[n // 2]
    plain = np.all(tab == mid, axis=1)
    margin = 0
    while margin < n // 2 and not (plain[margin] and plain[n - 1 - margin]):
        margin += 1
    if not plain[margin:n - margin].all():
        raise ValueError("the band's interior rows are not one set of taps")
    return tab, margin


@functools.lru_cache(maxsize=16)
def _tables_host(height: int, width: int, sigma: float) -> tuple:
    """B_h, B_h^T, B_w, B_w^T as tables, one array, and their margins."""
    mh, mw = blur._blur_matrix(height, sigma), blur._blur_matrix(width, sigma)
    parts = [band_table(m) for m in (mh, mh.T, mw, mw.T)]
    return (np.concatenate([t for t, _ in parts]).ravel(), tuple(m for _, m in parts))


@functools.lru_cache(maxsize=16)
def band_tables(height: int, width: int, sigma: float, device: str) -> tuple:
    """The tables resident on ``device`` (uploaded once per shape) and
    their margins."""
    host, margins = _tables_host(height, width, sigma)
    return to_device(host, device), margins


def nvcc_flags() -> tuple:
    return nvcc.NVCC_FLAGS


def library_path():
    return nvcc.library_path(SOURCE, nvcc_flags(), "libpacket")


def build_job() -> tuple:
    """(source, flags, library) for nvcc.compile_all."""
    return SOURCE, nvcc_flags(), library_path()


def build():
    """Compile csrc/packet.cu (once per source hash and flags) and load it;
    returns the ctypes library. Raises with nvcc's output if the build
    fails."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        import ctypes

        nvcc.compile_all([build_job()])
        lib = ctypes.CDLL(str(library_path()))
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.packet_allow_smem.argtypes = [i32]
        lib.packet_allow_smem.restype = i32
        lib.packet_objective.argtypes = [i32, i32, p, p, p, i64, p, i64, f32, f32, f32, f32,
                                         i32, i32, p, i32, i32, i32, i32, i32, i32, p, p, i32, p]
        lib.packet_objective.restype = i32
        lib.packet_error_string.argtypes = [i32]
        lib.packet_error_string.restype = ctypes.c_char_p
        _loaded["lib"] = lib
        return lib


def _check(name: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.packet_error_string(err).decode()}")


def allow_smem(device: torch.device) -> None:
    """Once per device: let K6 take the opt-in shared memory
    (cudaFuncSetAttribute, needed above 48 KB)."""
    lib = build()
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
        smem = cuda_iwe.device_attrs(device)[1]
        with _lock:
            if index not in _smem_ready:
                _check("cudaFuncSetAttribute", lib.packet_allow_smem(smem), lib)
                _smem_ready.add(index)


def launch(plan: PacketPlan, measure: int, packet, omega: torch.Tensor, cam,
           tables: torch.Tensor, margins: tuple, value: torch.Tensor,
           grad: torch.Tensor | None) -> None:
    """One raw K6 launch over the (b, 3) candidates ``omega`` of the
    packet's contiguous float32 (bearings, dts, weights) into ``value``
    (b,) and, given, ``grad`` (b, 3) (the "vg" form; None: "f"), on the
    current stream; not counted and allocating nothing."""
    bearings, dts, weights = packet
    lib = build()
    with torch.cuda.device(omega.device):
        stream = torch.cuda.current_stream(omega.device).cuda_stream
        err = lib.packet_objective(
            int(grad is not None), MEASURES.index(measure), bearings.data_ptr(), dts.data_ptr(),
            weights.data_ptr(), dts.shape[0], omega.data_ptr(), omega.shape[0],
            *(float(np.float32(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy)), cam.height,
            cam.width, tables.data_ptr(), *margins, plan.buf_rows, plan.cap, value.data_ptr(),
            None if grad is None else grad.data_ptr(), plan.smem_bytes, stream)
    _check("packet_objective launch", err, lib)


def make_fused_objective(packet, cam, blur_sigma: float, measure: int):
    """(f, value_and_grad) of one packet's negative contrast through K6:
    f takes (..., 3) candidates and gives (...) values, one cluster each
    (forward only: the "f" form); value_and_grad gives the values and their
    (..., 3) gradients (the "vg" form). Both read the packet's own tensors
    at every call (a device program rewrites them between evaluations).
    Raises where the planner does not take K6."""
    dev = packet.dts.device
    n, H, W = packet.dts.shape[-1], cam.height, cam.width
    if dev.type != "cuda" or packet.dts.dim() != 1:
        raise ValueError("K6 takes one packet's (N,) events on a CUDA device")
    plan = plan_packet_vg(1, n, H, W, blur_sigma, measure, cuda_iwe.device_attrs(dev)[1])
    if plan.route != "fused":
        raise ValueError(f"K6 does not take a {H}x{W} packet objective of sigma {blur_sigma} "
                         f"and measure {measure}")
    allow_smem(dev)
    tables, margins = band_tables(H, W, float(blur_sigma), str(dev))

    def run(omega: torch.Tensor, with_grad: bool):
        x = omega.detach().reshape(-1, 3).float().contiguous()
        ops = tuple(t.float().contiguous() for t in packet)
        b = x.shape[0]
        value = torch.empty(b, dtype=torch.float32, device=dev)
        grad = torch.empty((b, 3), dtype=torch.float32, device=dev) if with_grad else None
        launch(plan, measure, ops, x, cam, tables, margins, value, grad)
        cuda_iwe._launched("packet", "vg" if with_grad else "f", (b, n, H, W))
        lead = omega.shape[:-1]
        return value.reshape(lead), None if grad is None else grad.reshape(*lead, 3)

    def f(omega):
        return run(omega, False)[0]

    def value_and_grad(omega):
        return run(omega, True)

    return f, value_and_grad
