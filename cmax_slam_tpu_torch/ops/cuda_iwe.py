"""Hand-written CUDA vote kernels and their autograd wrapper; counterpart of
cmax_slam_tpu/ops/pallas_iwe.py.

K1 ``vote_fwd`` replaces the Pallas forward vote (pallas_iwe._fwd_impl,
kernel _fwd_kernel); K2 ``vote_bwd`` replaces the Pallas VJP
(pallas_iwe._vjp_bwd, kernels _bwd_kernel_lanes and _bwd_kernel). The
source, with the design notes, is csrc/iwe.cu. ``Vote`` wraps the pair as
one ``torch.autograd.Function``; ops/scatter.vote routes every CUDA tensor
here.

K1 has two variants, chosen by shape alone in ``plan_vote_fwd``:
- P, privatized bands: one block per (image, band of whole rows) sums the
  band in shared memory and writes it out with plain stores; no global
  atomics, no memset. Bound by the output write. Taken from
  ``P_MIN_IMAGES`` images per launch (the lane-batched tracker's launches),
  in bands thinned to fill one wave of blocks where the images are few.
- G, one thread per event and four global atomics into a zeroed image,
  bound by atomic throughput to L2. Everything else: narrow launches, where
  the launch dominates, and images too wide for a band plan worth having.
The thresholds are constants below, set by tools/tune_vote_fwd.py on an
H100 (PERF.md).

K2 writes dpx and dpy, and dw only when autograd asks for the weights'
gradient (no path does), and has two variants, chosen by shape alone in
``plan_vote_bwd``:
- S, staged image: one block per image copies the whole upstream gradient
  image into shared memory by bulk copies (TMA), streams the image's events
  with 16-byte loads and gathers the taps there. Bound by bytes (g and the
  events read once). Taken from ``S_MIN_IMAGES`` images per launch (the
  lane-batched tracker's gradients) of images that fit one block's shared
  memory; images too large for it are never staged in bands (they lost to
  G on every shape timed).
- G, global gathers: one thread per event (load, floor, early exit for a
  dropped event, four gathers, stores) in blocks of ``G_BWD_THREADS``, a
  compile-time constant. Bound by the SMs' throughput for scattered reads,
  and for narrow launches by the launch and that one chain. Fewer images
  (one packet, one back-end crop) and images too large to stage.
The constants are set by tools/tune_vote_bwd.py on an H100 (PERF.md).

K3 ``vote_jvp`` is the vote's forward-mode derivative, which the JAX
package gets from forward mode through its XLA scatter vote
(ops/scatter.py's bilinear_accumulate_scatter inside warp_pano's
derivative_images): T tangent images from coordinate tangents, the
floor-parametrized derivatives of the four taps that K2 differentiates, by
global atomics into a zeroed output. A thread takes ``JVP_ITEMS`` events,
tests each once and loops over a chunk of ``JVP_TANGENTS`` tangent images; a
block whose warps find lanes on one floor pixel sorts its events by pixel
and adds each warp's run of equal pixels once ("S", sorted: a window's
events pile on its landmarks).
``Vote.jvp`` sends coordinate tangents to it and a weight tangent to K1.

The kernels read each operand as a compact (B / g, N) array, flat image b
reading row b / g, so broadcast weights and coordinates are not copied per
image (``compact_rows``); K2 writes (B, N) gradients, summed over each
shared operand's row group by ``Vote.backward`` (``sum_rows``).

The library is built at first use with nvcc into ``_build/`` beside the
package, keyed by a hash of the source and flags, and loaded with ctypes.
Nothing is imported or compiled when this module is imported. There is no
fallback: a build or launch that fails raises, and no variant stands in for
another.

``LAUNCHES`` counts executed kernel launches, so a run can show that its
votes went through the kernels: ``"fwd"`` is every K1 launch and
``"fwd_P"``, ``"fwd_G"`` split it by variant; ``"bwd"``, ``"bwd_S"`` and
``"bwd_G"`` do the same for K2, ``"jvp"`` and ``"jvp_S"`` for K3, and
``"packet"`` with ``"packet_vg"``, ``"packet_f"`` for K6 (ops/cuda_packet.py);
``"packet_chain"`` and its forms count the evaluations of a packet objective
on the card that take the chain instead (ops/warp_local.py), one per
evaluation. A wrapper counts a launch where it makes it, and nowhere else.
A launch made while its stream is captured into a CUDA graph
(ops/device_loop.py) runs only when the graph does, perhaps many times: the
wrapper hands it to the recorder that ``recording`` installs, and the graph
adds it to the counts once for every time the device ran it. ``GRAPH_LAUNCHES`` is the part of them that ran
inside graphs. ``SHAPE_LAUNCHES``, when set to a dict, also counts launches
by (kernel, variant, images, events, height, width). The build, the counts
and the per-device set-up are guarded by a lock: the multi-device modes
drive votes from several host threads.
"""

from __future__ import annotations

import contextlib
import math
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from . import nvcc

LAUNCHES = {"fwd": 0, "fwd_P": 0, "fwd_G": 0, "bwd": 0, "bwd_S": 0, "bwd_G": 0,
            "jvp": 0, "jvp_S": 0,
            # K4 and K5 (ops/cuda_pano_vote.py), by spline order
            "pano_fwd": 0, "pano_fwd_o2": 0, "pano_fwd_o4": 0,
            "pano_bwd": 0, "pano_bwd_o2": 0, "pano_bwd_o4": 0,
            # K6 (ops/cuda_packet.py), by form, and beside it the chain's
            # evaluations of a packet objective on the card (not launches:
            # each is the chain's launches), by form
            "packet": 0, "packet_vg": 0, "packet_f": 0,
            "packet_chain": 0, "packet_chain_vg": 0, "packet_chain_f": 0}
GRAPH_LAUNCHES = dict.fromkeys(LAUNCHES, 0)  # the part of LAUNCHES run inside CUDA graphs
SHAPE_LAUNCHES: dict | None = None
_recorder: list | None = None  # launches captured into the graph being built (one at a
                               # time; autograd runs a backward on a thread of its own)

SOURCE = nvcc.CSRC / "iwe.cu"
BUILD_DIR = nvcc.BUILD_DIR

# K1 planner constants (tools/tune_vote_fwd.py on an H100, PERF.md).
P_MAX_BANDS = 4       # a band plan re-reads every event once per band: G beyond
                      # (10 also beat G at 24 images, where no path launches; PERF.md)
P_MIN_IMAGES = 24     # images per launch from which P beats G
G_THREADS = 256       # kThreadsG in csrc/iwe.cu

# K2 constants (tools/tune_vote_bwd.py on an H100, PERF.md).
S_MIN_IMAGES = 48     # images per launch from which S beats G (G at 32)
G_BWD_THREADS = 128   # G's block, compiled in (IWE_BWD_G_THREADS): within 4%
                      # of the best of 32-256 at every shape timed
S_BARRIER_BYTES = 16  # kBarrierBytes in csrc/iwe.cu

# K3 constants, compiled in (IWE_JVP_ITEMS, IWE_JVP_TANGENTS): events a
# thread (a block sorts 256 times as many) and tangent images per chunk (a
# block row of the grid each), the fastest of 2-8 events and 2-5 tangents on
# a phase-4 window's derivative images (tools/tune_vote_jvp.py, PERF.md).
JVP_ITEMS = 4
JVP_TANGENTS = 4

VARIANTS = ("G", "P")      # K1; index = the kernel's variant code
BWD_VARIANTS = ("G", "S")  # K2; likewise

_loaded: dict = {}      # nvcc_flags() -> the library built with them, once loaded
_lock = threading.Lock()
_attrs: dict = {}       # device index -> (SM count, opt-in shared bytes per block)
_smem_ready: set = set()  # (library, device index) whose shared-memory kernels may
                          # take the opt-in bytes


class VotePlan(NamedTuple):
    """How one K1 launch covers its images: the variant, rows per band, the
    band count and the dynamic shared memory of a block (all 0 for G)."""

    variant: str
    rows: int
    bands: int
    smem_bytes: int


class BwdPlan(NamedTuple):
    """How one K2 launch covers its events: the variant and the dynamic
    shared memory of a block (S: the barrier and one image; 0 for G, a
    thread per event)."""

    variant: str
    smem_bytes: int


def band_rows(height: int, width: int, cap_bytes: int, min_bands: int = 1):
    """(rows per band, bands): at least ``min_bands`` bands of whole rows of
    at most cap_bytes of float32, as even as the row count allows and none
    empty; None if not even one row fits."""
    cap = cap_bytes // (4 * width)
    if cap < 1:
        return None
    rows = -(-height // max(min_bands, -(-height // cap)))
    return rows, -(-height // rows)


def plan_vote_fwd(b: int, n: int, height: int, width: int, sm_count: int, smem_optin: int,
                  variant: str | None = None) -> VotePlan:
    """The K1 variant and its launch shape for b images of height x width
    from n events each, on a card with ``sm_count`` SMs and ``smem_optin``
    bytes of shared memory per block. ``variant`` forces one (chip_smoke's
    checks); nothing on the main path passes it.

    P from P_MIN_IMAGES images up, its bands cut thinner (up to P_MAX_BANDS)
    while images x bands still fit one wave of blocks (one per SM), unless
    the tallest bands the shared memory allows are more than P_MAX_BANDS;
    else G. ``n`` does not move the choice: every path's events are sparse
    (under 2 per pixel), where a band plan for few images loses to G."""
    tall = band_rows(height, width, smem_optin)
    if variant is None:
        banded = tall is not None and tall[1] <= P_MAX_BANDS
        variant = "P" if banded and b >= P_MIN_IMAGES else "G"
    if variant == "G":
        return VotePlan("G", 0, 0, 0)
    if variant not in VARIANTS:
        raise ValueError(f"unknown K1 variant {variant!r}")
    if tall is None:
        raise ValueError(f"a row of {width} floats does not fit {smem_optin} B of shared memory")
    rows, bands = band_rows(height, width, smem_optin, min(P_MAX_BANDS, sm_count // b))
    return VotePlan("P", rows, bands, 4 * rows * width)


def stages_whole(height: int, width: int, smem_optin: int) -> bool:
    """Whether K2's S can stage a height x width image: the barrier and the
    image fit a block's shared memory, and rows are a multiple of 16 bytes
    (the bulk copies' unit)."""
    return width % 4 == 0 and S_BARRIER_BYTES + 4 * height * width <= smem_optin


def plan_vote_bwd(b: int, n: int, height: int, width: int, sm_count: int, smem_optin: int,
                  variant: str | None = None) -> BwdPlan:
    """The K2 variant and its launch shape for b images of height x width
    from n events each, on a card with ``sm_count`` SMs and ``smem_optin``
    bytes of shared memory per block. ``variant`` forces one (chip_smoke's
    checks and tools/tune_vote_bwd.py); nothing on the main path passes it.

    S from S_MIN_IMAGES images up when the image stages whole (one block per
    image), else G (a thread per event). ``n`` and ``sm_count`` do not move
    the choice: every path's events are sparse (under 2 per pixel)."""
    whole = stages_whole(height, width, smem_optin)
    if variant is None:
        variant = "S" if whole and b >= S_MIN_IMAGES else "G"
    if variant == "G":
        return BwdPlan("G", 0)
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown K2 variant {variant!r}")
    if not whole:
        raise ValueError(f"a {height}x{width} image cannot be staged whole in {smem_optin} B of "
                         "shared memory by 16-byte copies")
    return BwdPlan("S", S_BARRIER_BYTES + 4 * height * width)


def compact_rows(t: torch.Tensor, lead: tuple, n: int) -> torch.Tensor:
    """An operand broadcastable to (*lead, n) as the contiguous float32
    (R, n) array K1 reads, flat image b reading row b // (B // R). A
    broadcast over trailing lead dimensions ((P, 1, N) against (P, M, N),
    (N,) against (2, N)) is a view, no copy; any other broadcast pattern is
    materialized to (B, n)."""
    shape = (1,) * (len(lead) + 1 - t.dim()) + tuple(t.shape)
    tl = shape[:-1]
    j = len(tl)
    while j and tl[j - 1] == 1:
        j -= 1
    if shape[-1] == n and tuple(tl[:j]) == tuple(lead[:j]):
        return t.reshape(math.prod(lead[:j]), n).float().contiguous()
    return t.expand(*lead, n).reshape(-1, n).float().contiguous()


def sum_rows(d: torch.Tensor, r: int) -> torch.Tensor:
    """A (b, n) gradient summed over each row group: (r, n)."""
    return d if d.shape[0] == r else d.reshape(r, -1, d.shape[1]).sum(1)


def nvcc_flags() -> tuple:
    """nvcc's flags and the constants compiled in: K2's G block size, K3's
    events a thread and tangent images a chunk."""
    return (*nvcc.NVCC_FLAGS, f"-DIWE_BWD_G_THREADS={G_BWD_THREADS}",
            f"-DIWE_JVP_ITEMS={JVP_ITEMS}", f"-DIWE_JVP_TANGENTS={JVP_TANGENTS}")


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    return nvcc.library_path(SOURCE, nvcc_flags(), "libiwe")


def build_job() -> tuple:
    """(source, flags, library) for nvcc.compile_all."""
    return SOURCE, nvcc_flags(), library_path()


def build():
    """Compile csrc/iwe.cu (once per source hash and flags) and load it;
    returns the ctypes library. Raises with nvcc's output if the build
    fails. After a change of G_BWD_THREADS (tools/tune_vote_bwd.py) the
    next call loads the library built with the new value."""
    with _lock:
        return _build_locked()


def _build_locked():
    flags = nvcc_flags()
    if flags in _loaded:
        return _loaded[flags]
    import ctypes

    nvcc.compile_all([build_job()])
    so = library_path()
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.iwe_device_attrs.argtypes = [i32, ip, ip]
    lib.iwe_device_attrs.restype = i32
    lib.iwe_allow_smem.argtypes = [i32]
    lib.iwe_allow_smem.restype = i32
    lib.iwe_vote_fwd.argtypes = [i32, p, p, p, i64, i64, i64, p, i64, i64, i32, i32,
                                 i32, i32, i32, p]
    lib.iwe_vote_fwd.restype = i32
    lib.iwe_vote_bwd.argtypes = [i32, p, p, p, i64, i64, i64, p, p, p, p, i64, i64, i32, i32,
                                 i32, p]
    lib.iwe_vote_bwd.restype = i32
    lib.iwe_vote_jvp.argtypes = [p, p, p, i64, i64, i64, p, p, i64, i64, p, i64, i64, i32, i32,
                                 p]
    lib.iwe_vote_jvp.restype = i32
    lib.iwe_noop.argtypes = [p]
    lib.iwe_noop.restype = i32
    lib.iwe_error_string.argtypes = [i32]
    lib.iwe_error_string.restype = ctypes.c_char_p
    _loaded[flags] = lib
    return lib


def _check(name: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.iwe_error_string(err).decode()}")


def device_attrs(device: torch.device) -> tuple:
    """(SM count, opt-in shared memory bytes per block) of a CUDA device, as
    the library reads them (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    import ctypes

    lib = build()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _lock:
        if index not in _attrs:
            sms, smem = ctypes.c_int(), ctypes.c_int()
            _check("cudaDeviceGetAttribute",
                   lib.iwe_device_attrs(index, ctypes.byref(sms), ctypes.byref(smem)), lib)
            _attrs[index] = (sms.value, smem.value)
        return _attrs[index]


def _allow_smem(lib, device: torch.device) -> None:
    """Once per library and device: let the shared-memory kernels take the
    opt-in shared memory (cudaFuncSetAttribute, needed above 48 KB). Runs on
    the current device."""
    key = (id(lib), torch.cuda.current_device())  # loaded libraries are kept: ids stay theirs
    smem = device_attrs(device)[1]
    with _lock:
        if key not in _smem_ready:
            _check("cudaFuncSetAttribute", lib.iwe_allow_smem(smem), lib)
            _smem_ready.add(key)


def count_launches(kernel: str, variant: str, shape: tuple, times: int = 1,
                   in_graph: bool = False) -> None:
    """Add ``times`` executed launches of one kernel variant at ``shape``
    (images, events, height, width) to LAUNCHES and SHAPE_LAUNCHES, and to
    GRAPH_LAUNCHES when a CUDA graph ran them."""
    with _lock:
        for counts in (LAUNCHES, GRAPH_LAUNCHES) if in_graph else (LAUNCHES,):
            counts[kernel] += times
            counts[f"{kernel}_{variant}"] += times
        if SHAPE_LAUNCHES is not None:
            key = (kernel, variant, *shape)
            SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + times


@contextlib.contextmanager
def recording(rec: list):
    """While a graph is captured: each launch the wrappers make on a
    capturing stream is appended to ``rec`` as (kernel, variant, shape)
    instead of being counted; the graph counts it per execution."""
    global _recorder
    prev, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = prev


def _launched(kernel: str, variant: str, shape: tuple) -> None:
    if torch.cuda.is_current_stream_capturing():
        if _recorder is None:
            raise RuntimeError(f"a {kernel} launch was captured outside device_loop: its "
                               "executions could not be counted")
        _recorder.append((kernel, variant, shape))
    else:
        count_launches(kernel, variant, shape)


def _check_events(px, py, w, b):
    """Validates compact (R, N) operands for b images; returns b."""
    ops = (px, py, w)
    for t in ops:
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("events must be contiguous float32 CUDA tensors")
    if not (all(t.dim() == 2 and t.shape[0] > 0 for t in ops)
            and py.shape[1] == w.shape[1] == px.shape[1] and py.device == w.device == px.device):
        raise ValueError("px, py and w must be (R, N) arrays on one device")
    b = max(t.shape[0] for t in ops) if b is None else b
    if any(b % t.shape[0] for t in ops):
        raise ValueError(f"each operand's row count must divide B = {b}")
    return b


def launch_fwd(plan: VotePlan, px, py, w, out, b: int, height: int, width: int) -> None:
    """One raw K1 launch of ``plan`` into ``out`` ((b, height, width), zeroed
    by the caller for G), on the current stream; not counted and allocating
    nothing (chip_smoke times the kernels with it)."""
    n = px.shape[1]
    blocks = -(-b * n // G_THREADS) if plan.variant == "G" else b * plan.bands
    if blocks >= 1 << 31:
        raise ValueError(f"K1 launch of {blocks} blocks exceeds the grid")
    lib = build()
    with torch.cuda.device(px.device):
        if plan.variant != "G":
            _allow_smem(lib, px.device)
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_fwd(
            VARIANTS.index(plan.variant), px.data_ptr(), py.data_ptr(), w.data_ptr(),
            b // px.shape[0], b // py.shape[0], b // w.shape[0], out.data_ptr(), b, n,
            height, width, plan.rows, plan.bands, plan.smem_bytes, stream)
    _check(f"iwe_vote_fwd ({plan.variant}) launch", err, lib)


def vote_fwd(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor, height: int, width: int,
             b: int | None = None, *, variant: str | None = None) -> torch.Tensor:
    """K1: compact (R, N) events (flat image i reads row i // (b // R);
    b defaults to the largest R) -> (b, height, width) vote images. The
    planner picks the variant; ``variant`` forces one (internal)."""
    b = _check_events(px, py, w, b)
    n = px.shape[1]
    if b * n * height * width == 0:
        return torch.zeros((b, height, width), dtype=torch.float32, device=px.device)
    plan = plan_vote_fwd(b, n, height, width, *device_attrs(px.device), variant=variant)
    alloc = torch.empty if plan.variant == "P" else torch.zeros
    out = alloc((b, height, width), dtype=torch.float32, device=px.device)
    launch_fwd(plan, px, py, w, out, b, height, width)
    _launched("fwd", plan.variant, (b, n, height, width))
    return out


def launch_bwd(plan: BwdPlan, px, py, w, g, dpx, dpy, dw, b: int) -> None:
    """One raw K2 launch of ``plan`` into preallocated (b, N) outputs (dw
    None: not written), on the current stream; not counted and allocating
    nothing (chip_smoke times the kernels with it)."""
    n, (height, width) = px.shape[1], g.shape[1:]
    if plan.variant == "S" and (width % 4 or g.data_ptr() % 16):
        raise ValueError("S stages rows by 16-byte copies: g must be 16-byte aligned, W % 4 == 0")
    lib = build()
    with torch.cuda.device(px.device):
        if plan.variant == "S":
            _allow_smem(lib, px.device)
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_bwd(
            BWD_VARIANTS.index(plan.variant), px.data_ptr(), py.data_ptr(), w.data_ptr(),
            b // px.shape[0], b // py.shape[0], b // w.shape[0], g.data_ptr(), dpx.data_ptr(),
            dpy.data_ptr(), None if dw is None else dw.data_ptr(), b, n, height, width,
            plan.smem_bytes, stream)
    _check(f"iwe_vote_bwd ({plan.variant}) launch", err, lib)


def vote_bwd(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
             b: int | None = None, *, with_dw: bool = True, variant: str | None = None):
    """K2: compact (R, N) events (as ``vote_fwd`` reads them) and the
    upstream (b, H, W) gradient -> (dpx, dpy, dw), each (b, N) per image;
    dw is None unless ``with_dw``. Any b x N: G indexes in 64 bits from 2^31
    events. The planner picks the variant; ``variant`` forces one
    (internal)."""
    b = _check_events(px, py, w, b)
    n = px.shape[1]
    if (g.device != px.device or g.dtype != torch.float32 or not g.is_contiguous()
            or g.dim() != 3 or g.shape[0] != b):
        raise ValueError("g must be a contiguous float32 (B, H, W) tensor on the events' device")
    dpx, dpy = (torch.empty((b, n), dtype=torch.float32, device=px.device) for _ in range(2))
    dw = torch.empty_like(dpx) if with_dw else None
    if b * n == 0:
        return dpx, dpy, dw
    plan = plan_vote_bwd(b, n, g.shape[1], g.shape[2], *device_attrs(px.device), variant=variant)
    if plan.variant == "S" and g.data_ptr() % 16:
        g = g.clone()  # a fresh allocation is aligned for the bulk copies
    launch_bwd(plan, px, py, w, g, dpx, dpy, dw, b)
    _launched("bwd", plan.variant, (b, n, g.shape[1], g.shape[2]))
    return dpx, dpy, dw


def launch_jvp(px, py, w, tpx, tpy, out, b: int, height: int, width: int) -> None:
    """One raw K3 launch into ``out`` ((b, height, width), zeroed by the
    caller), on the current stream; not counted and allocating nothing
    (chip_smoke times the kernel with it)."""
    if b >= 1 << 31 or height * width >= 1 << 30:
        raise ValueError(f"K3 launch of {b} tangent images of {height}x{width} exceeds the grid")
    lib = build()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_jvp(
            px.data_ptr(), py.data_ptr(), w.data_ptr(), b // px.shape[0], b // py.shape[0],
            b // w.shape[0], tpx.data_ptr(), tpy.data_ptr(), b // tpx.shape[0],
            b // tpy.shape[0], out.data_ptr(), b, px.shape[1], height, width, stream)
    _check("iwe_vote_jvp launch", err, lib)


def vote_jvp(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor, tpx: torch.Tensor,
             tpy: torch.Tensor, height: int, width: int, b: int | None = None) -> torch.Tensor:
    """K3: compact (R, N) events and coordinate tangents (tangent image i
    reads row i // (b // R) of each; b defaults to the largest R) -> the
    (b, height, width) tangent images of the vote along (tpx, tpy)."""
    b = _check_events(px, py, w, b)
    _check_events(tpx, tpy, tpx, b)
    if tpx.shape[1] != px.shape[1] or tpx.device != px.device:
        raise ValueError("tangents must be (R, N) arrays beside the events")
    n = px.shape[1]
    out = torch.zeros((b, height, width), dtype=torch.float32, device=px.device)
    if b * n * height * width == 0:
        return out
    launch_jvp(px, py, w, tpx, tpy, out, b, height, width)
    _launched("jvp", "S", (b, n, height, width))
    return out


def launch_noop(device: torch.device) -> None:
    """One launch of the empty kernel on ``device``'s current stream: the
    least device time any launch takes (chip_smoke's floor_ms). Not counted."""
    lib = build()
    with torch.cuda.device(device):
        err = lib.iwe_noop(torch.cuda.current_stream(device).cuda_stream)
    _check("iwe_noop launch", err, lib)


class Vote(torch.autograd.Function):
    """K1 forward, K2 backward (the floor-parametrized gradient) and the
    forward-mode rule (``jvp``: K3 for the coordinate tangents, K1 for a
    weight tangent), all on compact operands for b images. K2 writes dw only
    when the weights need a gradient; each gradient is summed back over its
    operand's row group. The context is set up apart from the forward, so
    ``torch.func.jvp`` takes the rule too."""

    @staticmethod
    def forward(px, py, w, height: int, width: int, b: int):
        return vote_fwd(px, py, w, height, width, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        px, py, w, height, width, b = inputs
        ctx.save_for_backward(px, py, w)
        ctx.save_for_forward(px, py, w)
        ctx.b, ctx.hw = b, (height, width)

    @staticmethod
    def jvp(ctx, tpx, tpy, tw, *_):
        """The images' tangent: K3 along the coordinate tangents (a missing
        one is zero), plus K1 voting the weight tangent where the weight is
        not zero (the vote drops weight-0 events, so its derivative there is
        zero)."""
        px, py, w = ctx.saved_tensors
        (H, W), b = ctx.hw, ctx.b
        out = None
        if tpx is not None or tpy is not None:
            tpx, tpy = (torch.zeros_like(px) if t is None else t.contiguous() for t in (tpx, tpy))
            out = _TangentVote.apply(px, py, w, tpx, tpy, H, W, b)
        if tw is not None:
            vw = Vote.apply(px, py, torch.where(w != 0, tw, 0.0).contiguous(), H, W, b)
            out = vw if out is None else out + vw
        if out is None:
            out = torch.zeros((b, H, W), dtype=torch.float32, device=px.device)
        return out

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        grads = vote_bwd(*ops, g.contiguous(), ctx.b, with_dw=need[2])
        return (*(sum_rows(d, t.shape[0]) if want else None
                  for d, t, want in zip(grads, ops, need)), None, None, None)


class _TangentVote(torch.autograd.Function):
    """K3 behind an autograd Function: torch.func.jvp hands Vote.jvp
    tensors wrapped for its transform, which have no storage a kernel could
    read; a Function's forward gets them unwrapped."""

    @staticmethod
    def forward(px, py, w, tpx, tpy, height: int, width: int, b: int):
        return vote_jvp(px, py, w, tpx, tpy, height, width, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


def bilinear_accumulate_cuda(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
    """(..., N) events on the card -> (..., height, width), through the
    kernels. Operands broadcast over trailing lead dimensions reach K1 and
    K2 as compact row groups, with no copy (``compact_rows``)."""
    shape = torch.broadcast_shapes(px.shape, py.shape, weights.shape)
    lead, n = tuple(shape[:-1]), shape[-1]
    if n * math.prod(lead) == 0:
        return torch.zeros(*lead, height, width, dtype=torch.float32, device=px.device)
    ops = [compact_rows(t, lead, n) for t in (px, py, weights)]
    out = Vote.apply(*ops, height, width, math.prod(lead))
    return out.reshape(*lead, height, width)
