"""Hand-written CUDA vote kernels and their autograd wrapper; counterpart of
cmax_slam_tpu/ops/pallas_iwe.py.

K1 ``vote_fwd`` replaces the Pallas forward vote (pallas_iwe._fwd_impl,
kernel _fwd_kernel); K2 ``vote_bwd`` replaces the Pallas VJP
(pallas_iwe._vjp_bwd, kernel _bwd_kernel_lanes) and is bound by its four
gathers per event. The source, with the design notes, is csrc/iwe.cu.
``Vote`` wraps the pair as one ``torch.autograd.Function``; ops/scatter.vote
routes every CUDA tensor here.

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
H100 (PERF.md). K1 reads each operand as a compact (B / g, N) array, flat
image b reading row b / g, so broadcast weights and coordinates are not
copied per image (``compact_rows``).

The library is built at first use with nvcc into ``_build/`` beside the
package, keyed by a hash of the source and flags, and loaded with ctypes.
Nothing is imported or compiled when this module is imported. There is no
fallback: a build or launch that fails raises, and no variant stands in for
another.

``LAUNCHES`` counts kernel launches, one per launch and nowhere else, so a
run can show that its votes went through the kernels: ``"fwd"`` is every K1
launch and ``"fwd_P"``, ``"fwd_G"`` split it by variant. The build, the
counts and the per-device set-up are guarded by a lock: the multi-device
modes drive votes from several host threads.
"""

from __future__ import annotations

import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

LAUNCHES = {"fwd": 0, "fwd_P": 0, "fwd_G": 0, "bwd": 0}

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "iwe.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

# K1 planner constants (tools/tune_vote_fwd.py on an H100, PERF.md).
P_MAX_BANDS = 4       # a band plan re-reads every event once per band: G beyond
                      # (10 also beat G at 24 images, where no path launches; PERF.md)
P_MIN_IMAGES = 24     # images per launch from which P beats G
G_THREADS = 256       # kThreadsG in csrc/iwe.cu

VARIANTS = ("G", "P")  # index = the kernel's variant code

_lib = None
_lock = threading.Lock()
_attrs: dict = {}       # device index -> (SM count, opt-in shared bytes per block)
_smem_ready: set = set()  # device indices whose band kernel may take the opt-in bytes


class VotePlan(NamedTuple):
    """How one K1 launch covers its images: the variant, rows per band, the
    band count and the dynamic shared memory of a block (all 0 for G)."""

    variant: str
    rows: int
    bands: int
    smem_bytes: int


def band_rows(height: int, width: int, cap_bytes: int, min_bands: int = 1):
    """(rows per band, bands): at least ``min_bands`` bands of whole rows,
    each of at most cap_bytes of float32, as even as the row count allows
    and none empty; None if one row is wider than cap_bytes."""
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


def expand_rows(t: torch.Tensor, b: int) -> torch.Tensor:
    """A compact (R, n) operand as the full (b, n) array (a copy if R < b)."""
    r = t.shape[0]
    if r == b:
        return t
    return t[:, None].expand(r, b // r, t.shape[1]).reshape(b, -1).contiguous()


def sum_rows(d: torch.Tensor, r: int) -> torch.Tensor:
    """A (b, n) gradient summed over each row group: (r, n)."""
    return d if d.shape[0] == r else d.reshape(r, -1, d.shape[1]).sum(1)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libiwe_{digest.hexdigest()[:16]}.so"


def build():
    """Compile csrc/iwe.cu (once per source hash) and load it; returns the
    ctypes library. Raises with nvcc's output if the build fails."""
    with _lock:
        return _build_locked()


def _build_locked():
    global _lib
    if _lib is not None:
        return _lib
    import ctypes

    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.iwe_device_attrs.argtypes = [i32, ip, ip]
    lib.iwe_device_attrs.restype = i32
    lib.iwe_vote_fwd_allow_smem.argtypes = [i32]
    lib.iwe_vote_fwd_allow_smem.restype = i32
    lib.iwe_vote_fwd.argtypes = [i32, p, p, p, i64, i64, i64, p, i64, i64, i32, i32,
                                 i32, i32, i32, p]
    lib.iwe_vote_fwd.restype = i32
    lib.iwe_vote_bwd.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, p]
    lib.iwe_vote_bwd.restype = i32
    lib.iwe_error_string.argtypes = [i32]
    lib.iwe_error_string.restype = ctypes.c_char_p
    _lib = lib
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
    """Once per device: let the band kernel take the opt-in shared memory
    (cudaFuncSetAttribute, needed above 48 KB). Runs on the current device."""
    index = torch.cuda.current_device()
    smem = device_attrs(device)[1]
    with _lock:
        if index not in _smem_ready:
            _check("cudaFuncSetAttribute", lib.iwe_vote_fwd_allow_smem(smem), lib)
            _smem_ready.add(index)


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
    with _lock:
        LAUNCHES["fwd"] += 1
        LAUNCHES["fwd_" + plan.variant] += 1
    return out


def launch_bwd(px, py, w, g, dpx, dpy, dw) -> None:
    """One raw K2 launch into preallocated (B, N) outputs; not counted."""
    b, n = px.shape
    lib = build()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_bwd(px.data_ptr(), py.data_ptr(), w.data_ptr(), g.data_ptr(),
                               dpx.data_ptr(), dpy.data_ptr(), dw.data_ptr(),
                               b, n, g.shape[1], g.shape[2], stream)
    _check("iwe_vote_bwd launch", err, lib)


def vote_bwd(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """K2: upstream (B, H, W) gradient -> (dpx, dpy, dw), each (B, N)."""
    _check_events(px, py, w, None)
    b, n = px.shape
    if py.shape != px.shape or w.shape != px.shape:
        raise ValueError("K2 takes px, py and w of one (B, N) shape")
    if (g.device != px.device or g.dtype != torch.float32 or not g.is_contiguous()
            or g.dim() != 3 or g.shape[0] != b):
        raise ValueError("g must be a contiguous float32 (B, H, W) tensor on the events' device")
    dpx, dpy, dw = (torch.empty_like(px) for _ in range(3))
    if b * n == 0:
        return dpx, dpy, dw
    launch_bwd(px, py, w, g, dpx, dpy, dw)
    with _lock:
        LAUNCHES["bwd"] += 1
    return dpx, dpy, dw


class Vote(torch.autograd.Function):
    """K1 forward on compact operands for b images, K2 backward (the
    floor-parametrized gradient) on the full (b, N) operands, each gradient
    summed back over its operand's row group."""

    @staticmethod
    def forward(ctx, px, py, w, height: int, width: int, b: int):
        ctx.save_for_backward(px, py, w)
        ctx.b = b
        return vote_fwd(px, py, w, height, width, b)

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        grads = vote_bwd(*(expand_rows(t, ctx.b) for t in ops), g.contiguous())
        return (*(sum_rows(d, t.shape[0]) for d, t in zip(grads, ops)), None, None, None)


def bilinear_accumulate_cuda(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
    """(..., N) events on the card -> (..., height, width), through the
    kernels. Operands broadcast over trailing lead dimensions reach K1 as
    compact row groups, with no copy (``compact_rows``)."""
    shape = torch.broadcast_shapes(px.shape, py.shape, weights.shape)
    lead, n = tuple(shape[:-1]), shape[-1]
    if n * math.prod(lead) == 0:
        return torch.zeros(*lead, height, width, dtype=torch.float32, device=px.device)
    ops = [compact_rows(t, lead, n) for t in (px, py, weights)]
    out = Vote.apply(*ops, height, width, math.prod(lead))
    return out.reshape(*lead, height, width)
