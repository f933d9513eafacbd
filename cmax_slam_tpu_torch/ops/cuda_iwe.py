"""Hand-written CUDA vote kernels and their autograd wrapper; counterpart of
cmax_slam_tpu/ops/pallas_iwe.py.

K1 ``vote_fwd`` replaces the Pallas forward vote (pallas_iwe._fwd_impl,
kernel _fwd_kernel) and is bound by atomic throughput on the card; K2
``vote_bwd`` replaces the Pallas VJP (pallas_iwe._vjp_bwd, kernel
_bwd_kernel_lanes) and is bound by its four gathers per event. The source,
with the design notes, is csrc/iwe.cu. ``Vote`` wraps the pair as one
``torch.autograd.Function``; ops/scatter.vote routes every CUDA tensor here.

The library is built at first use with nvcc into ``_build/`` beside the
package, keyed by a hash of the source and flags, and loaded with ctypes.
Nothing is imported or compiled when this module is imported. There is no
fallback: a build or launch that fails raises.

``LAUNCHES`` counts kernel launches, one per launch and nowhere else, so a
run can show that its votes went through the kernels. The build and the
counts are guarded by a lock: the multi-device modes drive votes from
several host threads.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

LAUNCHES = {"fwd": 0, "bwd": 0}

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "iwe.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()


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
    lib.iwe_vote_fwd.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
    lib.iwe_vote_fwd.restype = i32
    lib.iwe_vote_bwd.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, p]
    lib.iwe_vote_bwd.restype = i32
    lib.iwe_error_string.argtypes = [i32]
    lib.iwe_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(name: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.iwe_error_string(err).decode()}")


def _check_events(px, py, w):
    for t in (px, py, w):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("events must be contiguous float32 CUDA tensors")
        if t.dim() != 2 or t.shape != px.shape or t.device != px.device:
            raise ValueError("px, py and w must share one (B, N) shape and device")


def vote_fwd(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor,
             height: int, width: int) -> torch.Tensor:
    """K1: (B, N) events -> (B, height, width) vote images."""
    _check_events(px, py, w)
    b, n = px.shape
    out = torch.zeros((b, height, width), dtype=torch.float32, device=px.device)
    if b * n == 0:
        return out
    lib = build()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_fwd(px.data_ptr(), py.data_ptr(), w.data_ptr(), out.data_ptr(),
                               b, n, height, width, stream)
    _check("iwe_vote_fwd", err, lib)
    with _lock:
        LAUNCHES["fwd"] += 1
    return out


def vote_bwd(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """K2: upstream (B, H, W) gradient -> (dpx, dpy, dw), each (B, N)."""
    _check_events(px, py, w)
    b, n = px.shape
    if (g.device != px.device or g.dtype != torch.float32 or not g.is_contiguous()
            or g.dim() != 3 or g.shape[0] != b):
        raise ValueError("g must be a contiguous float32 (B, H, W) tensor on the events' device")
    height, width = g.shape[1], g.shape[2]
    dpx, dpy, dw = (torch.empty_like(px) for _ in range(3))
    if b * n == 0:
        return dpx, dpy, dw
    lib = build()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.iwe_vote_bwd(px.data_ptr(), py.data_ptr(), w.data_ptr(), g.data_ptr(),
                               dpx.data_ptr(), dpy.data_ptr(), dw.data_ptr(),
                               b, n, height, width, stream)
    _check("iwe_vote_bwd", err, lib)
    with _lock:
        LAUNCHES["bwd"] += 1
    return dpx, dpy, dw


class Vote(torch.autograd.Function):
    """K1 forward, K2 backward (the floor-parametrized gradient)."""

    @staticmethod
    def forward(ctx, px, py, w, height: int, width: int):
        ctx.save_for_backward(px, py, w)
        return vote_fwd(px, py, w, height, width)

    @staticmethod
    def backward(ctx, g):
        px, py, w = ctx.saved_tensors
        dpx, dpy, dw = vote_bwd(px, py, w, g.contiguous())
        return dpx, dpy, dw, None, None


def bilinear_accumulate_cuda(px: torch.Tensor, py: torch.Tensor, weights: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
    """(..., N) events on the card -> (..., height, width), through the
    kernels. Broadcast operands are expanded (autograd sums their gradients
    back)."""
    px, py, weights = torch.broadcast_tensors(px, py, weights)
    lead = px.shape[:-1]
    n = px.shape[-1]
    if n == 0:
        return torch.zeros(*lead, height, width, dtype=torch.float32, device=px.device)
    flat = [t.reshape(-1, n).float().contiguous() for t in (px, py, weights)]
    out = Vote.apply(*flat, height, width)
    return out.reshape(*lead, height, width)
