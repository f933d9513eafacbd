"""The host data plane in C++ (native/evstream.cpp), bound with ctypes:
text-event parsing, the packet-trigger scan, the time-window search and
the packet gather; counterpart of cmax_slam_tpu/io/native.py.

The front-end runs ``scan_triggers`` on every push (Frontend._scan_triggers)
and the batched cut runs ``scan_triggers`` and ``gather_packet``
(parallel/batched.cut_packets). The library is built from the repository's
``native/evstream.cpp`` at first use, with the host C++ compiler (``$CXX``,
else ``g++``), into ``_build/`` beside the package, named by a hash of the
source, the compiler and the flags (ops/nvcc.py). The flags leave out
``-march=native`` and ``-ffast-math``: the build may travel with a copied
tree to another host, and the scan's comparisons must round as numpy's do.
Nothing is built when this module is imported. A build or load that fails
raises with the compiler's output; ``available()`` says whether the library
loads, and is the only place that catches that error. No path falls back
to numpy.

The ``*_plain`` functions are the JAX package's numpy fallbacks, the
versions the library is held against (tests, chip_smoke.py). They differ in
one respect: ``scan_triggers_plain`` scans to the end of the stream, where
the library stops after ``max_out`` triggers and returns the index to
resume from.

``CALLS`` counts the library's calls by function.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from ..ops import nvcc

SOURCE = Path(__file__).resolve().parents[2] / "native" / "evstream.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

CALLS = {"parse_events_txt": 0, "scan_triggers": 0, "window": 0, "gather_packet": 0}

_loaded: dict = {}
_lock = threading.Lock()


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    return nvcc.library_path(SOURCE, (compiler(), *CXX_FLAGS), "libevstream")


def build() -> ctypes.CDLL:
    """Compile native/evstream.cpp (once per source, compiler and flags)
    and load it; returns the ctypes library. Raises with the compiler's
    output if the build fails."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        if not SOURCE.exists():
            raise RuntimeError(f"{SOURCE} not found: the host data plane builds from the "
                               "repository's native/evstream.cpp")
        so = library_path()
        nvcc.compile_all([(SOURCE, CXX_FLAGS, so)], compiler=compiler())
        lib = ctypes.CDLL(str(so))
        f64p, i32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
        i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
        i64, f64 = ctypes.c_int64, ctypes.c_double
        lib.evs_parse_txt.restype = i64
        lib.evs_parse_txt.argtypes = [ctypes.c_char_p, f64p, i32p, i32p,
                                      ctypes.POINTER(ctypes.c_int8), i64]
        lib.evs_scan_triggers.restype = i64
        lib.evs_scan_triggers.argtypes = [f64p, i64, f64p, i64p, f64, i64p, i64]
        lib.evs_window.restype = None
        lib.evs_window.argtypes = [f64p, i64, f64, f64, i64p, i64p]
        lib.evs_gather_packet.restype = None
        lib.evs_gather_packet.argtypes = [i32p, i32p, f64p, i64, i64, i64, f32p,
                                          ctypes.c_int32, f64, f32p, f32p, f32p]
        _loaded["lib"] = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        build()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_events_txt(path: str, max_events: int = -1):
    """Parse a 't x y p' text event file (comment lines start with '#'):
    (xs, ys, ts, ps), at most ``max_events`` events (-1: all)."""
    lib = build()
    CALLS["parse_events_txt"] += 1
    name = os.fsencode(path)
    n = lib.evs_parse_txt(name, None, None, None, None, max_events)
    if n < 0:
        raise IOError(f"failed to parse {path}")
    ts = np.empty(n, np.float64)
    xs = np.empty(n, np.int32)
    ys = np.empty(n, np.int32)
    ps = np.empty(n, np.int8)
    n2 = lib.evs_parse_txt(name, _ptr(ts, ctypes.c_double), _ptr(xs, ctypes.c_int32),
                           _ptr(ys, ctypes.c_int32), _ptr(ps, ctypes.c_int8), n)
    if n2 != n:
        raise IOError(f"{path} changed while it was parsed ({n} events, then {n2})")
    return xs, ys, ts, ps


def scan_triggers(ts: np.ndarray, cursor: float, next_idx: int, dt: float,
                  max_out: int = 65536) -> Tuple[np.ndarray, float, int]:
    """Front-end subset-cursor walk (ang_vel_estimator.cpp:68-135) over the
    sorted times from ``next_idx``: every first event past the cursor
    triggers a packet and advances the cursor by ``dt``; at most ``max_out``
    triggers. Returns (trigger_indices, new_cursor, new_next_idx), the
    index to resume from. A float64 C-contiguous ``ts`` (the event store's)
    is read in place."""
    lib = build()
    ts = np.ascontiguousarray(ts, np.float64)
    c = ctypes.c_double(cursor)
    nx = ctypes.c_int64(next_idx)
    out = np.empty(max_out, np.int64)
    CALLS["scan_triggers"] += 1
    k = lib.evs_scan_triggers(_ptr(ts, ctypes.c_double), len(ts), ctypes.byref(c),
                              ctypes.byref(nx), dt, _ptr(out, ctypes.c_int64), max_out)
    return out[:k].copy(), c.value, nx.value


def window(ts: np.ndarray, t_beg: float, t_end: float) -> Tuple[int, int]:
    """Index range [lo, hi) of the sorted times in [t_beg, t_end)."""
    lib = build()
    ts = np.ascontiguousarray(ts, np.float64)
    lo, hi = ctypes.c_int64(), ctypes.c_int64()
    CALLS["window"] += 1
    lib.evs_window(_ptr(ts, ctypes.c_double), len(ts), t_beg, t_end,
                   ctypes.byref(lo), ctypes.byref(hi))
    return lo.value, hi.value


def gather_packet(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, beg: int, end: int,
                  cap: int, lut: np.ndarray, width: int, t0: float):
    """LUT gather + pad of events [beg, end) into fixed-size packet buffers:
    (cap, 3) bearings, (cap,) float32 times relative to ``t0`` and (cap,)
    weights (1 real, 0 padding). Padding bearings are the optical axis
    (0, 0, 1), never zeros: the warp divides by the ray's z. Arrays already
    C-contiguous of the declared dtypes (int32 xs, ys; float64 ts; float32
    (H*W, 3) lut) are read in place."""
    lib = build()
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    ts = np.ascontiguousarray(ts, np.float64)
    lut = np.ascontiguousarray(lut, np.float32)
    if not 0 <= beg <= end <= min(len(xs), len(ys), len(ts)):
        raise ValueError(f"events [{beg}, {end}) out of the stream's {len(ts)}")
    e = beg + min(end - beg, cap)
    if e > beg and (lut.ndim != 2 or lut.shape[1] != 3 or xs[beg:e].min() < 0
                    or xs[beg:e].max() >= width or ys[beg:e].min() < 0
                    or (int(ys[beg:e].max()) + 1) * width > lut.shape[0]):
        raise ValueError("pixels outside the (H*W, 3) LUT")
    bearings = np.empty((cap, 3), np.float32)
    ts_rel = np.empty(cap, np.float32)
    w = np.empty(cap, np.float32)
    CALLS["gather_packet"] += 1
    lib.evs_gather_packet(
        _ptr(xs, ctypes.c_int32), _ptr(ys, ctypes.c_int32), _ptr(ts, ctypes.c_double),
        beg, end, cap, _ptr(lut, ctypes.c_float), width, t0,
        _ptr(bearings, ctypes.c_float), _ptr(ts_rel, ctypes.c_float), _ptr(w, ctypes.c_float))
    return bearings, ts_rel, w


# ---------------------------------------------------------------------------
# Plain versions: the JAX package's numpy fallbacks.
# ---------------------------------------------------------------------------

def parse_events_txt_plain(path: str, max_events: int = -1):
    from .events import read_events_txt

    return read_events_txt(path, None if max_events < 0 else max_events)


def scan_triggers_plain(ts: np.ndarray, cursor: float, next_idx: int, dt: float,
                        max_out: int = 65536) -> Tuple[np.ndarray, float, int]:
    """``scan_triggers`` in numpy, to the end of the stream: ``max_out`` is
    taken for the library's signature and ignored, as the JAX package's
    fallback ignores it."""
    ts = np.ascontiguousarray(ts, np.float64)
    out = []
    i = next_idx
    n = len(ts)
    while i < n:
        idx = int(np.searchsorted(ts, cursor, side="right"))
        idx = max(idx, i)
        if idx >= n:
            i = n
            break
        out.append(idx)
        cursor += dt
        i = idx + 1
    return np.asarray(out, np.int64), cursor, i


def window_plain(ts: np.ndarray, t_beg: float, t_end: float) -> Tuple[int, int]:
    ts = np.ascontiguousarray(ts, np.float64)
    return (int(np.searchsorted(ts, t_beg, side="left")),
            int(np.searchsorted(ts, t_end, side="left")))


def gather_packet_plain(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, beg: int, end: int,
                        cap: int, lut: np.ndarray, width: int, t0: float):
    n = min(end - beg, cap)
    bearings = np.zeros((cap, 3), np.float32)
    bearings[:, 2] = 1.0
    idx = ys[beg:beg + n].astype(np.int64) * width + xs[beg:beg + n]
    bearings[:n] = lut[idx]
    ts_rel = np.zeros(cap, np.float32)
    ts_rel[:n] = (ts[beg:beg + n] - t0).astype(np.float32)
    w = np.zeros(cap, np.float32)
    w[:n] = 1.0
    return bearings, ts_rel, w
