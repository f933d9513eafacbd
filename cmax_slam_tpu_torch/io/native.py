"""Text parsing, packet-trigger scan, window search and packet gather;
host-only copies of the numpy fallbacks of cmax_slam_tpu/io/native.py.

The JAX package runs these in C++ when native/libevstream.so is built and in
numpy otherwise; both give the same results. The port carries the numpy form
only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def parse_events_txt(path: str, max_events: int = -1):
    """Parse a 't x y p' text event file: (xs, ys, ts, ps)."""
    from .events import read_events_txt

    return read_events_txt(path, None if max_events < 0 else max_events)


def window(ts: np.ndarray, t_beg: float, t_end: float) -> Tuple[int, int]:
    """Index range [lo, hi) of the sorted times in [t_beg, t_end)."""
    ts = np.ascontiguousarray(ts, np.float64)
    return (int(np.searchsorted(ts, t_beg, side="left")),
            int(np.searchsorted(ts, t_end, side="left")))


def scan_triggers(
    ts: np.ndarray, cursor: float, next_idx: int, dt: float
) -> Tuple[np.ndarray, float, int]:
    """Front-end subset-cursor walk (ang_vel_estimator.cpp:68-135): every
    first event past the cursor triggers a packet and advances the cursor by
    ``dt``. Returns (trigger_indices, new_cursor, new_next_idx)."""
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


def gather_packet(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, beg: int, end: int,
                  cap: int, lut: np.ndarray, width: int, t0: float):
    """LUT gather + pad of events [beg, end) into fixed-size packet buffers:
    (cap, 3) bearings, (cap,) float32 times relative to ``t0`` and (cap,)
    weights (1 real, 0 padding). Padding bearings are the optical axis
    (0, 0, 1), never zeros: the warp divides by the ray's z."""
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
