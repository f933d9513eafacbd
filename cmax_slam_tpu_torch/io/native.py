"""Packet-trigger scan; host-only copy of the numpy fallback of
cmax_slam_tpu/io/native.py::scan_triggers.

The JAX package runs this walk in C++ when native/libevstream.so is built
and in numpy otherwise; both give the same triggers. The port carries the
numpy form only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
