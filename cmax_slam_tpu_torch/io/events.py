"""Host event store; host-only copy of cmax_slam_tpu/io/events.py::EventStore.

Replaces the reference's master event vector owned by the front-end
(include/frontend/ang_vel_estimator.h:64) and the timestamp->index lookup
shared with the back-end (include/backend/pose_graph_optimizer.h:93,147).
Fixed-size device packets are cut from this store.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EventStore:
    """Append-only event buffer with absolute indexing and prefix retirement.

    Absolute indices are stable across `drop_before` calls, mirroring the
    reference's index bookkeeping in deleteOldEvents
    (src/frontend/ang_vel_estimator.cpp:149-173) without the re-indexing walk.
    """

    def __init__(self):
        self._xs = np.empty(0, np.int32)
        self._ys = np.empty(0, np.int32)
        self._ts = np.empty(0, np.float64)
        self._ps = np.empty(0, np.int8)
        self.base = 0  # absolute index of self._xs[0]
        self._t_last = -np.inf  # newest timestamp ever appended

    def __len__(self) -> int:
        return self.base + len(self._xs)

    @property
    def total(self) -> int:
        return self.base + len(self._xs)

    def append(self, xs, ys, ts, ps) -> None:
        xs = np.asarray(xs, np.int32)
        ys = np.asarray(ys, np.int32)
        ts = np.asarray(ts, np.float64)
        ps = np.asarray(ps, np.int8)
        if len(self._ts) and len(ts) and ts[0] < self._ts[-1]:
            raise ValueError("events must arrive in timestamp order")
        self._xs = np.concatenate([self._xs, xs])
        self._ys = np.concatenate([self._ys, ys])
        self._ts = np.concatenate([self._ts, ts])
        self._ps = np.concatenate([self._ps, ps])
        if len(ts):
            self._t_last = float(ts[-1])

    def latest_time(self) -> float:
        """Newest timestamp ever appended (survives prefix retirement)."""
        return self._t_last

    def slice_abs(self, a: int, b: int):
        """Events with absolute indices in [a, b). Clipped to what's stored."""
        lo = max(a - self.base, 0)
        hi = max(b - self.base, 0)
        return (
            self._xs[lo:hi],
            self._ys[lo:hi],
            self._ts[lo:hi],
            self._ps[lo:hi],
        )

    def drop_before(self, abs_idx: int) -> None:
        """Retire events before absolute index (deleteOldEvents equivalent)."""
        n = abs_idx - self.base
        if n <= 0:
            return
        n = min(n, len(self._xs))
        self._xs = self._xs[n:]
        self._ys = self._ys[n:]
        self._ts = self._ts[n:]
        self._ps = self._ps[n:]
        self.base += n

    def searchsorted_time(self, t: float, side: str = "left") -> int:
        """Absolute index of the first event at/after time t."""
        return self.base + int(np.searchsorted(self._ts, t, side=side))

    def ts_at(self, abs_idx: int) -> float:
        return float(self._ts[abs_idx - self.base])

    @property
    def t_last(self) -> Optional[float]:
        return float(self._ts[-1]) if len(self._ts) else None
