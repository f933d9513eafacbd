"""Host event store and file readers; host-only copy of
cmax_slam_tpu/io/events.py.

Replaces the reference's master event vector owned by the front-end
(include/frontend/ang_vel_estimator.h:64), the timestamp->index lookup
shared with the back-end (include/backend/pose_graph_optimizer.h:93,147) and
the rosbag/driver ingestion path. Fixed-size device packets are cut from
this store.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

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


def read_events_txt(path, max_events: Optional[int] = None):
    """Read the IJRR/ECD plain-text event format: lines of 't x y p'.
    ``path`` may be a filename or an open (binary) file object."""
    data = np.loadtxt(path, max_rows=max_events)
    ts = data[:, 0].astype(np.float64)
    xs = data[:, 1].astype(np.int32)
    ys = data[:, 2].astype(np.int32)
    ps = data[:, 3].astype(np.int8)
    ps = np.where(ps > 0, 1, -1).astype(np.int8)
    return xs, ys, ts, ps


def read_events_npy(path: str):
    """Read a .npz/.npy event dump with keys x, y, t, p."""
    d = np.load(path)
    return (
        d["x"].astype(np.int32),
        d["y"].astype(np.int32),
        d["t"].astype(np.float64),
        np.where(d["p"] > 0, 1, -1).astype(np.int8),
    )


def read_events_hdf5(path: str, group: str = "events"):
    """Read an HDF5 event file with datasets {group}/{x,y,t,p}. h5py is
    imported here, so the module imports without it."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f[group]
        xs = np.asarray(g["x"], np.int32)
        ys = np.asarray(g["y"], np.int32)
        ts = np.asarray(g["t"], np.float64)
        ps = np.where(np.asarray(g["p"]) > 0, 1, -1).astype(np.int8)
    return xs, ys, ts, ps


def read_events_zip(path: str, max_events: Optional[int] = None):
    """Read the first .txt member of a zip archive (the ECD/IJRR datasets
    distribute events.txt zipped; docs/test_datasets.md)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.lower().endswith(".txt")]
        if not names:
            raise ValueError(f"no .txt member inside {path}")
        with z.open(names[0]) as f:
            return read_events_txt(f, max_events)


def load_events(path: str, max_events: Optional[int] = None):
    """Dispatch on extension (.txt/.csv, .zip, .npz/.npy, .h5, .bag)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".txt", ".csv"):
        return read_events_txt(path, max_events)
    if ext == ".zip":
        return read_events_zip(path, max_events)
    if ext in (".npz", ".npy"):
        out = read_events_npy(path)
    elif ext in (".h5", ".hdf5"):
        out = read_events_hdf5(path)
    elif ext == ".bag":
        from .rosbag import read_rosbag_events

        out = read_rosbag_events(path)
    else:
        raise ValueError(f"unknown event file format: {path}")
    if max_events is not None:
        out = tuple(a[:max_events] for a in out)
    return out


def stream_chunks(
    xs, ys, ts, ps, chunk_size: int = 65536
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield the event arrays in stream-order chunks (replaces the ROS
    EventArray subscriber feed, src/cmax_slam.cpp:147-161)."""
    for i in range(0, len(ts), chunk_size):
        yield xs[i : i + chunk_size], ys[i : i + chunk_size], ts[i : i + chunk_size], ps[
            i : i + chunk_size
        ]
