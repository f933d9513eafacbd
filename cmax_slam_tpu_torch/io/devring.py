"""Device-resident event ring for the front-end; counterpart of
cmax_slam_tpu/io/devring.py.

Consecutive packets overlap by packet minus stride events, so a front-end
that uploads each packet from the host store sends every event over the
link several times. The ring uploads each event once, as the two values the
packet objective reads (the bearing-LUT index ``y*width + x`` as int32 and
the epoch-relative time as float32), into two device tensors of a fixed
power-of-two capacity. Absolute event index ``a`` lives at ``a &
(capacity-1)``: host bookkeeping stays in the EventStore's absolute indices,
and retiring the store's prefix needs no device work (old entries are
overwritten). A packet reaching back further than the capacity is not
resident; the front-end then gathers it from the host store.

The JAX package pads each append to a bucket of sizes so that XLA compiles
few programs; PyTorch compiles nothing, so an append here writes exactly its
events.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class DeviceEventRing:
    """Fixed-capacity device mirror of the EventStore's front-end view: per
    event the int32 LUT index and the float32 epoch-relative time, the
    values and dtypes a packet gathered from the host store carries, so the
    solver's inputs are bit-identical either way."""

    def __init__(self, capacity: int, img_width: int, *, device):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("ring capacity must be a power of two")
        self.capacity = capacity
        self.img_width = img_width
        self.device = torch.device(device)
        self._idx = torch.zeros(capacity, dtype=torch.int32, device=self.device)
        self._ts = torch.zeros(capacity, dtype=torch.float32, device=self.device)
        self.hi = 0  # absolute index of the next write

    @property
    def buffers(self):
        """(int32 LUT index, float32 time) device tensors of ``capacity``."""
        return self._idx, self._ts

    def resident(self, abs_beg: int) -> bool:
        """True if absolute indices [abs_beg, hi) are still in the ring."""
        return self.hi - abs_beg <= self.capacity

    def append(self, xs, ys, ts_rel) -> None:
        """Write one stream chunk: ``ts_rel`` epoch-relative float32 times
        (the front-end passes ``ts - t0``), ``xs``/``ys`` integer pixel
        coordinates. Chunks over half the capacity are split so that one
        append never laps its own unread head."""
        n = len(ts_rel)
        half = self.capacity // 2
        for off in range(0, n, half):
            self._append_one(xs[off:off + half], ys[off:off + half], ts_rel[off:off + half])

    def _append_one(self, xs, ys, ts_rel) -> None:
        """One host-to-device copy of both fields (staged, so the host does
        not wait for the solves queued before it), then an in-place write of
        the ring (two slice copies where the chunk wraps)."""
        n = len(ts_rel)
        host = np.empty((2, n), np.int32)
        np.add(np.multiply(np.asarray(ys, np.int32), self.img_width, dtype=np.int32),
               np.asarray(xs, np.int32), out=host[0])
        host[1] = np.asarray(ts_rel, np.float32).view(np.int32)
        dev = to_device(host, self.device)
        idx, ts = dev[0], dev[1].view(torch.float32)
        pos = self.hi & (self.capacity - 1)
        first = min(n, self.capacity - pos)
        self._idx[pos:pos + first] = idx[:first]
        self._ts[pos:pos + first] = ts[:first]
        if n > first:
            self._idx[:n - first] = idx[first:]
            self._ts[:n - first] = ts[first:]
        self.hi += n

    def reset(self, hi: int = 0) -> None:
        """Empty the ring; the next write goes to absolute index ``hi``."""
        self._idx.zero_()
        self._ts.zero_()
        self.hi = hi

    def resync(self, store, t0: float) -> None:
        """Rebuild the ring from the EventStore's resident window (after a
        checkpoint restore; the ring itself is never serialized)."""
        self.reset(store.base)
        xs, ys, ts, _ = store.slice_abs(store.base, store.total)
        if len(ts):
            self.append(xs, ys, (ts - t0).astype(np.float32))
