"""The device event ring (cmax_slam_tpu_torch/io/devring.py) against the JAX
package's DeviceEventRing, and the packet the front-end gathers from it
against the packet it gathers from the host store."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu.io.devring import DeviceEventRing as JDeviceEventRing
from cmax_slam_tpu_torch.config import FrontendConfig, WarpOptions
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.io.devring import DeviceEventRing, _next_pow2
from cmax_slam_tpu_torch.io.events import EventStore
from cmax_slam_tpu_torch.ops.warp_local import CameraParams

torch.set_num_threads(1)

W, H, F = 120, 90, 90.0


def _chunk(rng, n, t_lo=0.0):
    xs = rng.integers(0, W, n).astype(np.int32)
    ys = rng.integers(0, H, n).astype(np.int32)
    ts = np.sort(rng.uniform(t_lo, t_lo + 0.01, n))
    return xs, ys, ts


def _contents(ring, lo, hi):
    """The ring's (index, time) of absolute events [lo, hi)."""
    pos = np.arange(lo, hi) & (ring.capacity - 1)
    idx, ts = ring.buffers
    return np.asarray(idx)[pos], np.asarray(ts)[pos]


def _expect(xs, ys, ts):
    return ys.astype(np.int32) * W + xs, ts.astype(np.float32)


def test_append_across_the_wrap(rng):
    ring = DeviceEventRing(16, W, device="cpu")
    ring.append(*_chunk(rng, 6))
    ring.append(*_chunk(rng, 7, 0.01))
    b = _chunk(rng, 7, 0.02)
    ring.append(*b)  # absolute 13..19: positions 13..15, then 0..3
    assert ring.hi == 20
    for got, want in zip(_contents(ring, 13, 20), _expect(*b)):
        np.testing.assert_array_equal(got, want)
    c = _chunk(rng, 7, 0.03)
    ring.append(*c)  # absolute 20..26: positions 4..10, the oldest entries
    for got, want in zip(_contents(ring, 20, 27), _expect(*c)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_contents(ring, 13, 20), _expect(*b)):
        np.testing.assert_array_equal(got, want)
    assert ring.buffers[0].dtype == torch.int32 and ring.buffers[1].dtype == torch.float32
    assert ring.buffers[0].shape == (16,)


def test_chunk_over_half_the_capacity_is_split(rng, monkeypatch):
    ring = DeviceEventRing(16, W, device="cpu")
    sizes = []
    one = ring._append_one
    monkeypatch.setattr(ring, "_append_one", lambda *a: (sizes.append(len(a[2])), one(*a)))
    xs, ys, ts = _chunk(rng, 21)
    ring.append(xs, ys, ts)
    assert sizes == [8, 8, 5] and ring.hi == 21
    idx, t = _contents(ring, 5, 21)  # the newest capacity's worth
    np.testing.assert_array_equal(idx, _expect(xs, ys, ts)[0][5:])
    np.testing.assert_array_equal(t, _expect(xs, ys, ts)[1][5:])


def test_resident_at_the_edge(rng):
    ring = DeviceEventRing(16, W, device="cpu")
    ring.append(*_chunk(rng, 20))
    assert ring.resident(4) and ring.resident(19) and ring.resident(20)
    assert not ring.resident(3)
    with pytest.raises(ValueError, match="power of two"):
        DeviceEventRing(24, W, device="cpu")
    assert [_next_pow2(n) for n in (1, 2, 3, 16, 17)] == [1, 2, 4, 16, 32]


def test_resync_after_drop_before(rng):
    store = EventStore()
    chunks = [_chunk(rng, 10, 0.01 * i) for i in range(4)]
    for xs, ys, ts in chunks:
        store.append(xs, ys, ts, np.ones(len(ts), np.int8))
    store.drop_before(17)
    t0 = 0.005
    ring = DeviceEventRing(32, W, device="cpu")
    ring.append(*_chunk(rng, 50))  # stale contents, overwritten or zeroed by the resync
    ring.resync(store, t0)
    assert ring.hi == store.total == 40 and ring.resident(store.base)
    xs, ys, ts, _ = store.slice_abs(17, 40)
    idx, t = _contents(ring, 17, 40)
    np.testing.assert_array_equal(idx, _expect(xs, ys, ts)[0])
    np.testing.assert_array_equal(t, (ts - t0).astype(np.float32))
    idx, t = _contents(ring, 40, 49)  # never written since the resync
    assert not idx.any() and not t.any()


def test_contents_match_jax_ring(rng):
    """Appends of 5-70 events (splits over half the capacity, wraps) leave
    both rings' buffers equal, bit for bit."""
    cap = 64
    ring, jring = DeviceEventRing(cap, W, device="cpu"), JDeviceEventRing(cap, W)
    t0 = 0.0
    for k, n in enumerate((5, 30, 33, 70, 1, 17, 64)):
        xs, ys, ts = _chunk(rng, n, 0.01 * k)
        ts_rel = (ts - t0).astype(np.float32)
        ring.append(xs, ys, ts_rel)
        jring.append(xs, ys, ts_rel)
        assert ring.hi == jring.hi
        for mine, theirs in zip(ring.buffers, jring.buffers):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("capacity", [0, 1 << 14])
def test_ring_packet_equals_host_packet(capacity):
    """Every packet gathered from the ring is torch.equal to the one
    gathered from the host store: the default ring, and one of 2^14 events
    in which packets wrap."""
    rng = np.random.default_rng(2)
    ev = synthetic.rotating_camera_events(rng, 24000, 0.2, np.array([0.9, -1.4, 2.0]), F, F,
                                          W / 2, H / 2, W, H, n_points=250)
    lut = synthetic.identity_lut(W, H, F, F, W / 2, H / 2)
    cfg = FrontendConfig(num_events_per_packet=4000, dt_ang_vel=0.02,
                         warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
                         device_store_capacity=capacity)
    fe = Frontend(CameraParams(F, F, W / 2, H / 2, W, H), lut, cfg, device="cpu")
    checked, wrapped = 0, 0
    gather = fe._ring_packet

    def check(beg, n, t_ref):
        nonlocal checked, wrapped
        ring = gather(beg, n, t_ref)
        xs, ys, ts, _ = fe.store.slice_abs(beg, beg + n)
        host = fe._packet(xs, ys, ts, t_ref)
        for a, b in zip(ring, host):
            assert a.dtype == b.dtype and torch.equal(a, b)
        checked += 1
        cap = fe._ring.capacity
        wrapped += (beg & (cap - 1)) + fe.packet_size > cap
        return ring

    fe._ring_packet = check
    for i in range(0, len(ev.ts), 3000):
        fe.push_events(ev.xs[i:i + 3000], ev.ys[i:i + 3000], ev.ts[i:i + 3000],
                       ev.pols[i:i + 3000])
    assert checked >= 5 and fe.metrics.counters["frontend.ring_packets"] == checked
    assert checked == sum(bool(np.any(e.omega != 0)) for e in fe.estimates)
    assert fe._ring.capacity == (1 << 21 if capacity == 0 else capacity)
    assert wrapped > 0 or capacity == 0
