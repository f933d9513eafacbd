"""Back-end bookkeeping of the port, with the cases and gates of
tests/test_backend_misc.py on its stream and configuration: the overfull
window's drop counter (and its absence under the cap), close() then more
streaming, step() and run() returning every completed window once (a window
completes one step late, as in the JAX package), refine's errors, and
refine then more streaming."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import (
    BackendConfig, FrontendConfig, PanoMapOptions, SlidingWindowOptions,
    SystemConfig, TrajectoryOptions, WarpOptions,
)
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.system import CMaxSLAM

torch.set_num_threads(1)

W, H = 120, 90
FX = FY = 90.0
CHUNK = 20000


def _make(cfg_kwargs=None):
    calib = CameraCalibration(
        width=W, height=H, K=np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]]))
    backend = BackendConfig(
        sliding_window=SlidingWindowOptions(0.2, 0.1),
        warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
        trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
        pano_map=PanoMapOptions(pano_height=256, pano_width=512, backend_min_ev_rate=1000,
                                max_update_times=200),
        **(cfg_kwargs or {}),
    )
    cfg = SystemConfig(
        frontend=FrontendConfig(num_events_per_packet=2000, dt_ang_vel=0.02,
                                warp=WarpOptions(blur_sigma=1.0, event_batch_size=100)),
        backend=backend,
    )
    return CMaxSLAM(calib, cfg, device="cpu")


def _stream(n=60000, duration=0.8, seed=5):
    return synthetic.rotating_camera_events(
        np.random.default_rng(seed), n, duration, np.array([0.8, -1.1, 1.4]), FX, FY,
        W / 2, H / 2, W, H, n_points=250)


def _push(slam, ev, lo, hi):
    for i in range(lo, hi, CHUNK):
        j = min(i + CHUNK, hi)
        slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])


@pytest.fixture(scope="module")
def whole():
    """The stream under the default cap, every step()'s windows recorded."""
    slam, ev = _make(), _stream()
    returned = []
    step = slam.backend.step

    def spied():
        out = step()
        returned.extend(r.index for r in out)
        return out

    slam.backend.step = spied
    _push(slam, ev, 0, len(ev.ts))
    tail = slam.backend.flush()
    return slam, returned, tail


def test_overfull_window_counts_dropped_events():
    # Cap far below the ~15k events per 0.2 s window: the drop must surface
    # in the metrics counter (and a warning), never silently.
    slam, ev = _make({"max_events_per_window": 2000}), _stream()
    _push(slam, ev, 0, len(ev.ts))
    slam.flush()
    assert slam.metrics.counters.get("backend.events_dropped", 0) > 0
    assert len(slam.window_results()) >= 3


def test_no_drop_counter_when_under_cap(whole):
    slam, _, _ = whole
    assert slam.metrics.counters.get("backend.events_dropped", 0) == 0


def test_close_then_continue_streaming():
    slam, ev = _make(), _stream()
    half = len(ev.ts) // 2
    _push(slam, ev, 0, half)
    slam.close()
    assert slam.backend._pending_win is None
    n_before = len(slam.window_results())
    _push(slam, ev, half, len(ev.ts))
    slam.flush()
    assert len(slam.window_results()) > n_before
    slam.close()  # idempotent
    assert slam.backend.close() is None


def test_run_returns_every_completed_window(whole):
    """step() returns a list, flush() the window it completes: together they
    return every window of backend.results once, in order, even where a
    BA-skipped window completes alongside the window in flight."""
    slam, returned, tail = whole
    results = slam.window_results()
    assert [r.index for r in results] == sorted(set(r.index for r in results))
    assert tail is not None and returned + [tail.index] == [r.index for r in results]
    assert slam.backend.flush() is None  # nothing left in flight


def test_backend_run_returns_every_window_once():
    """Backend.run() steps while a window is ready and appends the flush()
    tail: windows fed from a front-end of its own come back once each."""
    slam, ev = _make(), _stream()
    fe, be = slam.frontend, slam.backend
    got = []
    for i in range(0, len(ev.ts), CHUNK):
        ests = fe.push_events(ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK],
                              ev.pols[i:i + CHUNK])
        for e in ests:
            be.push_ang_vel(e.t, e)
        got.extend(r.index for r in be.run())
    assert got == [r.index for r in be.results] and len(got) >= 3
    assert be._pending_win is None


def test_refine_requires_tracked_trajectory():
    slam = _make()
    with pytest.raises(ValueError, match="tracked trajectory"):
        slam.backend.refine_pass((np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0)))


def test_refine_multipass_needs_rereadable_source():
    slam = _make()
    with pytest.raises(ValueError, match="re-readable"):
        slam.refine(iter([]), passes=2)


def test_refine_then_continue_streaming():
    """Mid-stream polish: refine joins the window in flight, restores the
    live cursors, and the online pass continues cleanly afterwards."""
    slam, ev = _make(), _stream()
    half = len(ev.ts) // 2
    _push(slam, ev, 0, half)
    assert slam.backend._pending_win is not None  # refine must join it
    cursors = (slam.backend.t_win_beg, slam.backend.t_win_end, slam.backend.count_window,
               slam.backend.idx_cp_opt_beg)
    ref = slam.refine((ev.xs[:half], ev.ys[:half], ev.ts[:half], ev.pols[:half]))
    assert slam.backend._pending_win is None
    n_online = len(slam.window_results())
    assert n_online >= 1 and len(ref) >= 1
    assert (slam.backend.t_win_beg, slam.backend.t_win_end, slam.backend.count_window,
            slam.backend.idx_cp_opt_beg) == cursors
    # chunked-iterator source must cover the same windows as the array form
    ref2 = slam.refine(iter([(ev.xs[i:i + 9000], ev.ys[i:i + 9000], ev.ts[i:i + 9000])
                             for i in range(0, half, 9000)]))
    assert [r.index for r in ref2] == [r.index for r in ref]
    assert [r.num_events for r in ref2] == [r.num_events for r in ref]
    _push(slam, ev, half, len(ev.ts))
    slam.flush()
    assert len(slam.window_results()) > n_online
