"""Checkpoint/resume of the port, with the gates of
tests/test_checkpoint_resume.py on its streams and configuration: a run cut
mid-stream after completed back-end windows and resumed in a fresh system
from the remaining raw events gives the uninterrupted run's trajectory
(< 0.05 deg RMS), window count and refined-pose times; a resume with another
chunk size continues the same packet grid. The configuration keeps the
front-end's stock schedule (the device ring), so the resumed front-end
rebuilds its ring from the restored store."""

import numpy as np
import torch

from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import (
    BackendConfig, FrontendConfig, PanoMapOptions, SlidingWindowOptions,
    SystemConfig, TrajectoryOptions, WarpOptions,
)
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

torch.set_num_threads(1)

W, H = 120, 90
FXY = 90.0
OMEGA_TRUE = np.array([0.9, -1.4, 2.0])
CHUNK = 5000


def _calib():
    return CameraCalibration(
        width=W, height=H,
        K=np.array([[FXY, 0, W / 2], [0, FXY, H / 2], [0, 0, 1.0]]),
    )


def _cfg():
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=4000, dt_ang_vel=0.02,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=128, pano_width=256,
                backend_min_ev_rate=10000, y_angle_deg=0.0,
            ),
        ),
    )


def _system():
    return CMaxSLAM(_calib(), _cfg(), device="cpu")


def _push_range(slam, ev, lo, hi, chunk=CHUNK):
    for i in range(lo, hi, chunk):
        j = min(i + chunk, hi)
        slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])


def test_midstream_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(11)
    n_total = 60_000
    ev = synthetic.rotating_camera_events(
        rng, n_total, 0.7, OMEGA_TRUE, FXY, FXY, W / 2, H / 2, W, H,
        n_points=250,
    )

    # run A: uninterrupted baseline
    slam_a = _system()
    _push_range(slam_a, ev, 0, n_total)
    slam_a.flush()
    assert slam_a.backend.count_window >= 4
    assert slam_a.metrics.counters["frontend.ring_packets"] > 0

    # run B: interrupt after >= 2 completed windows, checkpoint
    slam_b = _system()
    i = 0
    while slam_b.backend.count_window < 2:
        assert i < n_total, "stream exhausted before 2 windows completed"
        _push_range(slam_b, ev, i, i + CHUNK)
        i += CHUNK
    ckpt = str(tmp_path / "midstream.npz")
    slam_b.save_checkpoint(ckpt)
    consumed = slam_b.raw_count
    assert consumed == i
    assert slam_b.backend.traj is not None and slam_b.backend.traj.size > 0
    assert slam_b.backend.pose_latest is not None

    # run C: fresh system, restore, feed only the remaining events
    slam_c = _system()
    slam_c.load_checkpoint(ckpt)
    assert slam_c.raw_count == consumed
    assert slam_c.backend.pose_latest is not None, "integrator anchor lost"
    assert slam_c.backend._av_prev is not None
    assert slam_c.frontend._ring.hi == slam_c.store.total
    _push_range(slam_c, ev, consumed, n_total)
    slam_c.flush()
    assert slam_c.metrics.counters["frontend.ring_packets"] > 0

    assert slam_c.backend.count_window == slam_a.backend.count_window

    ta, tc = slam_a.backend.traj, slam_c.backend.traj
    t0 = max(ta.t_beg, tc.t_beg) + 1e-6
    t1 = min(ta.max_time(), tc.max_time()) - 1e-6
    grid = np.linspace(t0, t1, 100)
    rms, errs = rotation_rms_deg(grid, ta.evaluate(grid), tc.evaluate(grid), "global")
    assert rms < 0.05, f"resumed-vs-uninterrupted RMS {rms:.4f} deg"

    t_log_a = np.array([t for t, _ in slam_a.backend.trajectory_log])
    t_log_c = np.array([t for t, _ in slam_c.backend.trajectory_log])
    assert len(t_log_a) == len(t_log_c)
    np.testing.assert_allclose(t_log_a, t_log_c, atol=1e-9)


def test_resume_replays_identical_packet_grid(tmp_path):
    """The packetizer phase (_t0/_cursor/_t_packet) survives the round trip:
    the resumed run's estimate timestamps continue the same rigid grid
    t_k = t_first + dt/2 + k*dt, whatever the chunk size."""
    rng = np.random.default_rng(12)
    n_total = 30_000
    ev = synthetic.rotating_camera_events(
        rng, n_total, 0.4, OMEGA_TRUE, FXY, FXY, W / 2, H / 2, W, H,
        n_points=250,
    )
    slam_a = _system()
    _push_range(slam_a, ev, 0, n_total)
    slam_a.flush()
    grid_a = slam_a.ang_vel_log[:, 0]

    slam_b = _system()
    cut = 4 * CHUNK
    _push_range(slam_b, ev, 0, cut)
    ckpt = str(tmp_path / "grid.npz")
    slam_b.save_checkpoint(ckpt)
    grid_prefix = slam_b.ang_vel_log[:, 0]

    slam_c = _system()
    slam_c.load_checkpoint(ckpt)
    _push_range(slam_c, ev, cut, n_total, chunk=3211)
    slam_c.flush()
    grid_c = np.concatenate([grid_prefix, slam_c.ang_vel_log[:, 0]])

    assert len(grid_c) == len(grid_a)
    np.testing.assert_allclose(grid_c, grid_a, atol=1e-9)
