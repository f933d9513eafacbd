"""The online bootstrap re-solve (backend.bootstrap_resolve_window) of the
port, with the gates of tests/test_bootstrap_resolve.py on its stream and
configuration: it fires once, before the stream head, improves each
re-solved window, refreshes the early refined poses, keeps the RMS under
0.25 deg, and the store retains its prefix only while it is pending."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import (
    BackendConfig, FrontendConfig, PanoMapOptions, SlidingWindowOptions,
    SystemConfig, TrajectoryOptions, WarpOptions,
)
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import FX, FY, H, W, smooth_rot_fn

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def _run(bootstrap, duration=0.7, n=70000):
    rng = np.random.default_rng(3)
    rot_fn, omega_fn = smooth_rot_fn(duration)
    ev = synthetic.rotating_camera_events(
        rng, n, duration, np.zeros(3), FX, FY, W / 2, H / 2, W, H,
        n_points=250, rot_fn=rot_fn,
    )
    calib = CameraCalibration(
        width=W, height=H,
        K=np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]]),
    )
    cfg = SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=4000, dt_ang_vel=0.02,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=256, pano_width=512, backend_min_ev_rate=10000,
                max_update_times=200,
            ),
            bootstrap_resolve_window=bootstrap,
        ),
    )
    slam = CMaxSLAM(calib, cfg, device="cpu")
    for i in range(0, n, 20000):
        slam.push_events(ev.xs[i:i + 20000], ev.ys[i:i + 20000],
                         ev.ts[i:i + 20000], ev.pols[i:i + 20000])
    slam.flush()
    return slam, rot_fn


def _rms(slam, rot_fn):
    traj = slam.backend.traj
    times = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, 40)
    q_gt = lie.from_matrix(torch.tensor(rot_fn(times))).numpy()
    return rotation_rms_deg(times, q_gt, traj.evaluate(times), "global")


def test_bootstrap_resolve_fires_and_helps():
    slam, rot_fn = _run(bootstrap=3)
    be = slam.backend
    assert be._bootstrap_pending is None
    assert len(be.bootstrap_results) >= 2
    assert all(r.final_cost <= r.initial_cost + 1e-6 for r in be.bootstrap_results if r.ran_ba)
    assert all(r.t_end <= be.t_win_beg + be.win_size for r in be.bootstrap_results)
    assert len(be.results) >= 5
    rms, errs = _rms(slam, rot_fn)
    assert rms < 0.25, f"bootstrap-resolve RMS {rms} deg"
    # the early refined poses were refreshed from the re-solved trajectory
    for t, q in be.trajectory_log[:2]:
        q_now = be.traj.evaluate(t)[0]
        assert abs(float(np.dot(q, q_now))) > 1 - 1e-7


def test_bootstrap_retention_then_release():
    slam, _ = _run(bootstrap=3)
    assert slam.backend.store.base > 0
