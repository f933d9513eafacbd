"""The two-device pipeline in the port: CMaxSLAM(..., backend_device=...)
keeps the back-end's maps, LUT and window solves on the back-end device and
the front-end's packet solves on ``device`` (the reference's front-end and
back-end threads, src/cmax_slam.cpp:92). The case of
tests/test_pipeline_devices.py; on the CPU both names are the one CPU, so
the test checks the placement of every back-end tensor, the tracking
accuracy (the JAX test's gate) and that a CUDA back-end device without a
card raises instead of falling back."""

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

from test_e2e import smooth_rot_fn, W, H, FX, FY

torch.set_num_threads(1)

CALIB = CameraCalibration(width=W, height=H,
                          K=np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]]))
CFG = SystemConfig(
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
    ),
)


def test_backend_on_its_own_device():
    rng = np.random.default_rng(3)
    duration = 0.6
    rot_fn, _ = smooth_rot_fn(duration)
    n = 60000
    ev = synthetic.rotating_camera_events(
        rng, n, duration, np.zeros(3), FX, FY, W / 2, H / 2, W, H,
        n_points=250, rot_fn=rot_fn,
    )
    backend_device = torch.device("cpu")
    slam = CMaxSLAM(CALIB, CFG, device="cpu", backend_device=backend_device)
    for i in range(0, n, 20000):
        slam.push_events(ev.xs[i:i + 20000], ev.ys[i:i + 20000],
                         ev.ts[i:i + 20000], ev.pols[i:i + 20000])
    slam.flush()

    be = slam.backend
    assert slam.backend_device == backend_device and be.device == backend_device
    assert all(t.device == backend_device for t in (be.IG, be.update_times, be.lut_dev))
    assert slam.frontend.device == torch.device("cpu")
    results = slam.window_results()
    assert len(results) >= 3 and all(r.ran_ba for r in results)

    traj = be.traj
    times = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, 40)
    q_gt = lie.from_matrix(torch.as_tensor(rot_fn(times))).numpy()
    rms, _ = rotation_rms_deg(times, q_gt, traj.evaluate(times), "global")
    assert rms < 0.3, f"two-device pipeline RMS {rms} deg"


def test_backend_device_defaults_to_device_and_is_checked():
    slam = CMaxSLAM(CALIB, CFG, device="cpu")
    assert slam.backend.device == slam.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            CMaxSLAM(CALIB, CFG, device="cpu", backend_device="cuda")
