"""End-to-end SLAM of the port with the cubic (order-4) spline back-end, with
the gates of tests/test_e2e_cubic.py on its stream and configuration: the
stock ijrr preset with spline_degree=3 and the same dataset-scale overrides,
online RMS < 0.10 deg, one refine pass < 0.10 deg, and a line-search bracket
of 12 < 0.15 deg, with the front-end's omega percentiles."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import FX, FY, H, W
from test_e2e_cubic import smooth_rot_fn_noramp

# Full-tier suite: long e2e run (see pytest.ini; run with -m "")
pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def _run_cubic(bracket: int = 16, refine_passes: int = 0):
    rng = np.random.default_rng(11)
    duration = 0.8
    rot_fn, omega_fn = smooth_rot_fn_noramp(duration)
    n = 80000
    ev = synthetic.rotating_camera_events(
        rng, n, duration, np.zeros(3), FX, FY, W / 2, H / 2, W, H,
        n_points=250, rot_fn=rot_fn,
    )
    calib = CameraCalibration(
        width=W, height=H,
        K=np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]]),
    )
    cfg = replace(
        ijrr_config(num_events_per_packet=4000),
        **{
            "frontend.dt_ang_vel": 0.02,
            "backend.pano_map.pano_height": 256,
            "backend.pano_map.pano_width": 512,
            "backend.trajectory.spline_degree": 3,
            "backend.optim.max_fevals_per_linesearch": bracket,
        },
    )
    slam = CMaxSLAM(calib, cfg, device="cpu")
    for i in range(0, n, 20000):
        slam.push_events(ev.xs[i:i + 20000], ev.ys[i:i + 20000],
                         ev.ts[i:i + 20000], ev.pols[i:i + 20000])
    slam.flush()

    results = slam.window_results()
    assert len(results) >= 4
    assert all(r.ran_ba for r in results)

    if refine_passes:
        online_snapshot = list(results)
        ref_results = slam.refine((ev.xs, ev.ys, ev.ts, ev.pols), passes=refine_passes)
        assert all(r.ran_ba for r in ref_results)
        assert all(r.final_cost <= r.initial_cost + 1e-6 for r in ref_results)
        assert slam.backend.results == online_snapshot

    log = slam.ang_vel_log

    def omega_window_avg(t, half=0.01, k=9):
        return np.mean([omega_fn(tt) for tt in np.linspace(t - half, t + half, k)], axis=0)

    fe_errs = [np.linalg.norm(row[1:] - omega_window_avg(row[0])) for row in log]
    assert np.median(fe_errs) < 0.12, f"median omega err {np.median(fe_errs)}"
    assert np.percentile(fe_errs, 90) < 0.2, f"p90 omega err {np.percentile(fe_errs, 90)}"

    traj = slam.backend.traj
    assert traj.order == 4
    times = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, 50)
    q_gt = lie.from_matrix(torch.tensor(rot_fn(times))).numpy()
    return rotation_rms_deg(times, q_gt, traj.evaluate(times), alignment="global")


def test_cubic_backend_rms():
    rms, errs = _run_cubic()
    assert rms < 0.10, f"cubic trajectory RMS {rms} deg; errs={np.round(errs, 2)}"


def test_cubic_refine_pass_rms():
    rms, errs = _run_cubic(refine_passes=1)
    assert rms < 0.10, f"refined cubic RMS {rms} deg; errs={np.round(errs, 2)}"


def test_cubic_bracket_budget_robust():
    rms, errs = _run_cubic(bracket=12)
    assert rms < 0.15, f"bracket=12 RMS {rms} deg; errs={np.round(errs, 2)}"
