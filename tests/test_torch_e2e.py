"""End-to-end SLAM of the port on the CPU, with the gates of tests/test_e2e.py:
the same 1 s / 100k-event smooth-rotation stream on the 120x90 camera, the
stock ijrr preset with the same dataset-scale overrides, front-end omega
tracking, every window running BA, trajectory RMS, map accumulation, the
checkpoint round trip and one refine sweep."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import smooth_rot_fn

# Full-tier suite: long e2e run (see pytest.ini; run with -m "")
pytestmark = pytest.mark.slow

W, H = 120, 90
FX = FY = 90.0


@pytest.fixture(scope="module")
def slam_run():
    rng = np.random.default_rng(3)
    duration = 1.0
    rot_fn, omega_fn = smooth_rot_fn(duration)
    n = 100000
    ev = synthetic.rotating_camera_events(
        rng, n, duration, np.zeros(3), FX, FY, W / 2, H / 2, W, H,
        n_points=250, rot_fn=rot_fn,
    )
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]]))
    cfg = replace(ijrr_config(num_events_per_packet=4000), **{
        "frontend.dt_ang_vel": 0.02,
        "backend.pano_map.pano_height": 256,
        "backend.pano_map.pano_width": 512,
    })
    slam = CMaxSLAM(calib, cfg, device="cpu")
    for i in range(0, n, 20000):
        slam.push_events(ev.xs[i:i + 20000], ev.ys[i:i + 20000],
                         ev.ts[i:i + 20000], ev.pols[i:i + 20000])
    slam.flush()
    return slam, rot_fn, omega_fn, ev


def _rms_vs_truth(traj, rot_fn):
    times = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, 60)
    q_gt = lie.from_matrix(torch.tensor(rot_fn(times))).numpy()
    return rotation_rms_deg(times, q_gt, traj.evaluate(times), "global")


def test_frontend_tracks_omega(slam_run):
    slam, rot_fn, omega_fn, ev = slam_run
    log = slam.ang_vel_log
    assert len(log) >= 40

    def omega_window_avg(t, half=0.01, n=9):
        return np.mean([omega_fn(tt) for tt in np.linspace(t - half, t + half, n)], axis=0)

    errs = [np.linalg.norm(row[1:] - omega_window_avg(row[0])) for row in log]
    assert np.median(errs) < 0.08, f"median omega err {np.median(errs)}"
    assert np.percentile(errs, 90) < 0.25, f"p90 omega err {np.percentile(errs, 90)}"


def test_backend_windows_ran(slam_run):
    slam, *_ = slam_run
    results = slam.window_results()
    assert len(results) >= 6
    assert all(r.ran_ba for r in results)
    assert np.mean([r.final_cost for r in results]) < 0.0


def test_backend_trajectory_rms(slam_run):
    slam, rot_fn, *_ = slam_run
    assert slam.backend.traj.size >= 5
    rms, errs = _rms_vs_truth(slam.backend.traj, rot_fn)
    assert rms < 0.10, f"trajectory RMS {rms} deg; errs={np.round(errs, 2)}"


def test_global_map_accumulates(slam_run):
    slam, *_ = slam_run
    assert float(slam.backend.IG.sum()) > 0
    assert int((slam.backend.update_times > 0).sum()) > 0


def test_checkpoint_roundtrip(slam_run, tmp_path):
    slam, *_ = slam_run
    p = str(tmp_path / "state.npz")
    slam.save_checkpoint(p)
    d = np.load(p)
    assert d["knots"].shape[1] == 4
    np.testing.assert_allclose(d["IG"], slam.backend.IG.numpy())
    assert d["ang_vel_log"].shape[0] == len(slam.frontend.estimates)


def test_refine_reaches_north_star(slam_run):
    """KEEP LAST: refine mutates the module fixture's back-end state."""
    slam, rot_fn, omega_fn, ev = slam_run
    slam.backend.refine_pass((ev.xs, ev.ys, ev.ts, ev.pols))
    rms, errs = _rms_vs_truth(slam.backend.traj, rot_fn)
    assert rms < 0.1, f"refined RMS {rms} deg; errs={np.round(errs, 2)}"
