"""The port's cubic back-end (spline_degree=3, order 4) against the scalar
oracle (tools/scalar_oracle.py), with the gates of
tests/test_oracle_parity_cubic.py on its stream and configuration: the
order-4 spline math against the oracle's cumulative-basis spline, the
trajectory gap < 0.2 deg RMS (max 0.6), and the oracle within 0.2 deg of
the ground truth."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import scalar_oracle as oracle  # noqa: E402

from cmax_slam_tpu_torch import spline  # noqa: E402
from cmax_slam_tpu_torch.calib import CameraCalibration  # noqa: E402
from cmax_slam_tpu_torch.config import (  # noqa: E402
    BackendConfig, FrontendConfig, PanoMapOptions, SlidingWindowOptions,
    SystemConfig, TrajectoryOptions, WarpOptions,
)
from cmax_slam_tpu_torch.io import synthetic  # noqa: E402
from cmax_slam_tpu_torch.system import CMaxSLAM  # noqa: E402
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg  # noqa: E402

from test_oracle_parity_cubic import (  # noqa: E402
    BATCH, DT_AV, DT_KNOTS, DURATION, FXY, H, MAX_UPD, MIN_EV_RATE, N_EVENTS, OMEGA_TRUE,
    PACKET, PANO_H, PANO_W, SIGMA, STRIDE, W, WIN,
)

# Full-tier suite: long e2e run (see pytest.ini; run with -m "")
pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def test_cubic_spline_math_parity():
    rng = np.random.default_rng(0)
    dt = 0.05
    sp = oracle.CubicSpline(0.0, dt)
    q = np.array([1.0, 0, 0, 0])
    knots = []
    for _ in range(9):
        q = oracle.qmul(q, oracle.qexp(rng.normal(0, 0.12, 3)))
        knots.append(q.copy())
    sp.knots = list(knots)
    ts = np.linspace(1e-6, sp.max_time() - 1e-6, 200)
    q_o = sp.evaluate_many(ts)
    q_p = spline.evaluate_np(np.stack(knots), ts, 0.0, dt, order=4)
    dots = np.abs(np.sum(q_o * np.asarray(q_p), axis=1))
    ang = 2 * np.degrees(np.arccos(np.clip(dots, -1, 1)))
    assert ang.max() < 1e-4, f"max spline gap {ang.max()} deg"


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(9)
    return synthetic.rotating_camera_events(
        rng, N_EVENTS, DURATION, OMEGA_TRUE, FXY, FXY, W / 2, H / 2, W, H, n_points=300)


@pytest.fixture(scope="module")
def production(stream):
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[FXY, 0, W / 2], [0, FXY, H / 2], [0, 0, 1.0]]))
    cfg = SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=PACKET, dt_ang_vel=DT_AV,
            warp=WarpOptions(blur_sigma=SIGMA, event_batch_size=BATCH),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(WIN, STRIDE),
            warp=WarpOptions(blur_sigma=SIGMA, event_batch_size=BATCH),
            trajectory=TrajectoryOptions(dt_knots=DT_KNOTS, spline_degree=3),
            pano_map=PanoMapOptions(
                pano_height=PANO_H, pano_width=PANO_W,
                backend_min_ev_rate=MIN_EV_RATE, max_update_times=MAX_UPD,
                y_angle_deg=0.0,
            ),
            crop_solver=False,
            first_window_frozen_knots=1,
            bootstrap_resolve_window=4,
        ),
    )
    slam = CMaxSLAM(calib, cfg, device="cpu")
    ev = stream
    for i in range(0, N_EVENTS, 40_000):
        slam.push_events(ev.xs[i:i + 40_000], ev.ys[i:i + 40_000],
                         ev.ts[i:i + 40_000], ev.pols[i:i + 40_000])
    slam.flush()
    return slam


@pytest.fixture(scope="module")
def oracle_run(stream):
    fe = oracle.OracleFrontend(
        fx=FXY, fy=FXY, cx=W / 2, cy=H / 2, width=W, height=H,
        num_events_per_packet=PACKET, dt_ang_vel=DT_AV, blur_sigma=SIGMA,
        event_batch_size=BATCH,
    )
    be = oracle.OracleBackend(
        fx=FXY, fy=FXY, cx=W / 2, cy=H / 2, width=W, height=H,
        pano_width=PANO_W, pano_height=PANO_H,
        time_window_size=WIN, sliding_window_stride=STRIDE,
        dt_knots=DT_KNOTS, blur_sigma=SIGMA, event_batch_size=BATCH,
        min_ev_rate=MIN_EV_RATE, max_update_times=MAX_UPD,
        spline_degree=3, first_window_frozen_knots=1,
        bootstrap_resolve_window=4,
    )
    ev = stream
    traj, ests, tlog = oracle.run_oracle(ev.xs, ev.ys, ev.ts, fe, be)
    assert traj is not None and traj.size >= 4
    return traj, ests, tlog


def test_cubic_trajectory_parity(production, oracle_run):
    traj_o, _, _ = oracle_run
    traj_p = production.backend.traj
    assert traj_p.order == 4
    t0 = max(traj_p.t_beg, traj_o.t0) + 1e-6
    t1 = min(traj_p.max_time(), traj_o.max_time()) - 1e-6
    assert t1 - t0 > 0.3, "overlapping refined span too short"
    grid = np.linspace(t0, t1, 50)
    rms, errs = rotation_rms_deg(grid, traj_o.evaluate_many(grid), traj_p.evaluate(grid),
                                 "global")
    assert rms < 0.2, f"production vs oracle cubic RMS {rms:.4f} deg"
    assert errs.max() < 0.6, f"max sample gap {errs.max():.4f} deg"


def test_cubic_oracle_tracks_ground_truth(oracle_run):
    traj_o, _, _ = oracle_run
    grid = np.linspace(traj_o.t0 + 1e-6, traj_o.max_time() - 1e-6, 50)
    q_o = traj_o.evaluate_many(grid)
    q_gt = np.stack([oracle.qexp(OMEGA_TRUE * t) for t in grid])
    rms, _ = rotation_rms_deg(grid, q_gt, q_o, "global")
    assert rms < 0.2, f"cubic oracle vs ground truth RMS {rms:.4f} deg"
