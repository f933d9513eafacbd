"""The port's segmented replay (cmax_slam_tpu_torch/parallel/replay.py):
stitch_segments and its Procrustes gauge alignment against the JAX
package's on two spline trajectories with a known gauge, the input
validation of replay_multichip, and (slow tier) the full 3-segment replay
of tests/test_replay_multichip.py with its stitched-RMS gate.

Tolerances: the stitch is host numpy on float64 knots in both packages
(atol 1e-9); the recovered gauge is exact up to float64 rounding (1e-9);
the slow gate is the JAX test's (stitched RMS < 0.5 deg, max 1.5 deg)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cmax_slam_tpu import spline as jspline
from cmax_slam_tpu.parallel import replay as jreplay
from cmax_slam_tpu_torch import lie, spline
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import (
    BackendConfig, FrontendConfig, PanoMapOptions, SlidingWindowOptions,
    SystemConfig, TrajectoryOptions, WarpOptions,
)
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.parallel import replay
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

torch.set_num_threads(1)

W, H = 120, 90
FXY = 90.0
CALIB = CameraCalibration(width=W, height=H,
                          K=np.array([[FXY, 0, W / 2], [0, FXY, H / 2], [0, 0, 1.0]]))
DT = 0.05
OMEGA = np.array([0.6, -1.1, 0.9])
GAUGE = np.array([0.3, -0.7, 1.9])  # segment 1's gauge, as a rotation vector


def _fake_segments(spl, Segment):
    """Two segments fed over [0, 1.4) and [0.6, 2.0) (kept [0, 1) and [1, 2),
    overlap 0.4), each a linear-spline trajectory of the same motion; the
    second in another gauge G (knots G * q(t))."""
    g = spl._np_quat_exp(GAUGE)
    segs = []
    for i, (t_beg, t_end) in enumerate([(0.0, 1.4), (0.6, 2.0)]):
        n = int(round((t_end - t_beg) / DT)) + 1
        knots = np.stack([spl._np_quat_exp(OMEGA * (t_beg + k * DT)) for k in range(n)])
        if i == 1:
            knots = np.stack([spl._np_quat_mul(g, q) for q in knots])
        traj = spl.Trajectory(t_beg, DT, 2)
        traj.push_ctrl_poses(knots)
        slam = SimpleNamespace(backend=SimpleNamespace(traj=traj), flush=lambda: None)
        segs.append(Segment(index=i, device="cpu", t_lo=t_beg, t_hi=min(t_end, 2.0),
                            t_keep_lo=float(i), t_keep_hi=float(i + 1), slam=slam))
    return segs


def test_stitch_matches_jax_and_recovers_the_gauge():
    t_p, q_p = replay.stitch_segments(_fake_segments(spline, replay.Segment))
    t_j, q_j = jreplay.stitch_segments(_fake_segments(jspline, jreplay.Segment))
    np.testing.assert_array_equal(t_p, t_j)
    # quaternion sign is a convention of from_matrix: compare rotations
    R_p = replay.quat_to_rotmats(q_p)
    np.testing.assert_allclose(R_p, replay.quat_to_rotmats(np.asarray(q_j)), atol=1e-9)
    assert np.all(np.diff(t_p) > 0) and t_p[0] < 1e-5 and t_p[-1] > 1.9
    # segment 1's gauge is removed: the stitched poses are the true motion's
    # linear spline, R(t) = exp(omega t) at the knots and between them
    R_true = replay.quat_to_rotmats(np.stack([spline._np_quat_exp(OMEGA * t) for t in t_p]))
    np.testing.assert_allclose(R_p, R_true, atol=1e-9)


def test_procrustes_recovers_a_known_rotation():
    rng = np.random.default_rng(4)
    qs = np.stack([spline._np_quat_exp(v) for v in rng.normal(size=(20, 3))])
    A = replay.quat_to_rotmats(spline._np_quat_exp(GAUGE))[0]
    q_b = lie.from_matrix(torch.as_tensor(A.T[None] @ replay.quat_to_rotmats(qs))).numpy()
    np.testing.assert_allclose(replay._procrustes_quat(qs, q_b), A, atol=1e-9)


def test_segmented_replay_validates_inputs():
    ts = np.linspace(0.0, 2.0, 1000)
    xs = ys = np.zeros(1000, np.int32)
    ps = np.ones(1000, np.int8)
    with pytest.raises(ValueError, match="devices"):
        replay.replay_multichip(xs, ys, ts, ps, CALIB, _cfg(), n_segments=9,
                                devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="overlap"):
        replay.replay_multichip(xs, ys, ts, ps, CALIB, _cfg(), n_segments=3, overlap=10.0,
                                devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="non-empty list"):
        replay.replay_multichip(xs, ys, ts, ps, CALIB, _cfg(), n_segments=1, devices=None)


def _cfg():
    """tests/test_replay_multichip.py's configuration."""
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=6000, dt_ang_vel=0.02,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=256, pano_width=512, backend_min_ev_rate=1000,
                max_update_times=200,
            ),
            crop_solver=False,
        ),
    )


@pytest.mark.slow
def test_segmented_replay_stitches():
    """The JAX test's full run: 2 s, 400k events, 3 segments with 0.3 s
    overlaps on three CPU devices, each fed from its own thread; then the
    concurrent refine of every segment must improve the stitched result."""
    from test_e2e import smooth_rot_fn

    rng = np.random.default_rng(21)
    n, duration = 400_000, 2.0
    rot_fn, _ = smooth_rot_fn(duration)
    ev = synthetic.rotating_camera_events(
        rng, n, duration, np.zeros(3), FXY, FXY, W / 2, H / 2, W, H,
        n_points=260, rot_fn=rot_fn)
    times, quats, segs = replay.replay_multichip(
        ev.xs, ev.ys, ev.ts, ev.pols, CALIB, _cfg(), n_segments=3, overlap=0.3,
        chunk_events=40_000, devices=["cpu"] * 3)
    assert all(len(s.slam.window_results()) >= 2 for s in segs)
    assert len(times) > 100 and np.all(np.diff(times) > 0)
    q_gt = lie.from_matrix(torch.as_tensor(rot_fn(times))).numpy()
    rms, errs = rotation_rms_deg(times, q_gt, quats, "global")
    assert rms < 0.5, f"stitched RMS {rms} deg (max err {errs.max()})"
    assert errs.max() < 1.5, f"seam outlier: max err {errs.max()} deg"

    replay.refine_segments(segs, ev.xs, ev.ys, ev.ts, ev.pols, passes=1)
    times_r, quats_r = replay.stitch_segments(segs)
    q_gt_r = lie.from_matrix(torch.as_tensor(rot_fn(times_r))).numpy()
    rms_r, _ = rotation_rms_deg(times_r, q_gt_r, quats_r, "global")
    assert rms_r < min(0.35, rms + 0.05), f"refined RMS {rms_r} deg (online {rms})"
