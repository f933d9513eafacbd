"""The ECRot-real presets' options in the port against the JAX package on one
stream: ``ecrot_mount_config()`` (``y_angle_deg = -90``, non-overlapping
0.2 s windows) with the reference's live-mode shedding as
examples/tpu_ecrot_realtime_check.py's ECRT_SHED sets it
(``frontend_event_sample_rate = 10``, ``backend.warp.event_sample_rate =
5``, packets of a tenth the events).

The stream is that example's cut to the CPU: its omega, seed and 1200
landmarks in the default 120-degree cone, on a 160x120 camera (the 640x480
camera's focal length over 4) at 500 000 events/s for 0.8 s, pushed in
chunks whose sizes are not multiples of 10; the panorama is 256x512 and a
packet holds 2 000 decimated events, so that it spans 0.04 s as the
preset's 20 000 do at 5 Mev/s. Both systems run on the CPU in float32.

- front-end decimation: the events each system hands its front-end, and
  ``raw_count``, are equal, and are every tenth raw event across the chunks;
- in-batch decimation: one window's marshalled events (pixels, selected
  lanes, old/new split, batch times) are equal exactly;
- ``y_angle_deg``: the first window's knots carry the quarter turn about +Y,
  and its full-panorama objective's value and gradient agree (rtol 1e-4;
  gradient rtol 2e-3 of its scale, the tolerances of
  tests/test_torch_objectives.py);
- non-overlapping windows: the window count, boundaries and BA decisions
  are equal, each window 0.2 s long and starting where the last ended;
- the whole system: per-packet omega within OMEGA_MAX rad/s, the final
  knots and the trajectory within KNOT_DEG deg, and the global map's sum
  within 1e-3 and every pixel within MAP_REL of its largest (the gates of
  tests/test_torch_slice.py, and for the map the largest pixel
  difference's own scale: measured 0.018 rad/s, 0.084 deg, and 0.56 of a
  largest pixel of 14.05, about 4%: float32 summation order moves the last
  line search of a solve, and the map follows the knots).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cmax_slam_tpu.calib import CameraCalibration as JCalibration
from cmax_slam_tpu.config import ecrot_mount_config as j_ecrot_mount_config
from cmax_slam_tpu.config import replace as j_replace
from cmax_slam_tpu.ops import warp_pano as jwarp_pano
from cmax_slam_tpu.system import CMaxSLAM as JCMaxSLAM
from cmax_slam_tpu_torch.calib import CameraCalibration, EquirectCamera
from cmax_slam_tpu_torch.config import ecrot_mount_config, replace
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops import warp_pano
from cmax_slam_tpu_torch.system import CMaxSLAM

torch.set_num_threads(1)

W, H = 160, 120
F = 335.0 / 4
OMEGA = np.array([0.5, -0.9, 1.3])
RATE, DURATION = 500_000, 0.8
CHUNKS = (9_997, 10_003, 4_321, 25_679)  # pushed in turn: no size a multiple of 10
SHED = {"frontend_event_sample_rate": 10, "frontend.num_events_per_packet": 2_000,
        "backend.warp.event_sample_rate": 5,
        "backend.pano_map.pano_height": 256, "backend.pano_map.pano_width": 512}
OMEGA_MAX, KNOT_DEG, MAP_REL = 0.06, 0.1, 0.05


def _chunks(n):
    i, k = 0, 0
    while i < n:
        j = min(n, i + CHUNKS[k % len(CHUNKS)])
        yield i, j
        i, k = j, k + 1


def _spy_frontend(slam, into):
    push = slam.frontend.push_events

    def pushed(xs, ys, ts, ps):
        into.append((xs.copy(), ys.copy(), ts.copy(), ps.copy()))
        return push(xs, ys, ts, ps)

    slam.frontend.push_events = pushed


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(3)
    ev = synthetic.rotating_camera_events(rng, int(RATE * DURATION), DURATION, OMEGA, F, F,
                                          W / 2, H / 2, W, H, n_points=1200)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    j = JCMaxSLAM(JCalibration(width=W, height=H, K=K),
                  j_replace(j_ecrot_mount_config(), **SHED))
    t = CMaxSLAM(CameraCalibration(width=W, height=H, K=K),
                 replace(ecrot_mount_config(), **SHED), device="cpu")
    fed = {"j": [], "t": []}
    _spy_frontend(j, fed["j"])
    _spy_frontend(t, fed["t"])
    for a, b in _chunks(len(ev.ts)):
        chunk = (ev.xs[a:b], ev.ys[a:b], ev.ts[a:b], ev.pols[a:b])
        j.push_events(*chunk)
        t.push_events(*chunk)
    j.flush()
    t.flush()
    return dict(ev=ev, j=j, t=t, fed=fed)


def test_frontend_decimation_across_chunks_matches_jax(runs):
    ev, j, t = runs["ev"], runs["j"], runs["t"]
    assert t.raw_count == j.raw_count == len(ev.ts)
    got = [np.concatenate(c) for c in zip(*runs["fed"]["t"])]
    ref = [np.concatenate(c) for c in zip(*runs["fed"]["j"])]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    every10 = (ev.xs[::10], ev.ys[::10], ev.ts[::10], ev.pols[::10])
    assert all(np.array_equal(a, b) for a, b in zip(got, every10))


def _first_window_events(runs):
    """The first window's events as both back-ends took them: the
    front-end's decimated stream in [t_beg, t_end)."""
    xs, ys, ts, _ = (np.concatenate(c) for c in zip(*runs["fed"]["t"]))
    r = runs["t"].window_results()[0]
    a, b = np.searchsorted(ts, r.t_beg, "left"), np.searchsorted(ts, r.t_end - 1e-6, "right")
    return xs[a:b], ys[a:b], ts[a:b]


def test_inbatch_decimation_matches_jax(runs):
    xs, ys, ts = _first_window_events(runs)
    got = runs["t"].backend._window_arrays(xs, ys, ts, 0)
    ref = runs["j"].backend._window_arrays(xs, ys, ts, 0)
    evd = np.asarray(ref["evd"])
    assert len(got["valid"]) == ref["size"]
    np.testing.assert_array_equal(got["xs"], ref["np_xs"])
    np.testing.assert_array_equal(got["ys"], ref["np_ys"])
    np.testing.assert_array_equal(got["valid"], ref["np_valid"])
    np.testing.assert_array_equal(got["valid"], (evd >> 24) & 1 == 1)
    np.testing.assert_array_equal(got["is_old"], (evd >> 25) & 1 == 1)
    np.testing.assert_array_equal(got["batch_rel"], ref["np_batch_rel"])
    # every 5th lane of each 100-event batch, of the events the window holds
    bs, n = 100, len(ts)
    lanes = np.arange(len(got["valid"]))
    np.testing.assert_array_equal(got["valid"], (lanes < n) & ((lanes % bs) % 5 == 0))


def test_y_angle_window_objective_matches_jax(runs):
    j, t = runs["j"], runs["t"]
    # The first pose is the quarter turn about +Y (backend.py's q0).
    q0 = np.array([np.cos(np.radians(-45.0)), 0.0, np.sin(np.radians(-45.0)), 0.0])
    for slam in (j, t):
        assert abs(abs(np.dot(slam.backend.traj.knots[0], q0)) - 1.0) < 0.05
    xs, ys, ts = _first_window_events(runs)
    arrays = t.backend._window_arrays(xs, ys, ts, 0)
    be = t.backend
    K = be.K_win
    knots = np.asarray(j.backend.traj.knots[:K], np.float32)
    lut = be.lut
    valid = arrays["valid"]
    pixel = np.where(valid, arrays["ys"] * W + arrays["xs"], 0)
    bearings = np.ascontiguousarray(lut[pixel].T).astype(np.float32)
    ig = np.asarray(j.backend.IG, np.float32)
    common = dict(batch_times=arrays["batch_rel"], weights=valid.astype(np.float32),
                  is_old=arrays["is_old"], knots=knots, free_mask=np.ones(K, np.float32))
    win_j = jwarp_pano.PanoWindow(
        bearings=jnp.asarray(bearings), **{k: jnp.asarray(v) for k, v in common.items()},
        t0=jnp.float32(0.0), dt_knots=jnp.float32(be.cfg.trajectory.dt_knots),
        ig_prime=jnp.asarray(ig), alpha=jnp.float32(0.5))
    win_t = warp_pano.PanoWindow(
        bearings=torch.tensor(bearings), **{k: torch.tensor(v) for k, v in common.items()},
        t0=0.0, dt_knots=float(np.float32(be.cfg.trajectory.dt_knots)),
        ig_prime=torch.tensor(ig), alpha=torch.tensor(0.5))
    pano = EquirectCamera(width=ig.shape[1], height=ig.shape[0])
    _, vg_j = jwarp_pano.make_pano_objective(win_j, j.backend.pano, be.order, 1.0, 0)
    _, vg_t = warp_pano.make_pano_objective(win_t, pano, be.order, 1.0, 0)
    rng = np.random.default_rng(0)
    for scale in (0.0, 0.005):
        d = (rng.normal(size=3 * K) * scale).astype(np.float32)
        v_j, g_j = vg_j(jnp.asarray(d))
        v_t, g_t = vg_t(torch.tensor(d))
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=2e-3 * np.abs(g_j).max() + 1e-6)


def test_non_overlapping_windows_match_jax(runs):
    res_t, res_j = runs["t"].window_results(), runs["j"].window_results()
    assert len(res_t) == len(res_j) >= 3
    assert ([(r.index, r.num_events, r.ran_ba) for r in res_t]
            == [(r.index, r.num_events, r.ran_ba) for r in res_j])
    np.testing.assert_allclose([(r.t_beg, r.t_end) for r in res_t],
                               [(r.t_beg, r.t_end) for r in res_j], rtol=0, atol=1e-12)
    for a, b in zip(res_t, res_t[1:]):
        assert abs(a.t_end - a.t_beg - 0.2) < 1e-9 and abs(b.t_beg - a.t_end) < 1e-9
    assert all(r.ran_ba for r in res_t)


def test_mount_with_shedding_system_matches_jax(runs):
    j, t = runs["j"], runs["t"]
    log_t, log_j = t.ang_vel_log, j.ang_vel_log
    assert log_t.shape == log_j.shape and len(log_t) >= 60
    np.testing.assert_allclose(log_t[:, 0], log_j[:, 0], rtol=0, atol=1e-9)
    err = np.linalg.norm(log_t[:, 1:] - log_j[:, 1:], axis=1)
    assert err.max() < OMEGA_MAX, np.round(err, 4)
    k_t, k_j = t.backend.traj.knots, np.asarray(j.backend.traj.knots)
    assert k_t.shape == k_j.shape
    deg = 2 * np.degrees(np.arccos(np.clip(np.abs(np.sum(k_t * k_j, axis=1)), 0, 1)))
    assert deg.max() < KNOT_DEG, np.round(deg, 4)
    ig_t, ig_j = t.backend.IG.numpy(), np.asarray(j.backend.IG)
    assert abs(ig_t.sum() - ig_j.sum()) < 1e-3 * ig_j.sum()
    assert np.abs(ig_t - ig_j).max() < MAP_REL * ig_j.max()
    grid = np.linspace(t.backend.traj.t_beg + 1e-6, t.backend.traj.max_time() - 1e-6, 40)
    q_t, q_j = t.backend.traj.evaluate(grid), np.asarray(j.backend.traj.evaluate(grid))
    gap = 2 * np.degrees(np.arccos(np.clip(np.abs(np.sum(q_t * q_j, axis=1)), 0, 1)))
    assert gap.max() < KNOT_DEG, np.round(gap, 4)
