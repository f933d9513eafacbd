"""The whole slice, port against the JAX CMaxSLAM on one stream: the
tests/test_e2e.py recipe (120x90 camera, smooth rotation, stock ijrr preset
with its dataset-scale overrides) cut to 0.5 s.

The panorama is test_e2e's 256x512: at 128x256 the window footprint needs a
crop of 70% of the panorama or more, so every window would take the full-pano
solver and the crop solver, the stock path, would go untested; a second,
0.4 s run on 128x256 covers that full-panorama path. The bootstrap re-solve
fires at window 2 instead of 4 so that it runs within the stream.

Both systems run on the CPU in float32. Each CMax solve stops at its
tolerances (front-end grad_tol 1e-3, fun_tol 1e-4), and float32 summation
order moves the last line search of a solve, so two correct solvers agree
to the resolution of the solve, not to the last bit: per-packet omega within
0.06 rad/s (median 0.01 rad/s) and every knot within 0.1 deg, while the
window schedule, BA decisions and refined-pose times are identical.
"""

import numpy as np
import pytest
import torch

from cmax_slam_tpu.calib import CameraCalibration as JCalibration
from cmax_slam_tpu.config import ijrr_config as j_ijrr_config, replace as j_replace
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu.system import CMaxSLAM as JCMaxSLAM
from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import smooth_rot_fn

torch.set_num_threads(1)

W, H = 120, 90
FX = FY = 90.0
DURATION = 0.5
N_EVENTS = 50_000
CHUNK = 10_000
OVERRIDES = {
    "frontend.dt_ang_vel": 0.02,
    "backend.pano_map.pano_height": 256,
    "backend.pano_map.pano_width": 512,
    "backend.bootstrap_resolve_window": 2,
}
OMEGA_MAX, OMEGA_MEDIAN, KNOT_DEG = 0.06, 0.01, 0.1


def _systems(overrides=OVERRIDES):
    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1.0]])
    j = JCMaxSLAM(JCalibration(width=W, height=H, K=K),
                  j_replace(j_ijrr_config(num_events_per_packet=4000), **overrides))
    t = CMaxSLAM(CameraCalibration(width=W, height=H, K=K),
                 replace(ijrr_config(num_events_per_packet=4000), **overrides), device="cpu")
    return j, t


def _state(slam):
    """(windows completed, knots) after a chunk; each system is flushed
    first so that its in-flight window has completed too."""
    slam.flush()
    be = slam.backend
    knots = be.traj.knots.copy() if be.traj is not None else np.zeros((0, 4))
    return be.count_window, knots


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rot_fn, _ = smooth_rot_fn(DURATION)
    ev = synthetic.rotating_camera_events(
        np.random.default_rng(3), N_EVENTS, DURATION, np.zeros(3), FX, FY, W / 2, H / 2,
        W, H, n_points=250, rot_fn=rot_fn)
    j, t = _systems()
    states_j, states_t = [], []
    ckpt, cut = str(tmp_path_factory.mktemp("ckpt") / "jax.npz"), None
    for i in range(0, N_EVENTS, CHUNK):
        chunk = (ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK], ev.pols[i:i + CHUNK])
        j.push_events(*chunk)
        t.push_events(*chunk)
        states_j.append(_state(j))
        states_t.append(_state(t))
        if cut is None and j.backend.count_window >= 1:
            j.save_checkpoint(ckpt)  # mid-stream: windows done, bootstrap pending
            cut = i + CHUNK
    return dict(ev=ev, rot_fn=rot_fn, j=j, t=t, states_j=states_j, states_t=states_t,
                ckpt=ckpt, cut=cut)


def _assert_omega_close(log_t, log_j):
    assert log_t.shape == log_j.shape
    np.testing.assert_allclose(log_t[:, 0], log_j[:, 0], atol=1e-9)  # same packet grid
    err = np.linalg.norm(log_t[:, 1:] - log_j[:, 1:], axis=1)
    assert err.max() < OMEGA_MAX and np.median(err) < OMEGA_MEDIAN, np.round(err, 4)


def _knot_deg(a, b):
    return 2 * np.degrees(np.arccos(np.clip(np.abs(np.sum(a * b, axis=1)), 0, 1)))


def test_per_packet_omega_matches_jax(runs):
    _assert_omega_close(runs["t"].ang_vel_log, runs["j"].ang_vel_log)
    assert len(runs["t"].ang_vel_log) >= 20


def test_knots_after_each_window_match_jax(runs):
    for (cw_t, k_t), (cw_j, k_j) in zip(runs["states_t"], runs["states_j"]):
        assert cw_t == cw_j and k_t.shape == k_j.shape
        if len(k_t):
            assert _knot_deg(k_t, k_j).max() < KNOT_DEG, np.round(_knot_deg(k_t, k_j), 4)
    res_t, res_j = runs["t"].window_results(), runs["j"].window_results()
    assert [(r.index, r.ran_ba) for r in res_t] == [(r.index, r.ran_ba) for r in res_j]
    assert sum(r.ran_ba for r in res_t) >= 3
    for r in res_t:
        assert r.final_cost <= r.initial_cost + 1e-7
    # the stock path ran: crop solves and the bootstrap re-solve
    c_t, c_j = runs["t"].metrics.counters, runs["j"].metrics.counters
    for key in ("backend.crop_windows", "backend.refine_windows"):
        assert c_t.get(key, 0) == c_j.get(key, 0) > 0, key
    np.testing.assert_allclose([tt for tt, _ in runs["t"].trajectory_log],
                               [tt for tt, _ in runs["j"].trajectory_log], atol=1e-9)


def test_trajectory_and_map_match_jax(runs):
    j, t = runs["j"], runs["t"]
    tr_t, tr_j = t.backend.traj, j.backend.traj
    grid = np.linspace(tr_t.t_beg + 1e-6, tr_t.max_time() - 1e-6, 40)
    gap, _ = rotation_rms_deg(grid, tr_j.evaluate(grid), tr_t.evaluate(grid), "first")
    assert gap < KNOT_DEG
    q_gt = lie.from_matrix(torch.tensor(runs["rot_fn"](grid))).numpy()
    rms_t, _ = rotation_rms_deg(grid, q_gt, tr_t.evaluate(grid), "global")
    rms_j, _ = rotation_rms_deg(grid, q_gt, tr_j.evaluate(grid), "global")
    assert rms_t < max(2 * rms_j, 0.2), (rms_t, rms_j)
    ig_t, ig_j = t.backend.IG.numpy(), np.asarray(j.backend.IG)
    assert abs(ig_t.sum() - ig_j.sum()) < 1e-3 * ig_j.sum()
    upd_t, upd_j = t.backend.update_times.numpy(), np.asarray(j.backend.update_times)
    assert np.mean(upd_t != upd_j) < 1e-3


def test_jax_checkpoint_resumes_in_the_port(runs):
    """A JAX checkpoint loaded into the port resumes the stream; the port and
    a JAX system loaded from the same file continue alike on the remainder,
    and the port's own checkpoint carries the JAX keys and loads into JAX."""
    ev, cut = runs["ev"], runs["cut"]
    assert cut is not None and cut < N_EVENTS
    j, t = _systems()
    j.load_checkpoint(runs["ckpt"])
    t.load_checkpoint(runs["ckpt"])
    assert t.raw_count == cut and t.backend.count_window == j.backend.count_window >= 1
    np.testing.assert_array_equal(t.backend.traj.knots, j.backend.traj.knots)
    for i in range(cut, N_EVENTS, CHUNK):
        chunk = (ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK], ev.pols[i:i + CHUNK])
        j.push_events(*chunk)
        t.push_events(*chunk)
    j.flush()
    t.flush()
    _assert_omega_close(t.ang_vel_log, j.ang_vel_log)
    assert t.backend.count_window == j.backend.count_window == runs["j"].backend.count_window
    assert len(t.backend.bootstrap_results) == len(j.backend.bootstrap_results) > 0
    k_t, k_j = t.backend.traj.knots, j.backend.traj.knots
    assert k_t.shape == k_j.shape and _knot_deg(k_t, k_j).max() < KNOT_DEG

    path = runs["ckpt"].replace("jax.npz", "port.npz")
    t.save_checkpoint(path)
    with np.load(path) as d_t, np.load(runs["ckpt"]) as d_j:
        assert set(d_j.files) <= set(d_t.files)
    j2 = JCMaxSLAM(j.calib, j.cfg)
    j2.load_checkpoint(path)
    np.testing.assert_array_equal(j2.backend.traj.knots, k_t)
    np.testing.assert_array_equal(np.asarray(j2.backend.IG), t.backend.IG.numpy())
    assert j2.raw_count == t.raw_count == N_EVENTS


def test_full_pano_solver_matches_jax(runs):
    """On a 128x256 panorama no crop pays off (the footprint needs >= 70% of
    the map), so every window takes the full-panorama solver and the
    full-size old/new split: the path a crop escape falls back to."""
    ev = runs["ev"]
    n = 40_000  # 0.4 s
    j, t = _systems(dict(OVERRIDES, **{"backend.pano_map.pano_height": 128,
                                       "backend.pano_map.pano_width": 256}))
    for i in range(0, n, CHUNK):
        chunk = (ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK], ev.pols[i:i + CHUNK])
        j.push_events(*chunk)
        t.push_events(*chunk)
    j.flush()
    t.flush()
    assert "backend.crop_windows" not in t.metrics.counters
    assert t.backend.count_window == j.backend.count_window >= 2
    _assert_omega_close(t.ang_vel_log, j.ang_vel_log)
    k_t, k_j = t.backend.traj.knots, j.backend.traj.knots
    assert k_t.shape == k_j.shape and _knot_deg(k_t, k_j).max() < KNOT_DEG
    ig_t, ig_j = t.backend.IG.numpy(), np.asarray(j.backend.IG)
    assert abs(ig_t.sum() - ig_j.sum()) < 1e-3 * ig_j.sum()


def test_max_ba_correction_rejects_like_jax(runs):
    """backend.max_ba_correction_rad: the BA solve stops at the trust radius
    and a window whose correction moves a knot past the cap is rejected (the
    front-end knots stay, the map absorbs nothing). At a cap of 1e-4 rad
    every window that runs BA on this stream is rejected by both systems."""
    ev = runs["ev"]
    n = 40_000  # 0.4 s
    j, t = _systems(dict(OVERRIDES, **{"backend.max_ba_correction_rad": 1e-4}))
    for i in range(0, n, CHUNK):
        chunk = (ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK], ev.pols[i:i + CHUNK])
        j.push_events(*chunk)
        t.push_events(*chunk)
    j.flush()
    t.flush()
    res_t, res_j = t.window_results(), j.window_results()
    assert [(r.index, r.ran_ba, r.rejected) for r in res_t] == \
        [(r.index, r.ran_ba, r.rejected) for r in res_j]
    assert all(r.rejected for r in res_t if r.ran_ba) and sum(r.ran_ba for r in res_t) >= 2
    c_t, c_j = t.metrics.counters, j.metrics.counters
    assert c_t["backend.ba_rejected"] == c_j["backend.ba_rejected"] >= 2
    assert not t.backend.IG.any() and not np.asarray(j.backend.IG).any()
    _assert_omega_close(t.ang_vel_log, j.ang_vel_log)
    k_t, k_j = t.backend.traj.knots, j.backend.traj.knots
    assert k_t.shape == k_j.shape and _knot_deg(k_t, k_j).max() < KNOT_DEG
