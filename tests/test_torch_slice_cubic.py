"""The whole slice with the cubic back-end (trajectory.spline_degree=3, a
spline of order 4), port against the JAX CMaxSLAM on tests/test_torch_slice.py's
0.5 s stream and overrides, both on the stock front-end schedule: the same
packet grid, window schedule, BA decisions and refined-pose times, and
per-packet omega within 0.06 rad/s (median 0.01 rad/s), that file's
tolerances; the two trajectories within 0.45 deg RMS of each other after
gauge alignment (0.290 measured, 0.947 at the worst sample), and each as
close to the ground truth as test_torch_slice.py holds the linear one.

Knot by knot the two systems do not agree within that file's 0.1 deg. With
JAX's front-end estimates fed to the port's back-end, the first window's BA
solves take the same decisions (bracket outcomes, secant refinements) for
six line searches while their iterates drift apart from the float32
rounding of the objective (initial costs -2.7428398 and -2.7428405); at the
seventh the secant refinement's stop test |g.u| <= 0.1 |g| reads 0.0153 in
JAX and 0.1161 in the port, and from there the solves part: the port's
stops on the stagnation test after 11 line searches, JAX's after 13, and
with the restart the window ends at -3.07736 (port, 17 line searches)
against -3.08419 (JAX, 21). The port alone, started 1e-8 rad away, stops
0.02-0.04 deg from its own optimum: the cubic window's stop point is
rounding-sensitive. The knot gate stands as a known miss in the slow tier
(ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import smooth_rot_fn
from test_torch_slice import (CHUNK, DURATION, FX, FY, H, KNOT_DEG, N_EVENTS, OVERRIDES, W,
                              _assert_omega_close, _knot_deg, _state, _systems, synthetic)

torch.set_num_threads(1)

CUBIC = dict(OVERRIDES, **{"backend.trajectory.spline_degree": 3})
CUBIC_GAP_DEG = 0.45


@pytest.fixture(scope="module")
def runs():
    rot_fn, _ = smooth_rot_fn(DURATION)
    ev = synthetic.rotating_camera_events(
        np.random.default_rng(3), N_EVENTS, DURATION, np.zeros(3), FX, FY, W / 2, H / 2,
        W, H, n_points=250, rot_fn=rot_fn)
    j, t = _systems(CUBIC)
    states_j, states_t = [], []
    for i in range(0, N_EVENTS, CHUNK):
        chunk = (ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK], ev.pols[i:i + CHUNK])
        j.push_events(*chunk)
        t.push_events(*chunk)
        states_j.append(_state(j))
        states_t.append(_state(t))
    return dict(rot_fn=rot_fn, j=j, t=t, states_j=states_j, states_t=states_t)


def test_cubic_per_packet_omega_matches_jax(runs):
    _assert_omega_close(runs["t"].ang_vel_log, runs["j"].ang_vel_log)
    assert len(runs["t"].ang_vel_log) >= 20
    assert runs["t"].metrics.counters["frontend.ring_packets"] > 0


def test_cubic_windows_and_trajectory_match_jax(runs):
    t, j = runs["t"], runs["j"]
    assert t.backend.traj.order == j.backend.traj.order == 4
    for (cw_t, k_t), (cw_j, k_j) in zip(runs["states_t"], runs["states_j"]):
        assert cw_t == cw_j and k_t.shape == k_j.shape
    res_t, res_j = t.window_results(), j.window_results()
    assert [(r.index, r.ran_ba) for r in res_t] == [(r.index, r.ran_ba) for r in res_j]
    assert sum(r.ran_ba for r in res_t) >= 3
    for r in res_t:
        assert r.final_cost <= r.initial_cost + 1e-7
    assert len(t.backend.bootstrap_results) == len(j.backend.bootstrap_results) > 0
    np.testing.assert_allclose([tt for tt, _ in t.trajectory_log],
                               [tt for tt, _ in j.trajectory_log], atol=1e-9)
    tr_t, tr_j = t.backend.traj, j.backend.traj
    grid = np.linspace(tr_t.t_beg + 1e-6, tr_t.max_time() - 1e-6, 40)
    q_gt = lie.from_matrix(torch.tensor(runs["rot_fn"](grid))).numpy()
    rms_t, _ = rotation_rms_deg(grid, q_gt, tr_t.evaluate(grid), "global")
    rms_j, _ = rotation_rms_deg(grid, q_gt, tr_j.evaluate(grid), "global")
    assert rms_t < max(2 * rms_j, 0.2), (rms_t, rms_j)
    gap, _ = rotation_rms_deg(grid, tr_j.evaluate(grid), tr_t.evaluate(grid), "global")
    assert gap < CUBIC_GAP_DEG, gap


def test_cubic_counters_split_the_first_solve_from_the_restart(runs):
    """Each completed window counts its first solve's line searches in
    ``backend.cg_iters`` and its restarted solve's in
    ``backend.restart_cg_iters``, read from the window's packed result: over
    the run they sum to the windows' ``WindowResult.iters``, and the
    restart (one a window for the cubic) takes some."""
    t = runs["t"]
    results = t.window_results()
    c = t.metrics.counters
    assert c["backend.cg_iters"] + c["backend.restart_cg_iters"] == sum(r.iters for r in results)
    assert c["backend.cg_iters"] > 0 and c["backend.restart_cg_iters"] > 0


@pytest.mark.slow
@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): float32 rounding flips the first window's secant "
    "stop test at its seventh line search and the solves stop at different points; "
    "knots 0.35 deg apart after the first window, degrees at the weakly constrained "
    "end knots"))
def test_cubic_knots_after_each_chunk_match_jax(runs):
    for (_, k_t), (_, k_j) in zip(runs["states_t"], runs["states_j"]):
        if len(k_t):
            assert _knot_deg(k_t, k_j).max() < KNOT_DEG, np.round(_knot_deg(k_t, k_j), 4)
