"""Library functions the JAX package exports, ported with the slice: each fed
the same numpy inputs in both packages.

Tolerances: the SO(3) helpers, the spline Jacobian, the projections and the
bilinear sample run in float64 in both packages (the JAX tests enable x64),
so they agree to rounding: 1e-12. The packet is gathered and its batch
midpoints subtracted in float32 in both: equal to 1e-7. The host helpers
(distortion, midpoint interpolation, control-pose fit, text parsing, window
search) are the same numpy arithmetic: equal. The back-end's run/flush/close
and the front-end's close are synchronous in the port: nothing is in flight.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu import calib as jcalib, lie as jlie, spline as jspline
from cmax_slam_tpu.io import native as jnative
from cmax_slam_tpu.ops import scatter as jscatter, warp_local as jwarp_local
from cmax_slam_tpu_torch import calib, lie, spline
from cmax_slam_tpu_torch.backend import Backend
from cmax_slam_tpu_torch.config import ijrr_config
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import native
from cmax_slam_tpu_torch.io.events import EventStore
from cmax_slam_tpu_torch.ops import scatter, warp_local

torch.set_num_threads(1)


def _rotvecs(rng, n, scale=2.5):
    v = rng.normal(size=(n, 3))
    v[0] = 0.0
    v[1] = [1e-9, -1e-9, 2e-9]
    return v * np.array([[scale]] * n) / np.maximum(1.0, np.linalg.norm(v, axis=1,
                                                                       keepdims=True))


@pytest.mark.parametrize("name", ["hat", "left_jacobian", "left_jacobian_inv"])
def test_lie_matrices_match_jax(rng, name):
    v = _rotvecs(rng, 24)
    got = getattr(lie, name)(torch.tensor(v)).numpy()
    ref = np.asarray(getattr(jlie, name)(jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, atol=1e-12)
    if name == "hat":
        x = rng.normal(size=(24, 3))
        np.testing.assert_allclose(np.einsum("nij,nj->ni", got, x), np.cross(v, x), atol=1e-12)


def test_identity_matches_jax():
    np.testing.assert_array_equal(lie.identity().numpy(), np.asarray(jlie.identity()))
    assert lie.identity(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("order", [2, 4])
def test_evaluate_with_jacobian_matches_jax(rng, order):
    knots = np.stack([spline._np_quat_exp(w) for w in rng.normal(size=(8, 3)) * 0.4])
    t = np.array([0.05, 0.33, 0.61, 0.9])
    q_t, s_t, J_t = spline.evaluate_with_jacobian(torch.tensor(knots), torch.tensor(t), 0.0,
                                                  0.2, order)
    q_j, s_j, J_j = jspline.evaluate_with_jacobian(jnp.asarray(knots), jnp.asarray(t), 0.0,
                                                   0.2, order)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-12)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-12)
    assert J_t.shape == (len(t), order, 3, 3)
    np.testing.assert_allclose(q_t.numpy(), spline.evaluate(torch.tensor(knots),
                                                            torch.tensor(t), 0.0, 0.2,
                                                            order).numpy(), atol=1e-12)


def test_interp_pose_mid_and_generate_ctrl_poses_match_jax(rng):
    q1, q2 = (spline._np_quat_exp(w) for w in rng.normal(size=(2, 3)) * 0.5)
    t_t, q_t = spline.interp_pose_mid(0.1, q1, 0.3, q2)
    t_j, q_j = jspline.interp_pose_mid(0.1, q1, 0.3, q2)
    assert t_t == t_j
    np.testing.assert_array_equal(q_t, q_j)
    omega = np.array([0.5, -0.2, 0.8])
    times = np.linspace(0, 0.2, 21)
    qs = np.stack([spline._np_quat_exp(omega * t) for t in times])
    for order in (2, 4):
        got = spline.Trajectory(0.0, 0.05, order).generate_ctrl_poses(times, qs, 0.0, 0.2)
        ref = jspline.Trajectory(0.0, 0.05, order).generate_ctrl_poses(times, qs, 0.0, 0.2)
        assert len(got) == 4 + order - 1
        np.testing.assert_array_equal(got, ref)


def test_projection_helpers_match_jax(rng):
    pts = rng.normal(size=(50, 3)) + np.array([0.0, 0.0, 4.0])
    D = np.array([-0.3, 0.1, 1e-3, -2e-3, 0.01])
    np.testing.assert_array_equal(calib.distort_points(pts[:, :2], D),
                                  jcalib.distort_points(pts[:, :2], D))
    np.testing.assert_array_equal(calib.distort_points(pts[:, :2], D[:2]),
                                  jcalib.distort_points(pts[:, :2], D[:2]))
    can_t = calib.canonical_project(torch.tensor(pts))
    can_j = jcalib.canonical_project(jnp.asarray(pts))
    np.testing.assert_allclose(can_t.numpy(), np.asarray(can_j), atol=1e-12)
    px_t = calib.apply_intrinsics(can_t, 190.0, 180.0, 120.5, 90.5).numpy()
    px_j = np.asarray(jcalib.apply_intrinsics(can_j, 190.0, 180.0, 120.5, 90.5))
    np.testing.assert_allclose(px_t, px_j, atol=1e-12)


def test_bilinear_sample_matches_jax(rng):
    H, W = 30, 40
    img = rng.normal(size=(H, W))
    px = rng.uniform(-3, W + 3, 500)
    py = rng.uniform(-3, H + 3, 500)
    got = scatter.bilinear_sample(torch.tensor(img), torch.tensor(px), torch.tensor(py))
    ref = jscatter.bilinear_sample(jnp.asarray(img), jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)


def test_make_packet_matches_jax(rng):
    W, H, S, n, bs = 60, 40, 800, 650, 100
    lut = rng.normal(size=(W * H, 3)).astype(np.float32)
    xs = rng.integers(0, W, S).astype(np.int32)
    ys = rng.integers(0, H, S).astype(np.int32)
    ts = np.sort(rng.uniform(0, 0.01, S)).astype(np.float32)
    valid = np.arange(S) < n
    cam = warp_local.CameraParams(50.0, 50.0, W / 2, H / 2, W, H)
    got = warp_local.make_packet(torch.tensor(xs), torch.tensor(ys), torch.tensor(ts),
                                 torch.tensor(valid), torch.tensor(lut), cam, bs,
                                 float(np.float32(0.005)))
    ref = jwarp_local.make_packet(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ts),
                                  jnp.asarray(valid), jnp.asarray(lut),
                                  jwarp_local.CameraParams(*cam), bs, np.float32(0.005))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def test_parse_events_txt_and_window_match_jax(tmp_path, rng):
    ts = np.sort(rng.uniform(0, 1, 300))
    path = tmp_path / "ev.txt"
    with open(path, "w") as fh:
        for t, x, y, p in zip(ts, rng.integers(0, 240, 300), rng.integers(0, 180, 300),
                              rng.integers(0, 2, 300)):
            fh.write(f"{t:.9f} {x} {y} {p}\n")
    for max_events in (-1, 120):
        got = native.parse_events_txt(str(path), max_events)
        ref = jnative.parse_events_txt(str(path), max_events)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    for lo, hi in ((0.2, 0.5), (-1.0, 0.0), (0.9, 2.0), (float(ts[10]), float(ts[20]))):
        assert native.window(ts, lo, hi) == jnative.window(ts, lo, hi)


def test_backend_run_flush_close_and_frontend_close():
    """A back-end with nothing in flight: run() steps while a window is
    ready and returns them, flush() and close() return None (no window to
    complete), and the front-end's close() returns None."""
    cfg = ijrr_config()
    W, H = 24, 18
    lut = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (W * H, 1))
    be = Backend(W, H, lut, cfg.backend, EventStore(), device="cpu")
    assert be.run() == [] and be.flush() is None and be.close() is None
    cam = warp_local.CameraParams(20.0, 20.0, W / 2, H / 2, W, H)
    fe = Frontend(cam, lut, cfg.frontend, device="cpu")
    assert fe.close() is None
