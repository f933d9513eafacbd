"""The port's lie, spline, blur, contrast and fov_mask against the JAX package
on the same float32 inputs (x64 is on for the whole test run, so every JAX input is
an explicit float32 array).

Tolerances: elementwise float32 math agrees to a few ulps (atol 1e-5 on unit
quaternions and matrices); blur and contrast reduce sums in another order
(rtol 1e-5); fov_mask rounds projected pixel centres, so a ray that lands
within float32 rounding of a .5 boundary may round differently in the two
frameworks: the masks may differ on at most 0.1% of pixels."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu import calib as jcalib, lie as jlie, spline as jspline
from cmax_slam_tpu.config import (
    IMAGE_GRADIENT_MAGNITUDE_CONTRAST, MEAN_SQUARE_CONTRAST, VARIANCE_CONTRAST)
from cmax_slam_tpu.ops import blur as jblur, contrast as jcontrast, warp_pano as jwarp_pano
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu_torch import calib, lie, spline
from cmax_slam_tpu_torch.ops import blur, contrast, warp_pano

torch.set_num_threads(1)

MEASURES = [VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST, IMAGE_GRADIENT_MAGNITUDE_CONTRAST]


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_lie_matches_jax(rng):
    scale = rng.choice([1e-8, 1e-3, 1.0, 3.0], size=(64, 1))  # incl. the small-angle branch
    v = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    pairs = [
        (lie.exp(_t(v)), jlie.exp(_j(v))),
        (lie.log(_t(q1)), jlie.log(_j(q1))),
        (lie.mul(_t(q1), _t(q2)), jlie.mul(_j(q1), _j(q2))),
        (lie.inv(_t(q1)), jlie.inv(_j(q1))),
        (lie.normalize(_t(2 * q1)), jlie.normalize(_j(2 * q1))),
        (lie.to_matrix(_t(q1)), jlie.to_matrix(_j(q1))),
        (lie.from_matrix(lie.to_matrix(_t(q1))), jlie.from_matrix(jlie.to_matrix(_j(q1)))),
        (lie.rotate(_t(q1), _t(x)), jlie.rotate(_j(q1), _j(x))),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=str(i))
    # autograd is NaN-free at the identity (the BA evaluates at zero increments)
    z = torch.zeros(2, 3, requires_grad=True)
    lie.log(lie.exp(z)).sum().backward()
    assert torch.isfinite(z.grad).all()


@pytest.mark.parametrize("order", [2, 4])
def test_spline_matches_jax(rng, order):
    K, dt = 9, 0.05
    knots = _quats(rng, K)
    t = rng.uniform(0, (K - order + 1) * dt, 50).astype(np.float32)
    q_t = spline.evaluate(_t(knots), _t(t), 0.0, dt, order)
    q_j = jspline.evaluate(_j(knots), _j(t), 0.0, jnp.float32(dt), order)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)
    R_t = spline.evaluate_rotmats(_t(knots), _t(t), 0.0, dt, order)
    R_j = jspline.evaluate_rotmats(_j(knots), _j(t), 0.0, jnp.float32(dt), order)
    np.testing.assert_allclose(np.array([[c.numpy() for c in r] for r in R_t]),
                               np.array([[np.asarray(c) for c in r] for r in R_j]), atol=1e-5)
    # host float64 helpers are the JAX package's own
    np.testing.assert_allclose(spline.evaluate_np(knots, t, 0.0, dt, order),
                               jspline.evaluate_np(knots, t, 0.0, dt, order), atol=1e-12)
    d = (rng.normal(size=(K, 3)) * 0.05).astype(np.float32)
    mask = (np.arange(K) >= 2).astype(np.float32)
    np.testing.assert_allclose(
        spline.apply_masked_increments(_t(knots), _t(d), _t(mask)).numpy(),
        np.asarray(jspline.apply_masked_increments(_j(knots), _j(d), _j(mask))), atol=1e-6)
    np.testing.assert_allclose(
        spline.incremental_update(_t(knots), _t(d[3:]), 3).numpy(),
        np.asarray(jspline.incremental_update(_j(knots), _j(d[3:]), 3)), atol=1e-6)
    # host Trajectory update in float64, without a device round trip
    tr = spline.Trajectory(0.0, dt, order)
    tr.push_ctrl_poses(knots.astype(np.float64))
    tr.incremental_update(d[3:].astype(np.float64), 3)
    np.testing.assert_allclose(
        tr.knots, np.asarray(jspline.incremental_update(jnp.asarray(knots, jnp.float64),
                                                        jnp.asarray(d[3:], jnp.float64), 3)),
        atol=1e-12)


def test_fit_ctrl_poses_matches_jax(rng):
    times = np.sort(rng.uniform(0, 0.2, 30))
    quats = np.stack([jspline._np_quat_exp(np.array([0.5, -1.0, 2.0]) * t) for t in times])
    np.testing.assert_allclose(spline.fit_ctrl_poses(times, quats, 0.0, 0.05, 5, 2),
                               jspline.fit_ctrl_poses(times, quats, 0.0, 0.05, 5, 2), atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 40), (3, 17, 29)])
def test_blur_matches_jax_with_border_adjoint(rng, shape):
    img = rng.uniform(0, 3, shape).astype(np.float32)
    key = rng.normal(size=shape).astype(np.float32)
    out_t = blur.gaussian_blur(_t(img), 1.0)
    out_j = jblur.gaussian_blur(_j(img), 1.0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    # The adjoint is B^T, not B: the reflect-101 band matrix is asymmetric
    # at the borders, so the gradient differs from the blur of the key there.
    ti = _t(img).requires_grad_(True)
    torch.sum(_t(key) * blur.gaussian_blur(ti, 1.0)).backward()
    g_j = jax.grad(lambda a: jnp.vdot(_j(key), jblur.gaussian_blur(a, 1.0)))(_j(img))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    H, W = shape[-2:]
    bh, bw = blur._blur_matrix(H, 1.0), blur._blur_matrix(W, 1.0)
    np.testing.assert_allclose(ti.grad.numpy(), bh.T @ key @ bw, rtol=1e-5, atol=1e-5)
    assert not np.allclose(ti.grad.numpy(), blur.gaussian_blur(_t(key), 1.0).numpy(), atol=1e-3)


def test_blur_above_two_megapixels_is_shift_and_add(rng):
    """Just above 2^21 pixels both packages leave the band matmuls for the
    separable reflect-101 shift-and-add (JAX: _blur_conv). The port's result
    equals JAX's and the band-matrix blur's, and so does its gradient."""
    H, W = 1024, 2050
    assert H * W > blur.SHIFT_ADD_MIN_PIXELS >= 512 * 1024
    img = rng.uniform(0, 3, (H, W)).astype(np.float32)
    key = rng.normal(size=(H, W)).astype(np.float32)
    ti = _t(img).requires_grad_(True)
    out_t = blur.gaussian_blur(ti, 1.0)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(jblur.gaussian_blur(_j(img), 1.0)),
                               rtol=0, atol=1e-6)
    band = (torch.tensor(blur._blur_matrix(H, 1.0)) @ _t(img)
            @ torch.tensor(blur._blur_matrix(W, 1.0)).T)
    np.testing.assert_allclose(out_t.detach().numpy(), band.numpy(), rtol=0, atol=1e-6)
    torch.sum(_t(key) * out_t).backward()
    g_j = jax.grad(lambda a: jnp.vdot(_j(key), jblur.gaussian_blur(a, 1.0)))(_j(img))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(g_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("measure", MEASURES)
def test_contrast_and_stats_match_jax(rng, measure):
    img = rng.uniform(0, 2, (30, 44)).astype(np.float32)
    mask = np.zeros((30, 44), np.float32)
    mask[3:27, 5:40] = 1.0
    np.testing.assert_allclose(float(contrast.contrast(_t(img), measure)),
                               float(jcontrast.contrast(_j(img), measure)), rtol=1e-5)
    for a, b in zip(contrast.region_stats(_t(img), _t(mask), measure),
                    jcontrast.region_stats(_j(img), _j(mask), measure)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-5)
    for a, b in zip(contrast.full_stats(_t(img), measure), jcontrast.full_stats(_j(img), measure)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-5)
    s1, s2 = contrast.full_stats(_t(img), measure)
    np.testing.assert_allclose(float(contrast.contrast_from_stats(s1, s2, img.size, measure)),
                               float(jcontrast.contrast(_j(img), measure)), rtol=1e-4)
    # a stack gives one value per image
    stack = np.stack([img, 2 * img])
    np.testing.assert_allclose(contrast.contrast(_t(stack), measure).numpy(),
                               [float(jcontrast.contrast(_j(s), measure)) for s in stack],
                               rtol=1e-5)


def test_fov_mask_and_equirect_match_jax(rng):
    W, H, FXY = 120, 90, 90.0
    lut = synthetic.identity_lut(W, H, FXY, FXY, W / 2, H / 2)
    q = _quats(rng, 3)
    pano_t = calib.EquirectCamera(width=512, height=256)
    pano_j = jcalib.EquirectCamera(width=512, height=256)
    rays = rng.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(pano_t.project(_t(rays)).numpy(),
                               np.asarray(pano_j.project(_j(rays))), atol=1e-4)
    uv = pano_t.project(_t(rays))
    np.testing.assert_allclose(pano_t.lift(uv).numpy(), np.asarray(pano_j.lift(_j(uv.numpy()))),
                               atol=1e-5)
    m_t = warp_pano.fov_mask(_t(q), _t(lut), pano_t, radius=3).numpy()
    m_j = np.asarray(jwarp_pano.fov_mask(_j(q), _j(lut), pano_j, radius=3))
    assert m_t.dtype == np.int32 and set(np.unique(m_t)) <= {0, 1}
    assert m_t.sum() > 1000
    assert np.mean(m_t != m_j) <= 1e-3
    # the bearing LUT is the JAX package's
    cal = jcalib.CameraCalibration(width=W, height=H, K=np.array(
        [[FXY, 0, W / 2], [0, FXY, H / 2], [0, 0, 1.0]]), D=np.array([-0.1, 0.02, 0.001, 0.0, 0.0]))
    cal_t = calib.CameraCalibration(width=W, height=H, K=cal.K, D=cal.D)
    np.testing.assert_array_equal(calib.bearing_lut(cal_t), jcalib.bearing_lut(cal))


def test_event_store_and_trigger_scan_match_jax(rng):
    """The host copies (EventStore, the numpy trigger walk) behave as the JAX
    package's on the same chunked stream, retirement included."""
    from cmax_slam_tpu.io.events import EventStore as JStore
    from cmax_slam_tpu.io.native import scan_triggers as j_scan
    from cmax_slam_tpu_torch.io.events import EventStore
    from cmax_slam_tpu_torch.io.native import scan_triggers

    ts = np.sort(rng.uniform(0, 0.5, 5000))
    xs = rng.integers(0, 120, 5000)
    ys = rng.integers(0, 90, 5000)
    ps = rng.choice([-1, 1], 5000)
    a, b = EventStore(), JStore()
    cur_a = cur_b = 0.005
    nxt_a = nxt_b = 0
    for lo in range(0, 5000, 700):
        sl = slice(lo, lo + 700)
        for st in (a, b):
            st.append(xs[sl], ys[sl], ts[sl], ps[sl])
        ta, cur_a, nxt_a = scan_triggers(a._ts, cur_a, nxt_a, 0.01)
        tb, cur_b, nxt_b = j_scan(b._ts, cur_b, nxt_b, 0.01)
        np.testing.assert_array_equal(ta, tb)
        assert (cur_a, nxt_a) == (cur_b, nxt_b)
    for st in (a, b):
        st.drop_before(1234)
    assert a.total == b.total and a.base == b.base
    for t in (0.1, 0.3):
        assert a.searchsorted_time(t) == b.searchsorted_time(t)
    for x, y in zip(a.slice_abs(1500, 1600), b.slice_abs(1500, 1600)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        a.append(xs[:1], ys[:1], ts[:1], ps[:1])  # out of timestamp order


def test_sparse_packets_take_the_degenerate_guard():
    """A packet spanning more than 10 * dt_ang_vel yields omega = 0 and resets
    the warm start (ang_vel_estimator.cpp:108-114), without a solve."""
    from cmax_slam_tpu_torch.config import FrontendConfig
    from cmax_slam_tpu_torch.frontend import Frontend
    from cmax_slam_tpu_torch.ops.warp_local import CameraParams

    W, H = 120, 90
    lut = synthetic.identity_lut(W, H, 90.0, 90.0, W / 2, H / 2)
    fe = Frontend(CameraParams(90.0, 90.0, W / 2, H / 2, W, H), lut,
                  FrontendConfig(num_events_per_packet=200, dt_ang_vel=0.01), device="cpu")
    fe.omega = np.array([1.0, 2.0, 3.0])
    ts = np.arange(600) * 0.02  # 200 events span 4 s >> 10 * dt
    ests = fe.push_events(np.full(600, 60), np.full(600, 45), ts, np.ones(600, np.int8))
    assert len(ests) > 0
    assert all(not e.omega.any() and e.iters == 0 for e in ests)
    np.testing.assert_array_equal(fe.omega, 0.0)
    assert "frontend.solve" not in fe.metrics.timers
