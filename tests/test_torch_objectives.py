"""Value and gradient of the port's local (front-end) and crop (back-end)
objectives against the JAX package's, including at omega = 0 on quantized
events (the cold start, where every warped event lies on an integer pixel),
and the port's crop objective against its own full-panorama objective
(mirroring tests/test_crop_solver.py).

Tolerances: both sides vote, blur and reduce in float32 but sum in other
orders, so values agree to rtol 1e-4 and gradients, which are sums over all
events of per-event products, to rtol 2e-3 with atol 1e-6 (the bound
tests/test_crop_solver.py uses between the JAX crop and full objectives)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.config import (
    IMAGE_GRADIENT_MAGNITUDE_CONTRAST, MEAN_SQUARE_CONTRAST, VARIANCE_CONTRAST)
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu.ops import warp_local as jwarp_local, warp_pano as jwarp_pano
from cmax_slam_tpu_torch import calib
from cmax_slam_tpu_torch.ops import warp_local, warp_pano

from test_crop_solver import _plan_for_test, _smooth_map
from test_pano import _make_window

torch.set_num_threads(1)

MEASURES = [VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST, IMAGE_GRADIENT_MAGNITUDE_CONTRAST]
W, H = 120, 90
# Focal length and bearings exact in float32: at omega = 0 a quantized event
# then warps to exactly its integer pixel in both frameworks. (With unit
# bearings the pixel is an integer only up to float32 rounding, and XLA's
# fused multiply-add rounds it to the other side of the integer than
# separate rounding does for ~2% of events, which flips their one-sided
# derivative.)
FXY = 64.0


def _packets(rng, n=4000, batch=100):
    omega = np.array([0.8, -1.2, 1.7])
    ev = synthetic.rotating_camera_events(rng, n, 0.04, omega, FXY, FXY, W / 2, H / 2,
                                          W, H, n_points=250)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    lut = np.stack([((xs - W / 2) / FXY).ravel(), ((ys - H / 2) / FXY).ravel(),
                    np.ones(W * H)], axis=-1).astype(np.float32)
    S = n + 2 * batch  # padding lanes, as a packet shorter than its static size has
    idx = np.zeros(S, np.int64)  # padding gathers pixel 0, as both front-ends do
    idx[:n] = ev.ys * W + ev.xs
    bearings = lut[idx]
    ts = np.zeros(S, np.float32)
    ts[:n] = ev.ts.astype(np.float32)
    valid = np.arange(S) < n
    t_ref = np.float32(0.02)
    jp = jwarp_local.EventPacket(
        bearings=jnp.asarray(bearings),
        dts=jwarp_local.batch_midpoint_dts(jnp.asarray(ts), jnp.asarray(valid), batch,
                                           jnp.float32(t_ref)),
        weights=jnp.asarray(valid, jnp.float32))
    tp = warp_local.EventPacket(
        bearings=torch.tensor(bearings),
        dts=warp_local.batch_midpoint_dts(torch.tensor(ts), torch.tensor(valid), batch,
                                          float(t_ref)),
        weights=torch.tensor(valid, dtype=torch.float32))
    np.testing.assert_allclose(tp.dts.numpy(), np.asarray(jp.dts), atol=1e-7)
    cam = jwarp_local.CameraParams(FXY, FXY, W / 2, H / 2, W, H)
    return jp, tp, cam, omega


@pytest.mark.parametrize("measure", MEASURES)
def test_local_objective_value_and_gradient_match_jax(rng, measure):
    jp, tp, cam, omega = _packets(rng)
    tcam = warp_local.CameraParams(*cam)
    fj, vgj = jwarp_local.make_local_objective(jp, cam, 1.0, measure)
    ft, vgt = warp_local.make_local_objective(tp, tcam, 1.0, measure)
    for om in (np.zeros(3), omega, omega + rng.normal(size=3) * 0.3):
        om = om.astype(np.float32)
        v_j, g_j = jax.jit(vgj)(jnp.asarray(om))
        v_t, g_t = vgt(torch.tensor(om))
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4, err_msg=str(om))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-3, atol=1e-6,
                                   err_msg=str(om))
        if not om.any():  # the cold start has a real, one-sided gradient
            px, _ = warp_local.warp_events(torch.tensor(om), tp, tcam)
            assert torch.equal(px, torch.round(px))
            assert np.linalg.norm(g_t.numpy()) > 1e-3
    # a (M, 3) stack of candidates is one batched evaluation
    stack = np.stack([np.zeros(3), omega, 0.5 * omega]).astype(np.float32)
    np.testing.assert_allclose(ft(torch.tensor(stack)).numpy(),
                               [float(fj(jnp.asarray(s))) for s in stack], rtol=1e-4)


def _to_torch(win):
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return warp_pano.PanoWindow(
        bearings=t(win.bearings), batch_times=t(win.batch_times), weights=t(win.weights),
        is_old=torch.tensor(np.asarray(win.is_old)), knots=t(win.knots),
        free_mask=t(win.free_mask), t0=float(win.t0), dt_knots=float(win.dt_knots),
        ig_prime=t(win.ig_prime), alpha=torch.tensor(float(win.alpha)))


@pytest.mark.parametrize("measure", MEASURES)
def test_crop_objective_matches_jax_and_full_pano(rng, measure):
    order, sigma = 2, 1.0
    win_j, pano_j, _, _ = _make_window(rng, n_events=4096)
    win_j = win_j._replace(ig_prime=jnp.asarray(_smooth_map(rng, pano_j.height, pano_j.width)))
    K = win_j.knots.shape[0]
    Hc, Wc, ints = _plan_for_test(win_j, pano_j, order, sigma, measure)
    assert (Hc, Wc) != (pano_j.height, pano_j.width)

    cj = jwarp_pano.crop_window_constants(win_j, pano_j, order, sigma, measure, (Hc, Wc),
                                          jnp.asarray(ints))
    _, vgj = jwarp_pano.make_crop_objective(cj[0], pano_j, order, sigma, measure, (Hc, Wc),
                                            *cj[1:])
    pano = calib.EquirectCamera(width=pano_j.width, height=pano_j.height)
    win = _to_torch(win_j)
    ct = warp_pano.crop_window_constants(win, pano, order, sigma, measure, (Hc, Wc), ints)
    np.testing.assert_allclose(float(ct[0].alpha), float(cj[0].alpha), rtol=1e-5)
    assert float(ct[0].alpha) > 0
    np.testing.assert_allclose(ct[3].numpy(), np.asarray(cj[3]), rtol=1e-5, atol=1e-6)
    _, vgt = warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                           *ct[1:])
    _, vg_full = warp_pano.make_pano_objective(win._replace(alpha=ct[0].alpha), pano, order,
                                               sigma, measure)
    vgj = jax.jit(vgj)
    for scale in (0.0, 0.005, 0.02):
        d = (rng.normal(size=3 * K) * scale).astype(np.float32)
        v_j, g_j = vgj(jnp.asarray(d))
        v_t, g_t = vgt(torch.tensor(d))
        v_f, g_f = vg_full(torch.tensor(d))
        msg = f"measure={measure} scale={scale}"
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-3, atol=1e-6,
                                   err_msg=msg)
        np.testing.assert_allclose(float(v_t), float(v_f), rtol=2e-4, err_msg=msg)
        np.testing.assert_allclose(g_t.numpy(), g_f.numpy(), rtol=2e-3, atol=1e-6,
                                   err_msg=msg)


def test_pano_il_split_and_map_update_match_jax(rng):
    order = 2
    win_j, pano_j, _, _ = _make_window(rng, n_events=4096)
    pano = calib.EquirectCamera(width=pano_j.width, height=pano_j.height)
    win = _to_torch(win_j)
    d = (rng.normal(size=(win_j.knots.shape[0], 3)) * 0.01).astype(np.float32)
    jo, jn = jwarp_pano.pano_il_split(jnp.asarray(d), win_j, pano_j, order)
    to, tn = warp_pano.pano_il_split(torch.tensor(d), win, pano, order)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    upd = rng.integers(0, 4, (pano.height, pano.width)).astype(np.int32)
    ig = rng.uniform(size=(pano.height, pano.width)).astype(np.float32)
    np.testing.assert_allclose(
        warp_pano.accumulate_global_map(torch.tensor(ig), to, torch.tensor(upd), 2).numpy(),
        np.asarray(jwarp_pano.accumulate_global_map(jnp.asarray(ig), jo, jnp.asarray(upd), 2)),
        atol=1e-4)
