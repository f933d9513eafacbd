"""The port's CG host loop (cmax_slam_tpu_torch/ops/optim.py) against the
JAX package's compiled minimizer on the same objectives, with every bracket
ladder (sequential, vector, grid), both CG variants (Fletcher-Reeves and
Polak-Ribiere+) and the trust-radius stop: the final x, the iteration count
and the status. The front-end's coarse-to-fine solve is held against the JAX
front-end's on one stream.

Tolerances: the analytic objectives evaluate to the same float32 values on
both sides up to an ulp (XLA expands x**4 into products, torch calls pow), so
every decision matches and x agrees to atol 1e-4 (the secant polish of the
last line search moves with that ulp). On the CMax
packet objective the values differ by float32 summation order (rtol ~1e-6),
which can move the last secant step; x then agrees to 1e-3 rad/s, below the
front-end's own resolution (grad_tol 1e-3). The coarse-to-fine front-end
chains two such solves per packet and warm-starts the next packet from the
result, so per-packet omega agrees to the slice tolerance (tests/
test_torch_slice.py: max 0.06, median 0.01 rad/s)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.ops import optim as joptim, warp_local as jwarp_local
from cmax_slam_tpu_torch.ops import optim, warp_local

from test_torch_objectives import _packets

torch.set_num_threads(1)

A = np.array([[3.0, 0.4, 0.0], [0.4, 2.0, 0.1], [0.0, 0.1, 1.0]], np.float32)
B = np.array([1.0, -2.0, 0.5], np.float32)


def _bowl(x, lib):
    """0.5 x^T A x - b^T x, batched over leading axes of x."""
    a = lib.asarray(A) if lib is jnp else torch.tensor(A)
    b = lib.asarray(B) if lib is jnp else torch.tensor(B)
    return 0.5 * ((x @ a) * x).sum(-1) - (x * b).sum(-1)


def _quartic(x, lib):
    return ((x - 1.5) ** 2).sum(-1) + 0.1 * (x**4).sum(-1)


def _jax_solve(f, x0, **kw):
    res = jax.jit(lambda x: joptim.minimize_fr_cg(jax.value_and_grad(f), x, f_fn=f, **kw))(
        jnp.asarray(x0))
    return np.asarray(res.x), int(res.iters), int(res.status)


def _torch_solve(f, x0, **kw):
    res = optim.minimize_fr_cg(warp_local.value_and_grad(f), torch.tensor(x0), f_fn=f, **kw)
    return res.x.numpy(), res.iters, res.status


@pytest.mark.parametrize("ladder", ["sequential", "vector", "grid"])
@pytest.mark.parametrize("name", ["bowl", "quartic"])
def test_cg_matches_jax_on_analytic_objectives(ladder, name):
    fn = {"bowl": _bowl, "quartic": _quartic}[name]
    x0 = np.array([0.0, 0.0, 0.0] if name == "bowl" else [3.0, -1.0, 0.5, 2.0], np.float32)
    kw = dict(ladder=ladder, grad_tol=1e-3, fun_tol=1e-4)
    xj, itj, stj = _jax_solve(lambda x: fn(x, jnp), x0, **kw)
    xt, itt, stt = _torch_solve(lambda x: fn(x, torch), x0, **kw)
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    assert (itt, stt) == (itj, stj)
    assert stt in (optim.CONVERGED_FTOL, optim.CONVERGED_GTOL)
    if name == "bowl":
        np.testing.assert_allclose(xt, np.linalg.solve(A, B), atol=1e-3)


@pytest.mark.parametrize("ladder", ["sequential", "vector", "grid"])
def test_cg_matches_jax_on_packet_objective(rng, ladder):
    """The front-end's actual solve: CMax on one packet from a cold start."""
    jp, tp, cam, omega = _packets(rng)
    fj, _ = jwarp_local.make_local_objective(jp, cam, 1.0, 0)
    ft, _ = warp_local.make_local_objective(tp, warp_local.CameraParams(*cam), 1.0, 0)
    kw = dict(ladder=ladder, grad_tol=1e-3, fun_tol=1e-4)
    xj, itj, stj = _jax_solve(fj, np.zeros(3, np.float32), **kw)
    xt, itt, stt = _torch_solve(ft, np.zeros(3, np.float32), **kw)
    np.testing.assert_allclose(xt, xj, atol=1e-3)
    assert (itt, stt) == (itj, stj)
    assert np.linalg.norm(xt - omega) < 0.25  # near the true motion (4000 events, 40 ms)


def test_unported_options_raise():
    """Every option of the JAX minimizer is ported now; a value neither
    package knows still raises instead of falling back to a default."""
    vg = warp_local.value_and_grad(lambda x: (x * x).sum())
    for kw in (dict(ladder="nope"), dict(cg_variant="hs")):
        with pytest.raises(ValueError):
            optim.minimize_fr_cg(vg, torch.zeros(3), **kw)


@pytest.mark.parametrize("ladder", ["sequential", "grid"])
@pytest.mark.parametrize("name", ["bowl", "quartic", "packet"])
def test_polak_ribiere_matches_jax(rng, name, ladder):
    """cg_variant="pr": beta = max(g1.(g1 - g0) / |g0|^2, 0)."""
    kw = dict(ladder=ladder, cg_variant="pr", grad_tol=1e-3, fun_tol=1e-4)
    if name == "packet":
        jp, tp, cam, _ = _packets(rng)
        fj, _ = jwarp_local.make_local_objective(jp, cam, 1.0, 0)
        ft, _ = warp_local.make_local_objective(tp, warp_local.CameraParams(*cam), 1.0, 0)
        x0, atol = np.zeros(3, np.float32), 1e-3
    else:
        fn = {"bowl": _bowl, "quartic": _quartic}[name]
        fj, ft = (lambda x: fn(x, jnp)), (lambda x: fn(x, torch))
        x0 = np.array([0.0, 0.0, 0.0] if name == "bowl" else [3.0, -1.0, 0.5, 2.0], np.float32)
        atol = 1e-4
    xj, itj, stj = _jax_solve(fj, x0, **kw)
    xt, itt, stt = _torch_solve(ft, x0, **kw)
    np.testing.assert_allclose(xt, xj, atol=atol)
    assert (itt, stt) == (itj, stj)
    assert stt in (optim.CONVERGED_FTOL, optim.CONVERGED_GTOL)


@pytest.mark.parametrize("radius", [0.05, 0.3, 10.0])
def test_trust_radius_stop_matches_jax(radius):
    """The solve stops (TRUST_STOP) as soon as a 3-block of x reaches the
    radius; the bowl's optimum lies ~1.3 from x0, so the two small radii stop
    it and the large one does not."""
    x0 = np.array([0.0, 0.0, 0.0, 0.1, -0.1, 0.0], np.float32)

    def fn(x, lib):
        return _bowl(x[..., :3], lib) + _bowl(x[..., 3:], lib)

    kw = dict(trust_radius=radius, grad_tol=1e-3, fun_tol=1e-4)
    xj, itj, stj = _jax_solve(lambda x: fn(x, jnp), x0, **kw)
    xt, itt, stt = _torch_solve(lambda x: fn(x, torch), x0, **kw)
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    assert (itt, stt) == (itj, stj)
    assert (stt == optim.TRUST_STOP) == (radius < 1.0)
    # a start already outside the radius runs no line search at all
    _, it0, st0 = _torch_solve(lambda x: fn(x, torch), x0 + 20.0, **kw)
    assert (it0, st0) == (0, optim.TRUST_STOP)


def test_coarse_to_fine_frontend_matches_jax(rng):
    """frontend.coarse_to_fine: a solve on a 3x-blurred IWE with half the
    line-search budget, then the fine solve from its optimum; the estimate
    reports the iterations of both. The JAX front-end runs its per-packet
    schedule (batch_sweeps=0), the one the port implements."""
    from cmax_slam_tpu.config import FrontendConfig as JFrontendConfig, WarpOptions as JWarp
    from cmax_slam_tpu.frontend import Frontend as JFrontend
    from cmax_slam_tpu.io import synthetic
    from cmax_slam_tpu_torch.config import FrontendConfig, WarpOptions
    from cmax_slam_tpu_torch.frontend import Frontend

    W, H, F = 120, 90, 90.0
    omega_true = np.array([2.0, -3.5, 4.0])  # fast motion from a cold start
    ev = synthetic.rotating_camera_events(rng, 30000, 0.12, omega_true, F, F, W / 2, H / 2,
                                          W, H, n_points=300)
    lut = synthetic.identity_lut(W, H, F, F, W / 2, H / 2)
    cam = jwarp_local.CameraParams(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H)
    kw = dict(num_events_per_packet=8000, dt_ang_vel=0.02, coarse_to_fine=True)
    fe_j = JFrontend(cam, lut, JFrontendConfig(warp=JWarp(blur_sigma=1.0, event_batch_size=100),
                                               batch_sweeps=0, device_store=False, **kw))
    fe_t = Frontend(warp_local.CameraParams(*cam), lut,
                    FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=100), **kw),
                    device="cpu")
    fe_j.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    fe_t.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    fe_j.finalize_batch(fe_j.estimates)
    assert len(fe_t.estimates) == len(fe_j.estimates) >= 3
    om_t = np.array([e.omega for e in fe_t.estimates])
    om_j = np.array([e.omega for e in fe_j.estimates])
    err = np.linalg.norm(om_t - om_j, axis=1)
    assert err.max() < 0.06 and np.median(err) < 0.01, np.round(err, 4)
    assert np.median(np.linalg.norm(om_t - omega_true, axis=1)) < 0.25
    # iterations of both stages, summed: more than one solve's worth
    it_t = [e.iters for e in fe_t.estimates]
    it_j = [int(e.iters) for e in fe_j.estimates]
    assert abs(sum(it_t) - sum(it_j)) <= len(it_t), (it_t, it_j)
    assert it_t[0] > 1


def test_grid_ladder_on_crop_objective_matches_jax(rng):
    """The back-end's solve: the grid ladder with PR+ over the FOV-crop BA
    objective, whose rung sweep is one batched evaluation of (M, 3K) knot
    increments. The grid replays the sequential ladder's decisions, so it
    lands where the sequential ladder does. The crop objective's values
    differ between the packages by float32 summation order (rtol ~1e-5); on
    this flat landscape that moves x by up to ~1e-4 rad per line search, so
    the solve is held to three line searches and x agrees to 2e-4 rad, far
    below the 0.1 deg knot tolerance of the slice tests."""
    from cmax_slam_tpu.ops import warp_pano as jwarp_pano
    from cmax_slam_tpu_torch import calib
    from cmax_slam_tpu_torch.ops import warp_pano
    from test_crop_solver import _plan_for_test, _smooth_map
    from test_pano import _make_window
    from test_torch_objectives import _to_torch

    order, sigma, measure = 2, 1.0, 0
    win_j, pano_j, _, _ = _make_window(rng, n_events=4096)
    win_j = win_j._replace(ig_prime=jnp.asarray(_smooth_map(rng, pano_j.height, pano_j.width)))
    K = win_j.knots.shape[0]
    Hc, Wc, ints = _plan_for_test(win_j, pano_j, order, sigma, measure)
    cj = jwarp_pano.crop_window_constants(win_j, pano_j, order, sigma, measure, (Hc, Wc),
                                          jnp.asarray(ints))
    fj, _ = jwarp_pano.make_crop_objective(cj[0], pano_j, order, sigma, measure, (Hc, Wc),
                                           *cj[1:])
    pano = calib.EquirectCamera(width=pano_j.width, height=pano_j.height)
    ct = warp_pano.crop_window_constants(_to_torch(win_j), pano, order, sigma, measure,
                                         (Hc, Wc), ints)
    ft, _ = warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                          *ct[1:])
    kw = dict(cg_variant="pr", grad_tol=1e-4, line_search_tol=0.1, max_line_searches=3)
    x0 = np.zeros(3 * K, np.float32)
    xj, itj, stj = _jax_solve(fj, x0, ladder="grid", **kw)
    xt, itt, stt = _torch_solve(ft, x0, ladder="grid", **kw)
    assert np.abs(xj).max() > 1e-3  # the solve moved the knots
    np.testing.assert_allclose(xt, xj, atol=2e-4)
    assert (itt, stt) == (itj, stj)
    xs, its, sts = _torch_solve(ft, x0, ladder="sequential", **kw)
    np.testing.assert_allclose(xt, xs, atol=1e-6)
    assert (its, sts) == (itt, stt)
