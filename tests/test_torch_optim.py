"""The port's FR-CG host loop (cmax_slam_tpu_torch/ops/optim.py) against the
JAX package's compiled minimizer on the same objectives, with both bracket
ladders: the final x, the iteration count and the status.

Tolerances: the analytic objectives evaluate to the same float32 values on
both sides up to an ulp (XLA expands x**4 into products, torch calls pow), so
every decision matches and x agrees to atol 1e-4 (the secant polish of the
last line search moves with that ulp). On the CMax
packet objective the values differ by float32 summation order (rtol ~1e-6),
which can move the last secant step; x then agrees to 1e-3 rad/s, below the
front-end's own resolution (grad_tol 1e-3)."""

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


@pytest.mark.parametrize("ladder", ["sequential", "vector"])
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


@pytest.mark.parametrize("ladder", ["sequential", "vector"])
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
    vg = warp_local.value_and_grad(lambda x: (x * x).sum())
    for kw in (dict(ladder="grid"), dict(cg_variant="pr"), dict(trust_radius=0.1)):
        with pytest.raises(NotImplementedError):
            optim.minimize_fr_cg(vg, torch.zeros(3), **kw)
