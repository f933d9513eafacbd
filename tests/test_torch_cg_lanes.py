"""The port's lane-batched, resumable CG (cg_init / make_cg_body /
cg_run_rounds / cg_finalize in cmax_slam_tpu_torch/ops/optim.py) against
(a) the port's own one-solve host loop minimize_fr_cg run on each lane alone
and (b) the JAX package's state machine under jax.vmap, for every bracket
ladder and both CG variants; and the max_total_iters cap of cg_run_rounds.

Tolerances: (a) every lane evaluates the same float32 expressions as the
lone solve (element-wise objective, 3-vectors), so every decision matches:
identical iteration counts and statuses, x within atol 1e-6. (b) XLA expands
x**4 into products where torch calls pow, an ulp apart, which can move the
last secant step: x within atol 1e-3, iterations within one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.ops import optim as joptim
from cmax_slam_tpu_torch.ops import optim, warp_local

torch.set_num_threads(1)

P = 6
_RNG = np.random.default_rng(5)
C = _RNG.uniform(-2.0, 2.0, (P, 3)).astype(np.float32)     # per-lane optimum shift
A = _RNG.uniform(0.05, 0.4, (P, 1)).astype(np.float32)     # per-lane coupling
X0 = _RNG.uniform(-1.0, 1.0, (P, 3)).astype(np.float32)
X0[0] = C[0]  # a lane that starts at a near-stationary point
OPTS = dict(grad_tol=1e-3, fun_tol=1e-4, initial_step=0.1, line_search_tol=0.05,
            max_fevals_per_linesearch=16, stagnation_patience=1, secant_refine_evals=4)
MAX_LS = 50


def _f(x, c, a, lib):
    """Element-wise per lane: a smooth, non-quadratic bowl with coupling."""
    return (((x - c) ** 2).sum(-1) + 0.1 * (x**4).sum(-1)
            + a[..., 0] * x[..., 0] * x[..., 1])


def _torch_lanes():
    c, a = torch.tensor(C), torch.tensor(A)

    def f(x):  # (P, 3) -> (P,), (P, M, 3) -> (P, M)
        return _f(x, c, a, torch) if x.dim() == 2 else _f(x, c[:, None], a[:, None], torch)

    return f


def _lane_run(ladder, variant, rounds=(4, 4, 8, 8, 16, 50), max_ls=MAX_LS):
    f = _torch_lanes()
    vg = warp_local.value_and_grad(f)
    body = optim.make_cg_body(vg, f, dim=3, ladder=ladder, cg_variant=variant, **OPTS)
    st = optim.cg_init(vg, torch.tensor(X0), OPTS["initial_step"])
    for r in rounds:  # resumable: the state carries across rounds
        st = optim.cg_run_rounds(body, st, r, max_ls)
    return optim.cg_finalize(st, max_ls)


@pytest.mark.parametrize("variant", ["fr", "pr"])
@pytest.mark.parametrize("ladder", ["sequential", "vector", "grid"])
def test_lanes_match_host_loop_and_jax_vmap(ladder, variant):
    res = _lane_run(ladder, variant)
    x, it, status = res.x.numpy(), res.iters.numpy(), res.status.numpy()
    assert res.x.shape == (P, 3) and res.fun.shape == (P,)

    # (a) the port's host loop, one lane at a time
    for p in range(P):
        c, a = torch.tensor(C[p]), torch.tensor(A[p])
        one = optim.minimize_fr_cg(
            warp_local.value_and_grad(lambda x: _f(x, c, a, torch)), torch.tensor(X0[p]),
            f_fn=lambda x: _f(x, c, a, torch), max_line_searches=MAX_LS, ladder=ladder,
            cg_variant=variant, **OPTS)
        np.testing.assert_allclose(x[p], one.x.numpy(), atol=1e-6, err_msg=f"lane {p}")
        assert (int(it[p]), int(status[p])) == (one.iters, one.status), f"lane {p}"
        assert float(res.f0[p]) == one.f0

    # (b) the JAX state machine under vmap, same rounds
    def jax_one(x0, c, a):
        def fj(x):
            return _f(x, c, a, jnp)

        vg = jax.value_and_grad(fj)
        body = joptim.make_cg_body(vg, fj, dim=3, ladder=ladder, cg_variant=variant, **OPTS)
        s = joptim.cg_init(vg, x0, OPTS["initial_step"])
        s = joptim.cg_run_rounds(body, s, MAX_LS, MAX_LS)
        r = joptim.cg_finalize(s, MAX_LS)
        return r.x, r.iters, r.status

    xj, itj, stj = jax.jit(jax.vmap(jax_one))(jnp.asarray(X0), jnp.asarray(C),
                                              jnp.asarray(A))
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-3)
    assert np.abs(it.astype(int) - np.asarray(itj).astype(int)).max() <= 1
    # every lane stopped by a convergence test, none by the cap, and descended
    assert np.all(np.isin(status, [optim.CONVERGED_FTOL, optim.CONVERGED_GTOL,
                                   optim.NO_PROGRESS]))
    assert np.all(res.fun.numpy() <= res.f0.numpy())


def test_run_rounds_respects_max_total_iters():
    """A lane stops moving at max_total_iters however rounds divide the
    budget; cg_finalize then marks a lane still running as MAX_ITERS."""
    full = _lane_run("vector", "fr")
    cap = 3
    assert int(full.iters.max()) > cap
    capped = _lane_run("vector", "fr", rounds=(2, 2, 5), max_ls=cap)
    it = capped.iters.numpy()
    np.testing.assert_array_equal(it, np.minimum(full.iters.numpy(), cap))
    short = full.iters.numpy() <= cap
    assert short.any() and not short.all()
    np.testing.assert_array_equal(capped.x.numpy()[short], full.x.numpy()[short])
    # a lane cut at the cap is still RUNNING in the state: finalized, MAX_ITERS
    assert np.all(capped.status.numpy()[~short] == optim.MAX_ITERS)


def test_unknown_options_raise():
    vg = warp_local.value_and_grad(lambda x: (x * x).sum(-1))
    for kw in (dict(ladder="nope"), dict(cg_variant="hs")):
        with pytest.raises(ValueError):
            optim.make_cg_body(vg, dim=3, **kw)
