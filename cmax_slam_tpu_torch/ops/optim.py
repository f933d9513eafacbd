"""Nonlinear conjugate-gradient minimizer (Fletcher-Reeves) as a host loop;
counterpart of cmax_slam_tpu/ops/optim.py.

Replaces GSL's ``gsl_multimin_fdfminimizer_conjugate_fr`` loops
(src/frontend/local_optim_contrast_gsl.cpp:74-233,
src/backend/global_optim_contrast_gsl.cpp:15-145) with the JAX package's
semantics, decision for decision:

- Fletcher-Reeves beta = |g1|^2 / |g0|^2 with periodic direction restart;
- a line search that brackets an improving step with function-only
  evaluations, then polishes it with secant steps on the directional
  derivative until ``|g1 . u| <= tol * |g1|``;
- the stagnation test ``|1 - f_new/(f_prev + 1e-7)| < fun_tol``, the
  gradient test ``|g| < grad_tol`` and the ``max_line_searches`` cap, with
  the same status codes and stall patience.

The objective runs wherever its tensors live; the CG state (a handful of
floats) lives on the CPU in float32, and every control decision reads it
there, one device sync per objective evaluation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# Status codes
RUNNING = 0
CONVERGED_FTOL = 1
CONVERGED_GTOL = 2
NO_PROGRESS = 3
MAX_ITERS = 4
TRUST_STOP = 5


class CGResult(NamedTuple):
    x: torch.Tensor  # CPU float32
    fun: float
    iters: int
    status: int
    f0: float  # objective at x0 (the reference logs initial contrast)


def _refine(vg_fn, x, u, a_best, f_best, g0, dphi0, tol, refine_evals):
    """Phase 2 of every ladder: secant steps toward phi'(a) = 0 from the
    bracket winner; keeps the best (f, a, g) seen. Returns (f, a, g)."""
    a_cur, a_prev, dphi_prev = a_best, torch.zeros_like(a_best), dphi0
    fb, ab, gb = f_best, a_best, g0
    for _ in range(refine_evals):
        f1, g1 = vg_fn(x + a_cur * u)
        dphi1 = torch.dot(g1, u)
        if f1 <= fb:
            fb, ab, gb = f1, a_cur, g1
        ok = bool(torch.abs(dphi1) <= tol * torch.linalg.norm(g1))
        denom = dphi1 - dphi_prev
        if torch.abs(denom) < 1e-30:
            denom = torch.ones_like(denom)
        a_next = a_cur - dphi1 * (a_cur - a_prev) / denom
        a_next = torch.clamp(a_next, 0.05 * a_cur, 4.0 * a_cur)
        a_prev, a_cur, dphi_prev = a_cur, a_next, dphi1
        if ok:
            break
    return fb, ab, gb


def _line_search(f_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals, refine_evals):
    """Sequential ladder: trial steps fan out geometrically in both
    directions from alpha0 (a0, 2a0, a0/2, 4a0, a0/4, ...) until one
    improves, then keep doubling while f decreases, then refine. Returns
    (alpha, f, g, ok)."""
    dphi0 = torch.dot(g0, u)
    f_best, alpha_best, grow = f0, torch.zeros_like(f0), False
    for k in range(max_evals):
        if grow:
            a = alpha_best * 2.0
        else:
            m = (k + 1) // 2
            a = alpha0 * (2.0**m if k % 2 == 1 else 0.5**m)
        f1 = f_fn(x + a * u)
        improved = bool(f1 < f_best)
        if grow and not improved:
            break  # bracketed: we were improving and stopped
        if improved:
            f_best, alpha_best, grow = f1, a, True
    if not grow:
        return torch.zeros_like(f0), f0, g0, False
    f, a, g = _refine(vg_fn, x, u, alpha_best, f_best, g0, dphi0, tol, refine_evals)
    return a, f, g, True


def _line_search_vec(f_batch_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals,
                     refine_evals):
    """Vector ladder: every rung alpha0 * 2^m, m in [-half, half], in ONE
    batched objective call, then the global-best rung is refined."""
    dphi0 = torch.dot(g0, u)
    half = min(max_evals - 1, 9) // 2
    ms = torch.arange(-half, half + 1, dtype=x.dtype)
    alphas = alpha0 * (2.0**ms)
    fs = f_batch_fn(x[None, :] + alphas[:, None] * u[None, :])
    i_best = int(torch.argmin(fs))
    f_best, a_best = fs[i_best], alphas[i_best]
    if not bool(f_best < f0):
        return torch.zeros_like(f0), f0, g0, False
    f, a, g = _refine(vg_fn, x, u, a_best, f_best, g0, dphi0, tol, refine_evals)
    return a, f, g, True


def minimize_fr_cg(
    value_and_grad_fn: Callable,
    x0: torch.Tensor,
    f_fn: Callable | None = None,
    *,
    max_line_searches: int = 50,
    initial_step: float = 0.1,
    line_search_tol: float = 0.05,
    grad_tol: float = 1e-3,
    fun_tol: float = 1e-4,
    max_fevals_per_linesearch: int = 16,
    stagnation_patience: int = 1,
    ladder: str = "sequential",
    cg_variant: str = "fr",
    trust_radius: float | None = None,
    secant_refine_evals: int = 4,
) -> CGResult:
    """Minimize a smooth function with Fletcher-Reeves CG.

    value_and_grad_fn: x -> (f, g); f_fn: x -> f, the forward-only path the
    bracket uses (defaults to value_and_grad_fn's value). Both take x on
    x0's device. With ``ladder="vector"`` f_fn must also take a (M, D) batch
    of points and return (M,) values.

    ``stagnation_patience``: stalls (stagnation or failed bracket) before
    stopping; earlier stalls restart with steepest descent and the bracket
    re-seeded at ``initial_step``. 1 is GSL's semantics.
    """
    if ladder == "grid":
        raise NotImplementedError("ladder='grid' is not ported yet")
    if ladder not in ("sequential", "vector"):
        raise ValueError(f"unknown ladder {ladder!r}")
    if cg_variant != "fr":
        raise NotImplementedError(f"cg_variant={cg_variant!r} is not ported yet")
    if trust_radius is not None:
        raise NotImplementedError("trust_radius is not ported yet")
    if f_fn is None:
        f_fn = lambda x: value_and_grad_fn(x)[0]  # noqa: E731
    dev = x0.device
    cpu = dict(device="cpu", dtype=torch.float32)

    def vg(x):
        f, g = value_and_grad_fn(x.to(dev))
        return f.detach().to(**cpu), g.detach().to(**cpu)

    def f_only(x):
        with torch.no_grad():
            return f_fn(x.to(dev)).detach().to(**cpu)

    search = _line_search_vec if ladder == "vector" else _line_search
    x = x0.detach().to(**cpu)
    restart_every = max(x.shape[-1] if x.dim() else 1, 2)

    f, g = vg(x)
    f0 = f
    f_prev = torch.full_like(f, float("inf"))
    d = -g
    alpha0 = torch.tensor(initial_step, **cpu)
    it, status, stall = 0, RUNNING, 0
    while status == RUNNING and it < max_line_searches:
        dnorm = torch.linalg.norm(d)
        u = d / (dnorm if bool(dnorm != 0) else torch.ones_like(dnorm))
        if not bool(torch.dot(g, u) < 0):  # restart on a non-descent direction
            u = -g / torch.clamp(torch.linalg.norm(g), min=1e-30)
        alpha, f_new, g_new, ok = search(
            f_only, vg, x, f, g, u, alpha0, line_search_tol,
            max_fevals_per_linesearch, secant_refine_evals,
        )
        x_new = x + alpha * u

        # Convergence tests in the reference's order and form
        # (local_optim_contrast_gsl.cpp:176-194).
        stagnated = bool(torch.abs(1.0 - f_new / (f_prev + 1e-7)) < fun_tol)
        gsmall = bool(torch.linalg.norm(g_new) < grad_tol)
        stall_event = (not ok) or stagnated
        stall = stall + 1 if stall_event else 0
        final = stall_event and stall >= stagnation_patience
        if final:
            status = NO_PROGRESS if not ok else CONVERGED_FTOL
        else:
            status = CONVERGED_GTOL if gsmall else RUNNING
        retry = stall_event and not final

        beta = torch.dot(g_new, g_new) / torch.clamp(torch.dot(g, g), min=1e-30)
        it += 1
        if it % restart_every == 0 or retry:
            d = -g_new
        else:
            d = -g_new + beta * (u * dnorm)
        if ok:
            alpha0 = torch.clamp(2.0 * alpha, 1e-6, 1e3)
        if retry:
            alpha0 = torch.tensor(initial_step, **cpu)
        f_prev = f
        if ok:
            x, f, g = x_new, f_new, g_new
    if status == RUNNING:
        status = MAX_ITERS
    return CGResult(x=x, fun=float(f), iters=it, status=status, f0=float(f0))
