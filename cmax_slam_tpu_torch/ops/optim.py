"""Nonlinear conjugate-gradient minimizer (Fletcher-Reeves or Polak-Ribiere+)
as a host loop; counterpart of cmax_slam_tpu/ops/optim.py.

Replaces GSL's ``gsl_multimin_fdfminimizer_conjugate_fr`` loops
(src/frontend/local_optim_contrast_gsl.cpp:74-233,
src/backend/global_optim_contrast_gsl.cpp:15-145) with the JAX package's
semantics, decision for decision:

- Fletcher-Reeves beta = |g1|^2 / |g0|^2 (or PR+, clipped at 0) with
  periodic direction restart;
- a line search that brackets an improving step with function-only
  evaluations, then polishes it with secant steps on the directional
  derivative until ``|g1 . u| <= tol * |g1|``;
- the stagnation test ``|1 - f_new/(f_prev + 1e-7)| < fun_tol``, the
  gradient test ``|g| < grad_tol`` and the ``max_line_searches`` cap, with
  the same status codes and stall patience;
- an optional trust radius that stops a solve as soon as any 3-block of x
  leaves it (the back-end's max_ba_correction_rad).

``minimize_fr_cg`` is the one-solve host loop: the objective runs wherever
its tensors live; the CG state (a handful of floats) lives on the CPU in
float32, and every control decision reads it there, one device sync per
objective evaluation.

``cg_init``/``make_cg_body``/``cg_run_rounds``/``cg_finalize`` are the
resumable form over P independent solves at once (lanes), the counterpart
of the JAX package's vmapped state machine. Every field of ``CGState`` is a
tensor with leading dimension P on the objective's device, each bracket or
secant step evaluates the objective once for all lanes, and lanes that have
stopped keep their values through ``torch.where``. The host reads one
boolean per step (is any lane still searching?) and nothing else. Each lane
takes the decisions ``minimize_fr_cg`` takes on that lane alone.
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


def _line_search_grid(f_batch_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals,
                      refine_evals):
    """Grid ladder: the sequential ladder's choice at the vector ladder's
    cost. Every step the sequential bracket can probe lies on alpha0 * 2^m
    (alternation m = 0, +1, -1, +2, ...; then doubling from the best), so
    the whole reachable set is evaluated in ONE batched objective call and
    the sequential decisions are replayed over the values on the host."""
    dphi0 = torch.dot(g0, u)
    m_lo = -((max_evals - 2) // 2)
    m_hi = max_evals - 1
    ms = torch.arange(m_lo, m_hi + 1, dtype=x.dtype)
    fs = f_batch_fn(x[None, :] + (alpha0 * (2.0**ms))[:, None] * u[None, :])
    f_best, m_best, grow = f0, 0, False
    for k in range(max_evals):
        m = m_best + 1 if grow else ((k + 1) // 2 if k % 2 == 1 else -(k // 2))
        f1 = fs[min(max(m - m_lo, 0), m_hi - m_lo)]
        improved = bool(f1 < f_best)
        if grow and not improved:
            break
        if improved:
            f_best, m_best, grow = f1, m, True
    if not grow:
        return torch.zeros_like(f0), f0, g0, False
    a_best = alpha0 * 2.0**m_best
    f, a, g = _refine(vg_fn, x, u, a_best, f_best, g0, dphi0, tol, refine_evals)
    return a, f, g, True


def _within_trust(x: torch.Tensor, trust_radius: float) -> bool:
    """True while every 3-block of x (one knot's rotation increment) has
    norm below ``trust_radius``: a solve that has moved a knot this far is
    wandering on a weakly textured window, not converging (the JAX
    package's optim._within_trust)."""
    r = x.reshape(-1, 3)
    return bool(torch.max(torch.sum(r * r, dim=1)) < trust_radius * trust_radius)


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
    """Minimize a smooth function with nonlinear CG.

    value_and_grad_fn: x -> (f, g); f_fn: x -> f, the forward-only path the
    bracket uses (defaults to value_and_grad_fn's value). Both take x on
    x0's device. With ``ladder="vector"`` or ``"grid"`` f_fn must also take
    a (M, D) batch of points and return (M,) values: one batched call per
    line search.

    ``cg_variant``: "fr" = Fletcher-Reeves (GSL's conjugate_fr); "pr" =
    Polak-Ribiere+ (beta clipped at 0).

    ``stagnation_patience``: stalls (stagnation or failed bracket) before
    stopping; earlier stalls restart with steepest descent and the bracket
    re-seeded at ``initial_step``. 1 is GSL's semantics.

    ``trust_radius``: stop (status TRUST_STOP) as soon as any 3-block of x
    reaches this norm; the caller decides what to do with such an x.
    """
    searches = {"sequential": _line_search, "vector": _line_search_vec,
                "grid": _line_search_grid}
    if ladder not in searches:
        raise ValueError(f"unknown ladder {ladder!r}")
    if cg_variant not in ("fr", "pr"):
        raise ValueError(f"unknown cg_variant {cg_variant!r}")
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

    search = searches[ladder]
    x = x0.detach().to(**cpu)
    restart_every = max(x.shape[-1] if x.dim() else 1, 2)

    f, g = vg(x)
    f0 = f
    f_prev = torch.full_like(f, float("inf"))
    d = -g
    alpha0 = torch.tensor(initial_step, **cpu)
    it, status, stall = 0, RUNNING, 0

    def trusted(x):
        return trust_radius is None or _within_trust(x, trust_radius)

    while status == RUNNING and it < max_line_searches and trusted(x):
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

        gg = torch.clamp(torch.dot(g, g), min=1e-30)
        if cg_variant == "pr":
            beta = torch.clamp(torch.dot(g_new, g_new - g) / gg, min=0.0)
        else:
            beta = torch.dot(g_new, g_new) / gg
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
        status = MAX_ITERS if trusted(x) else TRUST_STOP
    return CGResult(x=x, fun=float(f), iters=it, status=status, f0=float(f0))


# ---------------------------------------------------------------------------
# Resumable CG over a leading lane axis (JAX: CGState, cg_init, make_cg_body,
# cg_run_rounds, cg_finalize). Objectives take x (P, D) and return (P,)
# values (value_and_grad_fn: also the (P, D) gradient); with the vector or
# grid ladder f_fn must also take (P, M, D) and return (P, M).
# ---------------------------------------------------------------------------

class CGState(NamedTuple):
    """Resumable CG state of P solves; every field is a tensor with leading
    dimension P on the objective's device."""

    x: torch.Tensor       # (P, D)
    f: torch.Tensor       # (P,)
    f_prev: torch.Tensor  # (P,) previous iteration's f (stagnation test)
    g: torch.Tensor       # (P, D)
    d: torch.Tensor       # (P, D) search direction
    alpha0: torch.Tensor  # (P,) next bracket scale
    it: torch.Tensor      # (P,) int32 line searches done
    status: torch.Tensor  # (P,) int32
    f0: torch.Tensor      # (P,) objective at x0
    stall: torch.Tensor   # (P,) int32 consecutive stalls (stagnation_patience)


def _lanes(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-lane select: ``new`` where the (P,) mask holds, else ``old``."""
    return torch.where(mask.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _refine_lanes(vg_fn, x, u, a_best, f_best, g0, dphi0, tol, refine_evals, active):
    """_refine over lanes: secant steps for the ``active`` lanes only."""
    a_cur, a_prev, dphi_prev = a_best, torch.zeros_like(a_best), dphi0
    fb, ab, gb = f_best, a_best, g0
    for _ in range(refine_evals):
        if not bool(active.any()):
            break
        f1, g1 = vg_fn(x + a_cur[:, None] * u)
        dphi1 = _dot(g1, u)
        better = active & (f1 <= fb)
        fb, ab, gb = _lanes(better, f1, fb), _lanes(better, a_cur, ab), _lanes(better, g1, gb)
        ok = torch.abs(dphi1) <= tol * torch.linalg.norm(g1, dim=-1)
        denom = dphi1 - dphi_prev
        denom = torch.where(torch.abs(denom) < 1e-30, torch.ones_like(denom), denom)
        a_next = a_cur - dphi1 * (a_cur - a_prev) / denom
        a_next = torch.clamp(a_next, 0.05 * a_cur, 4.0 * a_cur)
        a_prev, a_cur, dphi_prev = (_lanes(active, a_cur, a_prev), _lanes(active, a_next, a_cur),
                                    _lanes(active, dphi1, dphi_prev))
        active = active & ~ok
    return fb, ab, gb


def _finish_search(vg_fn, x, f0, g0, u, a_best, f_best, bracketed, tol, refine_evals):
    """Refine the bracketed lanes; the others keep (alpha 0, f0, g0)."""
    f, a, g = _refine_lanes(vg_fn, x, u, a_best, f_best, g0, _dot(g0, u), tol,
                            refine_evals, bracketed)
    return (torch.where(bracketed, a, torch.zeros_like(a)), torch.where(bracketed, f, f0),
            _lanes(bracketed, g, g0), bracketed)


def _line_search_lanes(f_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals, refine_evals,
                       live):
    """_line_search over lanes: the alternating ladder, then doubling from
    the first improvement, one batched evaluation per step."""
    f_best, alpha_best = f0, torch.zeros_like(f0)
    grow = torch.zeros_like(live)
    active = live
    for k in range(max_evals):
        if not bool(active.any()):
            break
        m = (k + 1) // 2
        ladder = alpha0 * (2.0**m if k % 2 == 1 else 0.5**m)
        a = torch.where(grow, alpha_best * 2.0, ladder)
        f1 = f_fn(x + a[:, None] * u)
        lower = f1 < f_best
        improved = active & lower
        stop = active & grow & ~lower  # we were improving and stopped: bracketed
        f_best = torch.where(improved, f1, f_best)
        alpha_best = torch.where(improved, a, alpha_best)
        grow = grow | improved
        active = active & ~stop
    return _finish_search(vg_fn, x, f0, g0, u, alpha_best, f_best, grow, tol, refine_evals)


def _line_search_vec_lanes(f_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals, refine_evals,
                           live):
    """_line_search_vec over lanes: every lane's rungs in ONE (P, M) call."""
    half = min(max_evals - 1, 9) // 2
    ms = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
    alphas = alpha0[:, None] * (2.0**ms)
    fs = f_fn(x[:, None, :] + alphas[:, :, None] * u[:, None, :])
    i_best = torch.argmin(fs, dim=1, keepdim=True)
    f_best = fs.gather(1, i_best)[:, 0]
    a_best = alphas.gather(1, i_best)[:, 0]
    bracketed = live & (f_best < f0)
    return _finish_search(vg_fn, x, f0, g0, u, a_best, f_best, bracketed, tol, refine_evals)


def _line_search_grid_lanes(f_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals,
                            refine_evals, live):
    """_line_search_grid over lanes: the reachable grid in ONE (P, M) call,
    then the sequential decisions replayed per lane on the device (no host
    reads: the replay is max_evals steps of masked tensor code)."""
    m_lo = -((max_evals - 2) // 2)
    m_hi = max_evals - 1
    ms = torch.arange(m_lo, m_hi + 1, dtype=x.dtype, device=x.device)
    fs = f_fn(x[:, None, :] + (alpha0[:, None] * (2.0**ms))[:, :, None] * u[:, None, :])
    f_best = f0
    m_best = torch.zeros(f0.shape, dtype=torch.int64, device=f0.device)
    grow = torch.zeros_like(live)
    active = live
    for k in range(max_evals):
        m = torch.where(grow, m_best + 1, (k + 1) // 2 if k % 2 == 1 else -(k // 2))
        f1 = fs.gather(1, torch.clamp(m - m_lo, 0, m_hi - m_lo)[:, None])[:, 0]
        lower = f1 < f_best
        improved = active & lower
        stop = active & grow & ~lower
        f_best = torch.where(improved, f1, f_best)
        m_best = torch.where(improved, m, m_best)
        grow = grow | improved
        active = active & ~stop
    a_best = alpha0 * torch.pow(2.0, m_best.to(x.dtype))
    return _finish_search(vg_fn, x, f0, g0, u, a_best, f_best, grow, tol, refine_evals)


def cg_init(value_and_grad_fn: Callable, x0: torch.Tensor, initial_step: float = 0.1) -> CGState:
    """Evaluate f/g at the (P, D) starting points and build the state."""
    f0, g0 = value_and_grad_fn(x0)
    P = x0.shape[0]

    def ints(v):
        return torch.full((P,), v, dtype=torch.int32, device=x0.device)

    return CGState(x=x0, f=f0, f_prev=torch.full_like(f0, float("inf")), g=g0, d=-g0,
                   alpha0=torch.full_like(f0, initial_step), it=ints(0), status=ints(RUNNING),
                   f0=f0, stall=ints(0))


def make_cg_body(
    value_and_grad_fn: Callable,
    f_fn: Callable | None = None,
    *,
    dim: int,
    line_search_tol: float = 0.05,
    grad_tol: float = 1e-3,
    fun_tol: float = 1e-4,
    max_fevals_per_linesearch: int = 16,
    stagnation_patience: int = 1,
    initial_step: float = 0.1,
    ladder: str = "sequential",
    cg_variant: str = "fr",
    secant_refine_evals: int = 4,
) -> Callable:
    """One CG line-search iteration over every lane: ``body(state, live)``.

    ``live`` (P,) bool marks the lanes whose result the caller keeps; the
    line searches stop stepping once no live lane is still searching. The
    returned state holds the iteration for every lane; callers mask it
    (cg_run_rounds). Options as in minimize_fr_cg."""
    searches = {"sequential": _line_search_lanes, "vector": _line_search_vec_lanes,
                "grid": _line_search_grid_lanes}
    if ladder not in searches:
        raise ValueError(f"unknown ladder {ladder!r}")
    if cg_variant not in ("fr", "pr"):
        raise ValueError(f"unknown cg_variant {cg_variant!r}")
    if f_fn is None:
        f_fn = lambda x: value_and_grad_fn(x)[0]  # noqa: E731
    search = searches[ladder]
    restart_every = max(dim, 2)

    def f_only(x):
        with torch.no_grad():
            return f_fn(x)

    def body(s: CGState, live: torch.Tensor | None = None) -> CGState:
        if live is None:
            live = torch.ones_like(s.status, dtype=torch.bool)
        dnorm = torch.linalg.norm(s.d, dim=-1)
        u = s.d / torch.where(dnorm == 0, torch.ones_like(dnorm), dnorm)[:, None]
        descent = _dot(s.g, u) < 0  # restart on a non-descent direction
        u = _lanes(descent, u,
                   -s.g / torch.clamp(torch.linalg.norm(s.g, dim=-1), min=1e-30)[:, None])
        alpha, f_new, g_new, ok = search(
            f_only, value_and_grad_fn, s.x, s.f, s.g, u, s.alpha0, line_search_tol,
            max_fevals_per_linesearch, secant_refine_evals, live)
        x_new = s.x + alpha[:, None] * u

        # Convergence tests in the reference's order and form
        # (local_optim_contrast_gsl.cpp:176-194).
        stagnated = torch.abs(1.0 - f_new / (s.f_prev + 1e-7)) < fun_tol
        gsmall = torch.linalg.norm(g_new, dim=-1) < grad_tol
        stall_event = ~ok | stagnated
        stall = torch.where(stall_event, s.stall + 1, torch.zeros_like(s.stall))
        final = stall_event & (stall >= stagnation_patience)
        status = torch.where(
            final, torch.where(ok, CONVERGED_FTOL, NO_PROGRESS),
            torch.where(gsmall, CONVERGED_GTOL, RUNNING)).to(torch.int32)
        retry = stall_event & ~final

        gg = torch.clamp(_dot(s.g, s.g), min=1e-30)
        if cg_variant == "pr":
            beta = torch.clamp(_dot(g_new, g_new - s.g) / gg, min=0.0)
        else:
            beta = _dot(g_new, g_new) / gg
        it = s.it + 1
        restart = (it % restart_every == 0) | retry
        d = _lanes(restart, -g_new, -g_new + beta[:, None] * (u * dnorm[:, None]))
        alpha0 = torch.where(ok, torch.clamp(2.0 * alpha, 1e-6, 1e3), s.alpha0)
        alpha0 = torch.where(retry, torch.full_like(alpha0, initial_step), alpha0)
        return CGState(x=_lanes(ok, x_new, s.x), f=torch.where(ok, f_new, s.f), f_prev=s.f,
                       g=_lanes(ok, g_new, s.g), d=d, alpha0=alpha0, it=it, status=status,
                       f0=s.f0, stall=stall)

    return body


def cg_run_rounds(body: Callable, state: CGState, num_iters: int,
                  max_total_iters: int | None = None) -> CGState:
    """Advance every lane by up to ``num_iters`` line searches; a lane moves
    only while it is RUNNING and under ``max_total_iters`` (GSL's hard cap,
    however rounds divide it). Stops early once no lane moves."""
    for _ in range(num_iters):
        keep = state.status == RUNNING
        if max_total_iters is not None:
            keep = keep & (state.it < max_total_iters)
        if not bool(keep.any()):
            break
        new = body(state, keep)
        state = CGState(*(_lanes(keep, n, o) for n, o in zip(new, state)))
    return state


def cg_finalize(state: CGState, max_line_searches: int) -> CGResult:
    """Per-lane result tensors; a lane still RUNNING at the cap is MAX_ITERS."""
    status = torch.where((state.status == RUNNING) & (state.it >= max_line_searches),
                         MAX_ITERS, state.status).to(torch.int32)
    return CGResult(x=state.x, fun=state.f, iters=state.it, status=status, f0=state.f0)
