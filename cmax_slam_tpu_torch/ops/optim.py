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

``LaneCG`` is the form the device runs: P independent solves at once
(lanes), the counterpart of the JAX package's while_loop state machine,
written as the steps of a device program (ops/device_loop.py) over static
buffers. Every field of ``CGState`` is a tensor with leading dimension P on
the objective's device, each bracket or secant step evaluates the objective
once for all lanes, and lanes that have stopped keep their values through
``torch.where``. Whether any lane is still searching is a flag on the
device that gates the next step: a conditional node in a CUDA graph, a host
check on the CPU. Each lane takes the decisions ``minimize_fr_cg`` takes on
that lane alone, and the tests hold it to that. ``LaneCG.rounds`` resumes a
loaded state for a bounded number of line searches (the lane-batched
tracker's rounds, JAX's ``cg_run_rounds``). ``cg_init``/``make_cg_body``/
``cg_run_rounds``/``cg_finalize`` are the same steps run from a CGState with
their gates read on the host: the eager reference the tests hold those
programs to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import device_loop

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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis: one reduction for a lone solve and
    for each lane, so both take the same float32 sums."""
    return (a * b).sum(-1)


def _refine(vg_fn, x, u, a_best, f_best, g0, dphi0, tol, refine_evals):
    """Phase 2 of every ladder: secant steps toward phi'(a) = 0 from the
    bracket winner; keeps the best (f, a, g) seen. Returns (f, a, g)."""
    a_cur, a_prev, dphi_prev = a_best, torch.zeros_like(a_best), dphi0
    fb, ab, gb = f_best, a_best, g0
    for _ in range(refine_evals):
        f1, g1 = vg_fn(x + a_cur * u)
        dphi1 = _dot(g1, u)
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
    dphi0 = _dot(g0, u)
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
    dphi0 = _dot(g0, u)
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
    dphi0 = _dot(g0, u)
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


def _check_options(ladder: str, cg_variant: str) -> None:
    if ladder not in ("sequential", "vector", "grid"):
        raise ValueError(f"unknown ladder {ladder!r}")
    if cg_variant not in ("fr", "pr"):
        raise ValueError(f"unknown cg_variant {cg_variant!r}")


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
    _check_options(ladder, cg_variant)
    searches = {"sequential": _line_search, "vector": _line_search_vec,
                "grid": _line_search_grid}
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
        if not bool(_dot(g, u) < 0):  # restart on a non-descent direction
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

        gg = torch.clamp(_dot(g, g), min=1e-30)
        if cg_variant == "pr":
            beta = torch.clamp(_dot(g_new, g_new - g) / gg, min=0.0)
        else:
            beta = _dot(g_new, g_new) / gg
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
# CG over a leading lane axis as steps on static buffers (JAX: CGState,
# cg_init, make_cg_body, cg_run_rounds, cg_finalize and minimize_fr_cg's
# while_loop). Objectives take x (P, D) and return (P,) values
# (value_and_grad_fn: also the (P, D) gradient); with the vector or grid
# ladder f_fn must also take (P, M, D) and return (P, M).
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


def _trusted(x: torch.Tensor, trust_radius: float | None) -> torch.Tensor:
    """Per lane: every 3-block of x below the trust radius (_within_trust)."""
    if trust_radius is None:
        return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    r = x.reshape(x.shape[0], -1, 3)
    return torch.sum(r * r, dim=-1).amax(dim=-1) < trust_radius * trust_radius


class LaneCG:
    """P CG solves at once as the steps of a device program
    (ops/device_loop.py) on static buffers.

    ``start(x0)`` evaluates f and g at x0 and resets the state;
    ``iteration(b)`` is one line-search iteration of every lane still moving
    (``keep``): the sequential ladder's bracket steps and the secant steps
    are loops gated on "any lane still searching, under the step budget",
    the counterpart of the JAX package's inner while_loops (gates on the
    ``active`` lanes with the step counter ``k`` or ``j``, read by the
    predicate itself), and the iteration ends by writing the next ``keep``,
    the CG loop's gate. ``solve(b, x0)`` is minimize_fr_cg over every lane:
    start, then iterations while any lane is RUNNING, under ``max_iters``
    line searches and inside the trust radius. Every decision is
    minimize_fr_cg's on each lane alone; a lane outside ``keep`` keeps its
    state. No step reads a value on the host: with ``device_loop.Eager`` the
    gates are read there (the CPU's form); in a graph they are conditional
    nodes. Options as in minimize_fr_cg; ``name`` names the CG loop's node
    (its line search's loops are ``bracket`` and ``secant`` inside it)."""

    def __init__(self, value_and_grad_fn: Callable, f_fn: Callable | None, lanes: int, dim: int,
                 device, *, max_iters: int = 50, line_search_tol: float = 0.05,
                 grad_tol: float = 1e-3, fun_tol: float = 1e-4,
                 max_fevals_per_linesearch: int = 16, stagnation_patience: int = 1,
                 initial_step: float = 0.1, ladder: str = "sequential", cg_variant: str = "fr",
                 secant_refine_evals: int = 4, trust_radius: float | None = None,
                 name: str = "cg"):
        _check_options(ladder, cg_variant)
        self.name = name
        self.vg = value_and_grad_fn
        f_fn = f_fn if f_fn is not None else (lambda x: value_and_grad_fn(x)[0])

        def f_only(x):
            with torch.no_grad():
                return f_fn(x)

        self.f = f_only
        self.max_iters = max_iters
        self.tol, self.grad_tol, self.fun_tol = line_search_tol, grad_tol, fun_tol
        self.max_evals, self.refine_evals = max_fevals_per_linesearch, secant_refine_evals
        self.patience, self.initial_step = stagnation_patience, initial_step
        self.ladder, self.variant, self.trust_radius = ladder, cg_variant, trust_radius
        self.restart_every = max(dim, 2)
        P, dev = lanes, torch.device(device)

        def fl(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i32, b8 = torch.int32, torch.bool
        self.s = CGState(x=fl(P, dim), f=fl(P), f_prev=fl(P), g=fl(P, dim), d=fl(P, dim),
                         alpha0=fl(P), it=fl(P, dtype=i32), status=fl(P, dtype=i32), f0=fl(P),
                         stall=fl(P, dtype=i32))
        # line-search scratch: direction, bracket winner, secant state
        self.u, self.dnorm, self.dphi0 = fl(P, dim), fl(P), fl(P)
        self.fb, self.ab, self.gb = fl(P), fl(P), fl(P, dim)
        self.a_cur, self.a_prev, self.dphi_prev = fl(P), fl(P), fl(P)
        self.grow, self.active, self.keep = fl(P, dtype=b8), fl(P, dtype=b8), fl(P, dtype=b8)
        self.k = fl(1, dtype=i32)  # the sequential ladder's step in the line search
        self.j = fl(1, dtype=i32)  # the secant step in the line search
        self.n = fl(1, dtype=i32)  # line searches done in a round (rounds)
        # The loops' gates, read by the predicate on the device: the lanes
        # still searching and the ladder's or secant's step under its limit;
        # the CG loop runs while any lane is kept.
        self.bracket_gate = device_loop.Gate(self.active, self.k,
                                             device_loop.limit(self.max_evals, dev))
        self.refine_gate = device_loop.Gate(self.active, self.j,
                                            device_loop.limit(self.refine_evals, dev))

    # -- state ------------------------------------------------------------
    def load(self, state: CGState, live: torch.Tensor | None = None) -> None:
        """Copy a CGState into the buffers; ``live`` (default all) is keep."""
        for buf, v in zip(self.s, state):
            buf.copy_(v)
        if live is None:
            self.keep.fill_(True)
        else:
            self.keep.copy_(live)

    def state(self) -> CGState:
        return CGState(*(t.clone() for t in self.s))

    def _set_keep(self) -> None:
        s = self.s
        keep = (s.status == RUNNING) & (s.it < self.max_iters) & _trusted(s.x, self.trust_radius)
        self.keep.copy_(keep)

    def start(self, x0: torch.Tensor) -> None:
        """Step: f and g at x0, a fresh state (cg_init), the first keep."""
        s = self.s
        s.x.copy_(x0)
        f0, g0 = self.vg(s.x)
        s.f.copy_(f0)
        s.f0.copy_(f0)
        s.f_prev.fill_(float("inf"))
        s.g.copy_(g0)
        s.d.copy_(-g0)
        s.alpha0.fill_(self.initial_step)
        s.it.zero_()
        s.status.fill_(RUNNING)
        s.stall.zero_()
        self._set_keep()

    # -- one iteration ----------------------------------------------------
    def iteration(self, b) -> None:
        b.seg(self._begin)
        if self.ladder == "sequential":
            b.repeat(self.bracket_gate, lambda: b.seg(self._bracket_step), trips=self.max_evals,
                     name="bracket")
            b.seg(self._refine_init)
        b.repeat(self.refine_gate, lambda: b.seg(self._refine_step), trips=self.refine_evals,
                 name="secant")
        b.seg(self._end)

    def solve(self, b, x0: torch.Tensor, name: str | None = None) -> None:
        """start(x0), then the CG loop; ``name`` (default the solver's)
        names the loop's node, so that a second solve in one program (a
        restart) is told apart in the trace."""
        b.seg(lambda: self.start(x0))
        b.repeat(self.keep, lambda: self.iteration(b), name=name or self.name)

    def rounds(self, b, num_iters: torch.Tensor) -> None:
        """cg_run_rounds on the state in the buffers, as program steps: up to
        ``num_iters`` (an int32 (1,) device buffer, read at every run) line
        searches of every lane still RUNNING under ``max_iters``; stops
        early once no lane moves."""
        def first():
            self._set_keep()
            self.n.zero_()

        def body():
            self.iteration(b)
            b.seg(lambda: self.n.add_(1))

        b.seg(first)
        b.repeat(device_loop.Gate(self.keep, self.n, num_iters), body, name=self.name)

    def _begin(self) -> None:
        """Direction (restart on a non-descent one) and the ladder's bracket,
        then the secant state of the lanes it bracketed."""
        s = self.s
        dnorm = torch.linalg.norm(s.d, dim=-1)
        u = s.d / torch.where(dnorm == 0, torch.ones_like(dnorm), dnorm)[:, None]
        descent = _dot(s.g, u) < 0
        u = _lanes(descent, u, -s.g / torch.clamp(torch.linalg.norm(s.g, dim=-1),
                                                  min=1e-30)[:, None])
        self.u.copy_(u)
        self.dnorm.copy_(dnorm)
        self.dphi0.copy_(_dot(s.g, u))
        if self.ladder == "sequential":
            self.fb.copy_(s.f)
            self.ab.zero_()
            self.grow.zero_()
            self.active.copy_(self.keep)
            self.k.zero_()
            return
        x, alpha0 = s.x, s.alpha0
        if self.ladder == "vector":
            # every rung alpha0 * 2^m, m in [-half, half], in ONE (P, M) call
            half = min(self.max_evals - 1, 9) // 2
            ms = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
            alphas = alpha0[:, None] * (2.0**ms)
            fs = self.f(x[:, None, :] + alphas[:, :, None] * u[:, None, :])
            i_best = torch.argmin(fs, dim=1, keepdim=True)
            f_best = fs.gather(1, i_best)[:, 0]
            a_best = alphas.gather(1, i_best)[:, 0]
            bracketed = self.keep & (f_best < s.f)
        else:
            # the sequential ladder's reachable grid in ONE (P, M) call, then
            # its decisions replayed per lane (masked, max_evals steps)
            m_lo = -((self.max_evals - 2) // 2)
            m_hi = self.max_evals - 1
            ms = torch.arange(m_lo, m_hi + 1, dtype=x.dtype, device=x.device)
            fs = self.f(x[:, None, :] + (alpha0[:, None] * (2.0**ms))[:, :, None] * u[:, None, :])
            f_best = s.f
            m_best = torch.zeros(f_best.shape, dtype=torch.int64, device=x.device)
            grow = torch.zeros_like(self.keep)
            active = self.keep
            for k in range(self.max_evals):
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
            bracketed = grow
        self.fb.copy_(f_best)
        self.ab.copy_(a_best)
        self.grow.copy_(bracketed)
        self._refine_init()

    def _bracket_step(self) -> None:
        """Sequential ladder step k (a device counter, so that one captured
        step serves every k): alternate alpha0 * 2^m above and below, then
        keep doubling from the first improvement until f rises."""
        s, k = self.s, self.k
        m = torch.div(k + 1, 2, rounding_mode="floor").to(s.alpha0.dtype)
        ladder = s.alpha0 * torch.where(k % 2 == 1, torch.pow(2.0, m), torch.pow(0.5, m))
        k.add_(1)
        a = torch.where(self.grow, self.ab * 2.0, ladder)
        f1 = self.f(s.x + a[:, None] * self.u)
        lower = f1 < self.fb
        active = self.active
        improved = active & lower
        stop = active & self.grow & ~lower  # we were improving and stopped: bracketed
        self.fb.copy_(torch.where(improved, f1, self.fb))
        self.ab.copy_(torch.where(improved, a, self.ab))
        self.grow.copy_(self.grow | improved)
        self.active.copy_(active & ~stop)

    def _refine_init(self) -> None:
        """Secant state from the bracket winner, for the bracketed lanes."""
        self.a_cur.copy_(self.ab)
        self.a_prev.zero_()
        self.dphi_prev.copy_(self.dphi0)
        self.gb.copy_(self.s.g)
        self.active.copy_(self.grow)
        self.j.zero_()

    def _refine_step(self) -> None:
        """One secant step toward phi'(a) = 0 for the lanes still searching;
        keeps the best (f, a, g) seen."""
        active, a_cur, a_prev = self.active, self.a_cur, self.a_prev
        f1, g1 = self.vg(self.s.x + a_cur[:, None] * self.u)
        dphi1 = _dot(g1, self.u)
        better = active & (f1 <= self.fb)
        fb, ab, gb = _lanes(better, f1, self.fb), _lanes(better, a_cur, self.ab), \
            _lanes(better, g1, self.gb)
        ok = torch.abs(dphi1) <= self.tol * torch.linalg.norm(g1, dim=-1)
        denom = dphi1 - self.dphi_prev
        denom = torch.where(torch.abs(denom) < 1e-30, torch.ones_like(denom), denom)
        a_next = a_cur - dphi1 * (a_cur - a_prev) / denom
        a_next = torch.clamp(a_next, 0.05 * a_cur, 4.0 * a_cur)
        new = (_lanes(active, a_cur, a_prev), _lanes(active, a_next, a_cur),
               _lanes(active, dphi1, self.dphi_prev), fb, ab, gb, active & ~ok)
        for buf, v in zip((self.a_prev, self.a_cur, self.dphi_prev, self.fb, self.ab, self.gb,
                           self.active), new):
            buf.copy_(v)
        self.j.add_(1)

    def _end(self) -> None:
        """The line search's outcome, the convergence tests in the
        reference's order and form (local_optim_contrast_gsl.cpp:176-194),
        the next direction, the update of the kept lanes, the next keep."""
        s = self.s
        ok = self.grow
        alpha = torch.where(ok, self.ab, torch.zeros_like(self.ab))
        f_new = torch.where(ok, self.fb, s.f)
        g_new = _lanes(ok, self.gb, s.g)
        x_new = s.x + alpha[:, None] * self.u

        stagnated = torch.abs(1.0 - f_new / (s.f_prev + 1e-7)) < self.fun_tol
        gsmall = torch.linalg.norm(g_new, dim=-1) < self.grad_tol
        stall_event = ~ok | stagnated
        stall = torch.where(stall_event, s.stall + 1, torch.zeros_like(s.stall))
        final = stall_event & (stall >= self.patience)
        status = torch.where(
            final, torch.where(ok, CONVERGED_FTOL, NO_PROGRESS),
            torch.where(gsmall, CONVERGED_GTOL, RUNNING)).to(torch.int32)
        retry = stall_event & ~final

        gg = torch.clamp(_dot(s.g, s.g), min=1e-30)
        if self.variant == "pr":
            beta = torch.clamp(_dot(g_new, g_new - s.g) / gg, min=0.0)
        else:
            beta = _dot(g_new, g_new) / gg
        it = s.it + 1
        restart = (it % self.restart_every == 0) | retry
        d = _lanes(restart, -g_new, -g_new + beta[:, None] * (self.u * self.dnorm[:, None]))
        alpha0 = torch.where(ok, torch.clamp(2.0 * alpha, 1e-6, 1e3), s.alpha0)
        alpha0 = torch.where(retry, torch.full_like(alpha0, self.initial_step), alpha0)
        new = CGState(x=_lanes(ok, x_new, s.x), f=torch.where(ok, f_new, s.f), f_prev=s.f,
                      g=_lanes(ok, g_new, s.g), d=d, alpha0=alpha0, it=it, status=status,
                      f0=s.f0, stall=stall)
        keep = self.keep
        for buf, n in zip(s, [_lanes(keep, n, o) for n, o in zip(new, s)]):
            buf.copy_(n)
        self._set_keep()

    def result(self) -> CGResult:
        """Per-lane result tensors (views of the buffers): a lane still
        RUNNING is TRUST_STOP outside the trust radius, else MAX_ITERS."""
        s = self.s
        running = s.status == RUNNING
        status = torch.where(running & ~_trusted(s.x, self.trust_radius), TRUST_STOP,
                             torch.where(running, MAX_ITERS, s.status)).to(torch.int32)
        return CGResult(x=s.x, fun=s.f, iters=s.it, status=status, f0=s.f0)


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
    """One CG line-search iteration over every lane: ``body(state, live)``,
    LaneCG.iteration run with its gates read on the host. ``live`` (P,)
    bool marks the lanes that move (default all); the others keep their
    state. Options as in minimize_fr_cg."""
    _check_options(ladder, cg_variant)
    opts = dict(line_search_tol=line_search_tol, grad_tol=grad_tol, fun_tol=fun_tol,
                max_fevals_per_linesearch=max_fevals_per_linesearch,
                stagnation_patience=stagnation_patience, initial_step=initial_step,
                ladder=ladder, cg_variant=cg_variant, secant_refine_evals=secant_refine_evals)
    cache: dict = {}

    def body(s: CGState, live: torch.Tensor | None = None) -> CGState:
        key = (s.x.shape[0], s.x.device)
        if key not in cache:
            cache.clear()
            cache[key] = LaneCG(value_and_grad_fn, f_fn, s.x.shape[0], dim, s.x.device, **opts)
        cg = cache[key]
        cg.load(s, live)
        cg.iteration(device_loop.Eager())
        return cg.state()

    return body


def cg_run_rounds(body: Callable, state: CGState, num_iters: int,
                  max_total_iters: int | None = None) -> CGState:
    """Advance every lane by up to ``num_iters`` line searches; a lane moves
    only while it is RUNNING and under ``max_total_iters`` (GSL's hard cap,
    however rounds divide it). The gate that stops early once no lane moves
    reads one flag on the host: the lane-batched tracker's rounds."""
    for _ in range(num_iters):
        keep = state.status == RUNNING
        if max_total_iters is not None:
            keep = keep & (state.it < max_total_iters)
        if not bool(keep.any()):
            break
        state = body(state, keep)
    return state


def cg_finalize(state: CGState, max_line_searches: int) -> CGResult:
    """Per-lane result tensors; a lane still RUNNING at the cap is MAX_ITERS."""
    status = torch.where((state.status == RUNNING) & (state.it >= max_line_searches),
                         MAX_ITERS, state.status).to(torch.int32)
    return CGResult(x=state.x, fun=state.f, iters=state.it, status=status, f0=state.f0)
