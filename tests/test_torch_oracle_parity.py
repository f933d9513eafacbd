"""The port against the scalar oracle (tools/scalar_oracle.py, an
independent numpy float64 implementation of the reference algorithm), with
the gates of tests/test_oracle_parity.py on its stream and configuration:
per-packet omega gap median < 0.03 and p90 < 0.08 rad/s, trajectory gap
< 0.1 deg RMS (max 0.3) after gauge alignment, and the oracle itself within
0.3 deg of the ground truth. The port misses the 0.3 deg bound on the
largest sample (a known miss, marked below and in ROADMAP Queue 3). The
last two tests trace that miss window by window: from JAX's state after
each window, the port and JAX solve the next one alike to float32
rounding, and where they part the first decision that differs is a tie
between two evaluations of one point."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import scalar_oracle as oracle  # noqa: E402

import cmax_slam_tpu.calib as jcalib  # noqa: E402
import cmax_slam_tpu.config as jconfig  # noqa: E402
import cmax_slam_tpu.system as jsystem  # noqa: E402
import cmax_slam_tpu_torch.config as tconfig  # noqa: E402
from cmax_slam_tpu_torch.calib import CameraCalibration  # noqa: E402
from cmax_slam_tpu_torch.io import synthetic  # noqa: E402
from cmax_slam_tpu_torch.system import CMaxSLAM  # noqa: E402
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg  # noqa: E402

from test_oracle_parity import (  # noqa: E402
    BATCH, DT_AV, DT_KNOTS, DURATION, FXY, H, MAX_UPD, MIN_EV_RATE, N_EVENTS, OMEGA_TRUE,
    PACKET, PANO_H, PANO_W, SIGMA, STRIDE, W, WIN,
)

# Full-tier suite: long e2e run (see pytest.ini; run with -m "")
pytestmark = pytest.mark.slow

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(7)
    return synthetic.rotating_camera_events(
        rng, N_EVENTS, DURATION, OMEGA_TRUE, FXY, FXY, W / 2, H / 2, W, H, n_points=300)


K = np.array([[FXY, 0, W / 2], [0, FXY, H / 2], [0, 0, 1.0]])


def _config(c):
    """tests/test_oracle_parity.py's configuration, built from the config
    module ``c`` of either package."""
    return c.SystemConfig(
        frontend=c.FrontendConfig(
            num_events_per_packet=PACKET, dt_ang_vel=DT_AV,
            warp=c.WarpOptions(blur_sigma=SIGMA, event_batch_size=BATCH),
        ),
        backend=c.BackendConfig(
            sliding_window=c.SlidingWindowOptions(WIN, STRIDE),
            warp=c.WarpOptions(blur_sigma=SIGMA, event_batch_size=BATCH),
            trajectory=c.TrajectoryOptions(dt_knots=DT_KNOTS, spline_degree=1),
            pano_map=c.PanoMapOptions(
                pano_height=PANO_H, pano_width=PANO_W,
                backend_min_ev_rate=MIN_EV_RATE, max_update_times=MAX_UPD,
                y_angle_deg=0.0,
            ),
            crop_solver=False,
        ),
    )


def _port_system():
    return CMaxSLAM(CameraCalibration(width=W, height=H, K=K), _config(tconfig), device="cpu")


def _jax_system():
    return jsystem.CMaxSLAM(jcalib.CameraCalibration(width=W, height=H, K=K), _config(jconfig))


@pytest.fixture(scope="module")
def production(stream):
    slam = _port_system()
    ev = stream
    for i in range(0, N_EVENTS, 40_000):
        slam.push_events(ev.xs[i:i + 40_000], ev.ys[i:i + 40_000],
                         ev.ts[i:i + 40_000], ev.pols[i:i + 40_000])
    slam.flush()
    slam.frontend.finalize_batch(slam.frontend.estimates)
    return slam


@pytest.fixture(scope="module")
def oracle_run(stream):
    fe = oracle.OracleFrontend(
        fx=FXY, fy=FXY, cx=W / 2, cy=H / 2, width=W, height=H,
        num_events_per_packet=PACKET, dt_ang_vel=DT_AV, blur_sigma=SIGMA,
        event_batch_size=BATCH,
    )
    be = oracle.OracleBackend(
        fx=FXY, fy=FXY, cx=W / 2, cy=H / 2, width=W, height=H,
        pano_width=PANO_W, pano_height=PANO_H,
        time_window_size=WIN, sliding_window_stride=STRIDE,
        dt_knots=DT_KNOTS, blur_sigma=SIGMA, event_batch_size=BATCH,
        min_ev_rate=MIN_EV_RATE, max_update_times=MAX_UPD,
        bootstrap_resolve_window=4,
    )
    ev = stream
    return oracle.run_oracle(ev.xs, ev.ys, ev.ts, fe, be)


def test_frontend_omega_parity(production, oracle_run):
    _, ests_o, _ = oracle_run
    ests_p = production.frontend.estimates
    to = np.array([t for t, _ in ests_o])
    wo = np.stack([w for _, w in ests_o])
    tp = np.array([e.t for e in ests_p])
    wp = np.stack([e.omega for e in ests_p])
    n = min(len(to), len(tp))
    assert n >= 30
    np.testing.assert_allclose(to[:n], tp[:n], atol=1e-9)
    live = (np.linalg.norm(wo[:n], axis=1) > 0) & (np.linalg.norm(wp[:n], axis=1) > 0)
    diffs = np.linalg.norm(wo[:n][live] - wp[:n][live], axis=1)
    assert np.median(diffs) < 0.03, f"median omega gap {np.median(diffs)}"
    assert np.percentile(diffs, 90) < 0.08, f"p90 omega gap {np.percentile(diffs, 90)}"


def _trajectory_gap(production, oracle_run):
    traj_o, _, _ = oracle_run
    traj_p = production.backend.traj
    t0 = max(traj_p.t_beg, traj_o.t0) + 1e-6
    t1 = min(traj_p.max_time(), traj_o.max_time()) - 1e-6
    assert t1 - t0 > 0.5, "overlapping refined span too short"
    grid = np.linspace(t0, t1, 60)
    q_p = traj_p.evaluate(grid)
    q_o = np.stack([traj_o.evaluate(t) for t in grid])
    return rotation_rms_deg(grid, q_o, q_p, "global")


def test_trajectory_parity(production, oracle_run):
    rms, _ = _trajectory_gap(production, oracle_run)
    assert rms < 0.1, f"production vs oracle RMS {rms:.4f} deg"


@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): the port's last sample, at the end of the last "
    "window, is 0.35 deg from the oracle's; JAX's is 0.25. There the data barely "
    "constrain the end knot: the port is 0.159 deg from the ground truth, JAX 0.084, "
    "the oracle 0.228, and over the whole span the port is 0.061 deg RMS from the "
    "truth, JAX 0.060"))
def test_trajectory_parity_max_sample(production, oracle_run):
    _, errs = _trajectory_gap(production, oracle_run)
    assert errs.max() < 0.3, f"max sample gap {errs.max():.4f} deg"


def test_oracle_tracks_ground_truth(oracle_run):
    traj_o, _, _ = oracle_run
    grid = np.linspace(traj_o.t0 + 1e-6, traj_o.max_time() - 1e-6, 60)
    q_o = np.stack([traj_o.evaluate(t) for t in grid])
    q_gt = np.stack([oracle.qexp(OMEGA_TRUE * t) for t in grid])
    rms, _ = rotation_rms_deg(grid, q_gt, q_o, "global")
    assert rms < 0.3, f"oracle vs ground truth RMS {rms:.4f} deg"


CHUNK = 20_000


def _drive(slam, ev, lo, omegas=None, stop_after=None):
    """Push the stream from event ``lo`` in chunks of CHUNK as push_events
    does, the back-end fed ``omegas`` (angular velocities by packet time) in
    place of its own front-end's (None: the front-end's own), until the end
    or until ``stop_after`` more windows have completed. Returns the next
    event index."""
    start, i = slam.backend.count_window, lo
    while i < N_EVENTS:
        j = min(i + CHUNK, N_EVENTS)
        slam._raw_count += j - i
        ests = slam.frontend.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])
        if omegas is None:
            slam.frontend.finalize_batch(ests)
        for e in ests:
            w = e.omega if omegas is None else omegas[round(e.t, 9)]
            slam.backend.push_ang_vel(e.t, np.asarray(w, np.float64))
        while slam.backend.ready():
            slam.backend.step()
        i = j
        if stop_after is not None and slam.backend.count_window >= start + stop_after:
            break
    return i


@pytest.fixture(scope="module")
def jax_chain(stream, tmp_path_factory):
    """JAX's system on the stream, checkpointed (JAX's .npz, which the port
    loads) after each push that completes a window: (its front-end's
    angular velocities by packet time, [(windows done, events consumed,
    checkpoint)])."""
    tmp = tmp_path_factory.mktemp("jax_chain")
    slam, cuts, i = _jax_system(), [], 0
    while i < N_EVENTS:
        done = slam.backend.count_window
        i = _drive(slam, stream, i, stop_after=1)
        k = slam.backend.count_window
        if done < k and i < N_EVENTS:
            path = str(tmp / f"cut_{k}.npz")
            slam.save_checkpoint(path)
            cuts.append((k, i, path))
    omegas = {round(t, 9): w for t, *w in slam.ang_vel_log.tolist()}
    return omegas, cuts


def _next_window(make, path, i, ev, omegas, k):
    """Window k solved by a fresh system restored from ``path``: (its
    initial cost, final cost, line searches, and the same for each window
    of a bootstrap re-solve that ran before it)."""
    slam = make()
    slam.load_checkpoint(path)
    assert slam.raw_count == i
    _drive(slam, ev, i, omegas, stop_after=1)
    w = next(w for w in slam.window_results() if w.index == k)
    boot = [(b.initial_cost, b.final_cost, b.iters) for b in slam.backend.bootstrap_results]
    return (w.initial_cost, w.final_cost, w.iters), boot


def test_windows_from_jax_state_match_jax_to_float32_rounding(stream, jax_chain):
    """The trace of the marked miss (ROADMAP Queue 3). From JAX's state
    after each window, fed JAX's front-end estimates, the port solves the
    next window as JAX does: its initial cost (the objective on the same
    knots, map and events: float32 sums of ~50k events in another order)
    agrees within 1e-5 relative at every cut, and where both solves take as
    many line searches their final costs agree within 1e-4 (the iterates
    drift by rounding at every step; where the counts differ the costs part
    by 2e-4 and more). Where they part, a stop test flipped on inputs equal
    to float32 rounding: the line-search counts differ (printed), and the
    window chain carries the difference to the end knot."""
    omegas, cuts = jax_chain
    assert len(cuts) >= 6
    rel = lambda a, b: abs(a - b) / abs(a)  # noqa: E731
    same = 0
    for k, i, path in cuts:
        (j0, j1, jit), jboot = _next_window(_jax_system, path, i, stream, omegas, k)
        (p0, p1, pit), pboot = _next_window(_port_system, path, i, stream, omegas, k)
        print(f"window {k}: initial {j0:.7f} jax / {p0:.7f} port (rel {rel(j0, p0):.2e}), "
              f"final {j1:.7f} / {p1:.7f} (rel {rel(j1, p1):.2e}), line searches {jit} / {pit}; "
              f"bootstrap re-solve before it: jax {jboot}, port {pboot}")
        assert len(jboot) == len(pboot)
        starts = [(j0, p0)] if not jboot else [(jboot[0][0], pboot[0][0])]
        assert all(rel(a, b) < 1e-5 for a, b in starts)
        solves = [(jit, pit)] + [(a[2], b[2]) for a, b in zip(jboot, pboot)]
        if all(a == b for a, b in solves):
            same += 1
            assert rel(j1, p1) < 1e-4
    assert same >= len(cuts) // 2


def _decisions(searches, tol, fun_tol, grad_tol):
    """Every decision one BA solve took, in order, from its line searches'
    records: {(line search, test, occurrence): (value, threshold, outcome)}.
    The tests are the ones both packages' optim modules apply: each bracket
    step improves (f < best so far), each secant step keeps its point (f <=
    best; the first one re-evaluates the bracket's winner with its
    gradient) and stops (|g.u| <= tol |g|), then per line search the
    stagnation test (|1 - f/(f_prev + 1e-7)| < fun_tol, f_prev the cost
    before the previous line search) and the gradient test (|g| <
    grad_tol); in float32 as both compute them."""
    out, f32 = {}, np.float32
    f_prev = f32(np.inf)
    for n, s in enumerate(searches):
        best = f32(s["f0"])
        grow = False
        for j, b in enumerate(s["bracket"]):
            improved = bool(f32(b) < best)
            out[n, "bracket f < best", j] = (float(b), float(best), improved)
            if grow and not improved:
                break
            if improved:
                best, grow = f32(b), True
        for j, (f, dphi, gn) in enumerate(s["secant"]):
            out[n, "secant f <= best", j] = (f, float(best), bool(f32(f) <= best))
            best = min(best, f32(f))
            ratio = abs(dphi) / gn
            out[n, "secant |g.u|/|g| <= tol", j] = (ratio, tol, bool(ratio <= tol))
        with np.errstate(divide="ignore", invalid="ignore"):
            stag = abs(f32(1.0) - f32(s["f"]) / (f_prev + f32(1e-7)))
        out[n, "stagnation < fun_tol", 0] = (float(stag), fun_tol, bool(stag < fun_tol))
        out[n, "|g| < grad_tol", 0] = (s["gnorm"], grad_tol, bool(s["gnorm"] < grad_tol))
        f_prev = f32(s["f0"])
    return out


def _first_differences(dj, dp):
    """The first decision whose outcome differs, or that one package took
    and the other did not, overall and per test: {test or "any": key}."""
    keys = sorted(set(dj) | set(dp), key=lambda k: (k[0], list(dj).index(k) if k in dj
                                                     else list(dp).index(k) + 0.5))
    firsts = {}
    for key in keys:
        a, b = dj.get(key), dp.get(key)
        if a is None or b is None or a[2] != b[2]:
            firsts.setdefault("any", key)
            firsts.setdefault(key[1], key)
    return firsts


def _trace_port(monkeypatch, solves):
    """Records every back-end (sequential-ladder) solve of the port into
    ``solves``: a list of line searches each, with f0, the bracket's values,
    each secant step's (f, g.u, |g|), and the result (f, |g|, ok, and
    whether the gradient it returns is its start gradient). The back-end's
    solves are ``optim.LaneCG`` programs (one lane), which run their steps
    eagerly on the CPU: a solve starts at ``start``, a line search at
    ``_begin``, each bracket step (``_bracket_step``) evaluates f once and
    each secant step (``_refine_step``) f and g once, and ``_end`` takes the
    line search's outcome."""
    from cmax_slam_tpu_torch.ops import optim as topt

    cls = topt.LaneCG
    start, begin, bracket, refine, end = (cls.start, cls._begin, cls._bracket_step,
                                          cls._refine_step, cls._end)

    def sequential(cg):
        return cg.ladder == "sequential" and cg.s.x.shape[0] == 1

    def traced_start(cg, x0):
        if sequential(cg):
            solves.append([])
        return start(cg, x0)

    def traced_begin(cg):
        begin(cg)
        if sequential(cg) and bool(cg.keep[0]):
            solves[-1].append({"f0": float(cg.s.f[0]), "tol": float(cg.tol), "bracket": [],
                               "secant": []})

    def traced_bracket(cg):
        if not sequential(cg):
            return bracket(cg)
        f = cg.f

        def f_rec(xq):
            v = f(xq)
            solves[-1][-1]["bracket"].append(float(v[0]))
            return v

        cg.f = f_rec
        try:
            bracket(cg)
        finally:
            cg.f = f

    def traced_refine(cg):
        if not sequential(cg):
            return refine(cg)
        vg = cg.vg

        def vg_rec(xq):
            v, g = vg(xq)
            solves[-1][-1]["secant"].append((float(v[0]), float(topt._dot(g, cg.u)[0]),
                                             float(torch.linalg.norm(g[0]))))
            return v, g

        cg.vg = vg_rec
        try:
            refine(cg)
        finally:
            cg.vg = vg

    def traced_end(cg):
        if sequential(cg) and bool(cg.keep[0]):
            ok = bool(cg.grow[0])
            f = cg.fb[0] if ok else cg.s.f[0]
            g = cg.gb[0] if ok else cg.s.g[0]
            solves[-1][-1].update(f=float(f), gnorm=float(torch.linalg.norm(g)), ok=ok,
                                  stale=ok and bool(torch.equal(cg.gb[0], cg.s.g[0])))
        return end(cg)

    for name, fn in (("start", traced_start), ("_begin", traced_begin),
                     ("_bracket_step", traced_bracket), ("_refine_step", traced_refine),
                     ("_end", traced_end)):
        monkeypatch.setattr(cls, name, fn)


def _trace_jax(monkeypatch, events):
    """The same for JAX's jitted back-end solve: its sequential line search
    and minimize_fr_cg wrapped to report through ordered debug callbacks
    (the solve itself is unchanged), and the window solver's memo cleared so
    that the wrapped functions are traced. ``events`` receives the flat
    callback stream; ``_jax_solves`` groups it."""
    import jax
    import jax.numpy as jnp
    from cmax_slam_tpu import backend as jbackend
    from cmax_slam_tpu.ops import optim as jopt

    search, minimize = jopt._line_search, jopt.minimize_fr_cg

    def emit(kind, *vals):
        jax.debug.callback(lambda *v: events.append((kind, *(np.asarray(x).item() for x in v))),
                           *vals, ordered=True)

    def traced_minimize(*a, **kw):
        if kw.get("ladder", "sequential") == "sequential":
            emit("solve", jnp.float32(0))
        return minimize(*a, **kw)

    def traced_search(f_fn, vg_fn, x, f0, g0, u, alpha0, tol, max_evals, refine_evals=4):
        emit("start", f0, jnp.float32(tol))

        def f_rec(xq):
            f = f_fn(xq)
            emit("bracket", f)
            return f

        def vg_rec(xq):
            f, g = vg_fn(xq)
            emit("secant", f, jnp.vdot(g.astype(x.dtype), u), jnp.linalg.norm(g))
            return f, g

        a, f, g, ok = search(f_rec, vg_rec, x, f0, g0, u, alpha0, tol, max_evals, refine_evals)
        emit("end", f, jnp.linalg.norm(g), ok, ok & jnp.array_equal(g, g0))
        return a, f, g, ok

    monkeypatch.setattr(jopt, "minimize_fr_cg", traced_minimize)
    monkeypatch.setattr(jopt, "_line_search", traced_search)
    jbackend._build_window_solver.cache_clear()
    return jbackend._build_window_solver.cache_clear  # for after the traced runs


def _jax_solves(events):
    solves = []
    for kind, *v in events:
        if kind == "solve":
            solves.append([])
        elif kind == "start":
            solves[-1].append({"f0": v[0], "tol": v[1], "bracket": [], "secant": []})
        elif kind == "bracket":
            solves[-1][-1]["bracket"].append(v[0])
        elif kind == "secant":
            solves[-1][-1]["secant"].append(tuple(v))
        else:
            solves[-1][-1].update(f=v[0], gnorm=v[1], ok=bool(v[2]), stale=bool(v[3]))
    return solves


def _show(dj, dp, key):
    fmt = lambda d: "not taken" if d is None else f"{d[0]:.7g} vs {d[1]:.7g} ({d[2]})"  # noqa: E731
    return f"line search {key[0]}, {key[1]} #{key[2]}: JAX {fmt(dj.get(key))}, port {fmt(dp.get(key))}"


def test_windows_from_jax_state_part_where_a_stop_test_flips(stream, jax_chain, monkeypatch):
    """Where the port and JAX part (ROADMAP Queue 3), the decisions that
    differ. From JAX's state after each window, fed JAX's front-end
    estimates, every BA solve of the next window (a bootstrap re-solve
    included) is traced in both packages, decision by decision. Printed:
    per solve the first decision that differs, overall and per test, and
    where the line-search counts differ every line search's stop tests
    (values and tolerance) in both packages, a secant step whose point was
    not kept marked, and a line search that returns its start gradient
    with its new point (no secant point kept). In the first solve of each
    window that parts, the decisions before the first that differs are the
    same, the costs they read agree to float32 rounding (1e-5 relative),
    and the first difference is a tie: the first secant step's
    value-and-gradient evaluation of the bracket's winning point against
    the bracket's forward-only value of the same point, within 1e-6
    relative of each other."""
    import jax

    omegas, cuts = jax_chain
    o = _config(tconfig).backend.optim
    port_solves, jax_events = [], []
    _trace_port(monkeypatch, port_solves)
    clear = _trace_jax(monkeypatch, jax_events)
    rel = lambda a, b: abs(a - b) / abs(a)  # noqa: E731
    # line searches; first secant steps not kept; start gradients returned
    tally = {"JAX": [0, 0, 0], "port": [0, 0, 0]}
    try:
        for k, i, path in cuts:
            port_solves.clear()
            jax_events.clear()
            _next_window(_jax_system, path, i, stream, omegas, k)
            jax.effects_barrier()
            _next_window(_port_system, path, i, stream, omegas, k)
            jax_solves = _jax_solves(jax_events)
            assert len(jax_solves) == len(port_solves) >= 1
            for name, solves in (("JAX", jax_solves), ("port", port_solves)):
                for solve in solves:
                    d = _decisions(solve, o.line_search_tol, o.fun_tol, o.grad_tol)
                    tally[name][0] += len(solve)
                    tally[name][1] += sum(not d[key][2] for key in d
                                          if key[1:] == ("secant f <= best", 0))
                    tally[name][2] += sum(r["stale"] for r in solve)
            for s, (js, ps) in enumerate(zip(jax_solves, port_solves)):
                dj = _decisions(js, o.line_search_tol, o.fun_tol, o.grad_tol)
                dp = _decisions(ps, o.line_search_tol, o.fun_tol, o.grad_tol)
                firsts = _first_differences(dj, dp)
                print(f"window {k} solve {s} of {len(jax_solves)}: line searches {len(js)} JAX, "
                      f"{len(ps)} port; costs {js[0]['f0']:.7f} -> {js[-1]['f']:.7f} JAX, "
                      f"{ps[0]['f0']:.7f} -> {ps[-1]['f']:.7f} port")
                if not firsts:
                    continue
                for test, key in firsts.items():
                    print(f"  first that differs{'' if test == 'any' else ' of its test'}: "
                          + _show(dj, dp, key))
                if len(js) != len(ps):
                    for n in range(max(len(js), len(ps))):
                        for name, recs, d in (("JAX", js, dj), ("port", ps, dp)):
                            if n < len(recs):
                                r = recs[n]
                                print(f"  line search {n} {name}: f {r['f0']:.7f} -> "
                                      f"{r['f']:.7f}, ok {r['ok']}, |g| {r['gnorm']:.6g}"
                                      f"{' (its start gradient)' if r['stale'] else ''}, "
                                      f"{len(r['bracket'])} bracket steps, secant |g.u|/|g| "
                                      + " ".join(f"{abs(g) / gn:.4f}"
                                                 + ("" if d[n, "secant f <= best", j][2]
                                                    else " (not kept)")
                                                 for j, (_, g, gn) in enumerate(r["secant"]))
                                      + f" (tol {r['tol']:g}), stagnation "
                                      f"{d[n, 'stagnation < fun_tol', 0][0]:.3g} "
                                      f"(fun_tol {o.fun_tol:g})")
                first = firsts["any"]
                order = list(dj)
                before = (order[:order.index(first)] if first in dj
                          else [key for key in order if key[0] < first[0]])
                assert all(key in dp and dj[key][2] == dp[key][2] for key in before)
                # The first difference is a tie: the first secant step
                # evaluates the bracket's winning point again, with its
                # gradient, and its value is held against the bracket's
                # forward-only value of the same point.
                assert first[1:] == ("secant f <= best", 0)
                value, bracket, _ = dj[first]
                assert rel(bracket, value) < 1e-6
                for rj, rp in zip(js[:first[0] + 1], ps):
                    assert rel(rj["f0"], rp["f0"]) < 1e-5
                break  # the window's later solves start from the parted point
        for name, (n, unkept, stale) in tally.items():
            print(f"{name}: {n} line searches, the first secant step's point not kept in "
                  f"{unkept}, the start gradient returned in {stale}")
    finally:
        clear()
