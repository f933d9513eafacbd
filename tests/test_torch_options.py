"""The solver options of the configuration that only a non-default setting
reaches, each in the port against the JAX package on one seeded stream: the
runs of chip_smoke's options phase (chip_smoke.OPTION_RUNS), here on the
CPU. Both systems take the stock ijrr preset with the run's dotted-key
overrides and are fed the same events. This file holds the contrast
measures, Polak-Ribiere+ and the front-end's sequential ladder;
tests/test_torch_options_backend.py the grid ladders, coarse-to-fine, the
trust cap and the refine prior; tests/test_torch_full_pano.py
``full_pano``; tests/test_torch_options_generator.py cases on
chip_smoke.make_stream's generator. They share this file's helpers.

The stream is tests/test_torch_slice.py's, on which the stock preset
agrees with JAX at these tolerances: tests/test_e2e.py's smooth rotation
(from rest up to about 2.5 rad/s), 50 000 events over 0.5 s on a 120x90
camera (fx = fy = 90), seed 3, 250 landmarks, pushed in chunks of 10 000,
with that test's overrides (4 000-event packets every 0.02 s, a 256x512
panorama, the bootstrap re-solve at window 2). On chip_smoke.make_stream's
constant-rate generator the stock preset itself parts from JAX in window 0,
at ROADMAP Queue 3's keep-test tie in the first line search
(tests/test_torch_options_generator.py traces it at 0.99 rad/s), so every
case there starts from that parting; that file runs the stock preset and
two options on it. The JAX system runs its per-packet schedule
(``frontend.batch_sweeps=0``; the port's schedules give equal estimates,
tests/test_torch_frontend_schedule.py).

Each case holds, at tests/test_torch_cli.py's tolerances: per-packet omega
within 0.06 rad/s (median 0.01) on equal packet grids; equal windows
(index, events, BA or not, rejected or not), bootstrap re-solves and, for
``refine_prior``, refine windows; equal crop windows, escapes and
rejections; the knots and the refined poses within 0.1 deg; the global map
within MAP_REL of its largest pixel.

``trust`` takes its cap by the options phase's rule (chip_smoke.trust_cap_deg:
chip_smoke.TRUST_FRACTION of a stock run's first window's largest knot
correction), here from the port's stock run on the case's stream.
``refine_prior`` runs one refine pass (Backend.refine_pass with the prior)
after the online pass, as the CLI's ``--refine-passes 1`` does. The JAX
package's RMS against the truth for the two other contrast measures sets
their gate on the card (G in OPTION_RUNS: 0.3 deg where JAX is under 0.15
deg, else twice JAX's figure); test_contrast_measure_gate_follows_jax holds
OPTION_RUNS to it."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import chip_smoke
import cmax_slam_tpu.calib as jcalib
import cmax_slam_tpu.config as jconfig
import cmax_slam_tpu.system as jsystem
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu_torch import config as tconfig
from cmax_slam_tpu_torch import lie
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import smooth_rot_fn
from test_torch_cli import OMEGA_MAX, OMEGA_MEDIAN, POSE_DEG, _knot_deg
from test_torch_presets import MAP_REL
from test_torch_slice import OVERRIDES

torch.set_num_threads(1)

W, H, F = 120, 90, 90.0
DURATION, N_EVENTS = 0.5, 50_000
PUSH = 10_000  # events per push_events call
SCALE = {"frontend.num_events_per_packet": 4_000} | OVERRIDES
JAX_SCHEDULE = {"frontend.batch_sweeps": 0}
NAMES = ["fe_sequential", "gradient_magnitude", "mean_square", "polak_ribiere"]


@functools.lru_cache(maxsize=1)
def _stream():
    """(events, rot_fn): tests/test_torch_slice.py's stream."""
    rot_fn, _ = smooth_rot_fn(DURATION)
    ev = synthetic.rotating_camera_events(np.random.default_rng(3), N_EVENTS, DURATION,
                                          np.zeros(3), F, F, W / 2, H / 2, W, H,
                                          n_points=250, rot_fn=rot_fn)
    return ev, rot_fn


def _rms(slam) -> float:
    """The trajectory's RMS against the truth, deg, after global alignment."""
    tr = slam.backend.traj
    grid = np.linspace(tr.t_beg + 1e-6, tr.max_time() - 1e-6, 40)
    q_gt = lie.from_matrix(torch.tensor(_stream()[1](grid))).numpy()
    return rotation_rms_deg(grid, q_gt, np.asarray(tr.evaluate(grid)), "global")[0]


def _calib(mod):
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    return mod.CameraCalibration(width=W, height=H, K=K)


def _push(slam, ev):
    for i in range(0, len(ev.ts), PUSH):
        j = min(i + PUSH, len(ev.ts))
        slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])
    slam.flush()


def _port(overrides):
    return CMaxSLAM(CameraCalibration(width=W, height=H, K=_calib(jcalib).K),
                    tconfig.replace(tconfig.ijrr_config(), **SCALE, **overrides), device="cpu")


def _jax(overrides):
    cfg = jconfig.replace(jconfig.ijrr_config(), **SCALE, **overrides, **JAX_SCHEDULE)
    return jsystem.CMaxSLAM(_calib(jcalib), cfg)


def stream_of(request):
    """The events a test module's cases run on: its ``STREAM()``, else
    this file's stream."""
    return getattr(request.module, "STREAM", lambda: _stream()[0])()


def overrides_of(name: str, cap_deg=None) -> dict:
    """A case's overrides: OPTION_RUNS[name]'s (none for "stock"), the
    trust run's cap C from ``cap_deg()``."""
    overrides = dict(chip_smoke.OPTION_RUNS[name]["overrides"]) if name != "stock" else {}
    if name == "trust":
        overrides["backend.max_ba_correction_rad"] = math.radians(cap_deg())
    return overrides


@pytest.fixture(scope="module")
def cap_deg(request):
    """The trust run's cap by the options phase's rule, from the port's
    stock run on the module's stream."""
    slam = _port({})
    _push(slam, stream_of(request))
    return chip_smoke.trust_cap_deg(chip_smoke.window_corrections(slam))


@pytest.fixture(scope="module")
def runs(request):
    """Each case's two systems on the module's stream, run once per module
    on first use."""
    ev = stream_of(request)
    done = {}

    def run(name):
        if name not in done:
            overrides = overrides_of(name, lambda: request.getfixturevalue("cap_deg"))
            j, t = _jax(overrides), _port(overrides)
            for slam in (j, t):
                _push(slam, ev)
                if name == "refine_prior":
                    slam.refine((ev.xs, ev.ys, ev.ts, ev.pols))
            done[name] = {"jax": j, "port": t}
        return done[name]

    return run


def _windows(results):
    return [(r.index, r.num_events, r.ran_ba, r.rejected) for r in results]


def _counts(slam):
    c = slam.metrics.counters
    return {k: c.get(k, 0) for k in ("backend.crop_windows", "backend.crop_escapes",
                                     "backend.ba_rejected", "backend.refine_windows",
                                     "frontend.events", "backend.events")}


# The partings, traced (test_option_window_parts_at_the_keep_test_tie and
# test_polak_ribiere_warm_starts_part_at_the_cold_start); each keeps its tolerance.
TIE = ("known miss (ROADMAP Queue 3): {} parts at the keep-test tie, the first secant "
       "step's keep test (test_option_window_parts_at_the_keep_test_tie[{}])")
PR_PACKET = ("known miss (ROADMAP Queue 3): the Polak-Ribiere+ front-ends first part at "
             "packet 4, the first to leave omega = 0, by the cold-start rounding (the "
             "gradient at omega = 0 of events on integer pixels); the 0.005 rad/s gap, "
             "carried by the warm starts, makes packet 9 end at one of two stops 0.076 "
             "rad/s apart (test_polak_ribiere_warm_starts_part_at_the_cold_start, "
             "test_polak_ribiere_packet_parts_by_its_warm_start)")
XFAIL_DECISIONS = {"polak_ribiere": PR_PACKET}
XFAIL_POSES = XFAIL_DECISIONS | {
    "full_pano": TIE.format("window 0, after equal decisions on costs drifting 6.4e-5 "
                            "relative over 6 line searches,", "full_pano-0"),
    "mean_square": TIE.format("window 0, after equal decisions on costs drifting 7.8e-5 "
                              "relative over 11 line searches,", "mean_square-0")
    + "; the knots stay within POSE_DEG and the map parts by 6.7% of its largest pixel",
    "trust": TIE.format("window 1 (from JAX's state the port takes 9 line searches to "
                        "JAX's 7; both reject the same windows)", "trust-1")
    + "; the knots stay within POSE_DEG and the map parts by 7.5% of its largest pixel",
}


def cases(names, xfail):
    """``names`` as parameters, those in ``xfail`` marked xfail(strict=True)
    with its reason."""
    return [pytest.param(n, marks=pytest.mark.xfail(strict=True, reason=xfail[n]))
            if n in xfail else n for n in names]


def check_decisions(run, name):
    """Packet grid and per-packet omega; windows, bootstrap re-solves and
    refine windows with their BA and rejection decisions; crop windows,
    escapes and rejections; for ``trust``, between 1 and windows - 1
    windows rejected, each solve rejected exactly when its recorded knot
    correction (WindowResult.correction_rad) exceeds the cap."""
    j, t = run["jax"], run["port"]
    av_j, av_t = np.asarray(j.ang_vel_log), t.ang_vel_log
    assert av_t.shape == av_j.shape and len(av_t) >= 20
    np.testing.assert_allclose(av_t[:, 0], av_j[:, 0], atol=1e-9)
    err = np.linalg.norm(av_t[:, 1:] - av_j[:, 1:], axis=1)
    assert err.max() < OMEGA_MAX and np.median(err) < OMEGA_MEDIAN, np.round(err, 4)
    assert _windows(t.window_results()) == _windows(j.window_results())
    assert len(t.window_results()) >= 3
    assert _windows(t.backend.bootstrap_results) == _windows(j.backend.bootstrap_results)
    assert _counts(t) == _counts(j)
    if name == "trust":
        assert 1 <= sum(r.rejected for r in t.window_results()) < len(t.window_results())
        cap = t.backend.cfg.max_ba_correction_rad  # each solve's correction, as held to it
        for r in t.window_results() + t.backend.bootstrap_results:
            assert r.rejected == (r.ran_ba and r.correction_rad > cap), r
    if name == "refine_prior":
        assert _counts(t)["backend.refine_windows"] >= 4
        assert any(k[5] == 100.0 for k in t.backend._entry.programs)


def check_poses_and_map(run):
    """The knots and the refined poses (equal times) within POSE_DEG; the
    global map within MAP_REL of its largest pixel."""
    j, t = run["jax"], run["port"]
    k_j, k_t = np.asarray(j.backend.traj.knots), t.backend.traj.knots
    assert k_t.shape == k_j.shape
    assert _knot_deg(k_t, k_j).max() < POSE_DEG
    (t_j, q_j), (t_t, q_t) = ((np.array([p[0] for p in s.trajectory_log]),
                               np.array([p[1] for p in s.trajectory_log])) for s in (j, t))
    np.testing.assert_array_equal(t_t, t_j)
    assert len(t_t) >= 3 and _knot_deg(q_t, q_j).max() < POSE_DEG
    ig_j, ig_t = np.asarray(j.backend.IG), t.backend.IG.numpy()
    assert np.abs(ig_t - ig_j).max() < MAP_REL * ig_j.max()


@pytest.mark.parametrize("name", cases(NAMES, XFAIL_DECISIONS))
def test_option_decisions_match_jax(runs, name):
    check_decisions(runs(name), name)


@pytest.mark.parametrize("name", cases(NAMES, XFAIL_POSES))
def test_option_poses_and_map_match_jax(runs, name):
    check_poses_and_map(runs(name))


@pytest.mark.parametrize("name", ["mean_square", "gradient_magnitude"])
def test_contrast_measure_gate_follows_jax(runs, name):
    """G, the options phase's RMS gate for the measure: 0.3 deg where the
    JAX package tracks this stream under 0.15 deg, else twice its figure
    (measured: mean square 0.0732, gradient magnitude 0.0703 deg; printed
    with -s)."""
    rms_j, rms_t = _rms(runs(name)["jax"]), _rms(runs(name)["port"])
    print(f"{name}: RMS against the truth, JAX {rms_j:.4f} deg, port {rms_t:.4f} deg")
    gate = 0.3 if rms_j < 0.15 else 2 * rms_j
    assert chip_smoke.OPTION_RUNS[name]["rms_deg"] == pytest.approx(gate, rel=0.05), rms_j
    assert rms_t < gate, (rms_t, rms_j)


def _field(cfg, dotted):
    for part in dotted.split("."):
        assert dataclasses.is_dataclass(cfg) and part in {f.name for f in
                                                          dataclasses.fields(cfg)}, dotted
        cfg = getattr(cfg, part)
    return cfg


def test_option_keys_are_fields_of_both_configs_with_equal_defaults():
    """Every dotted key OPTION_RUNS sets names a field of both packages'
    configuration, with the same default in SystemConfig() and in
    ijrr_config(), and takes the run's value in both."""
    keys = {k for run in chip_smoke.OPTION_RUNS.values() for k in run["overrides"]}
    assert len(keys) == 10
    for make in ("SystemConfig", "ijrr_config"):
        t, j = getattr(tconfig, make)(), getattr(jconfig, make)()
        for key in sorted(keys):
            assert _field(t, key) == _field(j, key), (make, key)
    for run in chip_smoke.OPTION_RUNS.values():
        values = {k: (0.001 if v is None else v) for k, v in run["overrides"].items()}
        t = tconfig.replace(tconfig.ijrr_config(), **values)
        j = jconfig.replace(jconfig.ijrr_config(), **values)
        for key, v in values.items():
            assert _field(t, key) == _field(j, key) == v, key


def test_polak_ribiere_packet_parts_by_its_warm_start(runs):
    """The Polak-Ribiere+ front-end's worst packet (9), solved alone by both
    packages from each package's estimate of the packet before: from
    either start the two packages land within 3e-3 rad/s of each other
    (the packet objective's float32 summation order), while the two
    starts, 0.002 rad/s apart, end at stops 0.07 rad/s apart (FTOL after
    6 line searches, NO_PROGRESS after 7)."""
    import jax
    import jax.numpy as jnp
    from cmax_slam_tpu.ops import optim as joptim, warp_local as jwarp_local
    from cmax_slam_tpu_torch.ops import optim, warp_local

    run = runs("polak_ribiere")
    ev = _stream()[0]
    av_j, av_t = np.asarray(run["jax"].ang_vel_log), run["port"].ang_vel_log
    k = int(np.argmax(np.linalg.norm(av_t[:, 1:] - av_j[:, 1:], axis=1)))
    assert k == 9 and abs(av_t[k - 1, 1:] - av_j[k - 1, 1:]).max() < 5e-3
    fe = run["port"].frontend
    e = fe.estimates[k]
    beg, end = e.span
    packet = fe._packet(ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end],
                        float(np.float32(e.t - fe._t0)))
    cam = tuple(fe.cam)
    jpacket = jwarp_local.EventPacket(*(jnp.asarray(a.numpy()) for a in packet))
    f_j, _ = jwarp_local.make_local_objective(jpacket, jwarp_local.CameraParams(*cam), 1.0, 0)
    f_t, _ = warp_local.make_local_objective(packet, warp_local.CameraParams(*cam), 1.0, 0)
    o = fe.cfg.optim
    kw = dict(max_line_searches=o.max_line_searches, initial_step=o.initial_step,
              line_search_tol=o.line_search_tol, grad_tol=o.grad_tol, fun_tol=o.fun_tol,
              max_fevals_per_linesearch=o.max_fevals_per_linesearch,
              stagnation_patience=o.stagnation_patience,
              secant_refine_evals=o.secant_refine_evals, ladder=o.ladder, cg_variant="pr")
    ends = []
    for start in (av_j[k - 1, 1:], av_t[k - 1, 1:]):
        x0 = np.asarray(start, np.float32)
        rj = jax.jit(lambda x: joptim.minimize_fr_cg(jax.value_and_grad(f_j), x, f_fn=f_j,
                                                     **kw))(jnp.asarray(x0))
        rt = optim.minimize_fr_cg(warp_local.value_and_grad(f_t), torch.tensor(x0), f_fn=f_t,
                                  **kw)
        assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 3e-3
        assert (rt.iters, rt.status) == (int(rj.iters), int(rj.status))
        ends.append(rt.x.numpy())
    assert np.linalg.norm(ends[0] - ends[1]) > 0.05


def _packet_solvers(run):
    """(solve, value_and_grad) for the packets of ``run``'s front-end:
    solve(k, x0) solves packet k from x0 in both packages under the run's
    front-end options and returns (JAX's result, the port's);
    value_and_grad(k, x) returns both packages' (value, gradient) of
    packet k's objective at x. JAX's solve is jitted once for every packet:
    its events are arguments."""
    import jax
    import jax.numpy as jnp
    from cmax_slam_tpu.ops import optim as joptim, warp_local as jwarp_local
    from cmax_slam_tpu_torch.ops import optim, warp_local

    ev, fe = _stream()[0], run["port"].frontend
    cam, o = tuple(fe.cam), fe.cfg.optim
    kw = dict(max_line_searches=o.max_line_searches, initial_step=o.initial_step,
              line_search_tol=o.line_search_tol, grad_tol=o.grad_tol, fun_tol=o.fun_tol,
              max_fevals_per_linesearch=o.max_fevals_per_linesearch,
              stagnation_patience=o.stagnation_patience,
              secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
              cg_variant=o.cg_variant)

    def packet(k):
        e = fe.estimates[k]
        beg, end = e.span
        return fe._packet(ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end],
                          float(np.float32(e.t - fe._t0)))

    def objectives(p):
        jp = jwarp_local.EventPacket(*(jnp.asarray(a.numpy()) for a in p))
        f_j, vg_j = jwarp_local.make_local_objective(jp, jwarp_local.CameraParams(*cam), 1.0, 0)
        f_t, _ = warp_local.make_local_objective(p, warp_local.CameraParams(*cam), 1.0, 0)
        return f_j, vg_j, f_t

    @jax.jit
    def solve_j(bearings, dts, weights, x0):
        f_j, vg_j = jwarp_local.make_local_objective(
            jwarp_local.EventPacket(bearings, dts, weights), jwarp_local.CameraParams(*cam),
            1.0, 0)
        return joptim.minimize_fr_cg(vg_j, x0, f_fn=f_j, **kw)

    def solve(k, x0):
        p = packet(k)
        x0 = np.asarray(x0, np.float32)
        rj = solve_j(*(jnp.asarray(a.numpy()) for a in p), jnp.asarray(x0))
        _, _, f_t = objectives(p)
        rt = optim.minimize_fr_cg(warp_local.value_and_grad(f_t), torch.tensor(x0), f_fn=f_t,
                                  **kw)
        return rj, rt

    def value_and_grad(k, x):
        _, vg_j, f_t = objectives(packet(k))
        v_j, g_j = vg_j(jnp.asarray(x, jnp.float32))
        v_t, g_t = warp_local.value_and_grad(f_t)(torch.tensor(x, dtype=torch.float32))
        return (float(v_j), np.asarray(g_j)), (float(v_t), g_t.numpy())

    return solve, value_and_grad


def test_polak_ribiere_warm_starts_part_at_the_cold_start(runs):
    """Where the Polak-Ribiere+ front-ends' estimates first part, packet by
    packet, each packet solved by both packages from JAX's warm start (its
    estimate of the packet before). Packets 0-3, the camera at rest, end
    at omega = 0 in both runs. Packet 4 starts there in both and is the
    first to part: equal line searches and stop, ends 0.0046 rad/s apart.
    Its objective at omega = 0 takes equal values but gradients apart
    beyond float32 rounding, the cold-start rounding of ROADMAP Queue 3
    (every warped event on an integer pixel, where ~2% take the other
    one-sided derivative); off omega = 0, at JAX's end point, the two
    gradients agree. Packets 5-9, from JAX's warm start, take equal line
    searches and stops within 3e-3 of each other: the runs' gap at packet
    9's start (0.002 rad/s) is packet 4's, carried by the warm starts."""
    run = runs("polak_ribiere")
    av_j, av_t = np.asarray(run["jax"].ang_vel_log), run["port"].ang_vel_log
    gap = np.abs(av_t[:, 1:] - av_j[:, 1:]).max(axis=1)
    assert not av_j[:4, 1:].any() and not av_t[:4, 1:].any()
    assert gap[4] > 1e-3 and gap[5:9].max() < 5e-3 and gap[9] > 0.05, np.round(gap[:10], 5)
    solve, value_and_grad = _packet_solvers(run)
    for k in range(4, 10):
        rj, rt = solve(k, av_j[k - 1, 1:])
        np.testing.assert_array_equal(np.asarray(rj.x), av_j[k, 1:])  # JAX's run, replayed
        assert (rt.iters, rt.status) == (int(rj.iters), int(rj.status)), k
        same_start = np.abs(rt.x.numpy() - np.asarray(rj.x)).max()
        assert same_start < (5e-3 if k == 4 else 3e-3), (k, same_start)
        if k == 4:
            np.testing.assert_array_equal(rt.x.numpy(), av_t[4, 1:])  # the port's run
    (v_j, g_j), (v_t, g_t) = value_and_grad(4, np.zeros(3))
    assert abs(v_t - v_j) < 2e-6 * abs(v_j)
    cold = np.abs(g_t - g_j).max() / np.abs(g_j).max()
    (v_j, g_j), (v_t, g_t) = value_and_grad(4, av_j[4, 1:])
    warm = np.abs(g_t - g_j).max() / np.abs(g_j).max()
    print(f"packet 4's gradient, port against JAX, relative to its largest component: "
          f"{cold:.3g} at omega = 0, {warm:.3g} at JAX's end point")
    assert cold > 1e-3 and warm < 1e-4, (cold, warm)


def test_mean_square_crop_objective_matches_jax(runs):
    """The mean-square measure on one real crop: the last window that the
    port's mean_square run loaded into its crop program (its events,
    times, knots and map), its crop planned as the back-end plans it, the
    crop objective's value and gradient in both packages at zero and at
    random increments, within 1e-5 relative (the gradient: of its largest
    component). The measure itself agrees to float32 rounding, so the
    mean_square window's cost drift before the keep-test tie
    (test_option_window_parts_at_the_keep_test_tie[mean_square-0]) is not
    a difference in the measure."""
    import jax.numpy as jnp
    from cmax_slam_tpu.ops import warp_pano as jwarp_pano
    from cmax_slam_tpu_torch.ops import warp_pano
    from test_crop_solver import _plan_for_test

    t = runs("mean_square")["port"].backend
    measure, sigma = t.cfg.contrast_measure, t.cfg.warp.blur_sigma
    assert measure == jconfig.MEAN_SQUARE_CONTRAST
    (solver,) = [s for key, s in t._entry.programs.items() if key[3] is not None][-1:]
    w = solver.win
    n = int((w.weights != 0).sum())
    arrays = {k: getattr(w, k).numpy() for k in ("bearings", "batch_times", "weights",
                                                 "is_old", "knots", "free_mask")}
    ig = w.ig_prime.numpy()
    assert n > 10_000 and ig.max() > 0
    win_j = jwarp_pano.PanoWindow(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, t0=jnp.float32(w.t0),
        dt_knots=jnp.float32(w.dt_knots), ig_prime=jnp.asarray(ig), alpha=jnp.float32(0))
    win_t = warp_pano.PanoWindow(
        **{k: torch.tensor(v) for k, v in arrays.items()}, t0=w.t0, dt_knots=w.dt_knots,
        ig_prime=torch.tensor(ig), alpha=torch.tensor(0.0))
    pano_j = jcalib.EquirectCamera(width=t.pano.width, height=t.pano.height)
    Hc, Wc, ints = _plan_for_test(win_j, pano_j, t.order, sigma, measure)
    assert (Hc, Wc) != (t.pano.height, t.pano.width)
    cj = jwarp_pano.crop_window_constants(win_j, pano_j, t.order, sigma, measure, (Hc, Wc),
                                          jnp.asarray(ints))
    _, vg_j = jwarp_pano.make_crop_objective(cj[0], pano_j, t.order, sigma, measure,
                                             (Hc, Wc), *cj[1:])
    ct = warp_pano.crop_window_constants(win_t, t.pano, t.order, sigma, measure, (Hc, Wc),
                                         ints)
    _, vg_t = warp_pano.make_crop_objective(ct[0], t.pano, t.order, sigma, measure, (Hc, Wc),
                                            *ct[1:])
    np.testing.assert_allclose(float(ct[0].alpha), float(cj[0].alpha), rtol=1e-5)
    K = arrays["knots"].shape[0]
    rng = np.random.default_rng(0)
    for scale in (0.0, 2e-3):
        d = (rng.normal(size=3 * K) * scale).astype(np.float32)
        v_j, g_j = vg_j(jnp.asarray(d))
        v_t, g_t = vg_t(torch.tensor(d))
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-5, err_msg=str(scale))
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-5 * np.abs(g_j).max(),
                                   err_msg=str(scale))


TRACES = {  # case: its window
    "full_pano-0": 0, "full_pano-1": 1, "full_pano-2": 2, "mean_square-0": 0, "trust-1": 1,
}
DRIFT = 1e-4  # the window-0 traces' cost drift before the tie, relative


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(TRACES))
def test_option_window_parts_at_the_keep_test_tie(case, cap_deg, monkeypatch, tmp_path):
    """The traces of the marked misses above (ROADMAP Queue 3): the case's
    window, from JAX's checkpoint before it and on JAX's front-end
    estimates, solved by both packages decision by decision
    (tests/test_torch_oracle_parity.py's tracer). Windows 1 and 2 of
    full_pano and window 1 of trust take the same decisions on costs equal
    to float32 rounding until the first secant step's keep-test tie;
    window 0 of full_pano and of mean_square take the same decisions up to
    that tie too. Their costs at the window's start (equal increments)
    agree to float32 rounding, 1e-5 relative (measured: 2.8e-6 on the
    full panorama, 2.6e-7 on mean_square's crop), and then drift as the
    iterates part by rounding, below DRIFT = 10 x that over the line
    searches before the tie (measured: 6.4e-5 over 6, 7.8e-5 over 11;
    test_mean_square_crop_objective_matches_jax holds the measure itself
    at 1e-5)."""
    from cmax_slam_tpu import backend as jbackend
    from test_torch_oracle_parity import (assert_parts_at_the_keep_test_tie,
                                          trace_window_from_jax_state)

    name, window = case.rsplit("-", 1)[0], TRACES[case]
    overrides = overrides_of(name, lambda: cap_deg)
    jbackend._build_window_solver.cache_clear()  # the tracer wraps what a new build traces
    try:
        traced = trace_window_from_jax_state(
            monkeypatch, lambda: _jax(overrides), lambda: _port(overrides), _stream()[0],
            window, _port(overrides).cfg.backend.optim, tmp_path)
    finally:
        jbackend._build_window_solver.cache_clear()
    dj, dp, first, js, ps = traced
    if window == 0 and name in ("full_pano", "mean_square"):
        order = list(dj)
        assert first[1:] == ("secant f <= best", 0)
        assert all(dj[k][2] == dp[k][2] for k in order[:order.index(first)])
        value, bracket, _ = dj[first]
        assert abs(value - bracket) / abs(bracket) < 1e-6
        drift = [abs(rj["f0"] - rp["f0"]) / abs(rj["f0"])
                 for rj, rp in zip(js[:first[0] + 1], ps)]
        print(f"{case}: cost drift per line search up to the tie {np.round(drift, 8)}")
        assert drift[0] < 1e-5 and max(drift) < DRIFT, drift
        return
    assert_parts_at_the_keep_test_tie(*traced)
