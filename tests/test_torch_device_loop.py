"""The CG solves as device programs (ops/device_loop.py, ops/optim.LaneCG,
the front-end's _PacketSolver), on the CPU, where every program runs
eagerly with its gates read on the host.

(a) One iteration reads nothing on the host: with the gates off, a Tensor's
    bool, item and float raise inside it (every ladder, both CG variants,
    with and without the trust radius), and so they do in one lane of the
    front-end's program.
(b) The runner takes minimize_fr_cg's decisions: on packets of the slice
    stream (tests/test_torch_slice.py) and on one back-end crop window,
    equal iterations and status and x within 1e-6 (both evaluate the same
    float32 expressions; the dot products are one reduction for both). It
    agrees with the JAX package's minimize_fr_cg on the same numpy inputs
    within tests/test_torch_optim.py's tolerances: 1e-3 rad/s on a packet
    with equal decisions, 2e-4 rad on the crop window held to three line
    searches.
(c) A stride of live, degenerate and padding lanes gives the rows and the
    warm-start carry of the JAX package's _build_stride_solver: degenerate
    and padding rows exactly zero, the carry exactly the last live lane's
    omega (or zero after a degenerate lane), and live rows within the slice
    tolerance (omega 0.06 rad/s; the cost, flat at the optimum, to rtol 1e-3).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.frontend import _build_stride_solver
from cmax_slam_tpu.ops import optim as joptim, warp_local as jwarp_local
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops import device_loop, optim, warp_local

torch.set_num_threads(1)

W, H, F = 120, 90, 90.0
CAM = warp_local.CameraParams(F, F, W / 2, H / 2, W, H)
LANE_OPTS = dict(grad_tol=1e-3, fun_tol=1e-4, initial_step=0.1, line_search_tol=0.05,
                 max_fevals_per_linesearch=16, stagnation_patience=1, secant_refine_evals=4)


@contextlib.contextmanager
def _no_host_reads():
    """Any read of a tensor's value on the host raises."""
    def refuse(*_a, **_k):
        raise AssertionError("a value was read on the host")

    saved = {k: getattr(torch.Tensor, k) for k in ("__bool__", "item", "__float__")}
    try:
        for k in saved:
            setattr(torch.Tensor, k, refuse)
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.Tensor, k, v)


def _bowl():
    rng = np.random.default_rng(2)
    c = torch.tensor(rng.uniform(-1, 1, (3, 6)).astype(np.float32))

    def f(x):  # (P, 6) -> (P,), (P, M, 6) -> (P, M)
        cc = c if x.dim() == 2 else c[:, None]
        return ((x - cc) ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1)

    return f


@pytest.mark.parametrize("trust", [None, 0.5])
@pytest.mark.parametrize("variant", ["fr", "pr"])
@pytest.mark.parametrize("ladder", ["sequential", "vector", "grid"])
def test_iteration_reads_nothing_on_the_host(ladder, variant, trust):
    f = _bowl()
    cg = optim.LaneCG(warp_local.value_and_grad(f), f, 3, 6, "cpu", ladder=ladder,
                      cg_variant=variant, trust_radius=trust, **LANE_OPTS)
    cg.start(torch.zeros(3, 6))
    gated = optim.LaneCG(warp_local.value_and_grad(f), f, 3, 6, "cpu", ladder=ladder,
                         cg_variant=variant, trust_radius=trust, **LANE_OPTS)
    gated.start(torch.zeros(3, 6))
    with _no_host_reads():
        for _ in range(3):
            cg.iteration(device_loop.Eager(gate=False))
    for _ in range(3):
        gated.iteration(device_loop.Eager())
    # with every gated step run, masked, the state is the gated run's
    for a, b in zip(cg.state(), gated.state()):
        assert torch.equal(a, b)
    assert int(cg.s.it.min()) >= 1


def _stream(duration=0.12, n=24_000, seed=3):
    rng = np.random.default_rng(seed)
    omega = np.array([0.6, -0.9, 1.3])
    ev = synthetic.rotating_camera_events(rng, n, duration, omega, F, F, W / 2, H / 2, W, H,
                                          n_points=250)
    return ev, omega


def _lut():
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([((xs - W / 2) / F).ravel(), ((ys - H / 2) / F).ravel(),
                     np.ones(W * H)], axis=-1).astype(np.float32)


def _frontend(**kw):
    cfg = replace(ijrr_config(num_events_per_packet=4000), **{"frontend.dt_ang_vel": 0.02})
    return Frontend(CAM, _lut(), replace(cfg.frontend, **kw), device="cpu")


def test_packet_program_lane_reads_nothing_on_the_host():
    ev, _ = _stream()
    fe = _frontend(device_store=True)
    fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    est = fe.estimates[2]
    solver = fe._solver(1)
    lanes = np.array([[est.span[0] & (fe._ring.capacity - 1), est.num_events,
                       np.float32(est.t - fe._t0), 1.0, 1.0]])
    solver.lanes_in[:1].copy_(torch.from_numpy(lanes))
    solver.count_in.fill_(1)
    with _no_host_reads():
        solver.program.build_fn(device_loop.Eager(gate=False))
    assert int(solver.fine.s.it[0]) == 1 and float(solver.out[3]) < 0


def _slice_packets(fe, ev, count=4):
    """(port packet, JAX packet) of the first packets of the stream."""
    out = []
    for est in fe.estimates[:count]:
        beg, end = est.span
        xs, ys, ts = ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end]
        t_ref = float(np.float32(est.t - fe._t0))
        tp = fe._packet(xs, ys, ts, t_ref)
        jp = jwarp_local.EventPacket(*(jnp.asarray(t.numpy()) for t in tp))
        out.append((tp, jp))
    return out


def _runner(vg, f, x0, **kw):
    """minimize over one lane as a device program (run eagerly here)."""
    cg = optim.LaneCG(vg, f, 1, x0.shape[-1], "cpu", **kw)
    x0 = x0.reshape(1, -1).clone()
    prog = device_loop.Program(lambda b: cg.solve(b, x0), 1, "cpu", name="test")
    prog.run()
    return cg.result()


def test_runner_matches_host_loop_and_jax_on_slice_packets(rng):
    """Against JAX: test_torch_optim.py's packet from a cold start within
    its 1e-3 rad/s with equal decisions; the stream's packets, each from the
    estimate before it, within the front-end's tolerance (max 0.06, median
    0.01 rad/s)."""
    from test_torch_objectives import _packets

    ev, omega = _stream()
    fe = _frontend(device_store=False)
    fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    o = fe.cfg.optim
    kw = dict(ladder=o.ladder, cg_variant=o.cg_variant, grad_tol=o.grad_tol,
              fun_tol=o.fun_tol)
    jp, tp, cam, _ = _packets(rng)
    cases = [(tp, jp, warp_local.CameraParams(*cam), np.zeros(3, np.float32), True)]
    # each slice packet warm-started, as the front-end does, from the
    # estimate before it
    warm = [np.zeros(3)] + [e.omega for e in fe.estimates]
    cases += [(t, j, CAM, warm[i].astype(np.float32), False)
              for i, (t, j) in enumerate(_slice_packets(fe, ev, count=6))]
    errs = []
    for tp, jp, cam, x0, exact in cases:
        f, vg = warp_local.make_local_objective(tp, cam, 1.0, 0)
        x0 = torch.tensor(x0)
        host = optim.minimize_fr_cg(vg, x0, f_fn=f, max_line_searches=50, **kw)
        res = _runner(vg, f, x0, max_iters=50, **kw)
        assert (int(res.iters[0]), int(res.status[0])) == (host.iters, host.status)
        np.testing.assert_allclose(res.x[0].numpy(), host.x.numpy(), atol=1e-6)
        assert float(res.f0[0]) == host.f0
        fj, _ = jwarp_local.make_local_objective(jp, jwarp_local.CameraParams(*cam), 1.0, 0)
        rj = jax.jit(lambda x: joptim.minimize_fr_cg(jax.value_and_grad(fj), x, f_fn=fj,
                                                     **kw))(jnp.asarray(x0.numpy()))
        if exact:
            np.testing.assert_allclose(res.x[0].numpy(), np.asarray(rj.x), atol=1e-3)
            assert (int(res.iters[0]), int(res.status[0])) == (int(rj.iters), int(rj.status))
        else:
            errs.append(np.linalg.norm(res.x[0].numpy() - np.asarray(rj.x)))
    assert max(errs) < 0.06 and np.median(errs) < 0.01, np.round(errs, 4)


def test_runner_matches_host_loop_and_jax_on_a_crop_window(rng):
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
    pano = calib.EquirectCamera(width=pano_j.width, height=pano_j.height)
    ct = warp_pano.crop_window_constants(_to_torch(win_j), pano, order, sigma, measure,
                                         (Hc, Wc), ints)
    ft, vgt = warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                            *ct[1:])
    o = ijrr_config().backend.optim  # the back-end's options: sequential ladder, FR
    kw = dict(ladder=o.ladder, cg_variant=o.cg_variant, grad_tol=o.grad_tol,
              line_search_tol=o.line_search_tol)
    x0 = torch.zeros(3 * K)
    host = optim.minimize_fr_cg(vgt, x0, f_fn=ft, max_line_searches=50, trust_radius=0.3, **kw)
    res = _runner(vgt, ft, x0, max_iters=50, trust_radius=0.3, **kw)
    assert (int(res.iters[0]), int(res.status[0])) == (host.iters, host.status)
    assert host.iters > 3
    np.testing.assert_allclose(res.x[0].numpy(), host.x.numpy(), atol=1e-6)

    cj = jwarp_pano.crop_window_constants(win_j, pano_j, order, sigma, measure, (Hc, Wc),
                                          jnp.asarray(ints))
    fj, _ = jwarp_pano.make_crop_objective(cj[0], pano_j, order, sigma, measure, (Hc, Wc),
                                           *cj[1:])
    short = _runner(vgt, ft, x0, max_iters=3, **kw)
    rj = jax.jit(lambda x: joptim.minimize_fr_cg(jax.value_and_grad(fj), x, f_fn=fj,
                                                 max_line_searches=3, **kw))(
        jnp.zeros(3 * K, jnp.float32))
    np.testing.assert_allclose(short.x[0].numpy(), np.asarray(rj.x), atol=2e-4)
    assert (int(short.iters[0]), int(short.status[0])) == (int(rj.iters), int(rj.status))


@pytest.mark.parametrize("flags", [(1, 0, 1, 1, -1, -1), (1, 1, 0, -1)])
def test_stride_rows_and_carry_match_jax(flags):
    ev, _ = _stream()
    fe = _frontend(device_store=False)
    fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    cfg = fe.cfg
    L, S = len(flags), fe.packet_size
    packets = iter(fe.estimates[1:])
    ests = [next(packets) if fl > 0 else None for fl in flags]
    omega0 = np.array([0.3, -0.5, 0.8], np.float32)
    lanes = np.zeros((L, 5))
    host = np.zeros((2, L, S), np.int32)
    evP = np.zeros((L, 4, S), np.float32)
    t_refs = np.zeros(L, np.float32)
    for i, (e, fl) in enumerate(zip(ests, flags)):
        lanes[i, 3] = fl
        if fl <= 0:
            continue
        beg, end = e.span
        xs, ys, ts = ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end]
        n = end - beg
        t_refs[i] = np.float32(e.t - fe._t0)
        lanes[i, :3] = (i * S, n, t_refs[i])
        host[:, i] = fe._host_events(xs, ys, ts)
        evP[i, 0, :n], evP[i, 1, :n] = xs, ys
        evP[i, 2, :n] = (ts - fe._t0).astype(np.float32)
        evP[i, 3, :n] = 1.0
    out = fe._solver(L).solve(lanes, torch.tensor(omega0), host).fetch()
    rows, carry = out[:L * 5].reshape(L, 5), out[-3:]

    jsolve = _build_stride_solver(jwarp_local.CameraParams(*CAM), cfg.warp.event_batch_size,
                                  cfg.warp.blur_sigma, cfg.contrast_measure, cfg.optim,
                                  cfg.coarse_to_fine, cfg.warp.precision, cfg.batch_sweeps)
    carry_j, rows_j = jsolve(jnp.asarray(evP), jnp.asarray(t_refs),
                             jnp.asarray(np.asarray(flags, np.float32)), jnp.asarray(omega0),
                             jnp.asarray(_lut()))
    rows_j, carry_j = np.asarray(rows_j), np.asarray(carry_j)
    live = np.asarray(flags) > 0
    np.testing.assert_array_equal(rows[~live], 0.0)
    np.testing.assert_array_equal(rows_j[~live], 0.0)
    np.testing.assert_allclose(rows[live, :3], rows_j[live, :3], atol=0.06)
    np.testing.assert_allclose(rows[live, 3], rows_j[live, 3], rtol=1e-3)
    assert np.all((rows[live, 4] > 0) & (rows[live, 4] <= 50))
    assert np.all(rows[live, 3] < 0)
    last = max(i for i, fl in enumerate(flags) if fl >= 0)
    expect = rows[last, :3] if flags[last] > 0 else np.zeros(3)
    np.testing.assert_array_equal(carry, expect.astype(np.float32))
    np.testing.assert_allclose(carry, carry_j, atol=0.06)
