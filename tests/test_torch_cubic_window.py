"""The cubic back-end window (spline order 4) held against the benchmark's
plain reference, portbench/pb/spline_reference.py (float64, written from the
reference's equations, importing nothing of the port), on the CPU at a small
size: seeded random knots and events, K = 7 knots at 0.05 s (a 0.2 s
window), 4 000 events in batches of 100, a 64x128 crop of a 128x256
panorama, blur sigma 1, the variance measure, a random global map.

(a) spline.evaluate and spline.segment_basis at orders 2 and 4;
(b) the crop objective (warp_pano.make_crop_objective, the plain versions of
    K4/K5 on the CPU): value and gradient;
(c) the same on the whole panorama (warp_pano.make_pano_objective);
(d) the window program's restarted solve: its cost is no higher than the
    first solve's, its loop nodes are named apart, and the packed result
    carries the first solve's line searches beside the total.

Each tolerance is written with its reason, and each test also computes the
reference in bfloat16 (the precision below the port's float32) and asserts
that it misses the tolerance."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import config, spline
from cmax_slam_tpu_torch.backend import WindowInputs, _WindowSolver
from cmax_slam_tpu_torch.calib import EquirectCamera
from cmax_slam_tpu_torch.ops import warp_pano

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "portbench"))
from pb import spline_reference as ref  # noqa: E402

torch.set_num_threads(1)

K, DT, BATCH, N = 7, 0.05, 100, 4000
PANO = EquirectCamera(width=256, height=128)
CROP = (64, 128)
SIGMA, MEASURE = 1.0, config.VARIANCE_CONTRAST
CAM_W, CAM_H, CAM_F = 64, 40, 60.0


def _quats(rotvecs: np.ndarray) -> np.ndarray:
    return np.stack([spline._np_quat_exp(v) for v in rotvecs])


def _case(seed: int = 2 ** 31 + 24):
    """Knots along a turn with seeded noise, events on a 64x40 pinhole's
    pixels spread over the window, a random map, increments of ~1e-3 rad."""
    rng = np.random.default_rng(seed)
    tk = DT * (np.arange(K) - 1)
    knots = _quats(np.outer(tk, [0.3, -0.2, 0.2]) + 0.01 * rng.standard_normal((K, 3)))
    xs = rng.integers(0, CAM_W, N)
    ys = rng.integers(0, CAM_H, N)
    ts = np.sort(rng.uniform(0.0, 0.2, N))
    rays = np.stack([(xs - CAM_W / 2) / CAM_F, (ys - CAM_H / 2) / CAM_F, np.ones(N)], -1)
    bearings = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    ig = (rng.random((PANO.height, PANO.width)) < 0.05) * rng.uniform(0.5, 3.0, (PANO.height,
                                                                                 PANO.width))
    free = np.ones(K)
    free[0] = 0.0
    x = 1e-3 * rng.standard_normal((K, 3))
    return dict(knots=knots.astype(np.float32), bearings=bearings, ts=ts,
                ig=ig.astype(np.float32), free=free, x=x)


def _reference(c, dtype=torch.float64):
    return ref.Window(c["bearings"], c["ts"], c["knots"], c["free"], 0.0, DT, 4, BATCH, c["ig"],
                      SIGMA, dtype=dtype, block=1024)


def _port_window(c) -> warp_pano.PanoWindow:
    mids = ref.batch_mid_times(c["ts"], BATCH)
    return warp_pano.PanoWindow(
        bearings=torch.as_tensor(c["bearings"]).T.contiguous(),
        batch_times=torch.as_tensor(mids, dtype=torch.float32),
        weights=torch.ones(N), is_old=torch.as_tensor(c["ts"] < 0.1),
        knots=torch.as_tensor(c["knots"]),
        free_mask=torch.as_tensor(c["free"], dtype=torch.float32),
        t0=0.0, dt_knots=float(np.float32(DT)), ig_prime=torch.as_tensor(c["ig"]),
        alpha=torch.zeros(()))


def _crop_objective(c):
    """The crop placed as the back-end places it: (y0, x0) = (32, 64), the
    blur's halo h = 4 inside every edge that is not the panorama's."""
    win = _port_window(c)
    h = 4
    ints = [32, 64, h, CROP[0] - h, h, CROP[1] - h]
    win, x0f, y0f, a_crop, mask, s1, s2 = warp_pano.crop_window_constants(
        win, PANO, 4, SIGMA, MEASURE, CROP, ints)
    with torch.no_grad():
        box = warp_pano.warp_bbox(torch.zeros(K, 3), win, PANO, 4)
    # The crop invariant: every warped event lies 2h + 2 px inside the interior.
    assert box[0] >= 64 + 3 * h + 2 and box[1] <= 64 + CROP[1] - 3 * h - 2, box
    assert box[2] >= 32 + 3 * h + 2 and box[3] <= 32 + CROP[0] - 3 * h - 2, box
    _, vg = warp_pano.make_crop_objective(win, PANO, 4, SIGMA, MEASURE, CROP, x0f, y0f, a_crop,
                                          mask, s1, s2)
    return win, vg


def _pano_objective(c):
    win = _port_window(c)
    with torch.no_grad():
        il0, _ = warp_pano.pano_objective_image(torch.zeros(K, 3), win, PANO, 4, SIGMA)
        win = win._replace(alpha=warp_pano.compute_alpha(il0, win.ig_prime))
    _, vg = warp_pano.make_pano_objective(win, PANO, 4, SIGMA, MEASURE)
    return win, vg


def _errors(value, grad, ref_value, ref_grad):
    """(value's error relative to the reference's, gradient's largest error
    relative to the reference gradient's largest component)."""
    return (abs(value - ref_value) / abs(ref_value),
            float(np.abs(grad - ref_grad).max() / np.abs(ref_grad).max()))


# (a) -----------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 4])
def test_spline_evaluate_and_basis_match_the_reference(order):
    """The port's blending matrix is the reference's M (exact up to the
    division by 6); evaluate in float64 agrees to 1e-12 (rounding of a few
    dozen float64 operations; read 2.2e-16) and in float32 to 2e-6 (float32
    ulps over the chain of log/exp products; read 1.2e-7-2.4e-7 over six
    seeds); segment_basis gives the same segments and its float32
    coefficients agree to 2e-6 (t rounded to float32, an ulp of 3e-8 at
    0.2 s, moves u = t / 0.05 by up to 6e-7; read 5.3e-7). bfloat16 (8 bits
    of mantissa) read 5.8e-3-1.1e-2: thousands of times 2e-6."""
    rng = np.random.default_rng(order)
    np.testing.assert_allclose(spline.blending_matrix(order, cumulative=True),
                               ref.BASIS[order].T, rtol=0, atol=1e-15)
    knots = _quats(np.cumsum(0.2 * rng.standard_normal((K, 3)), axis=0))
    t = np.sort(rng.uniform(0.0, DT * (K - order + 1), 500))
    want = ref.evaluate(torch.as_tensor(knots), t, 0.0, DT, order).numpy()
    got64 = spline.evaluate(torch.as_tensor(knots), torch.as_tensor(t), 0.0, DT, order).numpy()
    got32 = spline.evaluate(torch.as_tensor(knots, dtype=torch.float32),
                            torch.as_tensor(t, dtype=torch.float32), 0.0, DT, order).numpy()
    low = ref.evaluate(torch.as_tensor(knots).to(torch.bfloat16), t, 0.0, DT, order)

    def err(q):  # sign-free quaternion distance
        q = np.asarray(q, np.float64)
        return float(np.minimum(np.abs(q - want), np.abs(q + want)).max())

    assert err(got64) < 1e-12
    assert err(got32) < 2e-6
    assert err(low.double().numpy()) > 2e-6
    s, coeff = spline.segment_basis(torch.as_tensor(t, dtype=torch.float32), 0.0, DT, K, order)
    s_ref, coeff_ref = ref.segment(t, 0.0, DT, K, order)
    inner = np.abs(t / DT - np.round(t / DT)) > 1e-5  # not on a knot, where float32 may round
    assert np.array_equal(s.numpy()[inner], s_ref.numpy()[inner])
    np.testing.assert_allclose(coeff.numpy()[inner], coeff_ref.numpy()[inner], rtol=0, atol=2e-6)


# (b), (c) --------------------------------------------------------------------

# Value: the float32 image sums 4 000 events' votes and 32 768 pixels' squares;
# its variance agrees with float64's to 3e-8-1.9e-7 (six seeds), so 1e-6.
# Gradient: each component sums 4 000 events' terms of mixed sign in float32,
# each on its float32 pixel coordinate: within 3.5e-7-1.6e-6 of the largest
# component (six seeds), so 1e-4. bfloat16 read 8.8e-5-6.8e-3 and 0.73-1.25 on
# the same seeds: more than ten times each tolerance.
VALUE_RTOL, GRAD_RTOL = 1e-6, 1e-4


@pytest.mark.parametrize("objective", ["crop", "pano"])
def test_order4_objective_matches_the_reference(objective):
    c = _case()
    _, vg = (_crop_objective if objective == "crop" else _pano_objective)(c)
    v, g = vg(torch.as_tensor(c["x"].reshape(-1), dtype=torch.float32))
    r = _reference(c)
    rv, rg = r.value_grad(c["x"])
    ev, eg = _errors(float(v), g.double().numpy().reshape(K, 3), rv, rg)
    assert ev < VALUE_RTOL and eg < GRAD_RTOL, (ev, eg)
    assert np.all(rg[0] == 0) and np.all(g.reshape(K, 3)[0].numpy() == 0)  # the frozen knot
    lv, lg = _reference(c, torch.bfloat16).value_grad(c["x"])
    lev, leg = _errors(lv, lg, rv, rg)
    assert lev > 10 * VALUE_RTOL and leg > 10 * GRAD_RTOL, (lev, leg)


def test_the_reference_alpha_matches_the_port():
    """alpha = density(IL at zero) / density(IG'): the crop's constant and
    the whole panorama's are the reference's to float32 rounding."""
    c = _case()
    r = _reference(c)
    for win, _ in (_crop_objective(c), _pano_objective(c)):
        assert abs(float(win.alpha) - float(r.alpha)) <= 1e-5 * float(r.alpha)


# (d) -------------------------------------------------------------------------

def _inputs(c) -> WindowInputs:
    """The window's raw inputs, its bearings given as a LUT of their own
    (every event a row)."""
    return WindowInputs(
        idx=np.arange(N, dtype=np.int32), valid=np.ones(N, bool), is_old=c["ts"] < 0.1,
        batch_rel=ref.batch_mid_times(c["ts"], BATCH).astype(np.float32), knots=c["knots"],
        free=c["free"].astype(np.float32), fov_rel=np.array([0.0, 0.05], np.float32))


def _solver(restarts: int, c):
    """The window program on the whole panorama, launched once: it computes
    the window's alpha itself, which must be the objective's of (c)."""
    cfg = config.replace(config.SystemConfig(), **{"backend.trajectory.spline_degree": 3,
                                                   "backend.trajectory.dt_knots": DT}).backend
    win, _ = _pano_objective(c)
    lut = torch.as_tensor(c["bearings"])
    solver = _WindowSolver(cfg, PANO, 4, restarts, 0.0, lut, _inputs(c), None)
    ig = torch.as_tensor(c["ig"])
    result = solver.solve(_inputs(c), ig, torch.zeros(ig.shape, dtype=torch.int32))
    assert torch.equal(solver.win.alpha, win.alpha)
    return solver, result.fetch()


def test_the_restart_costs_no_more_and_its_iterations_are_packed_apart():
    c = _case()
    _, once = _solver(0, c)
    _, twice = _solver(1, c)
    s0, s1 = once[4 * K:], twice[4 * K:]  # [f0, fun, iters, alpha, bbox(4), first iters]
    assert s0[0] == s1[0]  # the same start
    assert s1[1] <= s0[1]  # the restart's cost is no higher
    assert s0[2] == s0[8] > 0  # no restart: every line search is the first solve's
    assert s1[8] == s0[2] and s1[2] >= s1[8]  # the same first solve, then the restart's


class _Names:
    """Records a program's loop nodes as device_loop's capture names them
    ("outer/inner"), running no step."""

    def __init__(self):
        self.paths, self._stack = [], []

    def seg(self, fn):
        pass

    def _node(self, name, body):
        path = "/".join(self._stack + [name])
        self.paths.append(path)
        self._stack.append(name)
        try:
            body()
        finally:
            self._stack.pop()

    def when(self, gate, body, name=None):
        self._node(name or "if", body)

    def repeat(self, gate, body, trips=None, name=None):
        self._node(name or "while", body)


@pytest.mark.parametrize("restarts, want", [
    (0, ["cg", "cg/bracket", "cg/secant"]),
    (1, ["cg", "cg/bracket", "cg/secant", "restart/cg", "restart/cg/bracket",
         "restart/cg/secant"]),
])
def test_restart_loop_nodes_are_named_apart(restarts, want):
    """The restarted solve's loop nodes carry their own names, so the trace
    (utils.metrics.loop_split) splits its device time from the first
    solve's."""
    c = _case()
    cfg = config.replace(config.SystemConfig(), **{"backend.trajectory.spline_degree": 3}).backend
    solver = _WindowSolver(cfg, PANO, 4, restarts, 0.0, torch.as_tensor(c["bearings"]),
                           _inputs(c), None)
    names = _Names()
    solver.program.build_fn(names)
    assert names.paths == want
