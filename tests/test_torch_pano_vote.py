"""The back-end objective's event chain as K4/K5 compute it
(ops/cuda_pano_vote.py, csrc/pano_vote.cu), on the CPU: the route's plain
version against the JAX package's make_crop_objective and
make_pano_objective, the hoisted spline basis, the decomposition of the
gradient that K5 evaluates, and the wrapper's operand preparation through
stand-ins of the kernels (K4 and K5 run only on the card: chip_smoke.py
holds them to the plain version there).

Inputs: tests/test_pano.py's seeded window with 100 events per batch, as
every preset has (the linear spline with 5 knots, the cubic with 7), on a
128x256 panorama, crops planned by tests/test_crop_solver.py's planner
(64-128 px), a smooth map term; the same numpy arrays for both packages.

Tolerances. Against JAX: values rtol 1e-4 and gradients rtol 2e-3
(tests/test_torch_objectives.py's: float32 votes, blurs and sums in other
orders), atol 1e-6 and at least 1e-5 of the gradient's largest component:
a component that cancels to ~1e-3 of the largest keeps the float32
rounding of its terms (measured 6.4e-5 of 9.5 on the cubic window with the
gradient-magnitude measure). The decomposition against autograd: both are
float32 sums of the same per-event products over ~4000 events in another
order, rtol 1e-5 with atol 1e-5 of the gradient's scale, for the same
reason (measured 2.6e-6 of it); frozen knots exactly 0 in both. The
stand-ins run the plain version's ops on the prepared operands: equal to
the plain version exactly.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.config import (
    IMAGE_GRADIENT_MAGNITUDE_CONTRAST, MEAN_SQUARE_CONTRAST, VARIANCE_CONTRAST)
from cmax_slam_tpu.ops import warp_pano as jwarp_pano
from cmax_slam_tpu_torch import calib, spline
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote, warp_pano

from test_crop_solver import _plan_for_test, _smooth_map
from test_pano import _make_window
from test_torch_objectives import _to_torch

torch.set_num_threads(1)

MEASURES = [VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST, IMAGE_GRADIENT_MAGNITUDE_CONTRAST]
HP, WP = 128, 256
ORDER_K = {2: 5, 4: 7}  # spline order -> window knots
STEPS = np.array([0.0, 0.005, 0.02], np.float32)  # candidate scales (M = 3)


def _windows(rng, order, n_events=4000):
    win_j, pano_j, _, _ = _make_window(rng, n_events=n_events, K=ORDER_K[order], Hp=HP, Wp=WP,
                                       batch=100)
    win_j = win_j._replace(ig_prime=jnp.asarray(_smooth_map(rng, HP, WP)))
    return win_j, pano_j, _to_torch(win_j), calib.EquirectCamera(width=WP, height=HP)


def _candidates(rng, K):
    return (rng.normal(size=(len(STEPS), 3 * K)) * STEPS[:, None]).astype(np.float32)


def _assert_matches_jax(vgj, ft, vgt, stack, msg):
    vgj = jax.jit(jax.vmap(vgj))
    v_j, g_j = vgj(jnp.asarray(stack))
    g_j = np.asarray(g_j)
    atol = max(1e-6, 1e-5 * float(np.abs(g_j).max()))
    for d, vj, gj in zip(stack, np.asarray(v_j), g_j):  # M = 1
        v_t, g_t = vgt(torch.tensor(d))
        np.testing.assert_allclose(float(v_t), vj, rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(g_t.numpy(), gj, rtol=2e-3, atol=atol, err_msg=msg)
    v_t, g_t = vgt(torch.tensor(stack))  # M = 3: one batched evaluation
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-4, err_msg=msg)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=2e-3, atol=atol, err_msg=msg)
    np.testing.assert_allclose(ft(torch.tensor(stack)).numpy(), np.asarray(v_j), rtol=1e-4,
                               err_msg=msg)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("order", [2, 4])
def test_crop_objective_route_matches_jax(order, measure):
    rng = np.random.default_rng(10 + order)
    sigma = 1.0
    win_j, pano_j, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    Hc, Wc, ints = _plan_for_test(win_j, pano_j, order, sigma, measure)
    assert (Hc, Wc) != (HP, WP) and max(Hc, Wc) <= 128
    cj = jwarp_pano.crop_window_constants(win_j, pano_j, order, sigma, measure, (Hc, Wc),
                                          jnp.asarray(ints))
    _, vgj = jwarp_pano.make_crop_objective(cj[0], pano_j, order, sigma, measure, (Hc, Wc),
                                            *cj[1:])
    ct = warp_pano.crop_window_constants(win, pano, order, sigma, measure, (Hc, Wc), ints)
    ft, vgt = warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                            *ct[1:])
    _assert_matches_jax(vgj, ft, vgt, _candidates(rng, K), f"order={order} measure={measure}")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("order", [2, 4])
def test_pano_objective_route_matches_jax(order, measure):
    rng = np.random.default_rng(20 + order)
    win_j, pano_j, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    win_j = win_j._replace(alpha=jnp.float32(0.3))
    _, vgj = jwarp_pano.make_pano_objective(win_j, pano_j, order, 1.0, measure)
    ft, vgt = warp_pano.make_pano_objective(win._replace(alpha=torch.tensor(0.3)), pano, order,
                                            1.0, measure)
    _assert_matches_jax(vgj, ft, vgt, _candidates(rng, K), f"order={order} measure={measure}")


@pytest.mark.parametrize("objective", ["crop", "pano"])
def test_routes_agree_on_the_cpu(monkeypatch, objective):
    """On the CPU the objectives' route (warp_pano.pano_vote) is the plain
    version: with the composed route (K1/K2 on the card) or the plain
    version in its place they give the same numbers, and no kernel is
    built or counted."""
    rng = np.random.default_rng(3)
    order, sigma, measure = 2, 1.0, VARIANCE_CONTRAST
    win_j, pano_j, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    if objective == "crop":
        Hc, Wc, ints = _plan_for_test(win_j, pano_j, order, sigma, measure)
        ct = warp_pano.crop_window_constants(win, pano, order, sigma, measure, (Hc, Wc), ints)

        _, vg = warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                              *ct[1:])
    else:
        _, vg = warp_pano.make_pano_objective(win, pano, order, sigma, measure)
    launches = dict(cuda_iwe.LAUNCHES)
    x = torch.tensor(_candidates(rng, K))
    got = vg(x)
    for images in (warp_pano.pano_vote_composed, warp_pano.pano_vote_plain):
        monkeypatch.setattr(warp_pano, "pano_vote", images)
        assert all(torch.equal(a, b) for a, b in zip(got, vg(x)))
    assert cuda_iwe.LAUNCHES == launches and not cuda_pano_vote._loaded


@pytest.mark.parametrize("order", [2, 4])
def test_hoisted_basis_is_the_one_evaluate_rotmats_computes(order):
    rng = np.random.default_rng(order)
    _, _, win, _ = _windows(rng, order)
    K = win.knots.shape[0]
    t = torch.cat([win.batch_times, torch.tensor([-0.5, 0.0, 10.0])])  # clamped segments too
    seg, coeff = spline.segment_basis(t, win.t0, win.dt_knots, K, order)
    s, u = spline._segment_and_u(t, win.t0, win.dt_knots, K, order)
    assert seg.dtype == torch.int32 and torch.equal(seg.long(), s)
    assert torch.equal(coeff, spline._coeffs(u, order, torch.float32))
    assert int(seg.min()) == 0 and int(seg.max()) == K - order
    knots = spline.apply_masked_increments(win.knots, torch.tensor(
        rng.normal(size=(3, K, 3)) * 0.01, dtype=torch.float32), win.free_mask)
    inside = spline.evaluate_rotmats(knots, t, win.t0, win.dt_knots, order)
    hoisted = spline.evaluate_rotmats(knots, t, win.t0, win.dt_knots, order, (seg, coeff))
    for row_a, row_b in zip(inside, hoisted):
        assert all(torch.equal(a, b) for a, b in zip(row_a, row_b))


@pytest.mark.parametrize("crop", [True, False])
def test_window_program_loads_the_basis_per_window(crop):
    """The window program computes each window's basis, at each launch,
    into its own buffers, which its objective reads (a captured graph reads
    them there): the window's raw inputs go in (its bearings as a LUT of
    its own, every event a row), the basis and the crop origin come out."""
    from cmax_slam_tpu_torch.backend import WindowInputs, _WindowSolver

    order = 2
    rng = np.random.default_rng(5)
    _, _, win, pano = _windows(rng, order)
    K, B = win.knots.shape[0], win.batch_times.shape[0]
    cfg = replace(ijrr_config(), **{"backend.trajectory.dt_knots": win.dt_knots,
                                    "backend.optim.max_line_searches": 1}).backend
    lut = win.bearings.T.contiguous()
    inputs = WindowInputs(
        idx=np.arange(lut.shape[0], dtype=np.int32), valid=win.weights.numpy() > 0,
        is_old=win.is_old.numpy(), batch_rel=win.batch_times.numpy(), knots=win.knots.numpy(),
        free=win.free_mask.numpy(), fov_rel=np.zeros(3, np.float32),
        crop=np.array([5, 7, 0, 64, 0, 96]) if crop else None)
    solver = _WindowSolver(cfg, pano, order, 0, 0.0, lut, inputs, (64, 96) if crop else None)
    for shift in (0.0, 0.07):  # two windows: the second's batches sit later
        w = win._replace(batch_times=win.batch_times + shift)
        with torch.no_grad():
            solver.solve(inputs._replace(batch_rel=w.batch_times.numpy()), torch.zeros(HP, WP),
                         torch.zeros(HP, WP, dtype=torch.int32)).fetch()
        seg, coeff = spline.segment_basis(w.batch_times, w.t0, w.dt_knots, K, order)
        assert solver.basis[0].shape == (B,) and torch.equal(solver.basis[0], seg)
        assert torch.equal(solver.basis[1], coeff)
        if crop:
            assert solver.origin.tolist() == [7.0, 5.0]


# ---------------------------------------------------------------------------
# The decomposition K5 evaluates
# ---------------------------------------------------------------------------

def _quats(q):
    return tuple(q[..., c] for c in range(4))


def _local_rotmats(delta_local, knots_local, free_local, coeff, order):
    """R_b (B, 3, 3) from each batch's ORDER knots (B, order, 4) perturbed by
    its own increments (B, order, 3): the spline code K4 and K5 run per
    batch, in plain torch (spline.py's component-wise helpers)."""
    e = spline._soa_exp((delta_local * free_local[..., None]).unbind(-1))
    kq = spline._soa_mul(e, _quats(knots_local))  # components (B, order)
    res = tuple(c[:, 0] for c in kq)
    for j in range(1, order):
        q0_inv = (kq[0][:, j - 1], -kq[1][:, j - 1], -kq[2][:, j - 1], -kq[3][:, j - 1])
        q1 = tuple(c[:, j] for c in kq)
        dx, dy, dz = spline._soa_log(spline._soa_mul(q0_inv, q1))
        c = coeff[:, j]
        res = spline._soa_mul(res, spline._soa_exp((c * dx, c * dy, c * dz)))
    w, x, y, z = res
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _image_from_rotmats(R, win, pano, hw, origin):
    """The vote of the events rotated by their batch's R (B, 3, 3)."""
    B = R.shape[0]
    b = win.bearings.reshape(3, B, -1)
    xyz = torch.einsum("bij,jbe->ibe", R, b).reshape(3, -1)
    x, y, z = xyz
    rho = torch.sqrt(x * x + y * y + z * z)
    px = pano.cx + torch.atan2(x, z) * pano.fx
    py = pano.cy + torch.asin(torch.clamp(y / rho, -1.0, 1.0)) * pano.fy
    if origin is not None:
        px, py = px - origin[0], py - origin[1]
    from cmax_slam_tpu_torch.ops.scatter import bilinear_accumulate
    return bilinear_accumulate(px, py, win.weights, *hw)


def _k5_decomposition(delta, win, pano, order, hw, origin, basis, g):
    """dL/ddelta for one candidate, L = <g, image>, as K5 evaluates it: per
    batch one forward-mode pass (torch.func.jvp) of the batch's spline along
    each direction d of its 3 x order knot parameters, whose primal is R_b
    and whose tangent is dR_b/ddelta_d; dL/dR_b by autograd of the vote
    through the projection from that primal; then <dL/dR_b, dR_b/ddelta_d>
    summed into the knots the batch touches. Returns (dL/ddelta, the
    primals of the 3 x order passes, R_b from the float pass)."""
    seg, coeff = basis
    K = win.knots.shape[0]
    idx = seg.long()[:, None] + torch.arange(order)  # (B, order)
    knots_local, free_local = win.knots[idx], win.free_mask[idx]
    delta_local = delta[idx]

    def rot(dl):
        return _local_rotmats(dl, knots_local, free_local, coeff, order)

    passes = []
    for j in range(order):
        for c in range(3):
            tangent = torch.zeros_like(delta_local)
            tangent[:, j, c] = 1.0
            passes.append((j, c, *torch.func.jvp(rot, (delta_local,), (tangent,))))
    R = passes[0][2].detach().requires_grad_(True)
    (gR,) = torch.autograd.grad(_image_from_rotmats(R, win, pano, hw, origin), R, g)
    out = torch.zeros((K, 3))
    for j, c, _, dR in passes:
        out[:, c].index_add_(0, idx[:, j], (gR * dR).sum((1, 2)))
    return out, [p[2] for p in passes], rot(delta_local)


def _seam_window(win):
    """The window turned about y so that its middle looks along phi = pi:
    its events straddle the atan2 seam of the panorama."""
    knots = win.knots.double().numpy()
    K = knots.shape[0]
    d = spline._np_quat_rotmat_batch(knots[K // 2][None])[0] @ np.array([0.0, 0.0, 1.0])
    q = spline._np_quat_exp(np.array([0.0, np.pi - np.arctan2(d[0], d[2]), 0.0]))
    return win._replace(knots=torch.tensor(np.stack([spline._np_quat_mul(q, k) for k in knots]),
                                           dtype=torch.float32))


def _padded(win, n_pad):
    """n_pad weight-0 events in whole batches at the tail, as the back-end
    pads a window (pixel 0's bearing, batch time 0 on the raw clock)."""
    B = win.batch_times.shape[0]
    ebs = win.weights.shape[0] // B
    return win._replace(
        bearings=torch.cat([win.bearings, win.bearings[:, :1].expand(3, n_pad)], 1),
        batch_times=torch.cat([win.batch_times, torch.full((n_pad // ebs,), -0.3)]),
        weights=torch.cat([win.weights, torch.zeros(n_pad)]),
        is_old=torch.cat([win.is_old, torch.zeros(n_pad, dtype=torch.bool)]))


@pytest.mark.parametrize("image", ["crop", "seam"])
@pytest.mark.parametrize("order", [2, 4])
def test_gradient_decomposition_matches_autograd(order, image):
    rng = np.random.default_rng(30 + order)
    _, _, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    free = torch.ones(K)
    free[0] = free[K // 2] = 0.0  # frozen knots, one inside the window
    win = _padded(win._replace(free_mask=free), 300)
    hw, origin = (HP, WP), None
    if image == "seam":
        win = _seam_window(win)
    with torch.no_grad():
        px, py = warp_pano.warp_to_pano(torch.zeros(K, 3), win, pano, order)
    live = win.weights > 0
    if image == "seam":  # events at both ends of the panorama
        assert float(px[live].min()) < 0.1 * WP and float(px[live].max()) > 0.9 * WP
    else:  # a crop whose border cuts through the events: the drop rule decides
        hw = (64, 96)
        origin = torch.tensor([float(px[live].min()) + 20.0, float(py[live].min()) - 5.0])
        inside = ((px - origin[0] >= 1) & (px - origin[0] < hw[1] - 2) & (py - origin[1] >= 1)
                  & (py - origin[1] < hw[0] - 2))[live]
        assert 0.1 < float(inside.float().mean()) < 0.9
    basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)
    delta = torch.tensor(rng.normal(size=(K, 3)) * 0.003, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=hw), dtype=torch.float32)
    d = delta.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        warp_pano.pano_vote_plain(d, win, pano, order, hw, origin, basis), d, g)
    got, primals, R_float = _k5_decomposition(delta, win, pano, order, hw, origin, basis, g)
    # every forward-mode pass's primal is the float pass's R, bit for bit
    assert len(primals) == 3 * order and all(torch.equal(p, R_float) for p in primals)
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * scale)
    assert not bool(want[free == 0].any()) and not bool(got[free == 0].any())
    # the rotations the decomposition runs through are the plain version's
    R = spline.evaluate_rotmats(spline.apply_masked_increments(win.knots, delta, win.free_mask),
                                win.batch_times, win.t0, win.dt_knots, order, basis)
    idx = basis[0].long()[:, None] + torch.arange(order)
    local = _local_rotmats(delta[idx], win.knots[idx], win.free_mask[idx], basis[1], order)
    assert torch.equal(torch.stack([torch.stack(r, -1) for r in R], -2), local)


# ---------------------------------------------------------------------------
# The wrapper's operands, through stand-ins of the kernels
# ---------------------------------------------------------------------------

def _storage(*ts):
    """Reads each tensor's storage, as the ctypes wrapper does."""
    for t in ts:
        if t is not None:
            t.data_ptr()


def _standin_window(ops):
    cx, cy, fx, fy = ops.geometry
    win = warp_pano.PanoWindow(bearings=ops.bearings, batch_times=torch.zeros(ops.seg.shape),
                               weights=ops.weights,
                               is_old=None, knots=ops.knots, free_mask=ops.free, t0=0.0,
                               dt_knots=1.0, ig_prime=None, alpha=None)
    return win, SimpleNamespace(cx=cx, cy=cy, fx=fx, fy=fy)


def _standin_fwd(calls):
    def fwd(ops, height, width):
        """K4's function on the prepared operands, in plain torch."""
        cuda_pano_vote.check_operands(ops, "cpu")
        _storage(*ops[:8])
        calls.append(("fwd", ops))
        win, pano = _standin_window(ops)
        return warp_pano.pano_vote_plain(ops.delta, win, pano, ops.order, (height, width),
                                         ops.origin, (ops.seg, ops.coeff))
    return fwd


def _standin_bwd(calls):
    def bwd(ops, g):
        """K5's function on the prepared operands, in plain torch."""
        cuda_pano_vote.check_operands(ops, "cpu")
        _storage(*ops[:8], g)
        assert g.is_contiguous() and g.shape[0] == ops.delta.shape[0]
        calls.append(("bwd", ops))
        win, pano = _standin_window(ops)
        with torch.enable_grad():  # autograd runs a backward with grad mode off
            d = ops.delta.detach().requires_grad_(True)
            img = warp_pano.pano_vote_plain(d, win, pano, ops.order, tuple(g.shape[1:]),
                                            ops.origin, (ops.seg, ops.coeff))
            return torch.autograd.grad(img, d, g)[0]
    return bwd


@pytest.mark.parametrize("lead", [(), (3,)])
def test_wrapper_prepares_the_kernels_operands(monkeypatch, lead):
    """PanoVote with K4/K5 stood in by plain torch that validates and reads
    its operands as the ctypes wrapper does: (K, 3) and (M, K, 3)
    increments (M broadcast over shared events), a non-contiguous bearing
    view, int64 segments, and a crop origin in a tensor rewritten between
    calls (read at each call, as a captured window program needs)."""
    calls = []
    monkeypatch.setattr(cuda_pano_vote, "pano_vote_fwd", _standin_fwd(calls))
    monkeypatch.setattr(cuda_pano_vote, "pano_vote_bwd", _standin_bwd(calls))
    rng = np.random.default_rng(7)
    order = 2
    _, _, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    win = win._replace(bearings=win.bearings.T.contiguous().T)  # (3, N), not contiguous
    assert not win.bearings.is_contiguous()
    seg, coeff = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)
    basis = (seg.long(), coeff)
    origin = torch.tensor([40.0, 20.0])
    hw = (64, 128)
    delta = torch.tensor(rng.normal(size=(*lead, K, 3)) * 0.01, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(*lead, *hw)), dtype=torch.float32)
    for x0 in (40.0, 64.0):
        origin[0] = x0  # rewritten in place, as the window program's buffer is
        d = delta.clone().requires_grad_(True)
        img = cuda_pano_vote.pano_vote_cuda(d, win, basis, pano, order, hw, origin)
        (got,) = torch.autograd.grad(img, d, g)
        d2 = delta.clone().requires_grad_(True)
        ref = warp_pano.pano_vote_plain(d2, win, pano, order, hw, origin, basis)
        (want,) = torch.autograd.grad(ref, d2, g)
        assert img.shape == (*lead, *hw) and torch.equal(img, ref)
        assert got.shape == delta.shape and torch.equal(got, want)
        assert float(img.sum()) > 0
    kinds = [k for k, _ in calls]
    assert kinds == ["fwd", "bwd"] * 2
    ops = calls[0][1]
    assert ops.delta.shape == (int(np.prod(lead)), K, 3) and ops.seg.dtype == torch.int32
    assert ops.geometry == tuple(float(np.float32(v)) for v in (pano.cx, pano.cy, pano.fx,
                                                                pano.fy))
    assert calls[2][1].origin.tolist() == [64.0, 20.0]


def test_operand_checks_raise_on_what_the_kernels_do_not_take():
    rng = np.random.default_rng(8)
    order = 2
    _, _, win, pano = _windows(rng, order)
    K = win.knots.shape[0]
    basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)
    ops = cuda_pano_vote.prepare(torch.zeros(K, 3), win, basis, pano, order, None)
    assert cuda_pano_vote.check_operands(ops, "cpu") == (1, K, win.batch_times.shape[0], 100)
    with pytest.raises(ValueError, match="cuda"):
        cuda_pano_vote.check_operands(ops)  # the kernels take CUDA tensors only
    bad = {
        "order": ops._replace(order=3),
        "seg": ops._replace(seg=ops.seg.long()),
        "coeff": ops._replace(coeff=ops.coeff[:, :1].contiguous()),
        "batches": ops._replace(seg=ops.seg[:7].contiguous(), coeff=ops.coeff[:7].contiguous()),
        "origin": ops._replace(origin=torch.zeros(3)),
        "knots": ops._replace(knots=torch.zeros(cuda_pano_vote.MAX_KNOTS + 1, 4),
                              free=torch.zeros(cuda_pano_vote.MAX_KNOTS + 1),
                              delta=torch.zeros(1, cuda_pano_vote.MAX_KNOTS + 1, 3)),
    }
    for what, b in bad.items():
        with pytest.raises(ValueError):
            cuda_pano_vote.check_operands(b, "cpu")


def _event_blocks(n, ebs, epb):
    """K4's and K5's blocks as the kernels derive them (event_span in
    csrc/pano_vote.cu): (first event, events, first batch, offset of the
    first event in its batch, batches)."""
    for e0 in range(0, n, epb):
        cnt = min(epb, n - e0)
        b0, off = divmod(e0, ebs)
        yield e0, cnt, b0, off, (off + cnt - 1) // ebs + 1


def _k5_batch_sums(vals, ebs, off, cnt, nb, chunks=8):
    """Per batch of one K5 block, the sum of its events' values (cnt,) as
    the kernel forms it: ``chunks`` runs of the batch's events in the
    block, each summed in order, then the runs as a fixed tree."""
    sums = []
    for lb in range(nb):
        lo, hi = max(0, lb * ebs - off), min(cnt, (lb + 1) * ebs - off)
        n = -(-(hi - lo) // chunks)
        p = [np.float32(0)] * chunks
        for c in range(chunks):
            for e in range(lo + c * n, min(hi, lo + (c + 1) * n)):
                p[c] = np.float32(p[c] + vals[e])
        sums.append(((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7])))
    return np.array(sums, np.float32)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("ebs, B", [(100, 1024), (100, 7680), (3, 5), (2000, 50)])
def test_blocks_take_whole_batches(ebs, B, order):
    """A block of either kernel takes consecutive events across batch
    boundaries, a thread each (K4 512 of them while one wave of such blocks
    holds every event, else 256): every event in exactly one block, each
    thread's batch the event's, a block's batches within the kernels'
    shared arrays (MAX_BATCHES). K5's per-batch sums of its events' dL/dR,
    formed in runs as the kernel forms them, hold every event of the batch
    that lies in the block once (a batch split between two blocks: its two
    parts). The window's spline segments
    (spline.segment_basis) read knots s .. s + order - 1 < K <= MAX_KNOTS."""
    n, sms = B * ebs, 132
    rng = np.random.default_rng(ebs)
    vals = rng.integers(-8, 8, n).astype(np.float32)  # exact sums in any order
    fwd = cuda_pano_vote.fwd_events(ebs, n, sms)
    wave = 2 * sms * cuda_pano_vote.FWD_EVENTS[0]  # events in one wave of 512-event blocks
    assert fwd == min(cuda_pano_vote.FWD_EVENTS[n > wave], cuda_pano_vote.events_cap(ebs))
    bwd = cuda_pano_vote.bwd_events(ebs)
    assert 1 <= bwd <= cuda_pano_vote.BWD_EVENTS_MAX
    for per_block in (fwd, bwd):
        seen = np.zeros(n, np.int64)
        batch_sums = np.zeros(B, np.float32)
        for e0, cnt, b0, off, nb in _event_blocks(n, ebs, per_block):
            assert 1 <= nb <= cuda_pano_vote.MAX_BATCHES and b0 + nb <= B
            t = np.arange(cnt)
            assert np.array_equal(b0 + (off + t) // ebs, (e0 + t) // ebs)
            seen[e0:e0 + cnt] += 1
            batch_sums[b0:b0 + nb] += _k5_batch_sums(vals[e0:e0 + cnt], ebs, off, cnt, nb)
        assert (seen == 1).all()
        np.testing.assert_array_equal(batch_sums, vals.reshape(B, ebs).sum(1))

    K = {2: 6, 4: 8}[order]
    t = torch.linspace(-0.1, 0.4, B)  # clamped at both ends
    seg, _ = spline.segment_basis(t, 0.0, 0.05, K, order)
    assert int(seg.min()) >= 0 and int(seg.max()) + order <= K <= cuda_pano_vote.MAX_KNOTS
