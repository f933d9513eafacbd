"""The port's event-sharded window objective (cmax_slam_tpu_torch/parallel/
window_shard.py) on an 8-entry CPU device list, against the JAX package's
single-device objective (warp_pano.make_pano_objective) on the same window:
the cases of tests/test_window_shard.py.

Tolerances (those of tests/test_window_shard.py): value rtol 2e-5, gradient
rtol 2e-3 and atol 2e-6. The sum of eight partial vote images and the
packages' different float32 summation orders stay well inside them. Against
the port's own single-device objective, which runs the same spline, warp and
vote (warp_pano.pano_vote) on the whole window, only the eight partial
images' sum order differs: value rtol 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.calib import EquirectCamera as JEquirectCamera
from cmax_slam_tpu.ops import warp_pano as jwarp_pano
from cmax_slam_tpu_torch.calib import EquirectCamera
from cmax_slam_tpu_torch.config import OptimOptions
from cmax_slam_tpu_torch import spline
from cmax_slam_tpu_torch.ops import optim, scatter, warp_pano
from cmax_slam_tpu_torch.parallel.sharding import make_mesh
from cmax_slam_tpu_torch.parallel.window_shard import (
    make_sharded_pano_objective, shard_window_events)

from test_torch_objectives import _to_torch
from test_window_shard import _make_window

torch.set_num_threads(1)

DEVICES = make_mesh(8, "cpu")


def _both(win_j, pano_j):
    """JAX's single-device (f, vg) and the port's sharded (f, vg)."""
    pano = EquirectCamera(width=pano_j.width, height=pano_j.height)
    shards = shard_window_events(_to_torch(win_j), DEVICES)
    return (jwarp_pano.make_pano_objective(win_j, pano_j, 2, 1.0, 0),
            make_sharded_pano_objective(DEVICES, shards, pano, 2, 1.0, 0), shards)


def test_sharded_objective_matches_jax_single_device():
    win, pano = _make_window()
    (_, vg_ref), (f_sh, vg_sh), _ = _both(win, pano)
    K = win.knots.shape[0]
    x = 0.01 * np.random.default_rng(0).normal(size=3 * K).astype(np.float32)
    v_ref, g_ref = vg_ref(jnp.asarray(x))
    v_sh, g_sh = vg_sh(torch.tensor(x))
    np.testing.assert_allclose(float(v_sh), float(v_ref), rtol=2e-5)
    np.testing.assert_allclose(g_sh.numpy(), np.asarray(g_ref), rtol=2e-3, atol=2e-6)
    # a (M, 3K) batch of candidates is one evaluation per shard
    xs = torch.tensor(np.stack([x, 0 * x, 2 * x]))
    np.testing.assert_allclose(f_sh(xs).numpy(), [float(f_sh(r)) for r in xs], rtol=1e-6)


def test_sharded_objective_padding_is_neutral():
    """A batch axis that does NOT divide the device count gets weight-0
    padding batches; the objective is unchanged. A padding batch's time 0
    lies in a segment the kernels may index ([0, K - order]), and its
    events add exactly 0 to the image and the gradient."""
    win, pano = _make_window(n_events=11_700, B=117)  # 117 % 8 != 0
    (f_ref, _), (f_sh, _), shards = _both(win, pano)
    assert {s.batch_times.shape[0] for s in shards} == {15}  # 120 batches / 8
    assert [s.weights.device for s in shards] == DEVICES
    pad = shards[-1].weights == 0
    assert pad.sum() == 3 * 100 and torch.all(shards[-1].bearings[:, pad] == 1.0)
    x = np.zeros(3 * win.knots.shape[0], np.float32)
    np.testing.assert_allclose(float(f_sh(torch.tensor(x))), float(f_ref(jnp.asarray(x))),
                               rtol=2e-5)
    last, K, order = shards[-1], win.knots.shape[0], 2
    seg, coeff = spline.segment_basis(last.batch_times, last.t0, last.dt_knots, K, order)
    assert torch.all(last.batch_times[-3:] == 0)
    assert seg.min() >= 0 and seg.max() <= K - order and torch.isfinite(coeff).all()
    only_pad = last._replace(weights=last.weights * pad)  # the padding events alone
    d = torch.full((K, 3), 0.01, requires_grad=True)
    hw = (pano.height, pano.width)
    image = warp_pano.pano_vote(d, only_pad, EquirectCamera(width=hw[1], height=hw[0]),
                                order, hw, None, (seg, coeff))
    (g,) = torch.autograd.grad((image * torch.rand(hw)).sum(), d)
    assert torch.all(image == 0) and torch.all(g == 0)


def test_sharded_objective_votes_each_shard_through_pano_vote(monkeypatch):
    """Every evaluation votes each shard once through warp_pano.pano_vote
    (K4/K5 on the card) with the shard's spline basis, computed when the
    objective is made, and never through scatter.vote (the composed route);
    the value equals the port's own single-device objective (rtol 1e-6), for
    one candidate and a (M, 3K) batch, with padding batches."""
    win_j, pano_j = _make_window(n_events=11_700, B=117)
    win = _to_torch(win_j)
    pano = EquirectCamera(width=pano_j.width, height=pano_j.height)
    shards = shard_window_events(win, DEVICES)
    bases, votes = [], []
    segment_basis, pano_vote = spline.segment_basis, warp_pano.pano_vote

    def count_basis(*a, **kw):
        bases.append(a[0].shape)
        return segment_basis(*a, **kw)

    def count_vote(drotv, w, pano_, order, hw, origin, basis):
        assert basis is not None and origin is None
        votes.append((drotv.shape[:-2], w.weights.shape[0]))
        return pano_vote(drotv, w, pano_, order, hw, origin, basis)

    def composed(*a, **kw):
        raise AssertionError("the sharded objective took the composed route")

    monkeypatch.setattr(spline, "segment_basis", count_basis)
    monkeypatch.setattr(warp_pano, "pano_vote", count_vote)
    monkeypatch.setattr(scatter, "vote", composed)
    monkeypatch.setattr(warp_pano, "vote", composed)
    f_sh, vg_sh = make_sharded_pano_objective(DEVICES, shards, pano, 2, 1.0, 0)
    assert bases == [(15,)] * 8
    K = win.knots.shape[0]
    x = torch.tensor(0.01 * np.random.default_rng(3).normal(size=3 * K).astype(np.float32))
    xs = torch.stack([x, 0 * x, 2 * x])
    v_sh, g_sh = vg_sh(x)
    m_sh = f_sh(xs)
    assert bases == [(15,)] * 8
    assert votes == [((), 1500)] * 8 + [((3,), 1500)] * 8  # value_and_grad, then f
    assert not any(a.device.type != "cpu" for a in (v_sh, g_sh, m_sh))
    monkeypatch.undo()
    f_ref, vg_ref = warp_pano.make_pano_objective(win, pano, 2, 1.0, 0)
    v_ref, g_ref = vg_ref(x)
    np.testing.assert_allclose(float(v_sh), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(m_sh.numpy(), f_ref(xs).numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_sh.numpy(), g_ref.numpy(), rtol=2e-3, atol=2e-6)


def test_sharded_objective_padding_big_pano():
    """The 2048x4096 panorama (the blur's shift-and-add path) with padding
    batches: the objective is finite (no NaN from the padding rays) and
    equals JAX's single-device value."""
    win, _ = _make_window(n_events=13_000, B=130)  # 130 % 8 = 2 -> pad 6
    pano_j = JEquirectCamera(width=4096, height=2048)
    win = win._replace(ig_prime=jnp.zeros((2048, 4096), jnp.float32))
    (f_ref, _), (f_sh, _), _ = _both(win, pano_j)
    x = np.zeros(3 * win.knots.shape[0], np.float32)
    a, b = float(f_sh(torch.tensor(x))), float(f_ref(jnp.asarray(x)))
    assert np.isfinite(a), "sharded objective is NaN"
    np.testing.assert_allclose(a, b, rtol=2e-5)


def test_sharded_window_solve_converges():
    """FR-CG through the sharded objective raises the contrast (the full
    multi-device BA path: warps and votes on the shards, one sum per
    evaluation, the gradient back through every shard)."""
    win, pano = _make_window()
    _, (f, vg), _ = _both(win, pano)
    o = OptimOptions(grad_tol=1e-4, line_search_tol=0.1)
    res = optim.minimize_fr_cg(
        vg, torch.zeros(3 * win.knots.shape[0]), f_fn=f,
        max_line_searches=o.max_line_searches, initial_step=o.initial_step,
        line_search_tol=o.line_search_tol, grad_tol=o.grad_tol, fun_tol=o.fun_tol)
    assert res.fun < res.f0 - 1e-4, f"no contrast improvement: {res.f0} -> {res.fun}"
    assert res.iters > 0


def test_shards_must_match_the_device_list():
    win, pano_j = _make_window()
    shards = shard_window_events(_to_torch(win), DEVICES)
    pano = EquirectCamera(width=pano_j.width, height=pano_j.height)
    with pytest.raises(ValueError, match="shard_window_events"):
        make_sharded_pano_objective(DEVICES[:4], shards, pano, 2, 1.0, 0)
    with pytest.raises(ValueError, match="non-empty list"):
        shard_window_events(_to_torch(win), "cpu")
