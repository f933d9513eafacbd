"""The port's event-sharded window objective (cmax_slam_tpu_torch/parallel/
window_shard.py) on an 8-entry CPU device list, against the JAX package's
single-device objective (warp_pano.make_pano_objective) on the same window:
the cases of tests/test_window_shard.py.

Tolerances (those of tests/test_window_shard.py): value rtol 2e-5, gradient
rtol 2e-3 and atol 2e-6. The sum of eight partial vote images and the
packages' different float32 summation orders stay well inside them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.calib import EquirectCamera as JEquirectCamera
from cmax_slam_tpu.ops import warp_pano as jwarp_pano
from cmax_slam_tpu_torch.calib import EquirectCamera
from cmax_slam_tpu_torch.config import OptimOptions
from cmax_slam_tpu_torch.ops import optim
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
    padding batches; the objective is unchanged."""
    win, pano = _make_window(n_events=11_700, B=117)  # 117 % 8 != 0
    (f_ref, _), (f_sh, _), shards = _both(win, pano)
    assert {s.batch_times.shape[0] for s in shards} == {15}  # 120 batches / 8
    assert [s.weights.device for s in shards] == DEVICES
    pad = shards[-1].weights == 0
    assert pad.sum() == 3 * 100 and torch.all(shards[-1].bearings[:, pad] == 1.0)
    x = np.zeros(3 * win.knots.shape[0], np.float32)
    np.testing.assert_allclose(float(f_sh(torch.tensor(x))), float(f_ref(jnp.asarray(x))),
                               rtol=2e-5)


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
