"""The port's plain vote (cmax_slam_tpu_torch/ops/scatter.py) against the JAX
package's XLA vote (ops/scatter.py) and its Pallas kernel
(ops/pallas_iwe.py, interpret mode on the CPU, as tests/test_pallas_iwe.py
runs it): forward, all three gradients, dropped events (out of bounds,
weight 0, NaN), integer coordinates, a batch of 9 and the two-image split.

Tolerances: the images are sums of float32 votes taken in another order
(matmul contractions in JAX, index_add here), so they agree to float32
rounding of the sums, atol 1e-4 on values of order 1; gradients are gathers
of the upstream image, atol 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.ops import scatter as jscatter
from cmax_slam_tpu.ops.pallas_iwe import LANE, ROWS, bilinear_accumulate_pallas
from cmax_slam_tpu_torch.ops import cuda_iwe, scatter

torch.set_num_threads(1)

ATOL = 1e-4


def _events(rng, n, H, W, lo=-3.0):
    """Coordinates spanning the borders, some on integers, some NaN/inf,
    and weights with zeros."""
    px = rng.uniform(lo, W + 3, n).astype(np.float32)
    py = rng.uniform(lo, H + 3, n).astype(np.float32)
    k = n // 5
    px[:k] = np.round(px[:k])  # integer coordinates: the omega = 0 cold start
    py[:k] = np.round(py[:k])
    px[k:k + 3] = [np.nan, np.inf, -np.inf]
    w = (rng.uniform(size=n) > 0.1).astype(np.float32) * rng.uniform(0.5, 1.5, n).astype(np.float32)
    return px, py, w


def _torch_vote_and_grads(px, py, w, key, H, W):
    tpx, tpy, tw = (torch.tensor(a, requires_grad=True) for a in (px, py, w))
    img = scatter.vote(tpx, tpy, tw, H, W)
    torch.sum(torch.as_tensor(key) * img).backward()
    return img.detach().numpy(), [t.grad.numpy() for t in (tpx, tpy, tw)]


def _jax_vote_and_grads(fn, px, py, w, key):
    key = jnp.asarray(key)
    args = tuple(jnp.asarray(a, jnp.float32) for a in (px, py, w))
    img = fn(*args)
    grads = jax.grad(lambda a, b, c: jnp.vdot(key, fn(a, b, c)), argnums=(0, 1, 2))(*args)
    return np.asarray(img), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_plain_vote_matches_jax(rng, ref):
    H, W = 48, 64
    n = ROWS * LANE + 137 if ref == "pallas" else 3000
    px, py, w = _events(rng, n, H, W)
    key = rng.normal(size=(H, W)).astype(np.float32)
    if ref == "xla":
        fn = lambda a, b, c: jscatter.bilinear_accumulate(a, b, c, height=H, width=W)  # noqa: E731
    else:
        fn = lambda a, b, c: bilinear_accumulate_pallas(a, b, c, H, W, "highest")  # noqa: E731
    img_j, g_j = _jax_vote_and_grads(fn, px, py, w, key)
    launches = dict(cuda_iwe.LAUNCHES)
    img_t, g_t = _torch_vote_and_grads(px, py, w, key, H, W)
    assert cuda_iwe.LAUNCHES == launches  # a CPU tensor never reaches the kernels
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)
    for name, a, b in zip(("dpx", "dpy", "dw"), g_t, g_j):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("orient", ["rows", "mixed"])
def test_vote_backward_matches_pallas_row_orientations(rng, orient):
    """The third Pallas kernel (pallas_iwe._bwd_kernel, orient "rows" and
    "mixed") computes the same VJP as the "lanes" kernel that K2 replaces,
    with the same in-bounds rule and one-sided derivative; only the layout
    of its hat contraction differs. So the port's vote backward (K2's plain
    version on the CPU) serves it: held here against both orientations on
    integer, out-of-bounds, non-finite and weight-0 events."""
    H, W = 40, 56
    n = 900
    px, py, w = _events(rng, n, H, W)
    key = rng.normal(size=(H, W)).astype(np.float32)

    def fn(a, b, c):
        return bilinear_accumulate_pallas(a, b, c, H, W, "highest", 512, 8, orient)

    img_j, g_j = _jax_vote_and_grads(fn, px, py, w, key)
    img_t, g_t = _torch_vote_and_grads(px, py, w, key, H, W)
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)
    for name, a, b in zip(("dpx", "dpy", "dw"), g_t, g_j):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    dropped = ~np.isfinite(px) | (w == 0)
    assert dropped.sum() >= 3
    for a in g_t:
        np.testing.assert_array_equal(a[dropped & (w == 0)], 0)


def test_dropped_events_vote_nothing_and_get_zero_gradients(rng):
    H, W = 20, 30
    # floor(px) = 0 and W-2, floor(py) = H-2, weight 0, NaN: all dropped.
    px = np.array([0.5, W - 2.0, 5.5, 5.5, np.nan, 3.25], np.float32)
    py = np.array([5.5, 5.5, H - 1.5, 5.5, 5.5, 4.75], np.float32)
    w = np.array([1, 1, 1, 0, 1, 2], np.float32)
    key = rng.normal(size=(H, W)).astype(np.float32)
    img, (dpx, dpy, dw) = _torch_vote_and_grads(px, py, w, key, H, W)
    assert np.isclose(img.sum(), 2.0)  # only the last event votes, mass w
    np.testing.assert_array_equal(dpx[:5], 0)
    np.testing.assert_array_equal(dpy[:5], 0)
    np.testing.assert_array_equal(dw[:5], 0)
    # the live event's taps, (dx, dy) = (0.25, 0.75) at cell (3, 4)
    np.testing.assert_allclose(img[4:6, 3:5], 2 * np.array([[0.75 * 0.25, 0.25 * 0.25],
                                                            [0.75 * 0.75, 0.25 * 0.75]]))


def test_integer_coordinates_take_the_one_sided_derivative(rng):
    """At integer coordinates d(vote)/dpx is g[cy, cx+1] - g[cy, cx]: the
    floor form, not the zero subgradient of |u| (scatter.py:39-58)."""
    H, W = 16, 16
    px = np.array([5.0], np.float32)
    py = np.array([7.0], np.float32)
    w = np.array([2.0], np.float32)
    key = rng.normal(size=(H, W)).astype(np.float32)
    _, (dpx, dpy, dw) = _torch_vote_and_grads(px, py, w, key, H, W)
    np.testing.assert_allclose(dpx, 2.0 * (key[7, 6] - key[7, 5]), rtol=1e-6)
    np.testing.assert_allclose(dpy, 2.0 * (key[8, 5] - key[7, 5]), rtol=1e-6)
    np.testing.assert_allclose(dw, key[7, 5], rtol=1e-6)


def test_batched_vote_of_nine_matches_jax_vmap(rng):
    """(9, N) coordinates with shared (N,) weights: one call, nine images."""
    H, W = 36, 48
    n = 1500
    px = np.stack([_events(rng, n, H, W)[0] for _ in range(9)])
    py = np.stack([_events(rng, n, H, W)[1] for _ in range(9)])
    w = _events(rng, n, H, W)[2]
    key = rng.normal(size=(9, H, W)).astype(np.float32)
    img_t, g_t = _torch_vote_and_grads(px, py, w, key, H, W)
    assert img_t.shape == (9, H, W) and g_t[2].shape == (n,)

    def fn(a, b, c):
        return jax.vmap(lambda x, y: jscatter.bilinear_accumulate(x, y, c, height=H, width=W))(a, b)

    img_j, g_j = _jax_vote_and_grads(fn, px, py, w, key)
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """The kernel wrappers take CUDA tensors only, and vote() has no path for
    a device other than the CPU and CUDA: neither falls back to the plain
    version, and neither builds anything on the way to raising."""
    launches = dict(cuda_iwe.LAUNCHES)
    px = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iwe.vote_fwd(px, px, px, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iwe.vote_bwd(px, px, px, torch.zeros(1, 8, 8))
    meta = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        scatter.vote(meta, meta, meta, 8, 8)
    assert not cuda_iwe._loaded and cuda_iwe.LAUNCHES == launches


def test_two_image_split_matches_jax(rng):
    H, W = 40, 56
    n = 2500
    px, py, w = _events(rng, n, H, W)
    sel = rng.uniform(size=n) > 0.4
    j0, j1 = jscatter.bilinear_accumulate_two(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(w), jnp.asarray(sel), height=H, width=W)
    t0, t1 = scatter.bilinear_accumulate_two(
        torch.tensor(px), torch.tensor(py), torch.tensor(w), torch.tensor(sel), H, W)
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), atol=ATOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=ATOL)
    np.testing.assert_allclose((t0 + t1).numpy(),
                               scatter.vote(torch.tensor(px), torch.tensor(py),
                                            torch.tensor(w), H, W).numpy(), atol=1e-5)
