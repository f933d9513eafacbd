"""``warp_pano.pano_iwe`` and ``warp_pano.derivative_images`` of the port
against the JAX package's (cmax_slam_tpu/ops/warp_pano.py: pano_iwe and
jax.jacfwd of it), the plain tangent vote that K3 is held to, and the
forward-mode rule of the kernels' autograd wrapper (cuda_iwe.Vote.jvp).

Inputs: tests/test_pano.py's seeded window on a 64x128 panorama with the
window's knots (5 for the linear spline, 7 for the cubic), a map term and
alpha, the same numpy arrays for both packages.

Tolerances: pano_iwe's three images are float32 sums of the same votes in
another order (atol 1e-4, a few ulps of their largest pixels). The
derivative images sum per-event products over ~4000 events whose values
reach ~100-200: max |port - JAX| <= 1e-4 x max |JAX| (measured ~7e-7
relative). JAX's small map votes through its dense hat matrices, whose
forward-mode derivative equals the floor-parametrized one away from integer
coordinates, where no warped event of the window lies. The plain tangent
vote against torch.func.jvp of the plain vote: the same products in
another order, rtol 1e-5 of the largest tangent pixel. The jvp of pano_iwe
along one knot parameter and the matching derivative image: the same plain
ops on the CPU, equal to 1e-5 of the image's scale.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu.ops import warp_pano as jwarp_pano
from cmax_slam_tpu_torch import calib
from cmax_slam_tpu_torch.ops import cuda_iwe, scatter, warp_pano
from cmax_slam_tpu_torch.utils import image

from test_pano import _make_window
from test_torch_objectives import _to_torch

torch.set_num_threads(1)

HP, WP = 64, 128
CASES = [(2, 5), (4, 7)]  # (spline order, window knots): linear, cubic


def _windows(order_k, seed=4):
    _, K = order_k
    rng = np.random.default_rng(seed)
    win_j, pano_j, _, _ = _make_window(rng, n_events=4096, K=K, Hp=HP, Wp=WP)
    ig = rng.uniform(0, 2, (HP, WP)).astype(np.float32)
    win_j = win_j._replace(alpha=jnp.float32(0.3), ig_prime=jnp.asarray(ig))
    return win_j, pano_j, _to_torch(win_j), calib.EquirectCamera(width=WP, height=HP), rng


@pytest.mark.parametrize("order_k", CASES)
def test_pano_iwe_matches_jax(order_k):
    order, K = order_k
    win_j, pano_j, win, pano, rng = _windows(order_k)
    d = (rng.normal(size=(K, 3)) * 0.01).astype(np.float32)
    want = jwarp_pano.pano_iwe(jnp.asarray(d), win_j, pano_j, order, 1.0)
    got = warp_pano.pano_iwe(torch.tensor(d), win, pano, order, 1.0)
    for g, w in zip(got, want):
        assert g.shape == (HP, WP)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    assert float(got[0].sum()) > 0 and float(got[1].sum()) > 0  # both halves of the split vote


@pytest.mark.parametrize("order_k", CASES)
def test_derivative_images_match_jax(order_k):
    order, K = order_k
    win_j, pano_j, win, pano, _ = _windows(order_k)
    want = np.asarray(jwarp_pano.derivative_images(win_j, pano_j, order, 1.0))
    got = warp_pano.derivative_images(win, pano, order, 1.0).numpy()
    assert got.shape == want.shape == (K, 3, HP, WP)
    scale = np.abs(want).max()
    assert scale > 1.0
    assert np.abs(got - want).max() <= 1e-4 * scale


def _events(rng, n=3000, h=40, w=56):
    """Coordinates over the image and past its borders, some on integers,
    NaN and infinite ones, weight-0 padding at the tail."""
    px = rng.uniform(-3, w + 3, n).astype(np.float32)
    py = rng.uniform(-3, h + 3, n).astype(np.float32)
    px[:200] = np.round(px[:200])
    px[200:203] = [np.nan, np.inf, -np.inf]
    wt = rng.uniform(0.5, 1.5, n).astype(np.float32)
    wt[-300:] = 0.0
    return (torch.tensor(a) for a in (px, py, wt)), h, w


def test_plain_tangent_vote_is_the_jvp_of_the_plain_vote():
    rng = np.random.default_rng(0)
    (px, py, wt), h, w = _events(rng)
    T = 4
    tpx = torch.tensor(rng.normal(size=(T, len(px))).astype(np.float32))
    tpy = torch.tensor(rng.normal(size=(T, len(px))).astype(np.float32))
    tpx[:, 201] = np.nan  # a dropped event's tangent is never read
    got = scatter.bilinear_accumulate_jvp(px, py, wt, tpx, tpy, h, w)
    assert got.shape == (T, h, w) and bool(torch.isfinite(got).all())
    for t in range(T):
        _, want = torch.func.jvp(lambda x, y: scatter.bilinear_accumulate(x, y, wt, h, w),
                                 (px, py), (torch.nan_to_num(tpx[t]), tpy[t]))
        tol = 1e-5 * float(want.abs().max())
        assert float((got[t] - want).abs().max()) <= tol
    # dropped events alone give exactly nothing
    dead = ~(scatter.inbounds_mask(px, py, h, w) & (wt != 0))
    none = scatter.bilinear_accumulate_jvp(px[dead], py[dead], wt[dead], tpx[:, dead],
                                           tpy[:, dead], h, w)
    assert not bool(none.any())
    assert torch.equal(scatter.tangent_vote(px, py, wt, tpx, tpy, h, w), got)


def _storage(*ts):
    """Reads each tensor's storage, as a kernel's wrapper does: raises for
    a tensor wrapped by a torch.func transform."""
    for t in ts:
        t.data_ptr()


def _compact_vote(px, py, w, height, width, b):
    """K1's function on compact (R, N) operands, in plain torch."""
    _storage(px, py, w)

    def rows(t):
        return t.repeat_interleave(b // t.shape[0], dim=0)
    return scatter.bilinear_accumulate(rows(px), rows(py), rows(w), height, width)


def _compact_jvp(px, py, w, tpx, tpy, height, width, b):
    """K3's function on compact (R, N) operands, in plain torch."""
    _storage(px, py, w, tpx, tpy)

    def rows(t):
        return t.repeat_interleave(b // t.shape[0], dim=0)
    return torch.stack([scatter.bilinear_accumulate_jvp(x, y, ww, tx[None], ty[None], height,
                                                        width)[0]
                        for x, y, ww, tx, ty in zip(*(rows(t) for t in (px, py, w, tpx, tpy)))])


@pytest.mark.parametrize("tangents", ["coordinates", "weights", "both"])
def test_vote_jvp_rule_routes_each_tangent(monkeypatch, tangents):
    """cuda_iwe.Vote's forward-mode rule with the kernels' functions stood
    in by plain torch that reads its operands' storage as the kernels'
    wrappers do (K1 and K3 run only on the card): the old/new split's
    operands (coordinates shared by 2 images, 2 weight rows), along
    coordinate tangents (K3), a weight tangent (K1, masked where the weight
    is 0) or both, against torch.func.jvp of the plain vote."""
    monkeypatch.setattr(cuda_iwe, "vote_fwd", _compact_vote)
    monkeypatch.setattr(cuda_iwe, "vote_jvp", _compact_jvp)
    rng = np.random.default_rng(1)
    (px, py, wt), h, w = _events(rng)
    w2 = torch.stack([wt, wt * torch.tensor(rng.uniform(0, 1, len(wt)).astype(np.float32))])
    w2[1, :50] = 0.0
    n = len(px)
    tx, ty = (torch.tensor(rng.normal(size=(1, n)).astype(np.float32)) for _ in range(2))
    tw = torch.tensor(rng.normal(size=(2, n)).astype(np.float32))
    ops = {"px": px[None], "py": py[None], "w": w2}
    tans = {"px": tx, "py": ty, "w": tw}
    moving = {"coordinates": ("px", "py"), "weights": ("w",), "both": ("px", "py", "w")}[tangents]

    def call(vote):  # the moving operands as arguments, the others constants (no tangent)
        def f(*args):
            a = dict(ops, **dict(zip(moving, args)))
            return vote(a["px"], a["py"], a["w"])
        return f

    prim, tan = tuple(ops[k] for k in moving), tuple(tans[k] for k in moving)
    _, got = torch.func.jvp(call(lambda a, b, c: cuda_iwe.Vote.apply(a, b, c, h, w, 2)), prim,
                            tan)
    _, want = torch.func.jvp(call(lambda a, b, c: scatter.bilinear_accumulate(
        a.expand(2, -1), b.expand(2, -1), c, h, w)), prim, tan)
    assert got.shape == (2, h, w) and bool(want.abs().max() > 0)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_jvp_of_pano_iwe_is_a_slice_of_the_derivative_images():
    order, K = CASES[0]
    _, _, win, pano, _ = _windows(CASES[0], seed=8)
    deriv = warp_pano.derivative_images(win, pano, order, 1.0)
    for k, c in ((1, 2), (3, 0)):
        v = torch.zeros(K, 3)
        v[k, c] = 1.0
        _, tan = torch.func.jvp(lambda d: warp_pano.pano_iwe(d, win, pano, order, 1.0)[2],
                                (torch.zeros(K, 3),), (v,))
        assert float((tan - deriv[k, c]).abs().max()) <= 1e-5 * float(deriv.abs().max())


def test_save_derivative_images_from_the_port(tmp_path):
    order, K = CASES[1]
    _, _, win, pano, _ = _windows(CASES[1])
    deriv = warp_pano.derivative_images(win, pano, order, 1.0).numpy()
    path = tmp_path / "derivatives.png"
    image.save_derivative_images(str(path), deriv)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    assert (w, h) == (3 * WP, K * HP)  # 3K tiles, three to a row
