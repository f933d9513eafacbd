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


def _piled(rng, n=12_000, T=15, h=40, w=56, nan=True):
    """A stream piled on a few pixels, as a window's events pile on its
    landmarks: runs of consecutive events on 9 floor pixels (each event at
    its own offset inside the pixel), with dropped events mixed in (NaN
    coordinates, or with ``nan`` False a coordinate left of the image;
    out-of-image coordinates, weight 0), and T coordinate tangents (NaN
    where the coordinate is: never read)."""
    centers = np.array([[5, 7], [5, 8], [6, 7], [20, 30], [20, 31], [33, 50], [10, 3],
                        [36, 52], [18, 18]], np.float32)  # (y, x) floor pixels
    which = np.repeat(rng.integers(0, len(centers), n // 40), 40)[:n]
    py = centers[which, 0] + rng.uniform(0, 1, n).astype(np.float32)
    px = centers[which, 1] + rng.uniform(0, 1, n).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, n).astype(np.float32)
    dropped = rng.uniform(size=n) < 0.1
    kind = rng.integers(0, 4, n)
    px[dropped & (kind == 0)] = np.nan if nan else -5.0
    px[dropped & (kind == 1)] = w - 1.5  # floor past W - 3
    py[dropped & (kind == 2)] = 0.5      # floor below 1
    wt[dropped & (kind == 3)] = 0.0
    tpx = rng.normal(size=(T, n)).astype(np.float32)
    tpy = rng.normal(size=(T, n)).astype(np.float32)
    tpx[:, dropped & (kind == 0)] = np.nan if nan else 0.0
    return px, py, wt, tpx, tpy, h, w, dropped


def test_plain_tangent_vote_matches_jax_on_a_piled_stream():
    """K3's plain version against JAX's forward mode through its scatter
    vote (jax.jvp of ops/scatter.py's bilinear_accumulate_scatter along each
    tangent, as jax.jacfwd takes it column by column) on a piled stream:
    thousands of votes a pixel, summed in another order, within 1e-5 of the
    largest pixel (K3's tolerance); the dropped events alone vote zeros.
    JAX's forward mode turns a NaN coordinate's zero weight into NaN
    tangents (0 x NaN), so its dropped events here have finite coordinates;
    the port drops NaN ones exactly (test_plain_tangent_vote_is_the_jvp_of_the_plain_vote)."""
    from cmax_slam_tpu.ops import scatter as jscatter
    import jax

    px, py, wt, tpx, tpy, h, w, dropped = _piled(np.random.default_rng(11), nan=False)
    got = scatter.bilinear_accumulate_jvp(*(torch.tensor(a) for a in (px, py, wt, tpx, tpy)),
                                          h, w)

    def vote(x, y):
        return jscatter.bilinear_accumulate_scatter(x, y, jnp.asarray(wt), height=h, width=w)

    want = np.stack([np.asarray(jax.jvp(vote, (jnp.asarray(px), jnp.asarray(py)),
                                        (jnp.asarray(tpx[t]), jnp.asarray(tpy[t])))[1])
                     for t in range(tpx.shape[0])])
    scale = float(np.abs(want).max())
    assert scale > 100.0  # piled: many votes a pixel
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    dead = [torch.tensor(a[..., dropped]) for a in (px, py, wt, tpx, tpy)]
    assert not bool(scatter.bilinear_accumulate_jvp(*dead, h, w).any())


def test_one_call_of_t_tangents_equals_t_calls_of_one():
    """K3 now shares each event's load, floor and keep test across its T
    tangents: the T-tangent plain call equals T one-tangent calls, exactly,
    on the piled stream."""
    px, py, wt, tpx, tpy, h, w, _ = _piled(np.random.default_rng(12))
    ev = [torch.tensor(a) for a in (px, py, wt)]
    tx, ty = torch.tensor(tpx), torch.tensor(tpy)
    whole = scatter.bilinear_accumulate_jvp(*ev, tx, ty, h, w)
    for t in range(tx.shape[0]):
        one = scatter.bilinear_accumulate_jvp(*ev, tx[t:t + 1], ty[t:t + 1], h, w)
        assert torch.equal(one[0], whole[t])


def _taps(px, py, wt, tpx, tpy, h, w):
    """Each event's floor-pixel key (h * w when dropped) and its four tap
    derivatives per tangent, (T, N, 4), zero for a dropped event."""
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(px), np.floor(py)
        keep = (fx >= 1) & (fx < w - 2) & (fy >= 1) & (fy < h - 2) & (wt != 0)
        dx, dy = (np.where(keep, a - f, 0.0).astype(np.float32) for a, f in ((px, fx), (py, fy)))
    key = np.where(keep, np.nan_to_num(fy) * w + np.nan_to_num(fx), h * w).astype(np.int64)
    x, y = (np.where(keep, t, 0.0).astype(np.float32) for t in (tpx, tpy))
    ww = np.where(keep, wt, 0.0).astype(np.float32)
    v = np.stack([ww * (-x * (1 - dy) - y * (1 - dx)), ww * (x * (1 - dy) - y * dx),
                  ww * (-x * dy + y * (1 - dx)), ww * (x * dy + y * dx)], -1)
    return key, v.astype(np.float32)


def _add(out, key, sums, w):
    for t in range(out.shape[0]):
        np.add.at(out[t], np.stack([key, key + 1, key + w, key + w + 1], -1), sums[t])


def _block_sorted_jvp(px, py, wt, tpx, tpy, h, w, per_block=1024):
    """K3 in numpy: blocks of ``per_block`` consecutive events (a warp holds
    32 consecutive ones). A block none of whose warps holds two kept events
    on one floor pixel adds every kept event's taps at once; any other
    block sorts its events by floor pixel (dropped last), and each warp of
    32 sorted events sums each run of equal pixels by the kernel's
    segmented suffix sum (at step d, lane i adds lane i + d while i + d is
    in its run), whose first lane adds the sums. Returns the images, the
    atomics per tangent and the blocks that sorted."""
    key, v = _taps(px, py, wt, tpx, tpy, h, w)
    out = np.zeros((tpx.shape[0], h * w + w + 2), np.float32)
    adds = sorted_blocks = 0
    for b0 in range(0, len(px), per_block):
        idx = np.arange(b0, min(len(px), b0 + per_block))
        warps = [key[idx[i:i + 32]] for i in range(0, len(idx), 32)]
        if not any(len(np.unique(k[k < h * w])) < int((k < h * w).sum()) for k in warps):
            kept = idx[key[idx] < h * w]
            _add(out, key[kept], v[:, kept], w)
            adds += 4 * len(kept)
            continue
        sorted_blocks += 1
        idx = idx[np.argsort(key[idx], kind="stable")]
        for w0 in range(0, len(idx), 32):
            lanes = idx[w0:w0 + 32]
            k, vals = key[lanes], v[:, lanes].copy()
            last = np.array([np.flatnonzero(k == kk).max() for kk in k])
            for d in (1, 2, 4, 8, 16):
                shifted = np.zeros_like(vals)
                shifted[:, :len(k) - d] = vals[:, d:]
                ok = (np.arange(len(k)) + d <= last)[None, :, None]
                vals = vals + np.where(ok, shifted, 0.0)
            heads = np.flatnonzero((np.r_[True, k[1:] != k[:-1]]) & (k < h * w))
            _add(out, k[heads], vals[:, heads], w)
            adds += 4 * len(heads)
    return out[:, :h * w].reshape(-1, h, w), adds, sorted_blocks


@pytest.mark.parametrize("stream", ["piled", "spread"])
def test_block_sorted_sums_equal_the_plain_tangent_vote(stream):
    """K3's sums before its atomics, emulated in numpy with fewer tangents:
    on the piled stream every block sorts and adds far fewer times than
    once per tap of a kept event; on events spread over the image (no warp
    with two on one pixel) no block sorts and every tap is added at once.
    Within 1e-5 of the plain version's largest pixel either way."""
    rng = np.random.default_rng(13)
    if stream == "piled":
        px, py, wt, tpx, tpy, h, w, dropped = _piled(rng, n=3000, T=3)
    else:
        (px, py, wt), h, w = (t.numpy() for t in _events(rng)[0]), 400, 560
        px, py = px * 10, py * 10  # one event on a pixel, about
        tpx, tpy = (rng.normal(size=(3, len(px))).astype(np.float32) for _ in range(2))
    got, adds, sorted_blocks = _block_sorted_jvp(px, py, wt, tpx, tpy, h, w)
    want = scatter.bilinear_accumulate_jvp(*(torch.tensor(a) for a in (px, py, wt, tpx, tpy)),
                                           h, w).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    kept = int((_taps(px, py, wt, tpx, tpy, h, w)[0] < h * w).sum())
    blocks = -(-len(px) // 1024)
    if stream == "piled":
        assert kept == len(px) - int(dropped.sum())
        assert sorted_blocks == blocks and adds < 4 * kept / 10
    else:
        assert sorted_blocks == 0 and adds == 4 * kept
