"""The K1 and K2 planners and the operand plumbing around the vote kernels
(cmax_slam_tpu_torch/ops/cuda_iwe.py), on the CPU: nothing here needs the
card, and nothing detects one.

(a) ``plan_vote_fwd`` at every chip_smoke.py shape and at 2048x4096, for an
    H100 (132 SMs, 232 448 B of opt-in shared memory per block, passed
    explicitly): bands of whole rows cover every row once, fit the shared
    memory, and the variant is the one the thresholds pick.
(b) A plain-torch emulation of variant P built from the planner's output
    (per band, the taps whose row lies in the band, accumulated and
    stitched) equals the port's plain vote and the JAX package's vote, to
    1e-5 of the largest pixel, on events placed on band edges, on integers,
    NaN and infinite, and with weight-0 padding.
(c) ``compact_rows``: broadcasts over trailing lead dimensions reach K1 as
    row groups with no copy; other broadcasts are materialized.
(d) ``Vote``'s backward on grouped operands (K1/K2 replaced by their plain
    versions, since the CPU has no kernels): K2 reads the same compact
    operands as K1, and its per-image gradients summed over each group
    equal autograd's through ``expand``; it is asked for dw only when the
    weights need a gradient, which no objective of the paths does.
(e) An empty batch gives empty images without reaching a kernel.
(f) ``plan_vote_bwd`` at the same shapes: S stages whole images only,
    within the shared memory, and is refused an image that does not fit;
    the variant is the one the thresholds pick.
(g) A plain-torch emulation of K2's variant S built from the planner's
    output (one block per image stages it whole, walks its events four at
    a time, past a ragged row end too, and gathers each event's taps from
    the staged copy) writes every event once and equals the plain autograd
    gradients and the JAX package's Pallas VJP (interpret mode), to 1e-5,
    on events on the image's border rows and columns, on integers, NaN,
    infinite and with weight 0.
(h) Dropped events alone vote an all-zero image (P's emulation, the plain
    vote, JAX's), as chip_smoke checks each K1 variant on the card.
(i) chip_smoke's count of the system path's K1 launches by shape: each
    bucket names the phase-3 shape it stands for, and the spy counts each
    launch once and is removed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmax_slam_tpu.ops import scatter as jscatter
from cmax_slam_tpu.ops.pallas_iwe import bilinear_accumulate_pallas
from cmax_slam_tpu_torch import calib
from cmax_slam_tpu_torch.ops import cuda_iwe, scatter, warp_local, warp_pano
from test_crop_solver import _plan_for_test, _smooth_map
from test_pano import _make_window
from test_torch_objectives import _packets, _to_torch

torch.set_num_threads(1)

SMS, OPTIN = 132, 232_448  # H100 SXM: SMs, cudaDevAttrMaxSharedMemoryPerBlockOptin

# The planner's pick at each shape, with the thresholds measured on an
# H100 (PERF.md): lanes and lanegrad are wide launches (P); sweep, packet,
# crop, split and headroom have fewer than P_MIN_IMAGES images (G), and
# split, the ECRot front-end's 480x640 and 2048x4096 need more bands than
# P_MAX_BANDS (G).
EXPECTED = {"sweep": "G", "packet": "G", "crop": "G", "split": "G", "headroom": "G",
            "lanes": "P", "lanegrad": "P", "ecrot_sweep": "G", "ecrot_packet": "G",
            "pano2048": "G"}
SHAPES = [(tag, b, n, H, W) for tag, b, n, H, W, *_ in chip_smoke.SHAPES] + [
    ("pano2048", 1, 84_700, 2048, 4096)]


def _band_rows_covered(plan, H):
    rows = []
    for band in range(plan.bands):
        r0 = band * plan.rows
        rows += range(r0, min(H, r0 + plan.rows))
    return rows


@pytest.mark.parametrize("tag,b,n,H,W", SHAPES, ids=[s[0] for s in SHAPES])
def test_planner_bands_cover_every_row_once_and_pick_the_variant(tag, b, n, H, W):
    plan = cuda_iwe.plan_vote_fwd(b, n, H, W, SMS, OPTIN)
    assert plan.variant == EXPECTED[tag]
    forced = cuda_iwe.plan_vote_fwd(b, n, H, W, SMS, OPTIN, variant="P")
    assert forced.variant == "P" and forced.bands >= 1
    assert _band_rows_covered(forced, H) == list(range(H))  # each row once, in order
    assert (forced.bands - 1) * forced.rows < H  # no empty band
    assert forced.smem_bytes == 4 * forced.rows * W <= OPTIN
    if plan.variant == "P":  # one wave of blocks, unless the tallest bands exceed it
        assert forced == plan
        tall = cuda_iwe.band_rows(H, W, OPTIN)[1]
        assert b >= cuda_iwe.P_MIN_IMAGES and b * plan.bands <= max(SMS, b * tall)
    if plan.variant == "G":
        assert plan == ("G", 0, 0, 0)


def test_planner_picks_by_shape_alone_and_refuses_what_it_cannot_band():
    # A 180x240 image is one band of 172 800 B. P from 24 images up, its
    # bands thinned (up to P_MAX_BANDS) while images x bands fit one wave of
    # 132 blocks; below 24 images, G, however dense the events.
    def plan(b, n=10_000):
        return cuda_iwe.plan_vote_fwd(b, n, 180, 240, SMS, OPTIN)

    assert plan(2016)[:3] == plan(132)[:3] == plan(67)[:3] == ("P", 180, 1)
    assert plan(66)[:3] == plan(48)[:3] == ("P", 90, 2)
    assert plan(44)[:3] == plan(34)[:3] == ("P", 60, 3)
    assert plan(33)[:3] == plan(24)[:3] == ("P", 45, 4)
    assert plan(23).variant == plan(1, 1 << 20).variant == plan(1, 1 << 24).variant == "G"
    assert plan(24, 1 << 20) == plan(24)
    # Wide launches of larger images: P up to P_MAX_BANDS bands, G beyond.
    assert cuda_iwe.plan_vote_fwd(24, 1 << 18, 384, 384, SMS, OPTIN)[:3] == ("P", 96, 4)
    assert cuda_iwe.plan_vote_fwd(24, 1 << 18, 512, 1024, SMS, OPTIN).variant == "G"
    assert cuda_iwe.plan_vote_fwd(24, 1 << 18, 2048, 4096, SMS, OPTIN).variant == "G"
    # A row wider than the shared memory: G, and forcing a band variant raises.
    assert cuda_iwe.plan_vote_fwd(4096, 10, 4, 100_000, SMS, OPTIN).variant == "G"
    with pytest.raises(ValueError, match="does not fit"):
        cuda_iwe.plan_vote_fwd(1, 10, 4, 100_000, SMS, OPTIN, variant="P")
    with pytest.raises(ValueError, match="unknown"):
        cuda_iwe.plan_vote_fwd(1, 10, 8, 8, SMS, OPTIN, variant="PS")


def emulate_bands(px, py, w, plan, H, W):
    """P in plain torch, from the planner's output: each band's block keeps
    the taps of the events whose row lies in its band (in-bounds test on the
    global floor), sums them in a band-local image, and the bands' images
    are stitched. Every pixel is written once, as P's plain stores do."""
    b, _ = px.shape
    out = torch.full((b, H, W), float("nan"))
    fx, fy = torch.floor(px), torch.floor(py)
    live = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (w != 0)
    dx, dy = px - fx, py - fy
    for band in range(plan.bands):
        r0 = band * plan.rows
        nrows = min(plan.rows, H - r0)
        acc = torch.zeros(b, nrows * W)
        for oy, wy in ((0, 1 - dy), (1, dy)):
            row = fy + oy - r0
            for ox, wx in ((0, 1 - dx), (1, dx)):
                keep = live & (row >= 0) & (row < nrows)
                idx = torch.where(keep, row * W + fx + ox, 0.0).long()
                acc.scatter_add_(1, idx, torch.where(keep, w * wx * wy, 0.0))
        assert bool(out[:, r0:r0 + nrows].isnan().all())  # no row stored twice
        out[:, r0:r0 + nrows] = acc.reshape(b, nrows, W)
    return out


def _edge_events(rng, b, n, H, W, plan):
    """Events with a third on the rows next to each band edge (floor(py) =
    r0 - 1 and r0, fractional and integer), a fifth of the rest on integer
    coordinates, NaN and infinite coordinates, weight-0 padding."""
    px = rng.uniform(-3, W + 3, (b, n)).astype(np.float32)
    py = rng.uniform(-3, H + 3, (b, n)).astype(np.float32)
    edges = np.arange(1, plan.bands) * plan.rows
    k = n // 3
    on_edge = rng.choice(edges, (b, k)) - rng.integers(0, 2, (b, k))
    frac = np.where(rng.uniform(size=(b, k)) < 0.25, 0.0, rng.uniform(size=(b, k)))
    py[:, :k] = (on_edge + frac).astype(np.float32)
    m = k + (n - k) // 5
    px[:, k:m] = np.round(px[:, k:m])
    py[:, k:m] = np.round(py[:, k:m])
    px[:, m:m + 3] = [np.nan, np.inf, -np.inf]
    py[:, m + 3:m + 5] = [np.nan, -np.inf]
    w = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    w[:, -n // 10:] = 0.0
    return px, py, w


CASES = {
    # (b, n, H, W, smem_optin): the 384x384 crop's bands forced to P with
    # the H100's shared memory; small images with a small shared memory, so
    # that P cuts them into many bands (the last one ragged in "ragged"),
    # against JAX too.
    "crop_P": (1, 20_000, 384, 384, OPTIN),
    "small_P": (2, 3_000, 40, 56, 4 * 56 * 7),
    "ragged": (3, 30_000, 41, 56, 4 * 56 * 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_band_emulation_equals_the_plain_and_jax_votes(rng, case):
    b, n, H, W, optin = CASES[case]
    plan = cuda_iwe.plan_vote_fwd(b, n, H, W, SMS, optin, variant="P")
    assert plan.variant == "P" and plan.bands >= 3
    px, py, w = _edge_events(rng, b, n, H, W, plan)
    tpx, tpy, tw = (torch.tensor(a) for a in (px, py, w))
    got = emulate_bands(tpx, tpy, tw, plan, H, W)
    ref = scatter.bilinear_accumulate(tpx, tpy, tw, H, W)
    tol = 1e-5 * float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)
    if H * W <= 4096:
        for i in range(b):
            jimg = jscatter.bilinear_accumulate(jnp.asarray(px[i]), jnp.asarray(py[i]),
                                                jnp.asarray(w[i]), height=H, width=W)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(jimg), rtol=0, atol=tol)
    # The band edges carried votes from both sides.
    edge_rows = torch.arange(1, plan.bands) * plan.rows
    assert float(ref[:, edge_rows - 1].abs().sum()) > 0 and float(ref[:, edge_rows].abs().sum()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_dropped_events_alone_vote_an_all_zero_image(rng, case):
    """chip_smoke's check of each K1 variant on the card, here on P's
    emulation, the plain vote and JAX's: the events every image drops (NaN
    and infinite coordinates, floors outside 1 <= floor < size - 2, weight
    0) vote exactly nothing, not even a NaN times zero."""
    b, n, H, W, optin = CASES[case]
    plan = cuda_iwe.plan_vote_fwd(b, n, H, W, SMS, optin, variant="P")
    px, py, w = _edge_events(rng, b, n, H, W, plan)
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(px), np.floor(py)
        live = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (w != 0)
    assert (~live & (w != 0)).sum(axis=1).min() >= 5  # dropped for their coordinates alone
    w = np.where(live, 0.0, w).astype(np.float32)  # the in-bounds events dropped by weight
    tpx, tpy, tw = (torch.tensor(a) for a in (px, py, w))
    assert not emulate_bands(tpx, tpy, tw, plan, H, W).any()
    assert not scatter.bilinear_accumulate(tpx, tpy, tw, H, W).any()
    if H * W <= 4096:
        for i in range(b):
            jimg = jscatter.bilinear_accumulate(jnp.asarray(px[i]), jnp.asarray(py[i]),
                                                jnp.asarray(w[i]), height=H, width=W)
            assert not np.asarray(jimg).any()


@pytest.mark.parametrize("tag", ["packet", "sweep", "crop", "split"])
def test_launch_buckets_name_the_phase3_shape_a_path_launch_stands_for(tag):
    """chip_smoke counts the system path's K1 launches by the phase-3 shape
    each stands for: the camera image (180x240) one image per packet or 9
    rungs per sweep, the ijrr panorama two images per old/new split, any
    other image one back-end crop."""
    _, b, _, H, W, *_ = next(s for s in chip_smoke.SHAPES if s[0] == tag)
    assert chip_smoke._fwd_bucket(b, H, W, (180, 240), (512, 1024)) == tag
    assert chip_smoke._fwd_bucket(3, H, W, (180, 240), (512, 1024)) not in EXPECTED


def test_launch_spy_counts_each_k1_launch_by_shape_and_variant_and_is_removed(monkeypatch):
    """The spy reads the wrappers' own counts by shape (cuda_iwe.count_launches,
    which every launch reaches, and every execution of a launch captured in a
    CUDA graph): K1's launches by shape bucket and variant, K2's left out;
    removing it stops the counting by shape."""
    monkeypatch.setattr(cuda_iwe, "LAUNCHES", dict.fromkeys(cuda_iwe.LAUNCHES, 0))
    tally = {}
    remove = chip_smoke._spy_fwd_shapes(tally, (180, 240), (512, 1024))
    cuda_iwe.count_launches("fwd", "G", (9, 10, 180, 240))
    cuda_iwe.count_launches("fwd", "G", (1, 10, 180, 240), times=3)  # a captured launch run 3x
    cuda_iwe.count_launches("fwd", "G", (2, 10, 512, 1024))
    cuda_iwe.count_launches("fwd", "P", (2016, 10, 180, 240))
    cuda_iwe.count_launches("bwd", "G", (1, 10, 180, 240))
    remove()
    assert cuda_iwe.SHAPE_LAUNCHES is None
    cuda_iwe.count_launches("fwd", "G", (1, 10, 180, 240))  # counted, not by shape
    assert cuda_iwe.LAUNCHES["fwd"] == 7 and cuda_iwe.LAUNCHES["bwd_G"] == 1
    assert tally == {
        "sweep": {"launches": 1, "events": 90, "variants": {"G": 1}},
        "packet": {"launches": 3, "events": 30, "variants": {"G": 3}},
        "split": {"launches": 1, "events": 20, "variants": {"G": 1}},
        "camera b=2016": {"launches": 1, "events": 20_160, "variants": {"P": 1}}}


def test_compact_rows_reads_trailing_broadcasts_in_place():
    P, M, N = 3, 4, 50
    w = torch.rand(P, 1, N)
    c = cuda_iwe.compact_rows(w, (P, M), N)
    assert c.shape == (P, N) and (P * M) // c.shape[0] == M
    assert c.data_ptr() == w.data_ptr()  # no copy
    px = torch.rand(P, M, N)
    c = cuda_iwe.compact_rows(px, (P, M), N)
    assert c.shape == (P * M, N) and c.data_ptr() == px.data_ptr()


def test_compact_rows_shares_coordinates_across_the_split():
    N = 50
    px = torch.rand(N)
    c = cuda_iwe.compact_rows(px, (2,), N)
    assert c.shape == (1, N) and 2 // c.shape[0] == 2 and c.data_ptr() == px.data_ptr()
    assert cuda_iwe.compact_rows(torch.rand(N), (), N).shape == (1, N)


def test_compact_rows_materializes_a_leading_broadcast():
    P, M, N = 3, 4, 50
    w = torch.rand(1, M, N)  # image p * M + m reads row m: not a row group
    c = cuda_iwe.compact_rows(w, (P, M), N)
    assert c.shape == (P * M, N) and c.data_ptr() != w.data_ptr()
    torch.testing.assert_close(c, w.expand(P, M, N).reshape(P * M, N), rtol=0, atol=0)
    # a weight broadcast along the events is materialized too
    c = cuda_iwe.compact_rows(torch.ones(P, M, 1), (P, M), N)
    assert c.shape == (P * M, N)


def _expand(t, b):
    """A compact (R, n) operand as the full (b, n) array, image i reading row
    i // (b // R)."""
    return t[:, None].expand(t.shape[0], b // t.shape[0], t.shape[1]).reshape(b, -1)


def _plain_kernels(monkeypatch, seen):
    """Replace K1 and K2 by their plain versions, recording what they get:
    (kernel, b, [(shape, data_ptr) of px, py, w], K2's with_dw)."""

    def fwd(px, py, w, height, width, b=None, **kw):
        seen.append(("fwd", b, [(t.shape, t.data_ptr()) for t in (px, py, w)], None))
        full = [_expand(t, b) for t in (px, py, w)]
        return scatter.bilinear_accumulate(*full, height, width)

    def bwd(px, py, w, g, b=None, *, with_dw=True, variant=None):
        assert all(t.is_contiguous() for t in (px, py, w, g))  # as K2 requires
        seen.append(("bwd", b, [(t.shape, t.data_ptr()) for t in (px, py, w)], with_dw))
        leaves = [_expand(t, b).detach().requires_grad_(True) for t in (px, py, w)]
        with torch.enable_grad():  # backward runs with grad mode off
            img = scatter.bilinear_accumulate(*leaves, g.shape[1], g.shape[2])
        dpx, dpy, dw = torch.autograd.grad(img, leaves, g)  # per image, (b, n)
        return dpx, dpy, dw if with_dw else None

    monkeypatch.setattr(cuda_iwe, "vote_fwd", fwd)
    monkeypatch.setattr(cuda_iwe, "vote_bwd", bwd)


@pytest.mark.parametrize("layout", ["lanes", "split", "leading"])
def test_grouped_backward_equals_autograd_through_expand(rng, monkeypatch, layout):
    H, W, N, P, M = 24, 32, 400, 3, 4
    xy_shape, w_shape = {
        "lanes": ((P, M, N), (P, 1, N)),  # rungs share each lane's weights
        "split": ((N,), (2, N)),  # both images share the coordinates
        "leading": ((P, M, N), (1, M, N)),  # materialized, for contrast
    }[layout]
    px = rng.uniform(-2, W + 2, xy_shape).astype(np.float32)
    py = rng.uniform(-2, H + 2, xy_shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, w_shape).astype(np.float32)
    lead = torch.broadcast_shapes(px.shape, w.shape)[:-1]
    key = torch.tensor(rng.normal(size=(*lead, H, W)).astype(np.float32))

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in (px, py, w)]
        img = fn(*leaves, H, W)
        torch.sum(key * img).backward()
        return img.detach(), [t.grad for t in leaves], leaves

    seen = []
    _plain_kernels(monkeypatch, seen)
    img, got, leaves = grads(cuda_iwe.bilinear_accumulate_cuda)
    ref_img, ref, _ = grads(scatter.bilinear_accumulate)
    torch.testing.assert_close(img, ref_img, rtol=0, atol=1e-5)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    (_, b, fwd_ops, _), (_, b_bwd, bwd_ops, with_dw) = seen
    B = int(np.prod(lead))
    assert b == b_bwd == B and with_dw
    assert bwd_ops == fwd_ops  # K2 reads the compact operands K1 read, in place
    w_rows, w_ptr = fwd_ops[2]
    if layout == "lanes":
        assert w_rows == (P, N)
    if layout == "split":
        assert fwd_ops[0][0] == (1, N) and w_rows == (2, N)
    if layout == "leading":
        assert w_rows == (B, N)
    # Read in place unless materialized.
    assert (w_ptr == leaves[2].data_ptr()) == (layout != "leading")


@pytest.mark.parametrize("shape", [(0, 50), (2, 0, 50), (3, 0)])
def test_empty_batch_gives_empty_images(shape):
    H, W = 12, 16
    px = torch.zeros(shape)
    img = cuda_iwe.bilinear_accumulate_cuda(px, px, torch.ones(shape[-1:]), H, W)
    assert img.shape == (*shape[:-1], H, W) and not img.any()
    assert img.shape == scatter.bilinear_accumulate(px, px, torch.ones(shape[-1:]), H, W).shape


@pytest.mark.parametrize("layout", ["lanes", "split"])
def test_vote_backward_asks_no_dw_when_the_weights_need_no_gradient(rng, monkeypatch, layout):
    H, W, N, P, M = 24, 32, 400, 3, 4
    xy_shape, w_shape = {"lanes": ((P, M, N), (P, 1, N)), "split": ((N,), (2, N))}[layout]
    px = rng.uniform(-2, W + 2, xy_shape).astype(np.float32)
    py = rng.uniform(-2, H + 2, xy_shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, w_shape).astype(np.float32)
    lead = torch.broadcast_shapes(px.shape, w.shape)[:-1]
    key = torch.tensor(rng.normal(size=(*lead, H, W)).astype(np.float32))

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=i < 2) for i, a in enumerate((px, py, w))]
        torch.sum(key * fn(*leaves, H, W)).backward()
        return [t.grad for t in leaves]

    seen = []
    _plain_kernels(monkeypatch, seen)
    got = grads(cuda_iwe.bilinear_accumulate_cuda)
    ref = grads(scatter.bilinear_accumulate)
    assert got[2] is None and ref[2] is None
    for a, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    assert [(k, with_dw) for k, *_, with_dw in seen] == [("fwd", None), ("bwd", False)]


def _route_votes_through_vote(monkeypatch, seen):
    """Send the objectives' votes on the CPU through the CUDA route
    (bilinear_accumulate_cuda, Vote) with K1/K2 replaced by their plain
    versions, as they reach the kernels on the card."""
    _plain_kernels(monkeypatch, seen)
    monkeypatch.setattr(warp_local, "vote", cuda_iwe.bilinear_accumulate_cuda)
    monkeypatch.setattr(warp_pano, "vote", cuda_iwe.bilinear_accumulate_cuda)


@pytest.mark.parametrize("objective", ["local", "local_lanes", "crop"])
def test_objectives_value_and_grad_ask_k2_for_no_dw(rng, monkeypatch, objective):
    """The front-end local objective (one packet, and lanes x rungs) and the
    back-end crop objective on its composed route (K1/K2: the main path
    takes K4/K5, ops/cuda_pano_vote.py) differentiate the warp, never the
    weights: their value_and_grad asks K2 for no dw, with the gradient
    unchanged."""
    if objective.startswith("local"):
        _, tp, cam, omega = _packets(rng)
        tcam = warp_local.CameraParams(*cam)
        x = torch.tensor(np.float32(omega))
        if objective == "local_lanes":  # (P, N) lane packets, (P, M, 3) candidates
            tp = warp_local.EventPacket(*(torch.stack([t, t]) for t in tp))
            x = torch.stack([torch.stack([x, 0.5 * x]), torch.stack([0.9 * x, x])])

        def make():
            return warp_local.make_local_objective(tp, tcam, 1.0, 0)[1]
    else:
        order, sigma, measure = 2, 1.0, 0
        win_j, pano_j, _, _ = _make_window(rng, n_events=4096)
        win_j = win_j._replace(ig_prime=jnp.asarray(_smooth_map(rng, pano_j.height,
                                                                pano_j.width)))
        Hc, Wc, ints = _plan_for_test(win_j, pano_j, order, sigma, measure)
        pano = calib.EquirectCamera(width=pano_j.width, height=pano_j.height)
        ct = warp_pano.crop_window_constants(_to_torch(win_j), pano, order, sigma, measure,
                                             (Hc, Wc), ints)
        x = torch.tensor((rng.normal(size=3 * win_j.knots.shape[0]) * 0.01).astype(np.float32))

        def make():
            return warp_pano.make_crop_objective(ct[0], pano, order, sigma, measure, (Hc, Wc),
                                                 *ct[1:])[1]

        monkeypatch.setattr(warp_pano, "pano_vote", warp_pano.pano_vote_composed)

    v_ref, g_ref = make()(x)
    seen = []
    _route_votes_through_vote(monkeypatch, seen)
    v, g = make()(x)
    torch.testing.assert_close(v, v_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-6)
    bwd = [with_dw for k, *_, with_dw in seen if k == "bwd"]
    assert bwd == [False]  # one K2 launch, no dw


# The K2 planner's pick at each shape, with the threshold measured on an
# H100 (PERF.md): lanes and lanegrad are wide launches of front-end images
# (S); the rest have fewer than S_MIN_IMAGES images (G), and 480x640 and
# 2048x4096 do not stage whole (G).
EXPECTED_BWD = {"sweep": "G", "packet": "G", "crop": "G", "split": "G", "headroom": "G",
                "lanes": "S", "lanegrad": "S", "ecrot_sweep": "G", "ecrot_packet": "G",
                "pano2048": "G"}


@pytest.mark.parametrize("tag,b,n,H,W", SHAPES, ids=[s[0] for s in SHAPES])
def test_bwd_planner_stages_whole_images_and_picks_the_variant(tag, b, n, H, W):
    plan = cuda_iwe.plan_vote_bwd(b, n, H, W, SMS, OPTIN)
    assert plan.variant == EXPECTED_BWD[tag]
    whole = cuda_iwe.S_BARRIER_BYTES + 4 * H * W
    assert cuda_iwe.stages_whole(H, W, OPTIN) == (whole <= OPTIN and W % 4 == 0)
    if cuda_iwe.stages_whole(H, W, OPTIN):
        forced = cuda_iwe.plan_vote_bwd(b, n, H, W, SMS, OPTIN, variant="S")
        assert forced == ("S", whole)
    else:  # the 384x384 crop and the panoramas: never staged in bands
        with pytest.raises(ValueError, match="cannot be staged whole"):
            cuda_iwe.plan_vote_bwd(b, n, H, W, SMS, OPTIN, variant="S")
    if plan.variant == "S":  # whole images, one block each
        assert forced == plan and b >= cuda_iwe.S_MIN_IMAGES
    else:  # G: a thread per event, its grid computed by the launch
        assert plan == ("G", 0)


def test_bwd_planner_picks_by_shape_alone_and_refuses_what_it_cannot_stage():
    def plan(b, n=10_000, H=180, W=240):
        return cuda_iwe.plan_vote_bwd(b, n, H, W, SMS, OPTIN)

    # A 180x240 image stages whole (172 816 B with the barrier): S from
    # S_MIN_IMAGES images, one block per image, however dense the events.
    assert plan(224) == plan(48) == ("S", 172_816)
    assert plan(47) == plan(1) == plan(1, 1 << 20) == ("G", 0)
    assert plan(48, 1 << 20) == plan(48)
    # Images that do not stage whole, rows of W % 4 != 0, rows too wide for
    # the shared memory: G, and forcing S raises.
    assert plan(224, 1 << 18, 384, 384).variant == "G"
    assert plan(224, 10_000, 180, 242).variant == "G"
    assert plan(4096, 10, 4, 100_000).variant == "G"
    assert plan(224, 10_000, 240, 240).variant == "S"  # 230 416 B: the largest square
    assert plan(224, 10_000, 244, 240).variant == "G"
    for H, W in ((180, 242), (4, 100_000), (384, 384)):
        with pytest.raises(ValueError, match="cannot be staged whole"):
            cuda_iwe.plan_vote_bwd(1, 10, H, W, SMS, OPTIN, variant="S")
    with pytest.raises(ValueError, match="unknown"):
        cuda_iwe.plan_vote_bwd(1, 10, 8, 8, SMS, OPTIN, variant="P")


def emulate_staged(px, py, w, g, plan, with_dw=True):
    """K2's variant S in plain torch, from the planner's output: each image's
    block stages the whole image in its shared memory, walks the events
    four at a time (weight 0 past the row's end, never stored), gathers each
    event's four taps from the staged copy (a dropped event reads the first
    pixels and ignores them) and writes its gradients. Every event must be
    written once."""
    b, n = px.shape
    H, W = g.shape[1:]
    assert plan.variant == "S" and plan.smem_bytes == cuda_iwe.S_BARRIER_BYTES + 4 * H * W
    m = -(-n // 4) * 4  # the last quad, ragged where n % 4 != 0
    pad = [torch.cat([t, torch.zeros(b, m - n)], 1) for t in (px, py, w)]
    out = [torch.full((b, n), float("nan")) for _ in range(3)]
    for i in range(b):
        staged = g[i].reshape(-1)  # the image, as the bulk copies land it
        for e in range(0, m, 4):
            x, y, wt = (t[i, e:e + 4] for t in pad)
            fx, fy = torch.floor(x), torch.floor(y)
            valid = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (wt != 0)
            at = torch.where(valid, fy * W + fx, 0.0).long()
            sx, sy = valid.long(), valid.long() * W
            t00, t01, t10, t11 = (staged[at + o] for o in (0, sx, sy, sy + sx))
            dx, dy = x - fx, y - fy
            grads = (wt * ((1 - dy) * (t01 - t00) + dy * (t11 - t10)),
                     wt * ((1 - dx) * (t10 - t00) + dx * (t11 - t01)),
                     (1 - dy) * ((1 - dx) * t00 + dx * t01) + dy * ((1 - dx) * t10 + dx * t11))
            cnt = min(4, n - e)
            for o, v in zip(out, grads):
                assert bool(o[i, e:e + cnt].isnan().all())  # no event written twice
                o[i, e:e + cnt] = torch.where(valid, v, 0.0)[:cnt]
    assert not any(bool(o.isnan().any()) for o in out)  # every event written
    return out if with_dw else out[:2] + [None]


def _border_events(rng, b, n, H, W):
    """Events with a third on the rows and columns at the in-bounds border
    (floor 0, 1, H-3 or W-3, H-2 or W-2; fractional and integer), a fifth
    of the rest on integer coordinates, NaN and infinite coordinates, and
    weight-0 padding."""
    px = rng.uniform(-3, W + 3, (b, n)).astype(np.float32)
    py = rng.uniform(-3, H + 3, (b, n)).astype(np.float32)
    k = n // 3
    for a, size in ((px, W), (py, H)):
        edge = rng.choice([0, 1, size - 3, size - 2], (b, k))
        frac = np.where(rng.uniform(size=(b, k)) < 0.25, 0.0, rng.uniform(size=(b, k)))
        a[:, :k] = (edge + frac).astype(np.float32)
    m = k + (n - k) // 5
    px[:, k:m] = np.round(px[:, k:m])
    py[:, k:m] = np.round(py[:, k:m])
    px[:, m:m + 3] = [np.nan, np.inf, -np.inf]
    py[:, m + 3:m + 5] = [np.nan, -np.inf]
    w = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    w[:, -n // 10:] = 0.0
    return px, py, w


STAGED_CASES = {
    # (b, n, H, W): small images against JAX too, with n % 4 = 0 and a
    # ragged last quad (n % 4 = 1); a front-end image against autograd.
    "small": (2, 3_000, 40, 56),
    "ragged": (3, 3_001, 41, 56),
    "front_end": (1, 4_003, 180, 240),
}


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_emulation_equals_plain_autograd_and_the_pallas_vjp(rng, case):
    b, n, H, W = STAGED_CASES[case]
    plan = cuda_iwe.plan_vote_bwd(b, n, H, W, SMS, OPTIN, variant="S")
    px, py, w = _border_events(rng, b, n, H, W)
    g = rng.normal(size=(b, H, W)).astype(np.float32)
    tpx, tpy, tw, tg = (torch.tensor(a) for a in (px, py, w, g))
    leaves = [t.clone().requires_grad_(True) for t in (tpx, tpy, tw)]
    ref = torch.autograd.grad(scatter.bilinear_accumulate(*leaves, H, W), leaves, tg)
    got = emulate_staged(tpx, tpy, tw, tg, plan)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=1e-5)
    assert emulate_staged(tpx, tpy, tw, tg, plan, with_dw=False)[2] is None
    dropped = ~np.isfinite(px) | ~np.isfinite(py) | (w == 0)
    assert dropped.sum() >= 5 * b and all(not a.numpy()[dropped].any() for a in got)
    if H * W <= 4096:
        for i in range(b):
            _, pull = jax.vjp(lambda a, c, d: bilinear_accumulate_pallas(a, c, d, H, W, "highest"),
                              *(jnp.asarray(t[i]) for t in (px, py, w)))
            for a, r in zip(got, pull(jnp.asarray(g[i]))):
                np.testing.assert_allclose(a[i].numpy(), np.asarray(r), rtol=0, atol=1e-5)
    # Events on the last in-bounds row and column took their taps from the
    # image's far edge.
    last = ((np.floor(py) == H - 3) | (np.floor(px) == W - 3)) & ~dropped
    assert last.sum() > 0 and np.abs(got[0].numpy()[last]).sum() > 0
