"""K6, the fused packet objective (cmax_slam_tpu_torch/ops/cuda_packet.py and
csrc/packet.cu), on the CPU: its planner, its band tables, a plain-torch
emulation of its algorithm, and the routes an objective takes. Nothing here
needs the card, and nothing detects one.

(a) ``plan_packet_vg`` at the front-end's shapes for an H100 (232 448 B of
    opt-in shared memory per block, passed explicitly): K6 ("fused") at the
    ijrr preset's and the default preset's packet and sweep (180x240) and
    at live_davis' 260x346, the chain at ECRot's 480x640, under the gradient
    magnitude and at sigma 3 (coarse_to_fine's coarse stage, 25 taps).
(b) The band tables: each holds the nine diagonals of the chain's float32
    band matrix (or of its transpose) exactly, with the interior taps
    between its margins.
(c) A plain-torch emulation of K6's cluster (each block's buffers of its
    rows, halos and zero columns, indexed as the kernel indexes them; the
    pass along W, the halos read from the neighbours' buffers, the pass
    along H) equals the band matrix products, forward and adjoint.
(d) The emulated algorithm (warp, the vote of each block's rows, the blur,
    the measure's sums in rank order, dL/dI, the adjoint, each block's part
    of the gather and the chain through d(px, py)/d(omega)) equals the
    chain's value and autograd gradient, for both measures K6 takes, at the
    ijrr packet's shape.
(e) On CPU tensors ``make_local_objective`` takes the chain, bit for bit
    the composed objective, at the ijrr packet's shape and on a lane
    packet, and building it loads no library; a CPU packet or a lane
    packet always takes the chain, and K6 refuses them.
(f) The front-end counts its objectives by route.
"""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch.config import (
    IMAGE_GRADIENT_MAGNITUDE_CONTRAST, MEAN_SQUARE_CONTRAST, VARIANCE_CONTRAST, FrontendConfig,
    WarpOptions)
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops import blur, cuda_iwe, cuda_packet, nvcc, warp_local
from cmax_slam_tpu_torch.ops.contrast import contrast

torch.set_num_threads(1)

OPTIN = 232_448  # H100 SXM: cudaDevAttrMaxSharedMemoryPerBlockOptin
V, MS, GM = VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST, IMAGE_GRADIENT_MAGNITUDE_CONTRAST

# (tag, b, n, H, W, sigma, measure, route): the front-end's packet (B 1,
# a value and gradient) and sweep (B 9, the vector ladder's rungs) at each
# preset's sensor.
PLANS = [
    ("ijrr_packet", 1, 10_000, 180, 240, 1.0, V, "fused"),
    ("ijrr_sweep", 9, 10_000, 180, 240, 1.0, V, "fused"),
    ("default_packet", 1, 30_000, 180, 240, 1.0, V, "fused"),
    ("default_sweep", 9, 30_000, 180, 240, 1.0, V, "fused"),
    ("mean_square", 1, 10_000, 180, 240, 1.0, MS, "fused"),
    ("ecrot_packet", 1, 200_000, 480, 640, 1.0, V, "chain"),
    ("ecrot_sweep", 9, 200_000, 480, 640, 1.0, V, "chain"),
    ("live_packet", 1, 5_000, 260, 346, 1.0, V, "fused"),
    ("gradient_magnitude", 1, 10_000, 180, 240, 1.0, GM, "chain"),
    ("sigma3", 1, 10_000, 180, 240, 3.0, V, "chain"),
    ("no_blur", 1, 10_000, 180, 240, 0.0, V, "chain"),
]


@pytest.mark.parametrize("tag,b,n,H,W,sigma,measure,route", PLANS, ids=[p[0] for p in PLANS])
def test_planner_picks_the_route_by_shape(tag, b, n, H, W, sigma, measure, route):
    plan = cuda_packet.plan_packet_vg(b, n, H, W, sigma, measure, OPTIN)
    assert plan.route == route
    if route == "fused":
        pitch = W + 8
        assert plan.buf_rows >= -(-H // cuda_packet.CLUSTER) + 8
        assert plan.buf_rows * pitch % 4 == 0  # the zero fill's 16-byte stores
        fixed = 4 * (2 * plan.buf_rows * pitch + 5 * 8 + 3 * 32 + 3 + 4 * 9 + 32)
        # a list a warp, each of the events the warp warps where they fit
        per = min(32 * -(-n // 1024), (OPTIN - fixed) // 512)
        assert plan.cap == 32 * per and (per == 32 * -(-n // 1024)) == (tag != "default_packet"
                                                                      and tag != "default_sweep")
        assert plan.smem_bytes == fixed + 16 * plan.cap <= OPTIN
    else:
        assert plan == ("chain", 0, 0, 0)


def test_planner_takes_what_fits_a_cluster_and_nothing_else():
    def route(H, W, optin=OPTIN, b=1):
        return cuda_packet.plan_packet_vg(b, 10_000, H, W, 1.0, V, optin).route

    assert route(180, 240) == route(240, 180) == "fused"
    assert route(180, 240, optin=62_331) == "chain"  # a byte short of a block's buffers
    assert route(180, 240, optin=62_332) == "fused"
    assert route(32, 240) == "fused" and route(31, 240) == "chain"  # four rows a block
    assert route(180, 9) == "fused" and route(180, 8) == "chain"  # the nine taps
    assert route(480, 640) == "chain" and route(288, 640) == "fused" and route(296, 640) == "chain"
    assert route(180, 240, b=0) == "chain"
    # sigma 0.9 and 1.05 give OpenCV's nine taps too; 0.8 gives seven
    for sigma, want in ((0.9, "fused"), (1.05, "fused"), (0.8, "chain")):
        assert cuda_packet.plan_packet_vg(1, 10, 180, 240, sigma, V, OPTIN).route == want


@pytest.mark.parametrize("size", [9, 10, 17, 180, 240])
@pytest.mark.parametrize("sigma", [1.0, 0.9])
def test_band_tables_hold_the_band_matrices_diagonals(size, sigma):
    mat = blur._blur_matrix(size, sigma)
    for m, want_margin in ((mat, 4), (mat.T, 5)):  # B: rows 0-3 fold; B^T: columns 1-4
        tab, margin = cuda_packet.band_table(m)
        assert margin == min(want_margin, size // 2)
        back = np.zeros_like(m)
        for i in range(size):
            for d in range(9):
                j = i + d - 4
                if 0 <= j < size:
                    back[i, j] = tab[i, d]
                else:
                    assert tab[i, d] == 0.0
        assert np.array_equal(back, m)  # every entry, bit for bit
        for i in range(margin, size - margin):
            assert np.array_equal(tab[i], tab[margin])


class _Cluster:
    """K6's cluster for one H x W image, as the kernel lays it out: block k
    holds rows [k H / C, (k + 1) H / C) in two flat buffers A and B of
    ``buf_rows`` rows of W + 8 floats, its rows after four halo rows and
    each row after four zero columns (``at``, the kernel's Rows::at)."""

    def __init__(self, H, W, sigma=1.0):
        self.H, self.W, self.C = H, W, cuda_packet.CLUSTER
        self.pitch = W + 8
        self.buf_rows = cuda_packet.plan_packet_vg(1, 1, H, W, sigma, V, OPTIN).buf_rows
        tab, self.margins = cuda_packet._tables_host(H, W, sigma)
        self.tabs = [torch.as_tensor(t, dtype=torch.float64)
                     for t in np.split(tab.reshape(-1, 9), [H, 2 * H, 2 * H + W])]
        self.blocks = []
        for k in range(self.C):
            r0 = k * H // self.C
            z = torch.zeros(self.buf_rows * self.pitch, dtype=torch.float64)
            self.blocks.append({"r0": r0, "rows": (k + 1) * H // self.C - r0, "A": z,
                                "B": z.clone()})

    def at(self, local_row, x):
        return (local_row + 4) * self.pitch + x + 4

    def rows_of(self, blk, buf):
        """The block's own rows of ``buf`` as an (rows, W) view."""
        v = blk[buf].view(self.buf_rows, self.pitch)
        return v[4:4 + blk["rows"], 4:4 + self.W]

    def pass_w(self, src, dst, which):
        """pass_w: out[x] = sum_d band[x][d] * in[x + d - 4], zero columns outside."""
        tab, margin = self.tabs[which], self.margins[which]
        for blk in self.blocks:
            v = blk[src].view(self.buf_rows, self.pitch)[4:4 + blk["rows"]]
            w = torch.where(((torch.arange(self.W) >= margin)
                             & (torch.arange(self.W) < self.W - margin))[:, None],
                            tab[margin][None], tab)  # the interior taps, else the table's row
            self.rows_of(blk, dst)[:] = sum(w[:, d] * v[:, d:d + self.W] for d in range(9))

    def read_halos(self, buf):
        """read_halos: the four rows above and below each block's own, from
        its neighbours' ``buf`` (none beyond the image)."""
        got = []
        for k, blk in enumerate(self.blocks):
            for side in (0, 1):
                peer = k - 1 if side == 0 else k + 1
                if not 0 <= peer < self.C:
                    continue
                pr0 = self.blocks[peer]["r0"]
                for q in range(4):
                    g = blk["r0"] - 4 + q if side == 0 else blk["r0"] + blk["rows"] + q
                    src = self.blocks[peer][buf][self.at(g - pr0, 0):self.at(g - pr0, self.W)]
                    got.append((blk, self.at(g - blk["r0"], 0), src.clone()))
        for blk, at, row in got:  # every read before any write: the cluster's barrier
            blk[buf][at:at + self.W] = row

    def pass_h(self, src, dst, which):
        """pass_h: out[r] = sum_d band[r][d] * in[r + d - 4], the halos' rows."""
        tab, margin = self.tabs[which], self.margins[which]
        for blk in self.blocks:
            v = blk[src].view(self.buf_rows, self.pitch)[:, 4:4 + self.W]
            out = self.rows_of(blk, dst)
            for r in range(blk["rows"]):
                g = blk["r0"] + r
                w = tab[margin] if margin <= g < self.H - margin else tab[g]
                out[r] = sum(w[d] * v[r + d] for d in range(9))

    def blur(self, adjoint=False):
        """The forward blur (B_h, B_w) or its adjoint (B_h^T, B_w^T), A into A."""
        self.pass_w("A", "B", 3 if adjoint else 2)
        self.read_halos("B")
        self.pass_h("B", "A", 1 if adjoint else 0)

    def load(self, img):
        for blk in self.blocks:
            self.rows_of(blk, "A")[:] = img[blk["r0"]:blk["r0"] + blk["rows"]]

    def image(self, buf="A"):
        return torch.cat([self.rows_of(blk, buf) for blk in self.blocks])


@pytest.mark.parametrize("H,W", [(180, 240), (260, 346), (32, 9), (45, 23)])
def test_cluster_emulation_equals_the_band_matrix_products(H, W):
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.random((H, W)))
    bh = torch.as_tensor(blur._blur_matrix(H, 1.0), dtype=torch.float64)
    bw = torch.as_tensor(blur._blur_matrix(W, 1.0), dtype=torch.float64)
    cl = _Cluster(H, W)
    assert min(b["rows"] for b in cl.blocks) >= 4
    cl.load(img)
    cl.blur()
    torch.testing.assert_close(cl.image(), bh @ img @ bw.T, rtol=1e-12, atol=1e-12)
    cl.load(img)
    cl.blur(adjoint=True)
    torch.testing.assert_close(cl.image(), bh.T @ img @ bw, rtol=1e-12, atol=1e-12)
    for blk in cl.blocks:  # the zero columns stay zero
        v = blk["A"].view(cl.buf_rows, cl.pitch)
        assert not v[:, :4].any() and not v[:, 4 + W:].any()


def _packet(n=10_000, H=180, W=240, pad=200, seed=0):
    """An ijrr-like packet: n events of a turning camera on the H x W sensor
    (unit bearings from a centred pinhole) and ``pad`` weight-0 events."""
    rng = np.random.default_rng(seed)
    F = 180.0
    ev = synthetic.rotating_camera_events(rng, n, 0.025, np.array([0.9, -1.3, 1.9]), F, F,
                                          W / 2, H / 2, W, H, n_points=400)
    lut = synthetic.identity_lut(W, H, F, F, W / 2, H / 2)
    S = n + pad
    xs, ys, ts = (np.zeros(S, np.int32), np.zeros(S, np.int32), np.zeros(S, np.float32))
    xs[:n], ys[:n], ts[:n] = ev.xs, ev.ys, ev.ts
    cam = warp_local.CameraParams(F, F, W / 2, H / 2, W, H)
    packet = warp_local.make_packet(torch.as_tensor(xs), torch.as_tensor(ys),
                                    torch.as_tensor(ts), torch.arange(S) < n,
                                    torch.as_tensor(lut), cam, 100, 0.0125)
    return packet, cam


def _chain(packet, cam, sigma, measure):
    """The composed objective as make_local_objective builds it on the
    CPU: f, and its value_and_grad by autograd."""
    def f(omega):
        return -contrast(warp_local.local_iwe(omega, packet, cam, sigma), measure)

    return f, warp_local.value_and_grad(f)


def _emulate(packet, cam, sigma, measure, omega):
    """K6's value and gradient at one candidate, block by block of its
    cluster, in float64 after the warp (which rounds as warp_events does, in
    float32)."""
    H, W = cam.height, cam.width
    cl = _Cluster(H, W, sigma)
    px, py = warp_local.warp_events(omega[None], packet, cam)
    px, py, w = px[0].double(), py[0].double(), packet.weights.double()
    fx, fy = torch.floor(px), torch.floor(py)
    keep = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (w != 0)
    dx, dy = px - fx, py - fy
    ix, iy = fx.long(), fy.long()
    taps = ((0, 0, (1 - dx) * (1 - dy)), (0, 1, dx * (1 - dy)), (1, 0, (1 - dx) * dy),
            (1, 1, dx * dy))
    for blk in cl.blocks:  # each block votes the taps in its rows
        ly = iy - blk["r0"]
        for row, col, v in taps:
            mine = keep & (ly + row >= 0) & (ly + row < blk["rows"])
            blk["A"].index_add_(0, cl.at(ly[mine] + row, ix[mine] + col), (w * v)[mine])
    cl.blur()
    n_pix = H * W
    parts = [cl.rows_of(blk, "A") for blk in cl.blocks]
    mean = sum(p.sum() for p in parts) / n_pix if measure == V else 0.0
    value = -sum(((p - mean) ** 2).sum() for p in parts) / n_pix
    for p in parts:
        p[:] = (p - mean) * (-2.0 / n_pix)
    cl.blur(adjoint=True)
    b = packet.bearings.double()
    bx, by, bz = b.unbind(-1)
    dt, om = packet.dts.double(), omega.double()
    d = [dt * om[k] for k in range(3)]
    rx, ry = bx + (d[1] * bz - d[2] * by), by + (d[2] * bx - d[0] * bz)
    inv = 1.0 / (bz + (d[0] * by - d[1] * bx))
    xn, yn = rx * inv, ry * inv
    grad = torch.zeros(3, dtype=torch.float64)
    for blk in cl.blocks:  # each block's part: the taps in its rows
        G, ly = blk["A"], iy - blk["r0"]
        upper = keep & (ly >= 0) & (ly < blk["rows"])
        lower = keep & (ly + 1 >= 0) & (ly + 1 < blk["rows"])
        at = cl.at(torch.where(upper | lower, ly, 0), torch.where(upper | lower, ix, 0))
        t00, t01 = G[at], G[at + 1]
        t10, t11 = G[at + cl.pitch], G[at + cl.pitch + 1]
        dpx = torch.where(upper, (1 - dy) * (t01 - t00), 0.0) + torch.where(
            lower, dy * (t11 - t10), 0.0)
        dpy = torch.where(upper, -((1 - dx) * t00 + dx * t01), 0.0) + torch.where(
            lower, (1 - dx) * t10 + dx * t11, 0.0)
        a, c = w * dpx * cam.fx * inv, w * dpy * cam.fy * inv
        grad += torch.stack([torch.sum(dt * (-a * xn * by - c * (bz + yn * by))),
                             torch.sum(dt * (a * (bz + xn * bx) + c * yn * bx)),
                             torch.sum(dt * (c * bx - a * by))])
    return value, grad


@pytest.mark.parametrize("measure", [V, MS])
@pytest.mark.parametrize("omega", [(0.9, -1.3, 1.9), (0.0, 0.0, 0.0), (0.5, 0.2, -0.7)])
def test_emulated_algorithm_equals_the_chain(measure, omega):
    packet, cam = _packet()
    x = torch.tensor(omega, dtype=torch.float32)
    _, vg = _chain(packet, cam, 1.0, measure)
    v_ref, g_ref = vg(x)
    v, g = _emulate(packet, cam, 1.0, measure, x)
    assert abs(float(v) - float(v_ref)) <= 1e-5 * abs(float(v_ref))
    scale = float(g_ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), g_ref.double().numpy(), rtol=0,
                               atol=2e-3 * scale + 1e-6)


def _no_build(monkeypatch):
    """Make every build of a CUDA library, and the card's attributes, raise."""
    def refuse(*a, **kw):
        raise AssertionError("a library was built or loaded for a CPU objective")

    for mod, name in ((nvcc, "compile_all"), (cuda_iwe, "build"), (cuda_iwe, "device_attrs"),
                      (cuda_packet, "build"), (cuda_packet, "allow_smem")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("lanes", [False, True])
def test_cpu_objective_is_the_chain_bit_for_bit_and_builds_nothing(monkeypatch, lanes):
    packet, cam = _packet()
    x = torch.tensor([[0.9, -1.3, 1.9]], dtype=torch.float32)
    xs = torch.stack([x[0] * s for s in (0.25, 0.5, 1.0, 2.0)])[None]  # (1, 4, 3) rungs
    if lanes:  # two lanes of the packet, with their own candidates
        packet = warp_local.EventPacket(*(torch.stack([t, t.flip(0)]) for t in packet))
        x = torch.cat([x, 0.5 * x])
        xs = torch.cat([xs, 0.5 * xs])
    f_ref, vg_ref = _chain(packet, cam, 1.0, V)
    _no_build(monkeypatch)
    assert warp_local.objective_route(packet, cam, 1.0, V) == "chain"
    f, vg = warp_local.make_local_objective(packet, cam, 1.0, V)
    for got, ref in ((vg(x), vg_ref(x)), ((f(xs),), (f_ref(xs),)), ((f(x),), (f_ref(x),))):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_cpu_and_lane_packets_always_take_the_chain(monkeypatch):
    packet, cam = _packet(n=2_000)
    _no_build(monkeypatch)
    for p in (packet, warp_local.EventPacket(*(t[None] for t in packet))):
        for sigma, measure in ((1.0, V), (1.0, MS), (3.0, V), (1.0, GM)):
            assert warp_local.objective_route(p, cam, sigma, measure) == "chain"
    with pytest.raises(ValueError, match="CUDA"):
        cuda_packet.make_fused_objective(packet, cam, 1.0, V)
    with pytest.raises(ValueError, match="route"):
        warp_local.make_local_objective(packet, cam, 1.0, V, route="bands")


@pytest.mark.parametrize("coarse_to_fine,count", [(False, 1), (True, 2)])
def test_frontend_counts_its_objectives_by_route(coarse_to_fine, count):
    W, H, F = 60, 45, 45.0
    ev = synthetic.rotating_camera_events(np.random.default_rng(1), 6_000, 0.06,
                                          np.array([0.9, -1.4, 2.0]), F, F, W / 2, H / 2, W,
                                          H, n_points=80)
    cfg = FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
                         num_events_per_packet=2_000, dt_ang_vel=0.02,
                         coarse_to_fine=coarse_to_fine)
    fe = Frontend(warp_local.CameraParams(F, F, W / 2, H / 2, W, H),
                  synthetic.identity_lut(W, H, F, F, W / 2, H / 2), cfg, device="cpu")
    fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    assert fe.estimates
    counters = fe.metrics.counters
    assert counters["frontend.objective_chain"] == count * len(fe._entry.programs)
    assert "frontend.objective_fused" not in counters
