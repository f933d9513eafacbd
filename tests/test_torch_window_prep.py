"""The back-end window's preparation inside its own program: the first
segment of backend._WindowSolver's program gathers the bearings from the
LUT, writes the window's buffers from its packed raw inputs
(backend.WindowInputs, one upload), computes the spline basis, alpha from
the zero-increment image (warp_pano.pano_vote: K4 on the card) and, on a
crop, the rest of warp_pano.crop_window_constants.

(1) CPU: after a launch, a crop and a full window at spline orders 2 and 4
    hold the constants the eager functions compute on the same window,
    exactly (the same ops in the same order on the CPU); the packed result's
    f0 and alpha are the eagerly built objective's value at zero and alpha.
(2) CPU: every window launched in a short system run, with its bootstrap
    re-solve and a refine pass, counts in backend.prep_in_program_crop or
    backend.prep_in_program_full.
(3) CPU: the host's ATen ops per dispatched window, outside the program.
(4) Card only (``card`` marker; skips without a card): the prologue's
    constants against the eager route the host took before (warp_to_pano,
    K1 and crop_window_constants, op by op) on an ijrr-sized crop window
    and an ECRot 2^20-event crop window, and the host's dispatch time per
    window both ways. Run on a card without tests/conftest.py (which
    imports jax): ``python -m pytest --noconftest -p no:cacheprovider
    tests/test_torch_window_prep.py -m card -s``.

This file imports nothing of the JAX package.
"""

import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cmax_slam_tpu_torch import config, spline
from cmax_slam_tpu_torch.backend import Backend, WindowInputs, _WindowSolver
from cmax_slam_tpu_torch.calib import CameraCalibration, EquirectCamera
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.io.events import EventStore
from cmax_slam_tpu_torch.ops import device_loop, warp_pano
from cmax_slam_tpu_torch.system import CMaxSLAM

torch.set_num_threads(1)

DT, BATCH, SPAN = 0.05, 100, 0.2
SIGMA, MEASURE = 1.0, config.VARIANCE_CONTRAST
OMEGA = np.array([0.6, -0.9, 1.2])  # rad/s


def _quats(rotvecs):
    return np.stack([spline._np_quat_exp(v) for v in rotvecs])


def make_case(seed, order, slots, camera, pano_hw, device="cpu"):
    """Seeded raw inputs of one window: ``slots`` event slots (half a batch
    of padding at the end) on a pinhole's pixels over 0.2 s, knots along a
    turn with noise, a sparse map, and the crop that covers the events'
    zero-increment footprint with the back-end's margin, placed and bounded
    as Backend._plan_crop places it. Returns (WindowInputs with the crop,
    the LUT (rows, 3), the map (H, W), the panorama, (Hc, Wc))."""
    width, height, f = camera
    rng = np.random.default_rng(seed)
    K = int(round(SPAN / DT)) + order - 1
    live = slots - BATCH // 2
    xs = rng.integers(0, width, slots)
    ys = rng.integers(0, height, slots)
    ts = np.zeros(slots)
    ts[:live] = np.sort(rng.uniform(0.0, SPAN, live))
    valid = np.arange(slots) < live
    tb, vb = ts.reshape(-1, BATCH), valid.reshape(-1, BATCH)
    first = np.where(vb, tb, np.inf).min(1)
    last = np.where(vb, tb, -np.inf).max(1)
    mid = np.where(vb.any(1), first + 0.5 * (last - first), 0.0)
    tk = DT * (np.arange(K) - (order // 2 - 1))
    knots = _quats(np.outer(tk, OMEGA) + 0.01 * rng.standard_normal((K, 3)))
    free = np.ones(K, np.float32)
    free[0] = 0.0
    H, W = pano_hw
    ig = (rng.random((H, W)) < 0.05) * rng.uniform(0.5, 3.0, (H, W))
    lut = synthetic.identity_lut(width, height, f, f, width / 2, height / 2)
    inputs = WindowInputs(
        idx=np.where(valid, ys * width + xs, 0).astype(np.int32), valid=valid,
        is_old=(ts < SPAN / 2) & valid, batch_rel=mid.astype(np.float32),
        knots=knots.astype(np.float32), free=free, fov_rel=np.array([0.0, 0.05], np.float32))
    pano = EquirectCamera(width=W, height=H)
    win = eager_window(inputs, torch.as_tensor(lut), torch.as_tensor(ig, dtype=torch.float32))
    with torch.no_grad():
        box = warp_pano.warp_bbox(torch.zeros(K, 3), win, pano, order).tolist()
    h, pad = 4, 32 + 2 * 4 + 2
    Hc = min(-(-int(box[3] - box[2] + 2 * pad) // 128) * 128, H)
    Wc = min(-(-int(box[1] - box[0] + 2 * pad) // 128) * 128, W)
    x0 = min(max(int(round(0.5 * (box[0] + box[1]) - Wc / 2)), 0), W - Wc)
    y0 = min(max(int(round(0.5 * (box[2] + box[3]) - Hc / 2)), 0), H - Hc)
    crop = np.array([y0, x0, h if y0 > 0 else 0, Hc - (h if y0 + Hc < H else 0),
                     h if x0 > 0 else 0, Wc - (h if x0 + Wc < W else 0)], np.int64)
    dev = torch.device(device)
    return (inputs._replace(crop=crop), torch.as_tensor(lut, device=dev),
            torch.as_tensor(ig, dtype=torch.float32, device=dev), pano, (Hc, Wc))


def eager_window(inputs: WindowInputs, lut, ig) -> warp_pano.PanoWindow:
    """The PanoWindow the host assembled before the program did: the LUT
    gathered on the host's side, each array uploaded on its own."""
    dev = lut.device
    t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return warp_pano.PanoWindow(
        bearings=lut[t(inputs.idx).long()].T.contiguous(),
        batch_times=t(inputs.batch_rel), weights=t(inputs.valid).float(),
        is_old=t(inputs.is_old), knots=t(inputs.knots), free_mask=t(inputs.free),
        t0=0.0, dt_knots=float(np.float32(DT)), ig_prime=ig,
        alpha=torch.zeros((), device=dev))


def _cfg(order, **extra):
    return config.replace(config.SystemConfig(), **{
        "backend.trajectory.spline_degree": 3 if order == 4 else 1,
        "backend.trajectory.dt_knots": DT, "backend.warp.blur_sigma": SIGMA,
        "backend.contrast_measure": MEASURE, **extra}).backend


def _launch(order, crop, inputs, lut, ig, pano, crop_hw):
    if not crop:
        inputs, crop_hw = inputs._replace(crop=None), None
    cfg = _cfg(order, **{"backend.optim.max_line_searches": 2})
    solver = _WindowSolver(cfg, pano, order, 0, 0.0, lut, inputs, crop_hw)
    with torch.no_grad():
        packed = solver.solve(inputs, ig, torch.zeros(ig.shape, dtype=torch.int32,
                                                      device=ig.device)).fetch()
    return solver, packed


# (1) -------------------------------------------------------------------------

@pytest.mark.parametrize("crop", [True, False], ids=["crop", "full"])
@pytest.mark.parametrize("order", [2, 4])
def test_the_prologue_computes_the_eager_constants(order, crop):
    inputs, lut, ig, pano, crop_hw = make_case(2 ** 31 + 25 + order, order, 4000, (64, 40, 60.0),
                                               (128, 256))
    solver, packed = _launch(order, crop, inputs, lut, ig, pano, crop_hw)
    win = eager_window(inputs, lut, ig)
    K = win.knots.shape[0]
    for name in ("bearings", "batch_times", "weights", "is_old", "knots", "free_mask"):
        assert torch.equal(getattr(solver.win, name), getattr(win, name)), name
    seg, coeff = spline.segment_basis(win.batch_times, 0.0, win.dt_knots, K, order)
    assert torch.equal(solver.basis[0], seg) and torch.equal(solver.basis[1], coeff)
    zeros = torch.zeros(1, 3 * K)
    with torch.no_grad():
        if crop:
            # As the harness calls it: host ints, no basis.
            w, x0f, y0f, a_crop, mask, s1, s2 = warp_pano.crop_window_constants(
                win, pano, order, SIGMA, MEASURE, crop_hw, inputs.crop.tolist())
            assert solver.origin.tolist() == [float(inputs.crop[1]), float(inputs.crop[0])]
            for got, want in ((solver.a_crop, a_crop), (solver.mask, mask),
                              (solver.out_s1, s1), (solver.out_s2, s2)):
                assert torch.equal(got, want)
            f, _ = warp_pano.make_crop_objective(w, pano, order, SIGMA, MEASURE, crop_hw, x0f,
                                                 y0f, a_crop, mask, s1, s2)
            alpha = w.alpha
        else:
            # The route the host took before: the vote of warp_to_pano, then alpha.
            il0, _ = warp_pano.pano_objective_image(torch.zeros(K, 3), win, pano, order, SIGMA)
            alpha = warp_pano.compute_alpha(il0, ig)
            f, _ = warp_pano.make_pano_objective(win._replace(alpha=alpha), pano, order, SIGMA,
                                                 MEASURE)
        f0 = float(f(zeros)[0])
    assert float(alpha) > 0 and torch.equal(solver.win.alpha, alpha)
    assert packed[4 * K + 3] == float(alpha)
    assert abs(packed[4 * K] - f0) <= 1e-6 * abs(f0), (packed[4 * K], f0)


# (2) -------------------------------------------------------------------------

def test_every_window_launched_counts_its_preparation_in_the_program(monkeypatch):
    """A 120x90 stream on a 256x512 panorama, 0.8 s: the online windows (the
    bootstrap re-solve after window 4 among them), then a refine pass; the
    counters, by kind, are the back-end programs' launches."""
    width, height, f = 120, 90, 90.0
    calib = CameraCalibration(width=width, height=height,
                              K=np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]]))
    cfg = config.replace(config.ijrr_config(num_events_per_packet=2000), **{
        "frontend.dt_ang_vel": 0.02, "backend.pano_map.pano_height": 256,
        "backend.pano_map.pano_width": 512, "backend.pano_map.backend_min_ev_rate": 1000})
    slam = CMaxSLAM(calib, cfg, device="cpu")
    ev = synthetic.rotating_camera_events(np.random.default_rng(5), 60000, 0.8,
                                          np.array([0.8, -1.1, 1.4]), f, f, width / 2,
                                          height / 2, width, height, n_points=250)
    launched = {"backend.crop": 0, "backend.full": 0}
    run = device_loop.Program.run

    def counted(prog):
        if prog.name in launched:
            launched[prog.name] += 1
        return run(prog)

    monkeypatch.setattr(device_loop.Program, "run", counted)
    for i in range(0, len(ev.ts), 20000):
        slam.push_events(ev.xs[i:i + 20000], ev.ys[i:i + 20000], ev.ts[i:i + 20000],
                         ev.pols[i:i + 20000])
    slam.flush()
    assert slam.backend.bootstrap_results
    slam.backend.refine_pass((ev.xs, ev.ys, ev.ts))
    c = slam.metrics.counters
    assert launched["backend.crop"] > 0
    assert c.get("backend.prep_in_program_crop", 0) == launched["backend.crop"]
    assert c.get("backend.prep_in_program_full", 0) == launched["backend.full"]


# (3) -------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    """Counts the ATen ops dispatched while ``outside`` holds."""

    def __init__(self):
        super().__init__()
        self.n, self.outside = 0, True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += self.outside
        return func(*args, **(kwargs or {}))


def test_the_host_dispatches_a_crop_window_in_few_ops(monkeypatch):
    """The ATen ops Backend._dispatch_window_solve issues outside
    device_loop.Program.run for one ijrr-shaped crop window (240x180, 102 400
    events, 5 knots, order 2, a 256x384 crop of 512x1024), its program
    already built: before the preparation moved into the program, 456 (the
    zero-increment warp op by op, its vote, the blur, alpha, the crop's
    gather, the mask and the stats in warp_pano.crop_window_constants; the
    window's uploads, the LUT gather and the spline basis); now 2, the map
    copies (on the card, one more: the packed upload). At most 60."""
    cfg = config.replace(config.ijrr_config(),
                         **{"backend.optim.max_line_searches": 1}).backend
    width, height, f = 240, 180, 200.0
    lut = synthetic.identity_lut(width, height, f, f, width / 2, height / 2)
    be = Backend(width, height, lut, cfg, EventStore(), device="cpu")
    be.traj = spline.Trajectory(0.0, DT, 2)
    be.traj.push_ctrl_poses(_quats(np.outer(DT * np.arange(8), OMEGA)))
    be.t_win_beg, be.t_win_end = 0.0, SPAN
    rng = np.random.default_rng(7)
    n = 102_400
    xs, ys = rng.integers(0, width, n), rng.integers(0, height, n)
    ts = np.sort(rng.uniform(0.0, SPAN, n))
    mode = _CountOps()
    run = device_loop.Program.run

    def uncounted(prog):
        mode.outside = False
        try:
            return run(prog)
        finally:
            mode.outside = True

    monkeypatch.setattr(device_loop.Program, "run", uncounted)
    be._dispatch_window_solve(xs, ys, ts, 0, 1)  # builds the window's program
    with mode:
        p = be._dispatch_window_solve(xs, ys, ts, 0, 1)
    assert p["plan"] is not None and p["K"] == 5
    assert mode.n <= 60, mode.n


# (4) -------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager_dispatch(inputs, lut, ig, pano, order, crop_hw):
    """The host's route before: the window's uploads and LUT gather, then
    crop_window_constants with the zero-increment image of warp_to_pano
    and the vote (K1), op by op."""
    win = eager_window(inputs, lut, ig)
    route = warp_pano.pano_vote
    warp_pano.pano_vote = warp_pano.pano_vote_composed
    try:
        return warp_pano.crop_window_constants(win, pano, order, SIGMA, MEASURE, crop_hw,
                                               torch.as_tensor(inputs.crop, device=lut.device))
    finally:
        warp_pano.pano_vote = route


def _timed(fn, reps):
    """(host ms, device ms) per call of ``fn``: perf_counter around each
    call, CUDA events around the same call; a Result ``fn`` returns is
    fetched after its call's clocks stop, as the next window's dispatch
    finds it fetched. After one call to warm up."""
    device_loop.fetch_all([r for r in [fn()] if r is not None])
    host = dev = 0.0
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        r = fn()
        host += time.perf_counter() - t0
        b.record()
        if r is not None:
            r.fetch()
        b.synchronize()
        dev += a.elapsed_time(b)
    return 1e3 * host / reps, dev / reps


@pytest.mark.card
@pytest.mark.parametrize("shape", ["ijrr", "ecrot"])
def test_the_prologue_matches_the_eager_constants_on_the_card(card, shape):
    """Alpha within 1e-5 relative (K4's image against warp_to_pano and K1's:
    alpha is a ratio of two sums over it), the mask exact, a_crop exactly
    the program's alpha times the blurred map's crop (and within 1e-5 of the
    eager one, by alpha), the stats within 1e-5 relative."""
    slots, camera, pano_hw = {"ijrr": (102_400, (240, 180, 200.0), (512, 1024)),
                              "ecrot": (1_048_600, (640, 480, 335.0), (2048, 4096))}[shape]
    inputs, lut, ig, pano, crop_hw = make_case(2 ** 31 + 77, 2, slots, camera, pano_hw, card)
    solver, packed = _launch(2, True, inputs, lut, ig, pano, crop_hw)
    with torch.no_grad():
        w, _, _, a_crop, mask, s1, s2 = _eager_dispatch(inputs, lut, ig, pano, 2, crop_hw)
        y0, x0 = (int(v) for v in inputs.crop[:2])
        blurred = warp_pano.gaussian_blur(ig, SIGMA)
        own = (solver.win.alpha * blurred)[y0:y0 + crop_hw[0], x0:x0 + crop_hw[1]]
    K = len(inputs.knots)
    alpha = float(w.alpha)

    def rel(got, want):
        return abs(float(got) - float(want)) / abs(float(want))

    errs = {"alpha": rel(solver.win.alpha, alpha), "packed_alpha": rel(packed[4 * K + 3], alpha),
            "a_crop": float(((solver.a_crop - a_crop).abs().max() / a_crop.abs().max())),
            "s1": rel(solver.out_s1, s1), "s2": rel(solver.out_s2, s2)}
    print(f"\n{shape}: {slots} slots, crop {crop_hw[0]}x{crop_hw[1]} of "
          f"{pano_hw[0]}x{pano_hw[1]}, alpha {alpha:.8g}; relative errors {errs}")
    assert all(v <= 1e-5 for v in errs.values()), errs
    assert torch.equal(solver.mask, mask) and torch.equal(solver.a_crop, own)

    upd = torch.zeros(ig.shape, dtype=torch.int32, device=card)

    def before():
        with torch.no_grad():
            _eager_dispatch(inputs, lut, ig, pano, 2, crop_hw)

    def load():
        solver.load(inputs, ig, upd)

    def after():
        solver.load(inputs, ig, upd)
        return solver.program.run()

    b_host, b_dev = _timed(before, 20)
    l_host, l_dev = _timed(load, 20)
    a_host, a_dev = _timed(after, 5)
    print(f"{shape}: host ms per window: before (eager window and constants) {b_host:.3f}, "
          f"after (load {l_host:.3f}, load and launch {a_host:.3f}); device ms: eager window "
          f"and constants {b_dev:.3f}, load {l_dev:.3f}, load and the whole program "
          f"{a_dev:.3f}; {torch.cuda.get_device_name(0)}")
