"""The cubic cell (``ecrot-cubic.replay``): the program's order-4 back-end
on the CPU at the tiny cell's size, and on the card at the cell's own size
one window of the run (2^20 events, a crop of 2048x4096, order 4) held
against the plain reference (pb/spline_reference.py, float64, computed in
blocks), K4/K5 timed on that window's own operands, and the comparison that
decides ``correct`` failing the control and both frozen solves. Run the card
tests from the checkout's root with

    python -m pytest portbench/test_pb_cubic.py -m card -s
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb import cell, control, harness, roofline, spline_reference, stream
from pb.drivers import replay

CELL = "ecrot-cubic.replay"
SEED = 2 ** 31 + 4343

# The window's objective on the card against the float64 reference, on an
# H100 with seed SEED, in two runs (the votes' float32 atomics sum in another
# order each run): value within 4.6e-7 and 2.1e-6 (relative), gradient within
# 5.0e-4 and 5.2e-4 of its largest component; the reference in bfloat16 read
# 0.82 and 1.93. The
# gradient's tolerance also holds what a few floor flips cost: the vote's
# derivative is one-sided in the floor, the window's events sit on a few
# thousand landmarks, so the image is sharp and the gradient's terms cancel,
# and an event whose float32 coordinate lies across a pixel edge from its
# float64 one takes the other side's derivative. On the tiny replay cell 6
# such events of 16 343 moved the gradient by 1.8% of its largest component,
# and the float64 reference itself moved by 2.2% when 1e-6 rad of increments
# flipped 14. So 1e-5 and 2e-2: more than 20 times the card's readings, and
# bfloat16 (or a NaN, where its asin meets +-1) misses both by 40 times or more.
VALUE_RTOL, GRAD_RTOL = 1e-5, 2e-2


def test_the_cubic_back_end_is_correct_on_the_tiny_cell(tiny_root):
    """The tiny replay cell with the cubic back-end (spline_degree 3): every
    number of the comparison within the cell's limits."""
    line = harness.run("tiny.replay", SEED, 1.0, False, "cpu", root=tiny_root,
                       overrides={"backend.trajectory.spline_degree": 3})
    assert line["correct"] is True, line["checks"]


def test_the_reference_imports_nothing_of_the_program():
    """pb/spline_reference.py loads no module the benchmark forbids (JAX, the
    JAX package) and nothing of the port, in a process of its own."""
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; import pb.spline_reference; "
            "from pb import harness; print(harness.forbidden_modules(), "
            "sorted(m for m in sys.modules if m.startswith('cmax_slam_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code, str(cell.BENCH_DIR), str(cell.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[] []"

def _errors(value, grad, ref_value, ref_grad):
    return (abs(value - ref_value) / abs(ref_value),
            float(np.abs(grad - ref_grad).max() / np.abs(ref_grad).max()))


def _reference(solver, p, st, width, lut, cfg, traj, dtype=torch.float64):
    """The reference's window from the stream's raw events of the window
    ``p`` (the back-end's record of its launch), its starting knots and free
    mask, and the map it started from, as the window program holds them."""
    g0 = st.index(p["t_beg"])
    n = int((solver.win.weights > 0).sum())
    xs, ys, ts, _ = st.slice(g0, g0 + n)
    bearings = np.asarray(lut, np.float64)[ys.astype(np.int64) * width + xs]
    return spline_reference.Window(
        bearings, ts, solver.win.knots.cpu().numpy(), solver.win.free_mask.cpu().numpy(),
        traj.knot_time(p["idx_cp_traj_beg"]), cfg.trajectory.dt_knots, solver.order,
        cfg.warp.event_batch_size, solver.ig_in.cpu().numpy(), cfg.warp.blur_sigma,
        device=solver.win.weights.device, dtype=dtype)


def _device_us(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` launches between CUDA events."""
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


@pytest.mark.card
def test_a_cubic_window_matches_the_reference_at_the_cells_size(card):
    """A crop window of the cell's run as its window program holds it (the
    2^20-event bucket, a crop of 2048x4096, order 4; its buffers keep the
    last window launched): the program's own crop objective (K4/K5) at
    seeded increments against the reference computed in blocks from the
    window's raw events, value and gradient; then K4's image and K5's
    gradient on the buffers' operands against the reference's, and their
    device time beside the bound of their bytes. Prints one JSON line of the
    numbers."""
    from cmax_slam_tpu_torch.ops import cuda_pano_vote

    spec = cell.spec(cell.benchmark(), CELL)
    sensor, cfg, slam = replay._system(spec, card)
    st = stream.make_stream(sensor, spec["traffic"], SEED, card)
    hz = float(spec["traffic"]["push_hz"])
    be, lut = slam.backend, slam.frontend.lut.cpu().numpy()
    assert be.order == 4
    # The first window launched on a crop after a second of stream (the map
    # then holds the windows before it); it completes at the flush.
    p, k = None, 0
    while p is None and k < math.ceil(st.period * hz):
        slam.push_events(*st.slice(*st.push_bounds(k, hz)))
        k += 1
        pend = be._pending_win
        if k >= hz and pend is not None and pend["plan"] is not None:
            p = pend
    assert p is not None, "no crop window in a period"
    slam.flush()
    solver = p["solver"]
    win, (Hc, Wc) = solver.win, solver.a_crop.shape
    N, K = win.weights.shape[0], win.knots.shape[0]
    assert N == 10486 * 100 and K == 7
    ref = _reference(solver, p, st, sensor.width, lut, cfg.backend, be.traj)
    # The raw events are the program's: its live slots hold their bearings.
    n = ref.n
    assert torch.equal(win.bearings[:, :n].cpu(), torch.as_tensor(ref.b.T.float().cpu()))
    assert abs(float(win.alpha) - float(ref.alpha)) <= 1e-5 * float(ref.alpha)
    x = torch.as_tensor(1e-3 * np.random.default_rng(SEED).standard_normal((1, 3 * K)),
                        dtype=torch.float32, device=card)
    v, g = solver.cg.vg(x)
    rv, rg = ref.value_grad(x.reshape(K, 3))
    ev, eg = _errors(float(v), g.double().cpu().numpy().reshape(K, 3), rv, rg)
    low = _reference(solver, p, st, sensor.width, lut, cfg.backend, be.traj, torch.bfloat16)
    lv, lg = low.value_grad(x.reshape(K, 3))
    lev, leg = _errors(lv, lg, rv, rg)

    # K4 and K5 on the buffers' operands, against the reference's image and
    # the votes' adjoint on the crop.
    ops = cuda_pano_vote.prepare(x.reshape(1, K, 3), win, solver.basis, be.pano, 4,
                                 solver.origin)
    x0, y0 = (int(c) for c in solver.origin.cpu())
    out = torch.zeros((1, Hc, Wc), device=card)

    def k4():
        out.zero_()
        cuda_pano_vote.launch_fwd(ops, out, Hc, Wc)

    k4_us = _device_us(k4)
    with torch.no_grad():
        il = ref.votes(ref._x(x.reshape(K, 3)))
    il_crop = il[y0:y0 + Hc, x0:x0 + Wc]
    assert torch.count_nonzero(il) == torch.count_nonzero(il_crop)  # every vote in the crop
    k4_err = float((out[0].double() - il_crop).abs().max())
    gimg = torch.randn((1, Hc, Wc), generator=torch.Generator(card).manual_seed(7), device=card)
    part = cuda_pano_vote.bwd_scratch(ops)
    dx = torch.empty_like(ops.delta)

    def k5():
        cuda_pano_vote.launch_bwd(ops, gimg, part, dx)

    k5_us = _device_us(k5)
    g_full = torch.zeros_like(il)
    g_full[y0:y0 + Hc, x0:x0 + Wc] = gimg[0].double()
    k5_ref = ref.adjoint(x.reshape(K, 3), g_full)
    k5_err = float(np.abs(dx[0].double().cpu().numpy() - k5_ref).max())
    peak = roofline.peaks(torch.cuda.get_device_name(0))
    B = ops.seg.shape[0]
    nbytes = 16 * N + B * 4 * (1 + ops.order) + 32 * K + 4 * Hc * Wc
    bound_us = 1e6 * nbytes / peak["bytes_per_s"]
    print(json.dumps({
        "cubic_window": {"window": p["index"], "events": n, "slots": N, "crop": [Hc, Wc],
                         "value_rel_err": ev, "grad_rel_err": eg, "bf16_value_rel_err": lev,
                         "bf16_grad_rel_err": leg, "k4_us": k4_us, "k5_us": k5_us,
                         "bound_us": bound_us, "k4_share_pct": 100 * bound_us / k4_us,
                         "k5_share_pct": 100 * bound_us / k5_us,
                         "k4_max_abs_err": k4_err, "k4_image_max": float(il_crop.max()),
                         "k5_max_abs_err": k5_err, "k5_scale": float(np.abs(k5_ref).max())}}))
    assert ev < VALUE_RTOL and eg < GRAD_RTOL, (ev, eg)
    assert not (lev <= 10 * VALUE_RTOL or leg <= 10 * GRAD_RTOL), (lev, leg)  # NaN misses
    # Against float64 the kernels' float32 coordinates move each vote's
    # bilinear weights (an error of ~5e-4 px moves a pixel of ~10^2 votes by
    # ~1e-2) and, for K5 against a noise image, flip a few floors: on the card
    # K4 read 4.1e-5 and 5.9e-5 of the largest pixel and K5 2.4e-3 and 2.2e-3
    # of the largest component (their plain versions on the tiny cell 7.5e-5
    # and 4.1e-4).
    # So 1e-3 and 1e-2.
    assert k4_err <= 1e-3 * float(il_crop.max())
    assert k5_err <= 1e-2 * float(np.abs(k5_ref).max())


@pytest.mark.card
def test_the_control_is_not_correct_at_the_cubic_cells_size(card):
    keep = {}
    line = harness.run(CELL, SEED, 3.0, False, card, keep=keep)
    assert line["correct"] is True, line["checks"]
    low = control.readings(keep["spec"], keep["rec"], card)
    assert not harness.correct(harness.judged(keep["spec"]["limits"], low))


@pytest.mark.card
@pytest.mark.parametrize("fault", ["frontend_frozen", "backend_frozen"])
def test_a_frozen_solve_is_not_correct_at_the_cubic_cells_size(card, fault):
    line = harness.run(CELL, SEED + 1, 3.0, False, card, overrides=control.FAULTS[fault])
    assert line["correct"] is False, line["checks"]
