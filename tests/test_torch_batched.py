"""Throughput-mode batched tracking in the port (cmax_slam_tpu_torch/
parallel/batched.py) against the JAX package's (cmax_slam_tpu/parallel/
batched.py) on tests/test_batched.py's stream: the packet cut, the bucket
ladder, the lockstep and compacted trackers, and the device-list split.

Tolerances: the packet cut is the same numpy arithmetic (atol 1e-7, times
exact). The trackers take the same CG decisions on CMax objectives whose
float32 values differ by summation order between the packages (rtol
~1e-6). Most lanes then end within 1e-5 rad/s of JAX's, but a near-tie in a
bracket or secant comparison occasionally flips, which moves that lane by
a line search or two, and the warm-start sweep carries the moved solution
to its right neighbour: on this stream 3 of 17 lockstep lanes end 0.011 to
0.045 rad/s from JAX's with 1 or 2 line searches more. So the JAX
comparisons hold the median lane to 1e-3 rad/s, every lane to 0.06 rad/s
(the per-packet tolerance between the two sequential front-ends,
tests/test_torch_slice.py) and iterations to within two; the 1e-2 rad/s,
one-iteration tolerance of tests/test_batched.py (between bucket widths in
one package) holds for the port's device-list splits against no list.
"""

import numpy as np
import pytest
import torch

from cmax_slam_tpu.config import FrontendConfig as JFrontendConfig, WarpOptions as JWarp
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu.ops.warp_local import CameraParams as JCameraParams
from cmax_slam_tpu.parallel import batched as jbatched
from cmax_slam_tpu_torch.config import FrontendConfig, WarpOptions
from cmax_slam_tpu_torch.ops.warp_local import CameraParams
from cmax_slam_tpu_torch.parallel import batched

torch.set_num_threads(1)

W, H = 120, 90
# Focal length and bearings exact in float32 (tests/test_torch_objectives.py):
# at the cold start omega = 0 every event then warps to exactly its integer
# pixel in both frameworks. With unit bearings XLA's fused multiply-add puts
# ~2% of them on the other side of the integer, which flips their one-sided
# derivative and sends the cold solves of the two packages down different
# paths (the accepted cold-start rounding of ROADMAP Queue 3).
FX = FY = 64.0
JCAM = JCameraParams(fx=FX, fy=FY, cx=W / 2, cy=H / 2, width=W, height=H)
CAM = CameraParams(*JCAM)
_XS, _YS = np.meshgrid(np.arange(W), np.arange(H))
LUT = np.stack([((_XS - W / 2) / FX).ravel(), ((_YS - H / 2) / FY).ravel(),
                np.ones(W * H)], axis=-1).astype(np.float32)
KW = dict(num_events_per_packet=4096, dt_ang_vel=0.02)
JCFG = JFrontendConfig(warp=JWarp(blur_sigma=1.0, event_batch_size=128), **KW)
CFG = FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=128), **KW)
MAX_LS = CFG.optim.max_line_searches


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(9)
    omega = np.array([0.8, -1.1, 1.7])
    ev = synthetic.rotating_camera_events(
        rng, 40000, 0.36, omega, FX, FY, W / 2, H / 2, W, H, n_points=220)
    return ev, omega


@pytest.fixture(scope="module")
def batches(stream):
    ev, _ = stream
    return (jbatched.cut_packets(ev.xs, ev.ys, ev.ts, LUT, JCAM, JCFG),
            batched.cut_packets(ev.xs, ev.ys, ev.ts, LUT, CAM, CFG, device="cpu"))


@pytest.fixture(scope="module")
def compacted(batches):
    """The port's compacted tracker with no device list (the reference run)."""
    return batched.track_batched_compacted(batches[1], CAM, CFG, sweeps=2)


def _agree(ours, theirs):
    _, om, _, it = ours
    _, om_ref, _, it_ref = theirs
    np.testing.assert_allclose(om, om_ref, atol=1e-2)
    assert np.abs(it.astype(int) - np.asarray(it_ref).astype(int)).max() <= 1


def _agree_with_jax(ours, theirs):
    _, om, _, it = ours
    _, om_ref, _, it_ref = theirs
    d = np.linalg.norm(om - np.asarray(om_ref), axis=1)
    assert np.median(d) < 1e-3 and d.max() < 0.06, np.round(d, 4)
    assert np.abs(it.astype(int) - np.asarray(it_ref).astype(int)).max() <= 2


def _median_err(res, omega):
    return float(np.median(np.linalg.norm(res[1] - omega, axis=1)))


def test_cut_packets_matches_jax(batches):
    jb, tb = batches
    assert tb.bearings.shape == jb.bearings.shape and tb.bearings.shape[0] >= 10
    for name in ("bearings", "dts", "weights"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   atol=1e-7, rtol=0, err_msg=name)
    np.testing.assert_array_equal(tb.times, jb.times)
    # padding rays are the optical axis, never zeros (1/rz stays finite)
    pad = tb.weights == 0
    assert pad.any() and torch.all(tb.bearings[pad] == torch.tensor([0.0, 0.0, 1.0]))


def test_quantize_bucket_matches_jax():
    for n in range(1, 301):
        for mb in (8, 32):
            assert batched._quantize_bucket(n, mb) == jbatched._quantize_bucket(n, mb)


def test_track_batched_matches_jax(stream, batches):
    ev, omega = stream
    jb, tb = batches
    ours = batched.track_batched(tb, CAM, CFG)
    _agree_with_jax(ours, jbatched.track_batched(jb, JCAM, JCFG))
    assert _median_err(ours, omega) < 0.2
    np.testing.assert_array_equal(ours[0], jb.times)


def test_track_batched_compacted_matches_jax(stream, batches, compacted):
    ev, omega = stream
    _agree_with_jax(compacted,
                    jbatched.track_batched_compacted(batches[0], JCAM, JCFG, sweeps=2))
    assert _median_err(compacted, omega) < 0.2
    its = compacted[3]
    assert its.max() <= MAX_LS and np.all(its > 0)


@pytest.mark.parametrize("n_dev", [8, 6])
def test_compacted_on_a_device_list_matches_no_list(stream, batches, compacted, n_dev):
    """Survivors compacted globally and split evenly over n_dev devices (the
    bucket rounded up to a multiple of n_dev: 28 lanes -> 30 on 6)."""
    ev, omega = stream
    res = batched.track_batched_compacted(batches[1], CAM, CFG, sweeps=2,
                                          devices=["cpu"] * n_dev)
    _agree(res, compacted)
    assert _median_err(res, omega) < 0.2
    assert res[3].max() <= MAX_LS


def test_lockstep_on_a_device_list_matches_no_list(stream, batches):
    ev, omega = stream
    tb = batches[1]
    Pn = (tb.bearings.shape[0] // 8) * 8
    tb8 = batched.PacketBatch(tb.bearings[:Pn], tb.dts[:Pn], tb.weights[:Pn], tb.times[:Pn])
    one = batched.track_batched(tb8, CAM, CFG, sweeps=1)
    res = batched.track_batched(tb8, CAM, CFG, devices=["cpu"] * 8, sweeps=1)
    _agree(res, one)
    assert _median_err(res, omega) < 0.2
    with pytest.raises(ValueError, match="divisible"):
        batched.track_batched(batched.PacketBatch(tb.bearings[:Pn - 1], tb.dts[:Pn - 1],
                                                  tb.weights[:Pn - 1], tb.times[:Pn - 1]),
                              CAM, CFG, devices=["cpu"] * 8)
