"""The harness on the CPU at tiny sizes: the modules a run loads, the tiled
stream's truth, the roofline's work, cells and metrics found by name, and
each driver's result line."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb import harness, reference, roofline, stream


def test_forbidden_names_are_whole_top_level_names():
    names = ["cmax_slam_tpu_torch", "cmax_slam_tpu_torch.ops.device_loop", "jaxtyping",
             "testsuite", "pb.reference", "chip_smoke_x", "tests.conftest", "jax.numpy",
             "jaxlib", "flax.linen", "cmax_slam_tpu", "cmax_slam_tpu.ops", "chip_smoke"]
    assert harness.forbidden_modules(names) == [
        "chip_smoke", "cmax_slam_tpu", "cmax_slam_tpu.ops", "flax.linen", "jax.numpy",
        "jaxlib", "tests.conftest"]


RUN = """
import json, sys, time
t0 = time.perf_counter()
root, bench_dir, repo = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [bench_dir, repo]
import torch
torch.set_num_threads(2)
from pathlib import Path
from pb import harness
line = harness.run(sys.argv[4], int(sys.argv[5]), float(sys.argv[6]), False, "cpu",
                   t_start=t0, root=Path(root))
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "keys": list(line)}))
print(json.dumps(line))
"""


@pytest.mark.parametrize("workload", ["tiny.replay", "tiny.batched"])
def test_each_driver_prints_the_contract_line(tiny_root, workload):
    """A tiny cell added as files only runs end to end in a process of its
    own: its line has the contract's keys with ``checks`` last, the metric
    read by a file added beside the others, and no forbidden module."""
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(tiny_root), str(tiny_root / "portbench"),
         str(harness.cell.ROOT), workload, str(2 ** 31 + 12345), "1.5"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    meta, line = (json.loads(s) for s in out.stdout.strip().splitlines()[-2:])
    assert meta["forbidden"] == []
    assert meta["keys"][:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert meta["keys"][-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) >= {"realtime_factor", "setup_s", "tiny.attempted"}
    assert line["metrics"]["tiny.attempted"]["value"] == line["attempted"] > 0
    assert ("window_latency_p95_ms" in line["metrics"]) == (workload == "tiny.replay")
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_tiled_truth_holds_across_the_seams():
    """Each event near a period's seam, on either side, is the projection at
    its tiled time through exp(omega t) of some landmark, to the pixel's
    rounding."""
    sensor = stream.Sensor(120, 90, 90.0, 90.0, 60.0, 45.0)
    traffic = {"omega": [0.9, -1.3, 1.9], "rate": 20000, "landmarks": 200,
               "landmarks_seed": 5, "margin": 3}
    st = stream.make_stream(sensor, traffic, 2 ** 31 + 7, "cpu")
    assert st.n == round(20000 * st.period)
    for seam in (1, 2):
        g = seam * st.n
        xs, ys, ts, _ = st.slice(g - 200, g + 200)
        assert np.all(np.diff(ts) >= 0) and ts[199] < seam * st.period <= ts[200]
        k, speed = stream.axis_angle(st.omega)
        rays = stream.world_to_camera(
            torch.as_tensor(k), torch.as_tensor(ts * speed)[:, None].expand(-1, 200).reshape(-1),
            torch.as_tensor(st.landmarks).repeat(len(ts), 1)).reshape(len(ts), 200, 3).numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            u = sensor.fx * rays[..., 0] / rays[..., 2] + sensor.cx
            v = sensor.fy * rays[..., 1] / rays[..., 2] + sensor.cy
        d = np.where(rays[..., 2] > 0.1, np.hypot(u - xs[:, None], v - ys[:, None]), np.inf)
        assert d.min(axis=1).max() <= math.sqrt(0.5) + 1e-6


def test_roofline_work_depends_on_shapes_alone():
    a = roofline.packet_objective_work(10000, 180, 240)
    assert a == roofline.packet_objective_work(10000, 180, 240)
    assert a["bytes"] == 12 * 10000 + 12 * 10000 + 16
    big = roofline.packet_objective_work(200000, 480, 640)
    assert big["bytes"] == 12 * 200000 + 12 * 200000 + 16
    assert roofline.packet_objective_work(400000, 480, 640)["bytes"] == (
        12 * 400000 + 12 * 480 * 640 + 16)
    w = roofline.window_objective_work(102400, 5, 384, 384, 43200)
    assert w["bytes"] == 12 * 102400 + 12 * 43200 + 16 * 5 + 8 * 384 * 384 + 4 * 16
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.share_pct(a, peak, None) is None
    assert roofline.share_pct(a, None, 1e-3) is None
    assert roofline.share_pct(a, peak, roofline.bound_s(a, peak)) == pytest.approx(100.0)


def test_reference_pieces():
    """The blur keeps a constant image, the vote keeps every kept event's
    unit of mass, the gauge alignment removes a fixed rotation, and the map
    numbers read 0 for mass on the landmarks."""
    img = torch.full((9, 12), 3.0, dtype=torch.float64)
    assert torch.allclose(reference.blur(img, 1.0), img)
    px = torch.tensor([2.3, 5.7, 0.5, 10.2], dtype=torch.float64)
    py = torch.tensor([3.1, 4.9, 4.0, 4.0], dtype=torch.float64)
    assert float(reference.vote(px, py, 9, 12).sum()) == pytest.approx(2.0)
    t = np.linspace(0, 3, 50)
    q = reference.truth_quats([0.9, -1.3, 1.9], t)
    g = reference.truth_quats([0.3, 0.2, -0.1], np.ones(1))[0]
    w1, v1 = g[0], g[1:]
    q2 = np.array([[w1 * w - v1 @ v, *(w1 * v + w * v1 + np.cross(v1, v))]
                   for w, v in zip(q[:, 0], q[:, 1:])])
    assert reference.rms_deg(q, q2)[0] < 1e-9
    H, W = 64, 128
    iy, ix = torch.tensor([10, 40]), torch.tensor([20, 100])
    land = reference.pixel_rays(ix, iy, H, W).numpy()
    image = np.zeros((H, W))
    image[10, 20] = image[40, 100] = 1.0
    nums = reference.map_numbers(image, land, "cpu")
    assert nums["map_offset_px"] < 1e-6 and nums["map_far_share"] == 0.0
    image[30, 60] = 2.0
    assert reference.map_numbers(image, land, "cpu")["map_far_share"] == pytest.approx(0.5)


def test_the_window_objective_is_rebuilt_from_public_state(tiny_root):
    """The back-end crop objective that the window roofline times is rebuilt
    from a finished window's public fields, the stream and the map: it
    evaluates to a finite value and gradient, and its work counts the
    window's events."""
    from pb import cell
    from pb.drivers import replay

    spec = cell.spec(cell.benchmark(tiny_root), "tiny.replay", tiny_root)
    sensor, _, slam = replay._system(spec, "cpu")
    st = stream.make_stream(sensor, spec["traffic"], 2 ** 31 + 99, "cpu")
    for k in range(int(st.period * 30)):
        slam.push_events(*st.slice(*st.push_bounds(k, 30.0)))
    be = slam.backend
    r = next(r for r in reversed(be.results) if r.ran_ba)
    built = harness.window_objective(be, st, sensor, r, slam.frontend.lut)
    assert built is not None
    vg, x, work, info = built
    value, grad = vg(x)
    assert torch.isfinite(value).all() and torch.isfinite(grad).all()
    assert grad.shape == x.shape and float(grad.abs().sum()) > 0
    assert info["events"] == st.index(r.t_end) - st.index(r.t_beg) > 0
    Hc, Wc = info["crop"]
    assert work == roofline.window_objective_work(info["events"], x.shape[1] // 3, Hc, Wc,
                                                  sensor.width * sensor.height)
