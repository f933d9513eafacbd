"""The front-end's schedules (frontend.device_store and frontend.batch_sweeps):
packets gathered from the device ring or from the host store; batch_sweeps
is accepted and changes nothing in the port. Every schedule runs the same
operations in the same order, so on the CPU their estimates are equal, bit
for bit; against the JAX front-end with its defaults (ring and stride
solver) they agree to the resolution of the solve
(tests/test_torch_slice.py's tolerance)."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu.config import FrontendConfig as JFrontendConfig, WarpOptions as JWarp
from cmax_slam_tpu.frontend import Frontend as JFrontend
from cmax_slam_tpu.ops.warp_local import CameraParams as JCameraParams
from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import FrontendConfig, SystemConfig, WarpOptions
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops.warp_local import CameraParams
from cmax_slam_tpu_torch.system import CMaxSLAM

torch.set_num_threads(1)

W, H, F = 120, 90, 90.0
N, CHUNK = 40_000, 10_000
OMEGA_MAX, OMEGA_MEDIAN = 0.06, 0.01
LUT = synthetic.identity_lut(W, H, F, F, W / 2, H / 2)
CAM = (F, F, W / 2, H / 2, W, H)
KW = dict(num_events_per_packet=4000, dt_ang_vel=0.02)
SCHEDULES = {"ring-stride": (True, 2), "ring-packet": (True, 0), "host-stride": (False, 2)}


def _cfg(device_store, batch_sweeps, **kw):
    return FrontendConfig(warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
                          device_store=device_store, batch_sweeps=batch_sweeps, **KW, **kw)


def _stream(seed=0, duration=0.3, gap_at=None):
    ev = synthetic.rotating_camera_events(np.random.default_rng(seed), N, duration,
                                          np.array([0.9, -1.4, 2.0]), F, F, W / 2, H / 2, W,
                                          H, n_points=250)
    ts = ev.ts.copy()
    if gap_at is not None:  # 0.3 s without events: the packets across it are degenerate
        ts[np.searchsorted(ts, gap_at):] += 0.3
    return ev.xs, ev.ys, ts, ev.pols


def _run(cfg, ev, cuts=range(CHUNK, N, CHUNK)):
    fe = Frontend(CameraParams(*CAM), LUT, cfg, device="cpu")
    edges = [0, *cuts, len(ev[2])]
    for a, b in zip(edges[:-1], edges[1:]):
        fe.push_events(*(x[a:b] for x in ev))
    return fe


def _omegas(fe):
    return np.array([e.omega for e in fe.estimates])


@pytest.fixture(scope="module")
def runs():
    ev = _stream()
    out = {name: _run(_cfg(*sched), ev) for name, sched in SCHEDULES.items()}
    out["host-packet"] = _run(_cfg(False, 0), ev)
    return ev, out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_give_identical_estimates(runs, name):
    _, out = runs
    base, fe = out["host-packet"], out[name]
    assert len(fe.estimates) == len(base.estimates) >= 10
    np.testing.assert_array_equal(_omegas(fe), _omegas(base))
    assert [(e.t, e.span, e.cost, e.iters) for e in fe.estimates] == \
        [(e.t, e.span, e.cost, e.iters) for e in base.estimates]
    np.testing.assert_array_equal(fe.omega, base.omega)
    c, live = fe.metrics.counters, len(fe.estimates)
    assert c["frontend.events"] == base.metrics.counters["frontend.events"]
    device_store, _ = SCHEDULES[name]
    assert c.get("frontend.ring_packets", 0) == (live if device_store else 0)
    assert "frontend.ring_packets" not in base.metrics.counters


def test_stock_schedule_matches_jax(runs):
    """Against the JAX front-end with its defaults: ring and stride solver."""
    ev, out = runs
    jcfg = JFrontendConfig(warp=JWarp(blur_sigma=1.0, event_batch_size=100), **KW)
    assert jcfg.device_store and jcfg.batch_sweeps > 0
    fe_j = JFrontend(JCameraParams(*CAM), LUT, jcfg)
    for i in range(0, N, CHUNK):
        fe_j.push_events(*(x[i:i + CHUNK] for x in ev))
    fe_j.finalize_batch(fe_j.estimates)
    fe_t = out["ring-stride"]
    t_j = np.array([e.t for e in fe_j.estimates])
    np.testing.assert_allclose([e.t for e in fe_t.estimates], t_j, atol=1e-9)
    err = np.linalg.norm(_omegas(fe_t) - np.array([e.omega for e in fe_j.estimates]), axis=1)
    assert err.max() < OMEGA_MAX and np.median(err) < OMEGA_MEDIAN, np.round(err, 4)


def test_small_capacity_takes_the_host_path(runs):
    """A ring of 4096 events is lapped before most packets are solved: those
    packets are gathered from the host store, with the same estimates."""
    ev, out = runs
    fe = _run(_cfg(True, 2, device_store_capacity=4096), ev)
    assert fe._ring.capacity == 4096
    assert fe.metrics.counters.get("frontend.ring_packets", 0) < len(fe.estimates) // 2
    np.testing.assert_array_equal(_omegas(fe), _omegas(out["host-packet"]))
    # a ring out of step with the store is never read
    fe = Frontend(CameraParams(*CAM), LUT, _cfg(True, 0), device="cpu")
    fe.push_events(*(x[:N - CHUNK] for x in ev))
    fe._ring.hi -= 1
    solved, before = len(fe.estimates), fe.metrics.counters["frontend.ring_packets"]
    fe.push_events(*(x[N - CHUNK:] for x in ev))
    assert len(fe.estimates) > solved
    assert fe.metrics.counters["frontend.ring_packets"] == before
    np.testing.assert_array_equal(_omegas(fe), _omegas(out["host-packet"]))


@pytest.mark.parametrize("cuts,where", [((10_000, 19_000, 22_500), "end"),
                                        ((10_000, 19_000, 26_000), "inside")])
def test_degenerate_lanes(cuts, where):
    """Packets across a 0.3 s gap are degenerate: omega 0 and the warm start
    reset to zero, as the last packet of a push (the next push starts from
    zero) and between live packets of one push (the next live packet starts
    from zero)."""
    ev = _stream(seed=1, duration=0.4, gap_at=0.2)
    fe = Frontend(CameraParams(*CAM), LUT, _cfg(True, 2), device="cpu")
    pushes, omegas = [], []
    edges = [0, *cuts, N]
    for a, b in zip(edges[:-1], edges[1:]):
        ests = fe.push_events(*(x[a:b] for x in ev))
        pushes.append([bool(np.any(e.omega != 0)) for e in ests])
        omegas.append(fe.omega)
    if where == "end":
        k = next(i for i, s in enumerate(pushes) if len(s) > 1 and s[0] and not s[-1])
        np.testing.assert_array_equal(omegas[k], np.zeros(3))
    else:
        assert any(len(s) > 2 and s[0] and s[-1] and not all(s) for s in pushes), pushes
    ref = _run(_cfg(False, 0), ev, cuts)
    np.testing.assert_array_equal(_omegas(fe), _omegas(ref))
    dead = [np.all(e.omega == 0) and e.iters == 0 for e in fe.estimates]
    assert sum(dead) >= 10 and not all(dead)


def test_resync_on_restore(tmp_path):
    """A checkpoint between pushes, restored into a fresh system whose ring
    is rebuilt from the restored store: the packets after it, which reach
    back before the cut, are gathered from the ring and give the
    uninterrupted run's estimates."""
    ev = _stream(seed=3)
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]]))
    cfg = SystemConfig(frontend=_cfg(True, 2))

    def system():
        return CMaxSLAM(calib, cfg, device="cpu", run_backend=False)

    a = system()
    for i in range(0, N, CHUNK // 2):
        a.push_events(*(x[i:i + CHUNK // 2] for x in ev))
    cut = 3 * CHUNK // 2 + 1234
    b = system()
    b.push_events(*(x[:cut] for x in ev))
    assert b.frontend._pending
    path = str(tmp_path / "cut.npz")
    b.save_checkpoint(path)
    c = system()
    c.load_checkpoint(path)
    ring = c.frontend._ring
    assert ring.hi == c.store.total == cut
    first = c.frontend._pending[0][0]
    assert first < cut and ring.resident(first)
    for i in range(cut, N, CHUNK // 2):
        c.push_events(*(x[i:i + CHUNK // 2] for x in ev))
    assert c.metrics.counters["frontend.ring_packets"] == len(c.frontend.estimates) > 0
    resumed = np.concatenate([b.ang_vel_log, c.ang_vel_log])
    np.testing.assert_array_equal(resumed, a.ang_vel_log)
