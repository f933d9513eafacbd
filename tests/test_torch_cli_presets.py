"""The CLI's presets that only the JAX package's tests named: ``default``
(``SystemConfig()``, what the CLI runs with no ``--preset``),
``ecrot_synth`` and ``live_davis`` (the latter on a real pipe, ``--events
-``), each run through the JAX CLI (``jcli.main``) and the port's
(``cli.main(["--device", "cpu", ...])``) on one seeded numpy stream, and the
six presets' fields in both packages.

Each stream is chip_smoke.make_stream's generator (1200 landmarks on the
whole sphere, seed 11, a vectorized rotation) on a camera of its own. What
the CPU forces is scaled with ``--set`` or by the stream alone; every other
value is the preset's own:

- ``default``: 120x90 (fx = fy = 90), omega [0.2, -0.3, 0.4] (0.54 rad/s),
  200 000 events/s for 1.5 s; ``--set`` the panorama to 256x512 (the
  preset's 1024x2048 over 4). It keeps 30 000-event packets every 0.02 s,
  ``dt_knots = 0.1`` (3 knots a window, one per stride),
  ``backend_min_ev_rate = 10`` (BA from 3 events a window) and
  ``max_update_times = 10``, which binds: the camera turns 46 degrees in a
  67-degree view, and map pixels are counted up to 17 times.
- ``ecrot_synth``: 160x120 (the 640x480 camera's fx = 335 over 4), omega
  [0.5, -0.9, 1.3], 200 000 events/s for 0.5 s; ``--set`` packets of 7 000
  events (on the card 70 000 at 2 Mev/s: a packet spans 0.035 s either
  way, inside the front-end's degenerate guard of 10 x dt = 0.05 s, past
  which both packages give omega = 0) and the panorama to 256x512 (512x1024
  over 2). It keeps dt 0.005, so one 65 536-event chunk completes about 65
  packets, which the port solves in one stride launch, and its 2^21-event
  ring; the file is an ``.npz``.
- ``live_davis``: 173x130 (a DAVIS346 over 2, fx = fy = 130), omega [0.3,
  -0.5, 0.8], 500 000 events/s for 0.6 s, written into a pipe in writes
  that end mid-line; ``--set`` the panorama to 256x512. It keeps the 10x
  front-end and 5x in-batch decimation, 5 000-event packets every 0.04 s,
  threshold 0 (BA on every window with an event) and no bootstrap re-solve.
- a window of a handful of events: ``live_davis`` on the ``default``
  test's camera at 400 000 events/s for 0.8 s, with all but 40 raw events
  of GAP removed (window 3 keeps 4 after the 10x decimation), the
  panorama at 128x256.

The JAX CLI runs its per-packet schedule (``frontend.batch_sweeps=0``, as
tests/test_torch_cli.py runs it; the port's schedules give equal estimates,
tests/test_torch_frontend_schedule.py). Tolerances are
tests/test_torch_cli.py's: per-packet omega within 0.06 rad/s (median
0.01), TUM poses and knots within POSE_DEG = 0.1 deg; equal packet grids,
window counts, windows' events and BA decisions, BA'd events and crop
windows; the global map within MAP_REL of its largest pixel
(tests/test_torch_presets.py). Measured: omega 0.0064 rad/s at most
(median 0.0005) on ``default``, whose poses part by 0.055 deg at most.

Where the solves part further, it is at ROADMAP Queue 3's keep-test tie
(the first secant step's keep test, 1-2 ulps apart in JAX's two
programs), and the test that holds the parted values is marked
``xfail(strict=True)`` with the tolerance kept: ``default``'s update
counts (26 pixels off by one, from window 4), ``live_davis``'s and the
sparse stream's poses and maps (window 0 of a flat objective of 1 500-2 000
events: 1.39 and 3.8 deg, and 21.8 deg at the sparse window's free knot,
which from JAX's state takes JAX's decisions). The slow-tier
``test_preset_window_parts_at_the_keep_test_tie`` traces each with
tests/test_torch_oracle_parity.py's tracer."""


import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from cmax_slam_tpu import cli as jcli
from cmax_slam_tpu_torch import cli
from cmax_slam_tpu_torch.utils.evaluate import read_tum_trajectory

from test_torch_cli import JAX_SCHEDULE, OUTPUTS, _assert_omega_close, _av, _knot_deg
from test_torch_presets import MAP_REL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_DEG = 0.1
GAP = (0.32, 0.52)  # the sparse stream's thinned span: window 3 of the live preset's grid


def _stream(W, H, F, omega, rate, duration):
    """chip_smoke.make_stream's generator (seed 11, 1200 landmarks on the
    whole sphere, the vectorized rotation) on a W x H camera of focal
    length F; a copy of its cached arrays."""
    ev = chip_smoke.make_stream(duration, tuple(omega), rate, (W, H, F))[0]
    return types.SimpleNamespace(xs=ev.xs.copy(), ys=ev.ys.copy(), ts=ev.ts.copy(),
                                 pols=ev.pols.copy())


def _lines(ev) -> bytes:
    rows = np.column_stack([ev.ts, ev.xs, ev.ys, (ev.pols > 0).astype(int)])
    return "".join(f"{t:.9f} {x:.0f} {y:.0f} {p:.0f}\n" for t, x, y, p in rows).encode()


def _files(d, ev, W, H, F, npz=False):
    """The stream as an event file (text, or .npz) and a .txt calibration;
    returns the CLI's common arguments."""
    d.mkdir(exist_ok=True)
    if npz:
        events = d / "events.npz"
        np.savez(events, x=ev.xs, y=ev.ys, t=ev.ts, p=ev.pols)
    else:
        events = d / "events.txt"
        events.write_bytes(_lines(ev))
    calib = d / "calib.txt"
    calib.write_text(f"{F} {F} {W / 2} {H / 2} 0 0 0 0 0\n")
    return ["--events", str(events), "--calib", str(calib), "--width", str(W),
            "--height", str(H)]


def _record(monkeypatch, made):
    """Each CLI's CMaxSLAM recorded into ``made`` ({"jax": [], "port": []})
    as it is made."""
    for name, mod in (("jax", jcli), ("port", cli)):
        base = mod.CMaxSLAM

        class Recorded(base):
            def __init__(self, *a, _into=made[name], **kw):
                super().__init__(*a, **kw)
                _into.append(self)

        monkeypatch.setattr(mod, "CMaxSLAM", Recorded)


def _run_both(d, common, preset, *extra):
    """Both CLIs on the same arguments, in this process; returns their
    systems (JAX's, the port's)."""
    made = {"jax": [], "port": []}
    flag = [] if preset == "default" else ["--preset", preset]
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, made)
        assert jcli.main([*common, *flag, "--out-dir", str(d / "jax"), *extra,
                          *JAX_SCHEDULE]) == 0
        assert cli.main(["--device", "cpu", *common, *flag, "--out-dir", str(d / "port"),
                         *extra]) == 0
    return made["jax"][0], made["port"][0]


def _stats(d):
    return [json.load(open(d / n / "stats.json")) for n in ("jax", "port")]


def _windows(slam):
    return [(w.index, w.num_events, w.ran_ba) for w in slam.window_results()]


def _assert_runs_match(run, min_windows):
    """Both CLIs read every event and wrote the six outputs; equal packet
    grids, window counts, windows (index, events, BA or not), BA'd events
    and crop windows; per-packet omega close."""
    d, n = run["dir"], run["events"]
    for name in ("jax", "port"):
        for f in OUTPUTS:
            assert os.path.exists(d / name / f), (name, f)
    s_j, s_t = _stats(d)
    assert s_t["events"] == s_j["events"] == n
    assert s_t["ang_vel_estimates"] == s_j["ang_vel_estimates"]
    assert s_t["windows"] == s_j["windows"] >= min_windows
    c_j, c_t = s_j["metrics"]["counters"], s_t["metrics"]["counters"]
    for key in ("frontend.events", "backend.events", "backend.crop_windows",
                "backend.events_dropped"):
        assert c_t.get(key) == c_j.get(key), key
    _assert_omega_close(_av(d, "port"), _av(d, "jax"))
    assert _windows(run["port"]) == _windows(run["jax"])
    with np.load(d / "jax" / "final_state.npz") as z_j, \
            np.load(d / "port" / "final_state.npz") as z_t:
        assert int(z_t["raw_count"]) == int(z_j["raw_count"]) == n
        assert z_t["knots"].shape == z_j["knots"].shape


def _assert_poses_and_map_match(run):
    """TUM poses (equal times) and the final knots within POSE_DEG; the
    global map within MAP_REL of its largest pixel."""
    d = run["dir"]
    (t_j, q_j), (t_t, q_t) = (read_tum_trajectory(d / n / "trajectory_tum.txt")
                              for n in ("jax", "port"))
    np.testing.assert_array_equal(t_t, t_j)
    with np.load(d / "jax" / "final_state.npz") as z_j, \
            np.load(d / "port" / "final_state.npz") as z_t:
        k_j, k_t, ig_j, ig_t = z_j["knots"], z_t["knots"], z_j["IG"], z_t["IG"]
    parted = max(_knot_deg(q_t, q_j).max(), _knot_deg(k_t, k_j).max())
    assert parted < POSE_DEG, parted
    assert np.abs(ig_t - ig_j).max() < MAP_REL * ig_j.max()


def _update_times(run):
    with np.load(run["dir"] / "jax" / "final_state.npz") as z_j, \
            np.load(run["dir"] / "port" / "final_state.npz") as z_t:
        return z_j["update_times"], z_t["update_times"]


# -- the runs, once per module --------------------------------------------

@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("preset_default")
    W, H, F = 120, 90, 90.0
    ev = _stream(W, H, F, [0.2, -0.3, 0.4], 200_000, 1.5)
    jax_slam, port_slam = _run_both(d, _files(d, ev, W, H, F), "default",
                                    "--set", "backend.pano_map.pano_height=256",
                                    "--set", "backend.pano_map.pano_width=512")
    return {"dir": d, "events": len(ev.ts), "jax": jax_slam, "port": port_slam}


@pytest.fixture(scope="module")
def synth_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("preset_ecrot_synth")
    W, H, F = 160, 120, 335.0 / 4
    ev = _stream(W, H, F, [0.5, -0.9, 1.3], 200_000, 0.5)
    jax_slam, port_slam = _run_both(d, _files(d, ev, W, H, F, npz=True), "ecrot_synth",
                                    "--set", "frontend.num_events_per_packet=7000",
                                    "--set", "backend.pano_map.pano_height=256",
                                    "--set", "backend.pano_map.pano_width=512")
    return {"dir": d, "events": len(ev.ts), "jax": jax_slam, "port": port_slam}


@pytest.fixture(scope="module")
def live_run(tmp_path_factory):
    """The port on a real pipe in a process of its own; JAX reading the
    same lines from stdin in this one."""
    d = tmp_path_factory.mktemp("preset_live_davis")
    W, H, F = 173, 130, 130.0
    ev = _stream(W, H, F, [0.3, -0.5, 0.8], 500_000, 0.6)
    common = _files(d, ev, W, H, F)[2:]
    pano = ["--set", "backend.pano_map.pano_height=256",
            "--set", "backend.pano_map.pano_width=512"]
    text = (d / "events.txt").read_bytes()
    with open(d / "stdout", "wb") as out, open(d / "stderr", "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cmax_slam_tpu_torch.cli", "--device", "cpu",
             "--events", "-", *common, "--preset", "live_davis", "--out-dir", str(d / "port"),
             *pano], stdin=subprocess.PIPE, stdout=out, stderr=err,
            env=dict(os.environ, PYTHONPATH=REPO))
        for i in range(0, len(text), 100_003):  # writes that end mid-line
            proc.stdin.write(text[i:i + 100_003])
            proc.stdin.flush()
        proc.stdin.close()
        assert proc.wait(timeout=600) == 0, (d / "stderr").read_text()[-2000:]
    made = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp, open(d / "events.txt") as f:
        _record(mp, made)
        mp.setattr(sys, "stdin", f)
        assert jcli.main(["--events", "-", *common, "--preset", "live_davis",
                          "--out-dir", str(d / "jax"), *pano, *JAX_SCHEDULE]) == 0
    return {"dir": d, "events": len(ev.ts), "jax": made["jax"][0], "port": None}


@pytest.fixture(scope="module")
def sparse_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("preset_sparse_window")
    W, H, F = 120, 90, 90.0
    ev = _stream(W, H, F, [0.3, -0.5, 0.8], 400_000, 0.8)
    gap = np.flatnonzero((ev.ts >= GAP[0]) & (ev.ts < GAP[1]))
    drop = np.setdiff1d(gap, gap[:: len(gap) // 40][:40])
    for k in ("xs", "ys", "ts", "pols"):
        setattr(ev, k, np.delete(getattr(ev, k), drop))
    jax_slam, port_slam = _run_both(d, _files(d, ev, W, H, F), "live_davis",
                                    "--set", "backend.pano_map.pano_height=128",
                                    "--set", "backend.pano_map.pano_width=256")
    return {"dir": d, "events": len(ev.ts), "jax": jax_slam, "port": port_slam}


# -- the tests ------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(cli.PRESETS))
def test_preset_fields_equal_jax(preset):
    """Every field of each preset, nested, in both packages."""
    assert sorted(cli.PRESETS) == sorted(jcli.PRESETS)
    assert dataclasses.asdict(cli.PRESETS[preset]()) == dataclasses.asdict(
        jcli.PRESETS[preset]())


def test_default_preset_matches_jax(default_run):
    """No --preset: SystemConfig() with its own cap, knot spacing and BA
    threshold, on a slow stream on which the cap of 10 binds in both."""
    j, t = default_run["jax"], default_run["port"]
    b = t.cfg.backend
    assert (b.pano_map.max_update_times, b.pano_map.backend_min_ev_rate,
            b.trajectory.dt_knots, b.draw_fov) == (10, 10, 0.1, False)
    assert t.backend.min_events_per_win == j.backend.min_events_per_win == 2
    assert t.backend.cp_stride == j.backend.cp_stride == 1
    assert t.backend.K_win == j.backend.K_win == 3
    _assert_runs_match(default_run, 12)
    assert all(ran for *_, ran in _windows(t))
    upd_j, upd_t = _update_times(default_run)
    assert upd_j.max() > 10 and upd_t.max() > 10 and upd_t.max() == upd_j.max()


def test_default_preset_poses_match_jax(default_run):
    _assert_poses_and_map_match(default_run)


@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): window 4's BA parts at the keep-test tie "
    "(test_preset_window_parts_at_the_keep_test_tie[default]), the bootstrap re-solve "
    "carries it to knot 1 (0.055 deg) and knot 4 (0.029 deg), within POSE_DEG, and 26 "
    "pixels of the update counts on the footprint's edge differ by one"))
def test_default_preset_update_times_equal_jax(default_run):
    upd_j, upd_t = _update_times(default_run)
    np.testing.assert_array_equal(upd_t, upd_j)


def test_ecrot_synth_preset_matches_jax(synth_run):
    """dt 0.005: a chunk completes tens of packets, which the port solves
    in one stride launch; the .npz reader; the ring of 2^21 events."""
    j, t = synth_run["jax"], synth_run["port"]
    assert t.cfg.frontend.dt_ang_vel == 0.005
    assert t.frontend._ring.capacity == j.frontend._ring.capacity == 1 << 21
    _assert_runs_match(synth_run, 3)
    s_t = _stats(synth_run["dir"])[1]
    counters = s_t["metrics"]["counters"]
    assert counters["frontend.stride_launches"] >= 1
    assert s_t["ang_vel_estimates"] >= 10 * counters["frontend.launches"]


def test_ecrot_synth_preset_poses_match_jax(synth_run):
    _assert_poses_and_map_match(synth_run)


def test_live_davis_on_a_pipe_matches_jax(live_run):
    """--events - on a real pipe (the port), against the JAX CLI reading
    the same lines from stdin: every event read, a tenth of them to the
    front-end, BA on every window from 0 events up, no bootstrap."""
    j, d = live_run["jax"], live_run["dir"]
    assert j.backend.min_events_per_win == 0 and j.cfg.backend.bootstrap_resolve_window is None
    for name in ("jax", "port"):
        for f in OUTPUTS:
            assert os.path.exists(d / name / f), (name, f)
    s_j, s_t = _stats(d)
    assert s_t["events"] == s_j["events"] == live_run["events"]
    assert json.loads((d / "stdout").read_text().splitlines()[-1])["events"] == live_run["events"]
    assert s_t["ang_vel_estimates"] == s_j["ang_vel_estimates"]
    assert s_t["windows"] == s_j["windows"] >= 4
    c_j, c_t = s_j["metrics"]["counters"], s_t["metrics"]["counters"]
    for key in ("frontend.events", "backend.events", "backend.crop_windows"):
        assert c_t.get(key) == c_j.get(key), key
    assert all(ran for *_, ran in _windows(j))
    # BA ran on every window in the port too: its BA'd events are JAX's.
    assert c_t["backend.events"] == sum(w[1] for w in _windows(j))
    _assert_omega_close(_av(d, "port"), _av(d, "jax"))
    with np.load(d / "jax" / "final_state.npz") as z_j, \
            np.load(d / "port" / "final_state.npz") as z_t:
        assert int(z_t["raw_count"]) == int(z_j["raw_count"]) == live_run["events"]


@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): window 0 (1 960 events after the in-batch decimation) "
    "parts at the keep-test tie after five line searches of equal decisions "
    "(test_preset_window_parts_at_the_keep_test_tie[live_davis]); the knots part by up "
    "to 1.39 deg and the map follows them"))
def test_live_davis_on_a_pipe_poses_match_jax(live_run):
    _assert_poses_and_map_match(live_run)


def test_window_of_a_handful_of_events_matches_jax(sparse_run):
    """live_davis (threshold 0): the window over the gap holds a handful of
    events after the front-end's decimation, one after the in-batch one,
    and both packages run BA on it."""
    _assert_runs_match(sparse_run, 5)
    sparse = [w for w in _windows(sparse_run["port"]) if w[1] <= 5]
    assert sparse, _windows(sparse_run["port"])
    assert all(ran for *_, ran in sparse)


@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): window 0 (1 541 events after the in-batch decimation) "
    "parts at the keep-test tie (test_preset_window_parts_at_the_keep_test_tie[sparse-0]), "
    "3.8 deg at knot 1; the window of 4 events, solved from JAX's state, takes JAX's "
    "decisions ([sparse-3]), but from the parted state its free knot parts by 21.8 deg"))
def test_window_of_a_handful_of_events_poses_match_jax(sparse_run):
    _assert_poses_and_map_match(sparse_run)


TRACES = {  # case: (stream, preset, --set overrides, window, parts at the tie)
    "default": ("default", None, {"backend.pano_map.pano_height": 256,
                                  "backend.pano_map.pano_width": 512}, 4, True),
    "live_davis": ("live_davis", "live_davis_config",
                   {"backend.pano_map.pano_height": 256, "backend.pano_map.pano_width": 512},
                   0, True),
    "sparse-0": ("sparse", "live_davis_config",
                 {"backend.pano_map.pano_height": 128, "backend.pano_map.pano_width": 256}, 0,
                 True),
    "sparse-3": ("sparse", "live_davis_config",
                 {"backend.pano_map.pano_height": 128, "backend.pano_map.pano_width": 256}, 3,
                 False),
}


def _trace_stream(name):
    if name == "default":
        return (120, 90, 90.0), _stream(120, 90, 90.0, [0.2, -0.3, 0.4], 200_000, 1.5)
    if name == "live_davis":
        return (173, 130, 130.0), _stream(173, 130, 130.0, [0.3, -0.5, 0.8], 500_000, 0.6)
    ev = _stream(120, 90, 90.0, [0.3, -0.5, 0.8], 400_000, 0.8)
    gap = np.flatnonzero((ev.ts >= GAP[0]) & (ev.ts < GAP[1]))
    drop = np.setdiff1d(gap, gap[:: len(gap) // 40][:40])
    for k in ("xs", "ys", "ts", "pols"):
        setattr(ev, k, np.delete(getattr(ev, k), drop))
    return (120, 90, 90.0), ev


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(TRACES))
def test_preset_window_parts_at_the_keep_test_tie(case, monkeypatch, tmp_path):
    """The traces of the marked misses above (ROADMAP Queue 3): ``window``
    of the run, from JAX's checkpoint before it and on JAX's front-end
    estimates (the front-end's decimated events), solved by both packages
    decision by decision (tests/test_torch_oracle_parity.py's tracer).
    default's window 4, and sparse's window 0, take the same decisions on
    costs equal to float32 rounding until the first secant step's
    keep-test tie; live_davis's window 0 takes the same decisions up to
    that tie too, but its costs drift to 2e-4 relative over the five line
    searches before it (a flat objective of 1 960 events). The window of 4
    events (sparse's window 3) takes JAX's decisions throughout."""
    import cmax_slam_tpu.calib as jcalib
    import cmax_slam_tpu.config as jconfig
    import cmax_slam_tpu.system as jsystem
    from cmax_slam_tpu_torch import config as tconfig
    from cmax_slam_tpu_torch.calib import CameraCalibration
    from cmax_slam_tpu_torch.system import CMaxSLAM
    from test_torch_oracle_parity import (assert_parts_at_the_keep_test_tie,
                                          trace_window_from_jax_state)

    stream, preset, overrides, window, parts = TRACES[case]
    (W, H, F), ev = _trace_stream(stream)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])

    def cfg(mod):
        base = getattr(mod, preset)() if preset else mod.SystemConfig()
        return mod.replace(base, **overrides, **{"frontend.batch_sweeps": 0})

    rate = cfg(tconfig).frontend_event_sample_rate  # the tracer pushes to the front-end
    ev = types.SimpleNamespace(xs=ev.xs[::rate], ys=ev.ys[::rate], ts=ev.ts[::rate],
                               pols=ev.pols[::rate])
    traced = trace_window_from_jax_state(
        monkeypatch,
        lambda: jsystem.CMaxSLAM(jcalib.CameraCalibration(width=W, height=H, K=K),
                                 cfg(jconfig)),
        lambda: CMaxSLAM(CameraCalibration(width=W, height=H, K=K), cfg(tconfig),
                         device="cpu"),
        ev, window, cfg(tconfig).backend.optim, tmp_path, chunk=1 if window == 3 else 2_000)
    dj, dp, first, js, ps = traced
    if not parts:
        assert first is None and len(js) == len(ps)
        return
    if case == "live_davis":
        order = list(dj)
        assert first[1:] == ("secant f <= best", 0)
        assert all(dj[k][2] == dp[k][2] for k in order[:order.index(first)])
        value, bracket, _ = dj[first]
        assert abs(value - bracket) / abs(bracket) < 1e-6
        return
    assert_parts_at_the_keep_test_tie(*traced)
