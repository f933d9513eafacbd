"""The port's CLI (python -m cmax_slam_tpu_torch.cli) against the JAX CLI on
tests/test_cli.py's dataset and SETTINGS: the six output files, the packet
grid, per-packet omega, the refined trajectory and knots, the window count,
image dumps, checkpoints, --refine-passes, --max-events, the bag that carries
its own CameraInfo, the stdin text stream, --resume in both directions
(each CLI resumes the other's final_state.npz), and the error messages.

The JAX CLI runs with frontend.batch_sweeps=0, its per-packet schedule (the
bag test also with its stock stride schedule; the port's schedules give
equal estimates, tests/test_torch_frontend_schedule.py). Tolerances are
tests/test_torch_slice.py's: the
solves agree to their own resolution, not to the last bit, so per-packet
omega agrees within 0.06 rad/s (median 0.01 rad/s) and knots and TUM poses
within 0.1 deg; packet and pose timestamps and the window count are
identical."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmax_slam_tpu import cli as jcli
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu_torch import cli
from cmax_slam_tpu_torch.utils.evaluate import read_tum_trajectory

from test_cli import FX, FY, H, SETTINGS, W
from test_io import _camera_info_msg, _event_array_msg, _write_test_bag

torch.set_num_threads(1)

OMEGA_MAX, OMEGA_MEDIAN, POSE_DEG = 0.06, 0.01, 0.1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("angular_velocity.txt", "angular_velocity_deg.txt", "trajectory_tum.txt",
           "pano_map.png", "final_state.npz", "stats.json")
JAX_SCHEDULE = ["--set", "frontend.batch_sweeps=0"]
CUT = 20_000  # events in the interrupted runs that the other CLI resumes


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_cli.py's dataset: 40 000 events over 0.5 s, 120x90."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(5)
    ev = synthetic.rotating_camera_events(rng, 40000, 0.5, np.array([0.9, -1.4, 2.0]),
                                          FX, FY, W / 2, H / 2, W, H, n_points=250)
    epath = d / "events.txt"
    with open(epath, "w") as f:
        for t, x, y, p in zip(ev.ts, ev.xs, ev.ys, ev.pols):
            f.write(f"{t:.9f} {x} {y} {1 if p > 0 else 0}\n")
    cpath = d / "calib.txt"
    cpath.write_text(f"{FX} {FY} {W/2} {H/2} 0 0 0 0 0\n")
    return str(epath), str(cpath), d


def _args(data, out, *extra):
    epath, cpath, d = data
    return ["--events", epath, "--calib", cpath, "--width", str(W), "--height", str(H),
            "--out-dir", str(d / out), *SETTINGS, *extra]


FULL = ("--refine-passes", "1", "--save-iwe-every", "5", "--save-maps-every", "2",
        "--checkpoint-every", "0.2")


@pytest.fixture(scope="module")
def runs(data):
    """Each CLI once on the whole file (with refine, image dumps and periodic
    checkpoints), once cut at CUT events, and once resuming the OTHER
    CLI's cut state on the whole file."""
    d = data[2]
    assert jcli.main(_args(data, "jax", *FULL, *JAX_SCHEDULE)) == 0
    assert cli.main(["--device", "cpu", *_args(data, "port", *FULL)]) == 0
    assert jcli.main(_args(data, "jax_cut", "--max-events", str(CUT), *JAX_SCHEDULE)) == 0
    assert cli.main(["--device", "cpu", *_args(data, "port_cut", "--max-events", str(CUT))]) == 0
    assert jcli.main(_args(data, "jax_resumes_port", "--resume",
                           str(d / "port_cut" / "final_state.npz"), *JAX_SCHEDULE)) == 0
    assert cli.main(["--device", "cpu", *_args(data, "port_resumes_jax", "--resume",
                                                str(d / "jax_cut" / "final_state.npz"))]) == 0
    return d


def _av(d, name):
    return np.atleast_2d(np.loadtxt(d / name / "angular_velocity.txt"))


def _assert_omega_close(av_t, av_j):
    assert av_t.shape == av_j.shape
    np.testing.assert_allclose(av_t[:, 0], av_j[:, 0], atol=1e-9)  # same packet grid
    err = np.linalg.norm(av_t[:, 1:] - av_j[:, 1:], axis=1)
    assert err.max() < OMEGA_MAX and np.median(err) < OMEGA_MEDIAN, np.round(err, 4)


def _knot_deg(a, b):
    return 2 * np.degrees(np.arccos(np.clip(np.abs(np.sum(a * b, axis=1)), 0, 1)))


def _assert_poses_close(d, a, b):
    (t_a, q_a), (t_b, q_b) = (read_tum_trajectory(d / n / "trajectory_tum.txt") for n in (a, b))
    np.testing.assert_array_equal(t_a, t_b)
    assert len(t_a) > 10 and _knot_deg(q_a, q_b).max() < POSE_DEG


def test_outputs_and_stats_match_jax(runs):
    for name in ("jax", "port"):
        for f in OUTPUTS + ("checkpoint.npz",):
            assert os.path.exists(runs / name / f), (name, f)
    s_t, s_j = (json.load(open(runs / n / "stats.json")) for n in ("port", "jax"))
    assert s_t["events"] == s_j["events"] == 40000
    assert s_t["ang_vel_estimates"] == s_j["ang_vel_estimates"] >= 15
    assert s_t["windows"] == s_j["windows"] >= 2
    assert s_t["metrics"]["counters"]["backend.refine_windows"] >= 2
    for k, v in s_t["metrics"]["counters"].items():
        assert type(v) is float, k
    dumps = [sorted(f for f in os.listdir(runs / n) if f.startswith(("local_iwe_", "pano_map_")))
             for n in ("port", "jax")]
    assert dumps[0] == dumps[1] and len(dumps[0]) >= 4


def test_angular_velocity_matches_jax(runs):
    _assert_omega_close(_av(runs, "port"), _av(runs, "jax"))
    av_t, deg_t = _av(runs, "port"), np.loadtxt(runs / "port" / "angular_velocity_deg.txt")
    np.testing.assert_allclose(deg_t[:, 1:], np.degrees(av_t[:, 1:]), rtol=1e-8)
    errs = np.linalg.norm(av_t[:, 1:] - np.array([0.9, -1.4, 2.0]), axis=1)
    assert np.median(errs) < 0.2


def test_trajectory_and_knots_match_jax(runs):
    _assert_poses_close(runs, "port", "jax")
    with np.load(runs / "port" / "final_state.npz") as d_t, \
            np.load(runs / "jax" / "final_state.npz") as d_j:
        assert set(d_j.files) <= set(d_t.files)
        assert d_t["knots"].shape == d_j["knots"].shape
        assert _knot_deg(d_t["knots"], d_j["knots"]).max() < POSE_DEG
        assert int(d_t["raw_count"]) == int(d_j["raw_count"]) == 40000
        assert int(d_t["count_window"]) == int(d_j["count_window"])


@pytest.mark.parametrize("resumed,cut_by", [("port_resumes_jax", "jax_cut"),
                                            ("jax_resumes_port", "port_cut")])
def test_cross_resume_continues_the_packet_grid(runs, resumed, cut_by):
    """The resumed run skips the CUT events the checkpoint consumed and
    solves only the packets after them: the cut run's packets followed by
    the resumed run's are the full run's packet grid, each packet once."""
    full = "port" if resumed.startswith("port") else "jax"
    av_cut, av_res, av_full = _av(runs, cut_by), _av(runs, resumed), _av(runs, full)
    np.testing.assert_allclose(np.concatenate([av_cut[:, 0], av_res[:, 0]]), av_full[:, 0],
                               atol=1e-9)
    _assert_omega_close(av_res, av_full[len(av_cut):])
    s = json.load(open(runs / resumed / "stats.json"))
    assert s["events"] == 40000 - CUT
    with np.load(runs / resumed / "final_state.npz") as d:
        assert int(d["raw_count"]) == 40000
    t, q = read_tum_trajectory(runs / resumed / "trajectory_tum.txt")
    assert len(t) > 10 and np.all(np.isfinite(q))


@pytest.mark.parametrize("jax_schedule", [JAX_SCHEDULE, []], ids=["per-packet", "stock"])
def test_bag_with_camera_info_matches_jax(tmp_path, jax_schedule):
    """A bag with no --calib: CameraInfo and events both come from it (the
    reference's primary input path), with IWE dumps; the JAX CLI on its
    per-packet schedule and on its stock one (ring and stride solver)."""
    rng = np.random.default_rng(6)
    ev = synthetic.rotating_camera_events(rng, 12000, 0.15, np.array([0.9, -1.4, 2.0]),
                                          FX, FY, W / 2, H / 2, W, H, n_points=250)
    bag = str(tmp_path / "stream.bag")
    msgs = [(1, _camera_info_msg(W, H, FX, FY, W / 2, H / 2, d=[0] * 5))]
    for i in range(0, len(ev.ts), 3000):
        msgs.append((0, _event_array_msg(ev.xs[i:i + 3000], ev.ys[i:i + 3000],
                                         ev.ts[i:i + 3000], ev.pols[i:i + 3000],
                                         width=W, height=H)))
    _write_test_bag(bag, msgs, compression="bz2",
                    conns=[("/dvs/events", "dvs_msgs/EventArray"),
                           ("/dvs/camera_info", "sensor_msgs/CameraInfo")])
    common = ["--events", bag, "--no-backend", "--save-iwe-every", "2", *SETTINGS]
    assert cli.main(["--device", "cpu", "--out-dir", str(tmp_path / "port"), *common]) == 0
    assert jcli.main(["--out-dir", str(tmp_path / "jax"), *common, *jax_schedule]) == 0
    _assert_omega_close(_av(tmp_path, "port"), _av(tmp_path, "jax"))
    iwes = [sorted(f for f in os.listdir(tmp_path / n) if f.startswith("local_iwe_"))
            for n in ("port", "jax")]
    assert iwes[0] == iwes[1] and len(iwes[0]) >= 2
    assert not os.path.exists(tmp_path / "port" / "trajectory_tum.txt")


def test_stdin_stream_matches_file_run(data, tmp_path):
    """--events - reads a live 't x y p' text stream from a real pipe; it
    gives the JAX CLI's packets on the same events read from the file."""
    epath, cpath, _ = data
    common = ["--calib", cpath, "--width", str(W), "--height", str(H), "--chunk-size", "8192",
              "--no-backend", "--max-events", "24000",
              "--set", "frontend.num_events_per_packet=6000",
              "--set", "frontend.dt_ang_vel=0.02"]
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(epath) as f:
        r = subprocess.run([sys.executable, "-m", "cmax_slam_tpu_torch.cli", "--device", "cpu",
                            "--events", "-", "--out-dir", str(tmp_path / "port"), *common],
                           stdin=f, capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "not implemented" not in r.stderr  # the stock schedule is the port's
    assert json.loads(r.stdout.strip().splitlines()[-1])["events"] == 24000
    assert jcli.main(["--events", epath, "--out-dir", str(tmp_path / "jax"), *common,
                      *JAX_SCHEDULE]) == 0
    _assert_omega_close(_av(tmp_path, "port"), _av(tmp_path, "jax"))


def test_errors_match_jax(data, capsys):
    epath, cpath, d = data
    out = str(d / "errors")
    cases = [
        (["--events", epath, "--calib", cpath, "--width", str(W), "--height", str(H),
          "--out-dir", out, "--set", "frontend.nope=1"], "unknown config key"),
        (["--events", epath, "--calib", cpath, "--out-dir", out], "width"),
        (["--events", epath, "--out-dir", out], "--calib is required"),
        (["--events", "-", "--calib", cpath, "--width", str(W), "--height", str(H),
          "--out-dir", out, "--refine-passes", "1"], "--refine-passes needs"),
    ]
    for argv, msg in cases:
        for run in (jcli.main, lambda a: cli.main(["--device", "cpu", *a])):
            with pytest.raises(SystemExit, match=msg):
                run(argv)
    # the device is required and has no default
    with pytest.raises(SystemExit):
        cli.main(cases[0][0][:-2])
    assert "--device" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--device", "cuda", *_args(data, "nocard")])
