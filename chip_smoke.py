#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (cmax_slam_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: prints ``nvidia-smi --query-gpu=name,power.limit`` as it reports them;
2. build: compiles the vote kernels from csrc/iwe.cu with nvcc, prints the seconds;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (front-end rung sweep, back-end window on a crop,
   old/new split on the full panorama) and at the kernel-alone headroom
   shape (2^20 events on 240x180), with dropped events, padding and integer
   coordinates; prints the max error and both times;
4. system: CMaxSLAM on the stock ijrr preset, driven through push_events on a
   2.0 s synthetic 240x180 stream at 390k ev/s (make_stream), must keep its
   state on the card, run at least 15 BA windows through both kernels and
   track the ground truth to < 0.3 deg RMS;
5. cli: the same stream written to an IJRR 't x y p' text file and run
   through ``cmax_slam_tpu_torch.cli.main`` on the stock ijrr preset with a
   refine pass, IWE-pair and map dumps: all outputs written, every event
   read back, >= 15 windows, both kernels launched (K1 also inside the IWE
   renders), the TUM trajectory < 0.3 deg RMS; then a run cut at 1.0 s and
   one resuming its final_state.npz must continue the packet grid.

Before the last line it prints one JSON object with every kernel's route,
source, launches on each path (the system run of phase 4 and the CLI run of
phase 5, each counted from 0), error and times; the last line is
``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Main-path vote shapes (tag: B images, N events, H x W, kernels checked):
# the front-end rung sweep and value-and-grad, a back-end window's events on
# a crop, the old/new split on the ijrr panorama; then the headroom shape,
# the one at which the JAX package times its kernels alone
# (examples/tpu_kernel_headroom.py), and the only one at which it runs the
# "rows"/"mixed" VJP orientation that K2 also serves.
SHAPES = (
    ("sweep", 9, 10_000, 180, 240, ("fwd",)),
    ("packet", 1, 10_000, 180, 240, ("fwd", "bwd")),
    ("crop", 1, 1 << 18, 384, 384, ("fwd", "bwd")),
    ("split", 2, 1 << 18, 512, 1024, ("fwd",)),
    ("headroom", 1, 1 << 20, 180, 240, ("fwd", "bwd")),
)
# The shape whose times go into the JSON line, per kernel.
REPORTED = {"fwd": "sweep", "bwd": "crop"}


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events(rng, b, n, h, w, device):
    """Vote inputs like the warps produce: coordinates over the image and
    past its borders, a fifth on integers (the omega = 0 cold start), NaN
    and infinite coordinates, weight-0 padding at the tail, and weights
    shared across the batch."""
    import torch

    px = rng.uniform(-3, w + 3, (b, n)).astype(np.float32)
    py = rng.uniform(-3, h + 3, (b, n)).astype(np.float32)
    k = n // 5
    px[:, :k] = np.round(px[:, :k])
    py[:, :k] = np.round(py[:, :k])
    px[:, k:k + 3] = [np.nan, np.inf, -np.inf]
    wt = np.ones(n, np.float32)
    wt[-n // 10:] = 0.0  # padding
    return [torch.tensor(a, device=device) for a in (px, py, wt)]


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(rng) -> dict:
    """Phase 3. Returns per kernel {max_abs_err over all shapes, ms, plain_ms
    and shape at its REPORTED shape, and the same times at every shape}."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, scatter

    out = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    for tag, b, n, H, W, kernels in SHAPES:
        px, py, wt = _events(rng, b, n, H, W, "cuda")
        wx = wt.expand(b, -1).contiguous()
        ref = scatter.bilinear_accumulate(px, py, wt, H, W)
        img = scatter.vote(px, py, wt, H, W)
        torch.cuda.synchronize()
        # Atomic adds land in run-dependent order: float32 sums agree to a
        # few ulps of the largest pixel.
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        err = float((img - ref).abs().max())
        if not (img.shape == ref.shape and torch.isfinite(img).all() and err <= tol):
            raise AssertionError(f"vote_fwd {tag}: max err {err} > {tol}")
        ms = _time_ms(lambda: cuda_iwe.vote_fwd(px, py, wx, H, W))
        plain_ms = _time_ms(lambda: scatter.bilinear_accumulate(px, py, wt, H, W))
        results = {"fwd": (err, ms, plain_ms)}
        if "bwd" in kernels:
            # K2 through autograd against the plain version's autograd.
            g = torch.tensor(rng.normal(size=(b, H, W)).astype(np.float32), device="cuda")
            grads = []
            for fn in (scatter.vote, scatter.bilinear_accumulate):
                leaves = [t.clone().requires_grad_(True) for t in (px, py, wt)]
                torch.autograd.backward(fn(*leaves, H, W), g)
                grads.append([t.grad for t in leaves])
            torch.cuda.synchronize()
            # Gathers with no atomics: only FMA contraction differs, but dw
            # sums B gathers of a broadcast weight.
            tol = 1e-5 * b * max(1.0, float(g.abs().max()))
            err = max(float((x - y).abs().max()) for x, y in zip(*grads))
            if not (all(torch.isfinite(x).all() for x in grads[0]) and err <= tol):
                raise AssertionError(f"vote_bwd {tag}: max err {err} > {tol}")
            ms = _time_ms(lambda: cuda_iwe.vote_bwd(px, py, wx, g))
            leaves = [t.clone().requires_grad_(True) for t in (px, py, wt)]
            plain_out = scatter.bilinear_accumulate(*leaves, H, W)
            plain_ms = _time_ms(
                lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True))
            results["bwd"] = (err, ms, plain_ms)
        for k, (err, ms, plain_ms) in results.items():
            _log(f"vote_{k} {tag:6s} B={b} N={n} {H}x{W}: max_abs_err={err:.3e} "
                 f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
            out[k].setdefault("by_shape", {})[tag] = {"ms": ms, "plain_ms": plain_ms}
            if REPORTED[k] == tag:
                out[k].update(ms=ms, plain_ms=plain_ms, shape=f"{b}x{n}@{H}x{W}")
    return out


def _rot_fn(omega):
    """Vectorized R(t) = exp(omega t) for the synthetic generator."""
    theta = np.linalg.norm(omega)
    k = omega / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    K2 = K @ K

    def rot_fn(ts):
        a = np.atleast_1d(ts)[:, None, None] * theta
        return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K2

    return rot_fn


def make_stream(duration: float = 2.0):
    """The examples/tpu_realtime_check.py stream (240x180, fx = fy = 180,
    omega = [0.9, -1.3, 1.9], 1200 landmarks, 390k ev/s, seed 11) with the
    landmarks spread over the whole sphere instead of a 120-degree cone:
    in 2 s the camera turns 286 degrees, and with the cone its view leaves
    the landmarks around t = 1.3 s (windows fall to 20k events), where the
    JAX system on the CPU ends 3.3 deg RMS off the truth on this 2 s cut.
    On the sphere every view keeps texture. Returns (events, omega, calib)."""
    from cmax_slam_tpu_torch.calib import CameraCalibration
    from cmax_slam_tpu_torch.io import synthetic

    W, H, F = 240, 180, 180.0
    omega = np.array([0.9, -1.3, 1.9])
    rng = np.random.default_rng(11)
    landmarks = synthetic.make_landmarks(rng, 1200, fov_deg=360.0)
    ev = synthetic.rotating_camera_events(rng, int(390_000 * duration), duration, omega,
                                          F, F, W / 2, H / 2, W, H,
                                          rot_fn=_rot_fn(omega), landmarks=landmarks)
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]]))
    return ev, omega, calib


def _reset_launches():
    from cmax_slam_tpu_torch.ops import cuda_iwe

    for k in cuda_iwe.LAUNCHES:
        cuda_iwe.LAUNCHES[k] = 0


def run_system(device: str = "cuda"):
    """Phase 4: the stock preset through the public entry points. Returns
    (launches during the run, {check: passed})."""
    import torch
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.system import CMaxSLAM
    from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

    chunk, duration = 39_000, 2.0
    t0 = time.perf_counter()
    ev, omega, calib = make_stream(duration)
    n = len(ev.ts)
    _log(f"stream: {n} events over {duration} s ({time.perf_counter() - t0:.1f} s to generate)")
    slam = CMaxSLAM(calib, ijrr_config(), device=device)

    _reset_launches()
    t0 = time.perf_counter()
    for i in range(0, n, chunk):
        slam.push_events(ev.xs[i:i + chunk], ev.ys[i:i + chunk], ev.ts[i:i + chunk],
                         ev.pols[i:i + chunk])
    slam.flush()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_iwe.LAUNCHES)

    be = slam.backend
    wins = slam.window_results()
    n_ba = sum(w.ran_ba for w in wins)
    log = slam.ang_vel_log
    traj = be.traj
    grid = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, 80)
    q_gt = np.stack([spline._np_quat_exp(omega * t) for t in grid])
    rms, _ = rotation_rms_deg(grid, q_gt, traj.evaluate(grid), "global")
    timers = {k: round(v.total, 3) for k, v in slam.metrics.timers.items()}
    _log(f"system: wall {wall:.2f} s for {duration} s of stream, realtime factor "
         f"{duration / wall:.3f}; packets {len(log)}, windows {len(wins)} ({n_ba} with BA); "
         f"trajectory RMS {rms:.4f} deg; timers_s {json.dumps(timers)}; "
         f"counters {json.dumps(dict(slam.metrics.counters))}; launches {launches}; "
         f"crop shapes {sorted(be._crop_shapes)}")
    checks = {
        "state on the device": all(t.device.type == device for t in (
            be.IG, be.update_times, be.lut_dev, slam.frontend.lut)),
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
        ">= 15 BA windows": n_ba >= 15,
        "finite omega log": log.shape[1] == 4 and bool(np.isfinite(log).all()),
        "RMS < 0.3 deg": rms < 0.3,
    }
    return launches, checks


def run_cli(device: str = "cuda", duration: float = 2.0):
    """Phase 5: the port's CLI on the make_stream recording written as an
    IJRR text file, stock ijrr preset. Returns (launches during the full
    run, {check: passed})."""
    from cmax_slam_tpu_torch import cli, spline
    from cmax_slam_tpu_torch.frontend import Frontend
    from cmax_slam_tpu_torch.io.streams import iter_events
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.utils.evaluate import read_tum_trajectory, rotation_rms_deg

    ev, omega, calib = make_stream(duration)
    n = len(ev.ts)
    with tempfile.TemporaryDirectory(prefix="cmax_cli_") as tmp:
        events = os.path.join(tmp, "events.txt")
        t0 = time.perf_counter()
        np.savetxt(events, np.column_stack([ev.ts, ev.xs, ev.ys, (ev.pols > 0).astype(int)]),
                   fmt="%.9f %d %d %d")
        K = calib.K
        calib_txt = os.path.join(tmp, "calib.txt")
        with open(calib_txt, "w") as f:
            f.write(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} 0 0 0 0 0\n")
        _log(f"cli: wrote {n} events to a text file in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        n_parsed = sum(len(c[2]) for c in iter_events(events, 1 << 16))
        _log(f"cli: text parse alone {time.perf_counter() - t0:.2f} s for {n_parsed} events")

        def argv(out, *extra):
            return ["--device", device, "--events", events, "--calib", calib_txt,
                    "--width", str(calib.width), "--height", str(calib.height),
                    "--preset", "ijrr", "--out-dir", os.path.join(tmp, out), *extra]

        # K1 launches inside the IWE-pair renders, counted apart.
        render_launches = [0]
        render = Frontend.render_iwe_pair

        def counted_render(self, *a, **kw):
            before = cuda_iwe.LAUNCHES["fwd"]
            try:
                return render(self, *a, **kw)
            finally:
                render_launches[0] += cuda_iwe.LAUNCHES["fwd"] - before

        walls = {}
        Frontend.render_iwe_pair = counted_render
        try:
            _reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(argv("full", "--refine-passes", "1", "--save-iwe-every", "50",
                               "--save-maps-every", "6"))
            walls["full"] = time.perf_counter() - t0
            launches = dict(cuda_iwe.LAUNCHES)
        finally:
            Frontend.render_iwe_pair = render
        cut = n // 2
        t0 = time.perf_counter()
        rc_cut = cli.main(argv("cut", "--max-events", str(cut)))
        walls["cut"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc_resume = cli.main(argv("resume", "--resume",
                                  os.path.join(tmp, "cut", "final_state.npz")))
        walls["resume"] = time.perf_counter() - t0

        full = os.path.join(tmp, "full")
        files = sorted(os.listdir(full))
        stats = json.load(open(os.path.join(full, "stats.json")))
        times, quats = read_tum_trajectory(os.path.join(full, "trajectory_tum.txt"))
        q_gt = np.stack([spline._np_quat_exp(omega * t) for t in times])
        rms, _ = rotation_rms_deg(times, q_gt, quats, "global")

        def grid(out):
            return np.atleast_2d(np.loadtxt(os.path.join(tmp, out, "angular_velocity.txt")))

        av_full, av_cut, av_res = grid("full"), grid("cut"), grid("resume")
        t_res, q_res = read_tum_trajectory(os.path.join(tmp, "resume", "trajectory_tum.txt"))
        stats_res = json.load(open(os.path.join(tmp, "resume", "stats.json")))
        timers = {k: round(v["total_s"], 3) for k, v in stats["metrics"]["timers"].items()}
        _log(f"cli: full run rc {rc} wall {walls['full']:.2f} s "
             f"(events_per_second {stats['events_per_second']:.0f}, "
             f"{stats['events']} events, {stats['windows']} windows, "
             f"{stats['ang_vel_estimates']} packets); trajectory_tum RMS {rms:.4f} deg; "
             f"launches {launches}, K1 in IWE renders {render_launches[0]}; "
             f"timers_s {json.dumps(timers)}; "
             f"counters {json.dumps(stats['metrics']['counters'])}")
        _log(f"cli: cut at {cut} events rc {rc_cut} wall {walls['cut']:.2f} s; resumed rc "
             f"{rc_resume} wall {walls['resume']:.2f} s "
             f"(events_per_second {stats_res['events_per_second']:.0f}), "
             f"{len(av_cut)} + {len(av_res)} packets of {len(av_full)}")
        outputs = ("angular_velocity.txt", "angular_velocity_deg.txt", "trajectory_tum.txt",
                   "pano_map.png", "final_state.npz", "stats.json")
        checks = {
            "cli rc 0": rc == 0 and rc_cut == 0 and rc_resume == 0,
            "six outputs": all(f in files for f in outputs),
            "iwe and map dumps": (any(f.startswith("local_iwe_") for f in files)
                                  and any(f.startswith("pano_map_") for f in files)),
            "K1 in IWE renders": render_launches[0] > 0,
            "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
            "every event read": stats["events"] == n_parsed == n,
            ">= 15 windows": stats["windows"] >= 15,
            "refine ran": stats["metrics"]["counters"].get("backend.refine_windows", 0) > 0,
            "trajectory_tum RMS < 0.3 deg": rms < 0.3,
            "resume continues the packet grid": (
                len(av_cut) + len(av_res) == len(av_full)
                and np.allclose(np.concatenate([av_cut[:, 0], av_res[:, 0]]), av_full[:, 0],
                                atol=1e-9)),
            "resumed run finite": (stats_res["events"] == n - cut and len(t_res) > 0
                                   and bool(np.isfinite(q_res).all())),
        }
    return launches, checks


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "cmax_slam_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(cmax_slam_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # Full float32 in the blur matmuls (TF32 keeps ~3 digits); these are
    # PyTorch's defaults for matmuls, stated here so no environment changes them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cmax_slam_tpu_torch.ops import cuda_iwe

    card = card_line()
    _log(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    cuda_iwe.build()
    _log(f"build: {time.perf_counter() - t0:.2f} s ({cuda_iwe.library_path().name})")
    kernels = check_kernels(np.random.default_rng(0))
    launches, checks = run_system()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"system checks failed: {failed}")
    cli_launches, checks = run_cli()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli checks failed: {failed}")

    src = "cmax_slam_tpu_torch/csrc/iwe.cu"
    replaces = {"fwd": "cmax_slam_tpu/ops/pallas_iwe.py:276 (_fwd_impl, pallas_call at :289)",
                "bwd": "cmax_slam_tpu/ops/pallas_iwe.py:307 (_vjp_bwd, pallas_call at :350; "
                       "kernel bodies _bwd_kernel_lanes :200 and _bwd_kernel :149)"}
    names = {"fwd": "vote_fwd", "bwd": "vote_bwd"}
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "launches_by_path": {"system": launches[k],
                                                       "cli": cli_launches[k]},
         "max_abs_err": v["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
         "shape": v["shape"], "by_shape": v["by_shape"]}
        for k, v in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
