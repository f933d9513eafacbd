"""Command-line entry point: run the PyTorch port of CMax-SLAM on an event
file; counterpart of cmax_slam_tpu/cli.py, with its flags, presets, outputs
and error messages.

Replaces the reference's process entry + launch harness (src/node.cpp:7-25,
launch/*.launch): dataset preset selection, parameter overrides, streaming
replay, and result output (trajectory in TUM format, angular velocities,
panoramic map PNG, checkpoint).

Usage:
  python -m cmax_slam_tpu_torch.cli --device cuda --events events.txt \
      --calib calib.yaml --preset ijrr --out-dir out/ [--max-events N] \
      [--set key=value ...]

``--device`` is ``cuda`` (the default) or ``cpu``: the port runs on the card
unless asked for the CPU, and ``cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import config as config_mod
from .calib import CameraCalibration
from .io.streams import _limit, iter_events, iter_events_text
from .system import CMaxSLAM
from .utils.image import write_png

PRESETS = {
    "default": lambda: config_mod.SystemConfig(),
    "ijrr": config_mod.ijrr_config,
    "ecrot_synth": config_mod.ecrot_synth_config,
    "ecrot_handheld": config_mod.ecrot_real_config,
    "ecrot_mount": config_mod.ecrot_mount_config,
    "live_davis": config_mod.live_davis_config,
}

_TAG = "[cmax-slam-tpu-torch]"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CMax-SLAM (PyTorch + CUDA port)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="where every solve and the maps live (default: the "
                        "card; 'cuda' without a card raises)")
    p.add_argument("--events", required=True,
                   help="event file (.txt/.zip/.npz/.h5/.bag), or '-' to "
                        "read a live 't x y p' text stream from stdin (the "
                        "live_davis analog: pipe a camera driver in)")
    p.add_argument("--calib", default=None,
                   help="calibration (.yaml ROS camera_info or .txt 'fx fy cx "
                        "cy d...'); optional for .bag input carrying a "
                        "sensor_msgs/CameraInfo topic")
    p.add_argument("--width", type=int, default=None,
                   help="sensor width (required for .txt calib)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--preset", default="default", choices=sorted(PRESETS))
    p.add_argument("--out-dir", default="out")
    p.add_argument("--max-events", type=int, default=None)
    p.add_argument("--chunk-size", type=int, default=1 << 16)
    p.add_argument("--no-backend", action="store_true")
    p.add_argument("--refine-passes", type=int, default=0, metavar="N",
                   help="after the online replay, re-run N offline "
                        "sliding-window BA sweeps over the whole stream "
                        "starting from the online trajectory + map "
                        "(removes the map-bootstrap transient; needs a "
                        "re-readable event file, not stdin)")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   help="save a checkpoint every N seconds of stream time")
    p.add_argument("--resume", default=None, metavar="STATE_NPZ",
                   help="resume from a checkpoint written by a previous run "
                        "of either package")
    p.add_argument("--save-maps-every", type=int, default=0, metavar="K",
                   help="dump pano_map_NNNN.png every K back-end windows "
                        "(the reference's continuous /pano_map publishing; "
                        "implied by backend.show_iwe)")
    p.add_argument("--save-iwe-every", type=int, default=0, metavar="K",
                   help="dump local_iwe_NNNNN.png (zero-motion | compensated)"
                        " every K front-end packets (the reference's "
                        "/local_iwe publishing; implied by frontend.show_iwe)")
    p.add_argument("-v", "--verbose", type=int, default=0, metavar="N",
                   help="glog-style verbosity: 0=warn, 1=info, 2=debug")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, dotted (e.g. frontend.dt_ang_vel=0.01)")
    return p.parse_args(argv)


def apply_overrides(cfg, overrides):
    for kv in overrides:
        key, _, val = kv.partition("=")
        try:
            parsed = json.loads(val)
        except json.JSONDecodeError:
            parsed = val
        try:
            cfg = config_mod.replace(cfg, **{key: parsed})
        except (TypeError, AttributeError) as e:
            raise SystemExit(
                f"unknown config key in --set {kv!r}: {e}\n"
                f"see docs/parameters.md for the catalog"
            ) from None
    return cfg


def load_calibration(args) -> CameraCalibration:
    if args.calib is None:
        # Auto-calibration from the bag's CameraInfo topic, like the
        # reference's camera_info subscriber (src/cmax_slam.cpp:122-145).
        if args.events == "-" or not args.events.endswith(".bag"):
            raise SystemExit("--calib is required unless --events is a .bag "
                             "with a sensor_msgs/CameraInfo topic")
        from .io.rosbag import read_rosbag_camera_info

        try:
            return read_rosbag_camera_info(args.events)
        except ValueError as e:
            raise SystemExit(f"{e}; pass --calib") from None
    if args.calib.endswith((".yaml", ".yml")):
        return CameraCalibration.from_yaml(args.calib)
    if args.width is None or args.height is None:
        raise SystemExit("--width/--height required with .txt calibration")
    return CameraCalibration.from_txt(args.calib, args.width, args.height)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .utils.metrics import configure_logging

    configure_logging(args.verbose)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.refine_passes > 0 and (args.events == "-" or args.no_backend):
        # Reject up front: discovering this after an hours-long live replay
        # would discard the whole run before any output is written.
        raise SystemExit("--refine-passes needs a re-readable event file "
                         "and a back-end (not --events - / --no-backend)")

    calib = load_calibration(args)
    cfg = apply_overrides(PRESETS[args.preset](), args.set)

    # Events stream straight off the file in chunks; the EventStore retires
    # its prefix as the back-end consumes windows, so long recordings replay
    # in bounded memory.
    print(f"{_TAG} streaming events from {args.events} on {args.device}",
          file=sys.stderr)

    slam = CMaxSLAM(calib, cfg, device=args.device, run_backend=not args.no_backend)
    skip = 0
    if args.resume:
        slam.load_checkpoint(args.resume)
        # Skip the raw events the interrupted run already consumed; the
        # checkpoint carries the exact stream position (system.raw_count).
        skip = slam.raw_count
        print(f"{_TAG} resumed from {args.resume} "
              f"(skipping {skip} consumed events)", file=sys.stderr)

    # show_iwe config flags imply continuous image output (the reference
    # publishes /local_iwe and /pano_map topics when show_local_iwe /
    # show_pano_map are set).
    iwe_every = args.save_iwe_every or (1 if cfg.frontend.show_iwe else 0)
    maps_every = args.save_maps_every or (1 if cfg.backend.show_iwe else 0)

    t_wall = time.perf_counter()
    next_ckpt = args.checkpoint_every
    maps_done = 0
    iwe_done = 0
    n_events = 0
    t_first = None
    if args.events == "-":
        source = _limit(iter_events_text(sys.stdin, args.chunk_size), args.max_events)
    else:
        source = iter_events(args.events, args.chunk_size, args.max_events)
    for chunk in source:
        if skip:
            n = len(chunk[2])
            if n <= skip:
                skip -= n
                continue
            chunk = tuple(a[skip:] for a in chunk)
            skip = 0
        n_events += len(chunk[2])
        if t_first is None and len(chunk[2]):
            t_first = float(chunk[2][0])
        ests = slam.push_events(*chunk)
        if iwe_every > 0:
            slam.frontend.finalize_batch(ests)  # the renders read their omega
            for est in ests:
                iwe_done += 1
                if (iwe_done - 1) % iwe_every or est.num_events == 0:
                    continue
                img = slam.frontend.render_iwe_pair(*est.span, est.omega)
                if img is not None:
                    write_png(
                        os.path.join(args.out_dir, f"local_iwe_{iwe_done:05d}.png"),
                        img.astype(np.uint8),
                    )
        if args.checkpoint_every > 0 and len(chunk[2]) and (
            chunk[2][-1] - t_first >= next_ckpt
        ):
            slam.save_checkpoint(os.path.join(args.out_dir, "checkpoint.npz"))
            next_ckpt += args.checkpoint_every
        if (
            maps_every > 0 and slam.backend is not None
            and len(slam.backend.results) >= maps_done + maps_every
        ):
            maps_done = len(slam.backend.results)
            write_png(
                os.path.join(args.out_dir, f"pano_map_{maps_done:04d}.png"),
                slam.backend.render_map(),
            )
    slam.flush()  # join the back-end's window in flight
    if args.refine_passes > 0 and slam.backend is not None:
        slam.refine(
            lambda: iter_events(args.events, args.chunk_size, args.max_events),
            passes=args.refine_passes,
        )
    wall = time.perf_counter() - t_wall

    # --- outputs ---
    av = slam.ang_vel_log
    np.savetxt(
        os.path.join(args.out_dir, "angular_velocity.txt"), av,
        header="t wx wy wz  (rad/s)",
    )
    # deg/s copy for direct parity with the reference's /dvs/angular_velocity
    # topic (TwistStamped in deg/s, ang_vel_estimator.cpp:191-201)
    av_deg = av.copy()
    if len(av_deg):
        av_deg[:, 1:] = np.degrees(av_deg[:, 1:])
    np.savetxt(
        os.path.join(args.out_dir, "angular_velocity_deg.txt"), av_deg,
        header="t wx wy wz  (deg/s)",
    )
    if slam.backend is not None and slam.backend.traj is not None:
        from .utils.evaluate import write_tum_trajectory

        write_tum_trajectory(
            os.path.join(args.out_dir, "trajectory_tum.txt"), slam.backend.traj
        )
        write_png(os.path.join(args.out_dir, "pano_map.png"),
                  slam.backend.render_map())
        slam.save_checkpoint(os.path.join(args.out_dir, "final_state.npz"))

    stats = {
        "events": int(n_events),
        "wall_seconds": wall,
        "events_per_second": n_events / max(wall, 1e-9),
        "ang_vel_estimates": int(len(av)),
        "windows": len(slam.window_results()),
        "metrics": slam.metrics.summary(),
    }
    with open(os.path.join(args.out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps({k: stats[k] for k in
                      ("events", "wall_seconds", "events_per_second",
                       "ang_vel_estimates", "windows")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
