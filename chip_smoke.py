#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (cmax_slam_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: prints ``nvidia-smi --query-gpu=name,power.limit`` as it reports them;
2. build: the host data plane's library (io/native.py: native/evstream.cpp
   with the host C++ compiler into _build/; native.available() must hold),
   then csrc/iwe.cu (the vote kernels), csrc/loop.cu (the loop predicate
   and graph assembly), csrc/pano_vote.cu (K4/K5) and csrc/packet.cu (K6),
   one nvcc each, started together; prints the seconds of each;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (front-end rung sweep, back-end window on a crop,
   old/new split on the full panorama, the batched tracker's lanes) and at
   the kernel-alone headroom shape (2^20 events on 240x180), with dropped
   events, padding and integer coordinates, and operands shared across
   images read in place; both K1 variants (P, G; cuda_iwe.plan_vote_fwd)
   forced at every shape, so P meets band edges on the 384x384 crop, and
   each variant voting only the dropped events must give an all-zero image;
   K2's G forced at every shape and its S (cuda_iwe.plan_vote_bwd) at every shape
   whose image it stages whole (not the 384x384 crop or the 512x1024
   panorama), and the planners' picks through autograd. K2 runs in two
   modes: "full" (dw too, the TPU kernel's whole function) and "paths" (no
   dw, as every path calls it, weights read in place); a small unaligned
   shape with a ragged row end checks the scalar loads, and a launch of
   more than 2^31 events G's 64-bit indexing. Prints per shape the
   planners' variants, each variant's device time in turns (G with the
   zero fill of its output, P, P, G; then the fill alone and G alone;
   G, S, S, G per K2 mode) beside the bound in bytes and us and its share,
   the launch floor (an empty kernel's device time), then the wrapper time
   of each variant and the plain time and, for K2, the bilinear gather of
   F.grid_sample as a yardstick;
   Then K3 (vote_jvp) against its plain version at one window's derivative
   images (15 tangents of 84 700 events on 512x1024) and a small shape, with
   dropped events (their NaN tangents never read) and dropped events alone
   voting zero, this tree's kernel and with --parent the parent's K3
   (ParentJvp); device times with the zero fill in turns, the fill alone
   and this tree's kernel alone beside the bound, the launch floor, wrapper and plain times, and how the events
   share floor pixels (pile_stats).
   Then K4 and K5 (csrc/pano_vote.cu: the back-end objective's spline, warp
   and vote, forward and backward) against their plain version
   (warp_pano.pano_vote_plain and autograd) at phase 4's crop window (6
   knots, 1 024 batches with weight-0 padding, a 384x384 crop whose border
   drops events), the cubic spline with 3 candidates, the full 512x1024
   panorama on the atan2 seam and 768 000 events on 2048x4096: the image
   within 1e-5 of its largest pixel (pixels past it counted), the gradient
   within rtol 2e-3, atol 2e-6 of its scale and exactly 0 on the frozen
   knot, two K5 launches torch.equal; device times (with --parent the
   parent's K4/K5 too, in turns) beside the bound and the launch floor, the
   wrapper's, the plain version's and the composed route's (K1/K2) times.
   Then K6 (ops/cuda_packet.py: the front-end's packet objective in one
   launch) against the chain (warp_events, K1/K2, the band matmuls,
   autograd) at PACKET_SHAPES (the ijrr and default presets' packet and
   9-rung sweep on 180x240, the mean square, a packet of padding alone, a
   packet whose events crowd two blocks' rows past their lists, live_davis'
   packet and sweep on 260x346):
   its "vg" and "f" forms, the value within PACKET_F_RTOL and the gradient
   within PACKET_G_RTOL of its scale, padding alone exactly the chain's
   zeros, the planner's route and the launches counted; per shape each
   form's device time, replay time and graph nodes beside the chain's,
   the wrapper times and the bound.
   Then the loop predicate: a WHILE node gated on a mask of 1, 24 and 2016
   lanes (live lanes first, middle, last, all, none) and an iteration
   counter under a limit, with a nested IF node, run as one graph against
   the same program with its gates read on the host (equal results and
   predicate executions), the predicate kernel's own device time by gate
   length, the time per loop iteration of tools/loop_latency.py's bodies
   (empty, one kernel, one kernel in two segments, the check body, and an
   unfolded gate), the check body also with the host gate; and three
   launches of one program in flight together, each fetching its own
   number;
4. system: CMaxSLAM on the stock ijrr preset, driven through push_events on a
   2.0 s synthetic 240x180 stream at 390k ev/s (make_stream), must keep its
   state on the card, gather its packets from the device event ring (the
   stock front-end schedule), each torch.equal to the packet gathered from
   the host store, run at least 15 BA windows through both kernels (K1's
   launches counted and printed by shape bucket: packet, sweep, crop,
   split, with the variant the planner took, counted per graph execution)
   and track the ground truth to < 0.3 deg RMS. Every packet launch, stride
   and window solve must run as a captured CUDA graph (ops/device_loop.py),
   and the loop must run ahead of the card as the JAX package's does: in
   the push loop the front-end waits no time and the back-end at most once
   per completed window (its fused fetch), besides the stream's start (two)
   and the synchronous re-solves (crop escape, bootstrap), by the counters;
   and no call synchronizes outside the captures, by
   torch.cuda.set_sync_debug_mode("warn") (SyncAudit, which also counts
   the explicit waits by call site); each window comes back from step() or
   flush() exactly once; every push runs one trigger scan through the host
   library (ScanAudit: the scans counted and timed on the host, then the
   same stored times scanned through the library and the plain version in
   turns, with equal results). Prints graph launches per path, the loop
   predicate's executions, captures and their seconds, the waits per
   packet, per stride and per window and the peak device memory, and the
   nodes of one CG iteration of the packet and crop-window programs; K4
   and K5 must have run; every packet objective evaluation on the card on
   the route its program planned (K6's share of them printed per run; 1 in
   the stock system). A captured evaluation
   of the packet objective (K6) must match the chain on the plain vote
   on the card, and one of the crop objective (through K4/K5) the composed
   route (K1/K2) and the plain version; each objective's evaluation
   (packet, crop and full panorama, the latter two through K4/K5 and
   composed), value-only and value-and-grad, captured alone: its nodes,
   replay time and device time per kernel (split_objectives); the graphed
   packet solves minimize_fr_cg
   (the host loop) solving the same packets from the same warm starts
   (median |omega difference| < 0.01 rad/s); the derivative images of
   phase 4's widest window program's last window (derivative_images through
   K3 against the plain tangent vote on the card, and torch.func.jvp of
   pano_iwe, through Vote.jvp, against two of its slices; K3's launches
   counted on that path; K3, and the parent's with --parent,
   checked and timed on that window's own coordinates and tangents); then
   the same stream on the
   per-packet schedule from the host store (frontend.device_store=False,
   batch_sweeps=0), with the same checks, the same packet grid and a median
   omega difference under 0.01 rad/s (the schedules give bit-equal solver
   inputs: what differs is K1's atomic sum order); the largest difference
   must stay under 0.1 rad/s, or the packet that carries it, solved again
   alone from both schedules' warm starts, must reach both logged values;
   both walls are printed, and the host schedule too must show no wait per
   packet. Then phase 4 again once its systems are released: the same
   configuration leases phase 4's pool entries (ops/program_pool.py) and
   must capture no graph; its wall is printed beside phase 4's first. Every
   later phase prints the pooled programs it built and captured, the
   entries it leased again, the pool and the peak device memory. Then a
   ring of 2^15 events on 0.6 s of the
   stream, cut, saved and resumed: appends and packets wrap, the resync
   wraps, lapped packets are gathered from the host store, and every ring
   packet equals its host packet. Then the cubic system: the stock preset
   with backend.trajectory.spline_degree=3 on the same stream, with phase
   4's checks; and the resume pair: 1.0 s of the stream run whole, and cut
   after two windows, saved, loaded into a fresh CMaxSLAM (its ring rebuilt
   from the restored store) and fed the rest: the same window count and
   refined-pose times, the resumed trajectory within 0.05 deg RMS of the
   uninterrupted one. The ring and resume runs print their synchronizing
   calls and waits by call site. RMS readings are printed also with the
   quaternions left unnormalized, the JAX package's yardstick;
5. cli: the same stream written to an IJRR 't x y p' text file and run
   through ``cmax_slam_tpu_torch.cli.main`` on the stock ijrr preset with a
   refine pass, IWE-pair and map dumps: all outputs written, every event
   read back, >= 15 windows, both kernels launched (K1 also inside the IWE
   renders), the TUM trajectory < 0.3 deg RMS, its synchronizing calls and
   waits printed by call site; then a run cut at 1.0 s and one resuming its
   final_state.npz must continue the packet grid;
6. batched: ``cut_packets`` and ``track_batched_compacted(sweeps=2)`` on the
   same stream at full width (240x180, 10 000-event packets, the stock ijrr
   front-end); the cut must scan once and gather every packet through the
   host library, and is timed through the library and the plain versions
   in turns (cut_in_turns: seconds per call, the gather's share, packets
   torch.equal); the tracker called twice: median |omega - omega_true| < 0.2 rad/s, every
   lane's iterations in (0, max_line_searches], every round one graph
   launch of a pooled round program, one host wait per round and one read
   of the result (SyncAudit), both kernels launched, one K1 launch of at
   least 224 lanes' images, and the second call capturing only buckets the
   first did not meet; prints per
   call packets per second, rounds, captures and host reads per round, and
   the median difference against phase 4's sequential log;
7. multi-device on one card, with the device list ["cuda:0", "cuda:0"]: the
   event-sharded window objective against the single-device one, both
   through K4/K5, on a back-end window of the stream with an odd batch
   count (a padding batch), at the ijrr 512x1024 panorama and at 2048x4096
   (the blur's shift-and-add path), value within rtol 2e-5 and gradient
   within rtol 2e-3, atol 2e-6, K5 raw on each shard's operands twice
   torch.equal and exactly 0 for an all-padding shard, K4 and K5 launched
   and K1/K2 not, value_and_grad timed in turns (sharded,
   single-device, single-device, sharded); then the 2-segment replay
   (overlap 0.4 s) on the stock preset, stitched RMS < 0.5 deg, its two
   live segments on distinct pool entries;
8. ecrot: the JAX package's ECRot-real presets at full width
   (run_ecrot_phase). First the pool's entries and bytes held by the ijrr
   phases (program_pool.stats); then on examples/tpu_ecrot_realtime_check.py's
   stream (make_ecrot_stream: 640x480, 5 Mev/s, 1.2 s, 6 000 000 events,
   pushed in 0.1 s chunks; its generation time printed and kept out of
   every wall): (a) the stock ecrot_real_config() (200 000-event packets
   from a 2^22-event device ring that wraps, non-overlapping 0.2 s windows
   of up to 2^20 events on a 2048x4096 panorama) with phase 4's spies and
   gates: BA in at least 5 of the 6 windows, events cut only past the
   window cap and as the reference cuts them, RMS < 0.3 deg, K1, K2, K4,
   K5 and the loop predicate launched, no front-end wait, the back-end's
   waits bounded, no synchronizing call outside captures; then K4 and K5
   on the last crop window that run solved, its own operands (about
   1 048 600 events, the crop it picked, order 2), against the plain
   version as phase 3 holds them (shape "ecrot_crop"); (b) a second
   system of the configuration on the first 0.6 s, which must capture no
   graph (the warm realtime factor); (c) ecrot_mount_config()
   (y_angle_deg = -90) with the reference's live-mode shedding (ECROT_SHED:
   10x front-end and 5x back-end decimation, 20 000-event packets) on the
   same stream: phase 4's gates, BA in at least 5 windows, the front-end's
   events the raw count over 10. Each run prints its wall and realtime
   factor, the frontend.solve/backend.fetch/backend.solve timers, the
   windows and their events before and after the in-batch decimation, the
   crop shapes and each objective's blur path (band matmuls or
   shift-and-add), K1/K2 launches by variant, K4/K5 launches, predicate
   executions, captures, waits by kind and site, peak device memory, the
   pool's entries, bytes and drops, and the RMS against the truth both
   ways. Phase 3 also holds K1 and K2 at this preset's packet shapes
   (ecrot_sweep: 9 rungs x 200 000 events, ecrot_packet: 1 x 200 000, on
   480x640);
9. presets: the CLI's three other presets, each through
   ``cmax_slam_tpu_torch.cli.main`` in this process (run_preset,
   PRESET_RUNS): (a) no --preset (SystemConfig(): 30 000-event packets
   every 0.02 s, one knot per 0.1 s, BA from 3 events a window, the map's
   update cap of 10, a 1024x2048 panorama) on make_stream's camera turning
   at 0.54 rad/s for 1.5 s, a text file, with a refine pass; (b)
   ecrot_synth (70 000-event packets every 0.005 s, a 512x1024 panorama)
   on the ecrot phase's camera and motion at 2 Mev/s for 0.8 s, an .npz
   file read in chunks of 2^17 events; (c) live_davis (10x front-end and
   5x in-batch decimation, 5 000-event packets every 0.04 s, BA on every
   window, no bootstrap re-solve) on a 346x260 camera at 1 Mev/s and 1.0
   rad/s for 1.0 s, fed as 't x y p' lines through a pipe bound to
   sys.stdin (--events -). Each run: rc 0, every event read, the six
   outputs, K1, K2, K4, K5 and the loop predicate launched, phase 4's loop
   gates (no front-end wait, the back-end's waits bounded, no
   synchronizing call outside captures in the push loop), windows cut
   only past their cap as the reference cuts them, BA in 12 of 13 / 5 /
   7 of 8 windows and RMS < 0.3 / 0.3 / 1.5 deg; (a) the map's cap bound
   (update_times past 10), (b) 8 or more packets a front-end launch, (c)
   the front-end's events the raw count over 10 within one per chunk and
   its omega within 0.05 rad/s of the truth at the median. Each prints
   its wall, events/s and realtime factor, the timers, packets, windows
   and their events after the decimation, the crop shapes and blur paths,
   launches by kernel and variant, captures, waits, the pool's new
   entries and their bytes, peak memory and the RMS both ways. Phase 3
   also holds K1 and K2 at these presets' packet shapes (default_sweep /
   default_packet: 9 / 1 x 30 000 on 180x240, synth_sweep / synth_packet:
   9 / 1 x 70 000 on 480x640, live_packet: 1 x 5 000 on 260x346);
10. options: every solver option of the configuration that no other phase
   sets (run_options_phase, OPTION_RUNS), each a first run of its
   configuration on phase 4's 2.0 s stream and stock ijrr preset through
   run_system with phase 4's path checks (every solve a captured graph, no
   front-end wait, the back-end's waits bounded, no synchronizing call
   outside the captures, BA in >= 15 windows, K1, K2, K4, K5 and the loop
   predicate launched): mean_square and gradient_magnitude (both
   contrast_measure 1 / 2, RMS under their gate G; the crop halo h = r + 1
   printed), polak_ribiere (both cg_variant "pr"), fe_sequential (the
   front-end's ladder "sequential"; predicate executions beside phase
   4's), grid (both ladders "grid"), coarse_to_fine (and
   tests/test_frontend.py's cold start on the front-end alone: omega [2.0,
   -3.5, 4.0], 8 000-event packets, median error < 0.25 rad/s), full_pano
   (crop_solver=False: no crop window, every window solve a full-panorama
   program), each RMS < 0.3 deg; trust (max_ba_correction_rad = C,
   TRUST_FRACTION of phase 4's first window's largest knot correction,
   which phase 4 prints per window: between 1 and windows - 1 windows
   rejected, the bootstrap re-solves' rejections counted besides in
   backend.ba_rejected, each rejection leaving IG and update_times
   torch.equal to what they were before it); refine_prior (run_cli with
   --set backend.refine_prior_lambda=100: phase 5's checks, and a window
   program of that prior built by the refine pass). Then ecrot_full_pano
   (run_ecrot_full_pano): ecrot_real_config() with crop_solver=False on
   the ecrot phase's stream (reused): phase 8's gates, BA in >= 5 windows, every window objective
   on the 2048x4096 panorama blurred by shift-and-add, K4/K5 launched on
   it; K4 and K5 on the widest full-panorama program's last window
   (about 10^6 events) against their plain version (shape "ecrot_pano"),
   and that program's own objective captured against the plain route on
   the card (value rtol 2e-5, gradient 2e-3 of its scale + 2e-6). Each run
   prints its wall, captures, the pool's new entries and bytes, peak
   memory, the RMS both ways and its launches.

With ``--parent DIR`` (an unpacked checkout of another commit) phase 3
also builds the parent's csrc/iwe.cu and, where it differs from this
tree's, its csrc/pano_vote.cu, and holds and times its K3 and K4/K5 in
turns with this tree's (ParentJvp: the C interface read from the
parent's source, which must be this tree's; ParentPanoVote: this tree's
launch plan, the parent's C interfaces read from its source, which must
be this tree's), phase 4 captures the crop evaluation
through the parent's K4/K5 too, and at the end it times the loop bodies
(tools/loop_latency.py) and phase 4 on both trees in turns, each turn a
process of its own, and prints the nodes of one CG iteration of each
tree's packet and crop-window programs and how many fewer per gate this
tree's take; ``--fewer-nodes-per-gate K`` fails the run unless both
programs take at least K fewer per gate than the parent's.

Before the last line it prints one JSON object with every kernel's route,
source, launches on each path (the system runs of phase 4, its derivative
images, the small ring, the cubic system, the resume pair, the CLI run of
phase 5, the second batched call of phase 6, the window and replay runs
of phase 7, the three runs of phase 8, the three of phase 9 and the ten
of phase 10, each
counted from 0), error, times and bound, and the same per
variant (K1: G, P), with K1's launches on the system path by shape bucket;
K3's launches are those of the derivative-images path; K4's and K5's by
path, spline order and shape, K4's with the captured crop evaluation's
nodes and time through K4/K5 and through the composed route. A line before
it, "host data plane: {...}", holds the host library's build time, its
scans per system run and the cut's times both ways; the last line is ``{"ok": true,
"device": {...}}``. Imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Main-path vote shapes (tag: B images, N events, H x W, the kernels the
# paths run at this shape (phase 3 checks both at every shape), rows of the
# coordinates and of the weights as the paths hand them to K1 and K2):
# the front-end rung sweep (9 rungs share the packet's weights) and
# value-and-grad, a back-end window's events on a crop, the old/new split on
# the ijrr panorama (both images share the coordinates); then the headroom
# shape, the one at which the JAX package times its kernels alone
# (examples/tpu_kernel_headroom.py), and the only one at which it runs the
# "rows"/"mixed" VJP orientation that K2 also serves.
SHAPES = (
    ("sweep", 9, 10_000, 180, 240, ("fwd",), (9, 1)),
    ("packet", 1, 10_000, 180, 240, ("fwd", "bwd"), (1, 1)),
    ("crop", 1, 1 << 18, 384, 384, ("fwd", "bwd"), (1, 1)),
    ("split", 2, 1 << 18, 512, 1024, ("fwd",), (1, 2)),
    ("headroom", 1, 1 << 20, 180, 240, ("fwd", "bwd"), (1, 1)),
    # Lane-batched front-end (phase 6): the first compacted bucket of the
    # 2 s stream is 224 packets, times 9 vector-ladder rungs per bracket
    # (each packet's weights shared by its rungs), and 224 packets per
    # value-and-grad.
    ("lanes", 2016, 10_000, 180, 240, ("fwd",), (2016, 224)),
    ("lanegrad", 224, 10_000, 180, 240, ("fwd", "bwd"), (224, 224)),
    # The ecrot_real preset's front-end (the ecrot phase): 200 000-event
    # packets on the 640x480 camera, the rung sweep and the value-and-grad.
    ("ecrot_sweep", 9, 200_000, 480, 640, ("fwd",), (9, 1)),
    ("ecrot_packet", 1, 200_000, 480, 640, ("fwd", "bwd"), (1, 1)),
    # The presets phase's front-ends: the default preset's 30 000-event
    # packets on the 240x180 camera, ecrot_synth's 70 000 on 640x480 and
    # live_davis's 5 000 on the DAVIS346's 346x260.
    ("default_sweep", 9, 30_000, 180, 240, ("fwd",), (9, 1)),
    ("default_packet", 1, 30_000, 180, 240, ("fwd", "bwd"), (1, 1)),
    ("synth_sweep", 9, 70_000, 480, 640, ("fwd",), (9, 1)),
    ("synth_packet", 1, 70_000, 480, 640, ("fwd", "bwd"), (1, 1)),
    ("live_packet", 1, 5_000, 260, 346, ("fwd", "bwd"), (1, 1)),
)
# The shape whose times go into the JSON line, per kernel: its widest
# launch on the paths, the batched tracker's.
REPORTED = {"fwd": "lanes", "bwd": "lanegrad"}
# The least time of a kernel: its bytes (each input read once, each output
# written once) over the H100 SXM's 3.35 TB/s, or its float32 operations
# over 67 TFLOP/s (non-tensor), whichever is larger. Operations per event:
# K1 2 floors, 4 differences, 8 products and 4 adds; K2 2 floors, 4
# differences and 21 products, sums and differences over its four gathers;
# K3, per event and tangent image, 2 floors, 4 differences, 4 tangent
# products, 4 sums, 4 weight products and 4 adds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLOPS_PER_EVENT = {"fwd": 18, "bwd": 27, "jvp": 22}
# K3's shapes (tag: T tangent images, N events, H x W): one back-end window
# of the stock preset on its 512x1024 panorama with the linear spline's 3K =
# 15 knot parameters (phase 7's window holds 84 700 events; derivative_images
# launches it), and a small one on the camera image.
JVP_SHAPES = (("window", 15, 84_700, 512, 1024), ("small", 4, 10_000, 180, 240))
# K4/K5's shapes (tag: spline order, M candidates, window span in s,
# events after the back-end's bucketing, image: ("crop", H, W) on the ijrr
# 512x1024 panorama or the ("full", H, W) panorama): phase 4's crop window
# (6 knots, 1 024 batches of 100 events, some of them weight-0 padding, a
# 384x384 crop whose border drops some events), the vector ladder's 3
# candidates on the cubic spline, the full ijrr panorama with the window on
# the atan2 seam, and the headroom shape: 2 s of the stream, 768 000 events
# on the ecrot_real preset's 2048x4096 panorama.
PANO_SHAPES = (
    ("crop", 2, 1, 0.25, 102_400, ("crop", 384, 384)),
    ("cubic", 4, 3, 0.25, 102_400, ("crop", 384, 384)),
    ("pano", 2, 1, 0.25, 102_400, ("full", 512, 1024)),
    ("headroom", 2, 1, 2.0, 768_000, ("full", 2048, 4096)),
)
# Operations per live event and candidate, for K4/K5's bound: K4 the
# rotation (15), the norm, atan2, asin and the projection (about 60 as the
# math library evaluates them) and the vote (18); K5 the same forward, K2's
# 27 and the chain to dL/dR (about 40).
PANO_FLOPS_PER_EVENT = {"pano_fwd": 93, "pano_bwd": 160}
# K2's modes: "full" writes dw too (the TPU kernel's whole function),
# "paths" does not (as every path calls it: no path differentiates weights).
BWD_MODES = {"full": True, "paths": False}


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events(rng, n, h, w, rows, device):
    """Vote inputs like the warps produce: coordinates over the image and
    past its borders, a fifth on integers (the omega = 0 cold start), NaN
    and infinite coordinates, weight-0 padding at the tail. Coordinates are
    (rows[0], n) and weights (rows[1], n), each row read by a group of
    images as the paths share them; rows of weights differ, so that a
    misread group shows."""
    import torch

    r_xy, r_w = rows
    px = rng.uniform(-3, w + 3, (r_xy, n)).astype(np.float32)
    py = rng.uniform(-3, h + 3, (r_xy, n)).astype(np.float32)
    k = n // 5
    px[:, :k] = np.round(px[:, :k])
    py[:, :k] = np.round(py[:, :k])
    px[:, k:k + 3] = [np.nan, np.inf, -np.inf]
    wt = np.ones((r_w, n), np.float32)
    if r_w > 1:
        wt *= rng.uniform(0.5, 1.5, (r_w, n)).astype(np.float32)
    wt[:, -n // 10:] = 0.0  # padding
    return [torch.tensor(a, device=device) for a in (px, py, wt)]


def _dropped(n: int):
    """The events that _events drops in every row: NaN and infinite px, and
    the weight-0 padding."""
    import torch

    k = n // 5
    dropped = torch.zeros(n, dtype=torch.bool, device="cuda")
    dropped[k:k + 3] = True
    dropped[n - n // 10:] = True
    return dropped


def _lead(t, r0: int):
    """A compact (R, n) operand as (r0, R // r0, n): operands of nested row
    counts then broadcast against each other as the paths' operands do."""
    return t.reshape(r0, -1, t.shape[-1])


def bound(kernel: str, b: int, n: int, H: int, W: int, rows, mode: str = "full") -> dict:
    """The least time of one launch at this shape (see HBM_BYTES_PER_S). K1
    reads its compact operands (rows[0] coordinate rows, rows[1] weight
    rows) and writes B images. K2 in "full" mode is counted as it was
    before it read compact operands: three full (B, N) operands and g read,
    three (B, N) gradients written; in "paths" mode as that call moves
    bytes: the compact operands and g read, dpx and dpy written."""
    if kernel == "fwd":
        nbytes = 4 * (n * (2 * rows[0] + rows[1]) + b * H * W)
    elif kernel == "jvp":  # one event row, b tangent rows per coordinate
        nbytes = 4 * (3 * n + 2 * b * n + b * H * W)
    elif mode == "full":
        nbytes = 4 * (6 * b * n + b * H * W)
    else:
        nbytes = 4 * (n * (2 * rows[0] + rows[1]) + b * H * W + 2 * b * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_EVENT[kernel] * b * n / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def device_ms(fn, reps: int = 50) -> tuple:
    """Device time of one call of ``fn`` (raw launches into preallocated
    outputs, no allocation, each kernel once per call), in ms, two ways:
    the mean duration of each kernel that ``reps`` calls ran, summed over
    the kernels, from torch.profiler (a mean over the records it kept, so a
    record it drops or repeats does not skew it); and CUDA events around
    ``reps`` calls back to back over ``reps``, which also count the gaps the
    host leaves and so bound the first from above. A profiler session that
    records no kernel is repeated (one in ~100 did, on an H100); raises if
    three in a row record none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    events_ms = _time_ms(fn, reps)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.count)
        if us > 0:
            return us / 1e3, events_ms
    raise RuntimeError("torch.profiler recorded no kernel time on the card")


def _plain_grads(px, py, wt, g, H, W, r0):
    """Autograd of the plain vote on the compact operands, broadcast to
    their images as the paths' operands are (``_lead``): every gradient
    summed over its operand's row group."""
    import torch
    from cmax_slam_tpu_torch.ops import scatter

    leaves = [t.clone().requires_grad_(True) for t in (px, py, wt)]
    res = scatter.bilinear_accumulate(*(_lead(t, r0) for t in leaves), H, W)
    return leaves, res, torch.autograd.grad(res, leaves, g.reshape(res.shape),
                                            retain_graph=True)


def check_kernels(rng) -> dict:
    """Phase 3. Returns per kernel {max_abs_err over all shapes and
    variants, and per shape: the bound, the device times, the wrapper and
    plain times, the planner's plan and each variant's error and device
    times in turns; for K2 per mode, with the launch floor and the gather
    yardstick}."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, scatter

    out = {"fwd": {"max_abs_err": 0.0, "by_shape": {}},
           "bwd": {"max_abs_err": 0.0, "by_shape": {}}}
    dev = torch.device("cuda", 0)
    attrs = cuda_iwe.device_attrs(dev)
    _log(f"planners: {attrs[0]} SMs, {attrs[1]} B of shared memory per block (opt-in)")
    floor = [device_ms(lambda: cuda_iwe.launch_noop(dev)) for _ in range(2)]
    floor_ms = float(np.mean([f[0] for f in floor]))
    _log(f"launch floor (empty kernel): device {floor[0][0]:.4f}/{floor[1][0]:.4f} ms "
         f"(events {floor[0][1]:.4f}/{floor[1][1]:.4f})")
    out["bwd"]["floor_ms"] = floor_ms
    for tag, b, n, H, W, kernels, rows in SHAPES:
        px, py, wt = _events(rng, n, H, W, rows, "cuda")
        r0 = min(rows)
        grouped = [_lead(t, r0) for t in (px, py, wt)]
        ref = scatter.bilinear_accumulate(*grouped, H, W).reshape(b, H, W)
        torch.cuda.synchronize()
        # Atomic adds land in run-dependent order: float32 sums agree to a
        # few ulps of the largest pixel.
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        variants = list(cuda_iwe.VARIANTS)
        plans = {v: cuda_iwe.plan_vote_fwd(b, n, H, W, *attrs, variant=v)
                 for v in [None, *variants]}
        errs = {}
        dropped = _dropped(n)
        for v in plans:  # the planner's route through ops/scatter.vote, then each forced
            if v is None:
                img = scatter.vote(*(_lead(t, r0) for t in (px, py, wt)), H, W).reshape(b, H, W)
            else:
                img = cuda_iwe.vote_fwd(px, py, wt, H, W, b, variant=v)
            torch.cuda.synchronize()
            err = float((img - ref).abs().max())
            if not (img.shape == ref.shape and torch.isfinite(img).all() and err <= tol):
                raise AssertionError(f"vote_fwd {tag} variant {plans[v].variant}"
                                     f"{'' if v else ' (planned)'}: max err {err} > {tol}")
            errs[v or "planned"] = err
        # Dropped events (NaN and infinite coordinates, weight-0 padding) add
        # exactly nothing: voted alone, every variant gives an all-zero image.
        dead = [t[:, dropped].contiguous() for t in (px, py, wt)]
        for v in variants:
            img = cuda_iwe.vote_fwd(*dead, H, W, b, variant=v)
            torch.cuda.synchronize()
            if bool(img.any()):
                raise AssertionError(f"vote_fwd {tag} variant {v}: dropped events voted")
        del img, ref, dead
        img = torch.empty((b, H, W), device="cuda")

        def launcher(plan, fill=True):
            def launch():
                if fill:
                    img.zero_()
                cuda_iwe.launch_fwd(plan, px, py, wt, img, b, H, W)
            return launch

        # Device time in turns: G with the fill its zeroed output needs
        # ("G" is G plus fill, as the wrapper runs it) and P (which writes
        # every pixel), then back; then the fill alone and G alone on
        # an image already zeroed (it accumulates: only its time counts).
        timed = {v: launcher(plans[v], v == "G") for v in variants}
        timed |= {"fill": lambda: img.zero_(), "G_alone": launcher(plans["G"], False)}
        order = variants + variants[::-1] + ["fill", "G_alone", "G_alone", "fill"]
        dev_t = {v: [] for v in timed}
        evs = {v: [] for v in timed}
        for v in order:
            kern, ev = device_ms(timed[v])
            dev_t[v].append(kern)
            evs[v].append(ev)
        del img
        ms = _time_ms(lambda: cuda_iwe.vote_fwd(px, py, wt, H, W, b))
        wrapper = {v: _time_ms(lambda v=v: cuda_iwe.vote_fwd(px, py, wt, H, W, b, variant=v))
                   for v in variants}
        plain_ms = _time_ms(lambda: scatter.bilinear_accumulate(*grouped, H, W))
        planned = plans[None]
        bd = bound("fwd", b, n, H, W, rows)
        dev_ms = float(np.mean(dev_t[planned.variant]))
        entry = {"plan": planned._asdict(), **bd, "device_ms": dev_ms, "ms": ms,
                 "plain_ms": plain_ms, "fill_ms": dev_t["fill"], "g_alone_ms": dev_t["G_alone"],
                 "variants": {
                     v: {"max_abs_err": errs[v], "device_ms": dev_t[v], "events_ms": evs[v],
                         "wrapper_ms": wrapper[v], "plan": plans[v]._asdict()}
                     for v in variants}}
        _log(f"vote_fwd {tag:8s} B={b} N={n} {H}x{W} rows {rows}: planner "
             f"{planned.variant} ({planned.rows} rows x {planned.bands} bands, "
             f"{planned.smem_bytes} B); max_abs_err {errs['planned']:.3e} planned, "
             + ", ".join(f"{v} {errs[v]:.3e} ({plans[v].bands} bands)" for v in variants)
             + f" (tol {tol:.3e}); device ms in turns (G with its fill) "
             + ", ".join(f"{v} {'/'.join(f'{a:.4f}' for a in t)} (events "
                         f"{'/'.join(f'{e:.4f}' for e in evs[v])})" for v, t in dev_t.items())
             + f"; bound {bd['bytes'] / 1e6:.3f} MB, {bd['bound_ms'] * 1e3:.2f} us "
             f"({bd['bound_by']}), planned at {bd['bound_ms'] / dev_ms:.1%} of it"
             + "".join(f", {v} {bd['bound_ms'] / np.mean(dev_t[v]):.1%}" for v in variants)
             + f"; wrapper {ms:.4f} ms planned, "
             + ", ".join(f"{v} {t:.4f}" for v, t in wrapper.items())
             + f"; plain {plain_ms:.4f} ms")
        out["fwd"]["max_abs_err"] = max([out["fwd"]["max_abs_err"], *errs.values()])
        out["fwd"]["by_shape"][tag] = entry
        del grouped
        entry = check_bwd(tag, b, n, H, W, kernels, rows, px, py, wt, rng, attrs, floor_ms)
        out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], entry["max_abs_err"])
        out["bwd"]["by_shape"][tag] = entry
    out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], check_bwd_unaligned(rng, attrs),
                                    check_bwd_wide(rng, attrs))
    for k, v in out.items():
        rep = v["by_shape"][REPORTED[k]]
        b, n, H, W = next(s[1:5] for s in SHAPES if s[0] == REPORTED[k])
        v.update(shape=f"{REPORTED[k]} {b}x{n}@{H}x{W}", ms=rep["ms"], device_ms=rep["device_ms"],
                 plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"])
    return out


def _bwd_close(tag, got, ref, tol, dropped, what):
    """K2's gradients against the plain version's: within tol, finite, and
    exactly zero on the events every image drops. Returns the max error."""
    import torch

    err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    zeros = all(not bool(x[:, dropped].any()) for x in got)
    if not (finite and zeros and err <= tol):
        raise AssertionError(f"vote_bwd {tag} {what}: max err {err} (tol {tol}), finite "
                             f"{finite}, exact zeros on dropped events {zeros}")
    return err


def check_bwd(tag, b, n, H, W, kernels, rows, px, py, wt, rng, attrs, floor_ms) -> dict:
    """Phase 3's K2 part at one shape: the planner's pick through autograd
    (scatter.vote, Vote.backward) and each variant forced through vote_bwd
    (S only where the image stages whole), in both modes, against the plain
    version's autograd; device times in turns (G, S, S, G; G, G where S
    does not stage) per mode beside that mode's bound; wrapper, plain and
    gather-yardstick times."""
    import torch
    import torch.nn.functional as F
    from cmax_slam_tpu_torch.ops import cuda_iwe, scatter

    r0 = min(rows)
    g = torch.tensor(rng.normal(size=(b, H, W)).astype(np.float32), device="cuda")
    leaves, plain_out, ref = _plain_grads(px, py, wt, g, H, W, r0)
    torch.cuda.synchronize()
    # Gathers with no atomics: only FMA contraction differs, but a shared
    # operand's gradient sums up to B gathers.
    tol = 1e-5 * b * max(1.0, float(g.abs().max()))
    dropped = _dropped(n)
    variants = [v for v in cuda_iwe.BWD_VARIANTS
                if v != "S" or cuda_iwe.stages_whole(H, W, attrs[1])]
    plans = {v: cuda_iwe.plan_vote_bwd(b, n, H, W, *attrs, variant=v)
             for v in [None, *variants]}
    planned = plans[None]
    seen = []
    vote_bwd = cuda_iwe.vote_bwd

    def spy(px_, py_, w_, g_, b_=None, **kw):
        seen.append((px_.shape[0], w_.shape[0], w_.data_ptr(), kw.get("with_dw")))
        return vote_bwd(px_, py_, w_, g_, b_, **kw)

    errs = {m: {} for m in BWD_MODES}
    for mode, with_dw in BWD_MODES.items():
        want = 3 if with_dw else 2
        for v in plans:
            if v is None:  # through autograd: weights need a gradient only in "full"
                lv = [t.clone().requires_grad_(i < 2 or with_dw)
                      for i, t in enumerate((px, py, wt))]
                res = scatter.vote(*(_lead(t, r0) for t in lv), H, W)
                cuda_iwe.vote_bwd, seen[:] = spy, []
                try:
                    got = torch.autograd.grad(res, lv[:want], g.reshape(res.shape))
                finally:
                    cuda_iwe.vote_bwd = vote_bwd
                if seen != [(rows[0], rows[1], lv[2].data_ptr(), with_dw)]:
                    raise AssertionError(f"vote_bwd {tag} {mode}: Vote.backward asked K2 "
                                         f"{seen}, expected compact rows {rows} read in place "
                                         f"and with_dw={with_dw}")
            else:
                d = cuda_iwe.vote_bwd(px, py, wt, g, b, with_dw=with_dw, variant=v)
                if (d[2] is None) == with_dw:
                    raise AssertionError(f"vote_bwd {tag} {mode} {v}: dw {d[2] is not None}")
                got = [cuda_iwe.sum_rows(x, t.shape[0]) for x, t in zip(d[:want], (px, py, wt))]
            torch.cuda.synchronize()
            what = f"{mode} variant {plans[v].variant}{'' if v else ' (planned)'}"
            errs[mode][v or "planned"] = _bwd_close(tag, got, ref[:want], tol, dropped, what)
    del got, res, lv, d

    turns = variants + variants[::-1]
    modes = {}
    dpx, dpy, dw = (torch.empty((b, n), device="cuda") for _ in range(3))
    for mode, with_dw in BWD_MODES.items():
        times = {v: [] for v in variants}
        evs = {v: [] for v in variants}
        for v in turns:
            kern, ev = device_ms(lambda plan=plans[v]: cuda_iwe.launch_bwd(
                plan, px, py, wt, g, dpx, dpy, dw if with_dw else None, b))
            times[v].append(kern)
            evs[v].append(ev)
        bd = bound("bwd", b, n, H, W, rows, mode)
        modes[mode] = {**bd, "device_ms": float(np.mean(times[planned.variant])),
                       "ms": _time_ms(lambda w=with_dw: cuda_iwe.vote_bwd(
                           px, py, wt, g, b, with_dw=w)),
                       "variants": {v: {"max_abs_err": errs[mode][v], "device_ms": times[v],
                                        "events_ms": evs[v]} for v in variants}}
    del dpx, dpy, dw
    plain_ms = _time_ms(lambda: torch.autograd.grad(plain_out, leaves, g.reshape(plain_out.shape),
                                                    retain_graph=True))
    del plain_out, leaves
    # Yardstick: the bilinear gather alone (one of K2's three outputs, with
    # other border rules), on a prebuilt normalized grid of every image's events.
    full = [_lead(t, r0).expand(r0, b // r0, n).reshape(b, n) for t in (px, py)]
    grid = torch.stack([full[0] * (2.0 / (W - 1)) - 1.0,
                        full[1] * (2.0 / (H - 1)) - 1.0], -1).reshape(b, n, 1, 2)
    gather_library_ms = _time_ms(lambda: F.grid_sample(
        g[:, None], grid, mode="bilinear", align_corners=True))
    del grid, full, g
    paths = modes["paths"]
    for mode, m in modes.items():
        _log(f"vote_bwd {tag:8s} B={b} N={n} {H}x{W} rows {rows} {mode:5s}: planner "
             f"{planned.variant} ({planned.smem_bytes} B); max_abs_err "
             f"{errs[mode]['planned']:.3e} planned, "
             + ", ".join(f"{v} {errs[mode][v]:.3e}" for v in variants)
             + f" (tol {tol:.3e}); device ms in turns "
             + ", ".join(f"{v} {a:.4f}/{c:.4f} (events {x['events_ms'][0]:.4f}/"
                         f"{x['events_ms'][1]:.4f})"
                         for v, x in m["variants"].items() for a, c in [x["device_ms"]])
             + f"; bound {m['bytes'] / 1e6:.3f} MB, {m['bound_ms'] * 1e3:.2f} us "
             f"({m['bound_by']}), planned at {m['bound_ms'] / m['device_ms']:.1%} of it; "
             f"floor {floor_ms * 1e3:.2f} us; wrapper {m['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
             f"gather_library {gather_library_ms:.4f} ms"
             f"{'' if 'S' in variants else ' (S does not stage this image)'}"
             f"{'' if 'bwd' in kernels else ' (shape not on a K2 path)'}")
    return {"plan": planned._asdict(), "bytes": paths["bytes"], "bound_ms": paths["bound_ms"],
            "bound_by": paths["bound_by"], "device_ms": paths["device_ms"], "ms": paths["ms"],
            "plain_ms": plain_ms, "floor_ms": floor_ms, "gather_library_ms": gather_library_ms,
            "max_abs_err": max(e for m in errs.values() for e in m.values()), "modes": modes}


def check_bwd_unaligned(rng, attrs) -> float:
    """K2 on operands whose rows start off 16-byte boundaries, with a ragged
    row end (n % 4 = 3) and an unaligned g (S copies it): each variant,
    both modes, against the plain version. Returns the max error."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe

    b, n, H, W, rows = 3, 9_999, 40, 56, (3, 1)

    def shifted(a):  # contiguous, one float past an aligned allocation
        t = torch.empty(a.size + 1, device="cuda")[1:].view(a.shape)
        return t.copy_(torch.tensor(a, device="cuda"))

    px, py, wt = (shifted(t.cpu().numpy()) for t in _events(rng, n, H, W, rows, "cpu"))
    g = shifted(rng.normal(size=(b, H, W)).astype(np.float32))
    _, _, ref = _plain_grads(px, py, wt, g, H, W, 1)
    tol = 1e-5 * b * max(1.0, float(g.abs().max()))
    dropped = _dropped(n)
    err = 0.0
    for mode, with_dw in BWD_MODES.items():
        for v in cuda_iwe.BWD_VARIANTS:
            d = cuda_iwe.vote_bwd(px, py, wt, g, b, with_dw=with_dw, variant=v)
            want = 3 if with_dw else 2
            got = [cuda_iwe.sum_rows(x, t.shape[0]) for x, t in zip(d[:want], (px, py, wt))]
            torch.cuda.synchronize()
            err = max(err, _bwd_close("unaligned", got, ref[:want], tol, dropped,
                                      f"{mode} variant {v}"))
    _log(f"vote_bwd unaligned B={b} N={n} {H}x{W} rows {rows}: both variants, both modes, "
         f"max_abs_err {err:.3e} (tol {tol:.3e})")
    return err


def check_bwd_wide(rng, attrs) -> float:
    """K2 on a launch of more than 2^31 events (2049 images of 8x8 reading
    one shared row of 2^20 events, ~17 GB of gradients), where G indexes in
    64 bits: each variant and the planner's pick, in "paths" mode, against
    the plain version's gradients of the first image and of the last, which
    lies wholly past 2^31. Returns the max error."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe

    b, n, H, W = 2049, 1 << 20, 8, 8
    assert (b - 1) * n >= 1 << 31
    px, py, wt = _events(rng, n, H, W, (1, 1), "cuda")
    g = torch.tensor(rng.normal(size=(b, H, W)).astype(np.float32), device="cuda")
    refs = {i: _plain_grads(px, py, wt, g[i:i + 1], H, W, 1)[2] for i in (0, b - 1)}
    tol = 1e-5 * max(1.0, float(g.abs().max()))
    err, picks, dropped = 0.0, [], _dropped(n)
    for v in (None, *cuda_iwe.BWD_VARIANTS):
        picks.append(cuda_iwe.plan_vote_bwd(b, n, H, W, *attrs, variant=v).variant)
        dpx, dpy, _ = cuda_iwe.vote_bwd(px, py, wt, g, b, with_dw=False, variant=v)
        torch.cuda.synchronize()
        for i, ref in refs.items():
            err = max(err, _bwd_close("wide", [dpx[i:i + 1], dpy[i:i + 1]], ref[:2], tol,
                                      dropped, f"variant {picks[-1]}{'' if v else ' (planned)'} image {i}"))
        del dpx, dpy
    del g
    torch.cuda.empty_cache()
    _log(f"vote_bwd wide B={b} N={n} {H}x{W} rows (1, 1), {b * n} events: planner {picks[0]}, "
         f"forced {', '.join(picks[1:])}, max_abs_err {err:.3e} (tol {tol:.3e})")
    return err


class ParentJvp:
    """K3 of another commit's tree (``chip_smoke.py --parent DIR``): its
    csrc/iwe.cu built beside this tree's and launched through its
    ``iwe_vote_jvp``, for K3's times in turns with this tree's. The C
    interface is read from the parent's source: it must be this tree's
    (K3's interface has not changed since K3 was added), or the parent is
    refused."""

    def __init__(self, root: str):
        from cmax_slam_tpu_torch.ops import cuda_iwe, nvcc

        self.src = Path(root) / "cmax_slam_tpu_torch" / "csrc" / "iwe.cu"
        mine, theirs = (_c_signature(f, "iwe_vote_jvp") for f in (cuda_iwe.SOURCE, self.src))
        if theirs != mine:
            raise RuntimeError(f"the parent's iwe_vote_jvp takes ({theirs}), not this tree's "
                               f"({mine}): its K3 cannot be launched here")
        self.flags = cuda_iwe.nvcc_flags()
        self.path = nvcc.library_path(self.src, self.flags, "libiwe_parent")
        self.lib = None

    def build_job(self) -> tuple:
        return self.src, self.flags, self.path

    def launch(self, px, py, w, tpx, tpy, out, b: int, height: int, width: int) -> None:
        import ctypes
        import torch
        from cmax_slam_tpu_torch.ops import cuda_iwe

        if self.lib is None:
            lib = ctypes.CDLL(str(self.path))
            lib.iwe_vote_jvp.argtypes = cuda_iwe.build().iwe_vote_jvp.argtypes
            lib.iwe_vote_jvp.restype = ctypes.c_int
            self.lib = lib
        err = self.lib.iwe_vote_jvp(
            px.data_ptr(), py.data_ptr(), w.data_ptr(), b // px.shape[0], b // py.shape[0],
            b // w.shape[0], tpx.data_ptr(), tpy.data_ptr(), b // tpx.shape[0],
            b // tpy.shape[0], out.data_ptr(), b, px.shape[1], height, width,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent iwe_vote_jvp launch failed: error {err}")


def _c_signature(path: Path, name: str) -> str:
    """The parameter list of C function ``name`` in source ``path``, with
    its white space collapsed."""
    import re

    m = re.search(rf"\bint {name}\(([^)]*)\)", path.read_text())
    if m is None:
        raise RuntimeError(f"{path} defines no {name}")
    return " ".join(m.group(1).split())


PARENT_JVP: ParentJvp | None = None  # set by --parent DIR
JVP_FLOOR_MS = float("nan")  # the launch floor, set by main from phase 3


def pile_stats(px, py, wt, H: int, W: int) -> dict:
    """How a K3 input's kept events share floor pixels: within each warp of
    32 consecutive events (the share of warps where some lanes share one,
    the mean largest group), and over the whole input (distinct pixels,
    the largest count on one pixel)."""
    x, y, w = (t.reshape(-1).cpu().numpy() for t in (px, py, wt))
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(x), np.floor(y)
        keep = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (w != 0)
    key = np.where(keep, np.nan_to_num(fy) * W + np.nan_to_num(fx), -1).astype(np.int64)
    pad = (-len(key)) % 32
    warps = np.concatenate([key, np.full(pad, -1)]).reshape(-1, 32)
    largest, shared = [], 0
    for row in warps:
        live = row[row >= 0]
        if len(live):
            counts = np.unique(live, return_counts=True)[1]
            largest.append(int(counts.max()))
            shared += int(counts.max() > 1)
    _, counts = np.unique(key[keep], return_counts=True)
    return {"kept": int(keep.sum()), "warps_with_shared_pixel": shared / max(1, len(largest)),
            "mean_largest_group": float(np.mean(largest)) if largest else 0.0,
            "pixels": int(len(counts)), "max_on_one_pixel": int(counts.max()) if len(counts) else 0}


def jvp_case(tag, px, py, wt, tpx, tpy, H, W, dropped, floor_ms) -> dict:
    """K3 at one input: this tree's kernel (and the parent's with --parent)
    against the plain version (scatter.bilinear_accumulate_jvp), within
    1e-5 of the largest pixel, and the dropped events alone voting all-zero
    images; device times of each with the zero fill of its output, in turns
    (this, parent, parent, this), the fill alone and this kernel alone;
    wrapper and plain times."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, scatter

    T, n = tpx.shape
    ref = scatter.bilinear_accumulate_jvp(px[0], py[0], wt[0], tpx, tpy, H, W)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    img = torch.empty((T, H, W), device="cuda")
    mine = f"{cuda_iwe.JVP_ITEMS}/{cuda_iwe.JVP_TANGENTS}"  # events a thread / tangents a chunk
    launchers = {mine: lambda out, *a: cuda_iwe.launch_jvp(*(a or (px, py, wt, tpx, tpy)), out,
                                                           T, H, W)}
    if PARENT_JVP is not None:
        launchers["parent"] = lambda out, *a: PARENT_JVP.launch(
            *(a or (px, py, wt, tpx, tpy)), out, T, H, W)
    dead = [t[:, dropped].contiguous() for t in (px, py, wt, tpx, tpy)]
    errs = {}
    for d, launch in launchers.items():
        img.zero_()
        launch(img)
        torch.cuda.synchronize()
        errs[d] = float((img - ref).abs().max())
        if not (bool(torch.isfinite(img).all()) and errs[d] <= tol):
            raise AssertionError(f"vote_jvp {tag} {d}: max err {errs[d]} > {tol}")
        none = torch.zeros((T, H, W), device="cuda")
        launch(none, *dead)
        torch.cuda.synchronize()
        if bool(none.any()):
            raise AssertionError(f"vote_jvp {tag} {d}: dropped events voted")
    got = cuda_iwe.vote_jvp(px, py, wt, tpx, tpy, H, W, T)
    err = float((got - ref).abs().max())
    if not (got.shape == ref.shape and err <= tol):
        raise AssertionError(f"vote_jvp {tag}: wrapper max err {err} > {tol}")

    def with_fill(launch):
        def call():
            img.zero_()
            launch(img)
        return call

    order = list(launchers)
    dev_t = {d: [] for d in order}
    for d in order + order[::-1]:
        dev_t[d].append(device_ms(with_fill(launchers[d]))[0])
    fill = [device_ms(img.zero_)[0] for _ in range(2)]
    alone = [device_ms(lambda: launchers[mine](img))[0] for _ in range(2)]
    ms = _time_ms(lambda: cuda_iwe.vote_jvp(px, py, wt, tpx, tpy, H, W, T))
    plain_ms = _time_ms(lambda: scatter.bilinear_accumulate_jvp(px[0], py[0], wt[0], tpx, tpy,
                                                                H, W))
    bd = bound("jvp", T, n, H, W, (1, 1))
    dev_ms = float(np.mean(dev_t[mine]))
    piles = pile_stats(px, py, wt, H, W)
    entry = {**bd, "device_ms": dev_ms, "ms": ms, "plain_ms": plain_ms, "floor_ms": floor_ms,
             "fill_ms": fill, "alone_ms": alone, "max_abs_err": errs[mine],
             "designs": {d: {"device_ms": dev_t[d], "max_abs_err": errs[d]} for d in order},
             "design": mine, "piles": piles}
    _log(f"vote_jvp {tag:6s} T={T} N={n} {H}x{W}: piles {json.dumps(piles)}; max_abs_err "
         + ", ".join(f"{d} {e:.3e}" for d, e in errs.items()) + f" (tol {tol:.3e}); device ms "
         f"with the fill, in turns: " + "; ".join(
             f"{d} {'/'.join(f'{a:.4f}' for a in dev_t[d])}" for d in order)
         + f"; fill {'/'.join(f'{a:.4f}' for a in fill)}, {mine} alone "
         f"{'/'.join(f'{a:.4f}' for a in alone)}; bound {bd['bytes'] / 1e6:.3f} MB, "
         f"{bd['bound_ms'] * 1e3:.2f} us ({bd['bound_by']}), {mine} at "
         f"{bd['bound_ms'] / dev_ms:.1%} of it; floor {floor_ms * 1e3:.2f} us; wrapper "
         f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return entry


def check_jvp(rng, floor_ms: float) -> dict:
    """Phase 3's K3 part: vote_jvp at JVP_SHAPES (jvp_case) with _events'
    dropped events (NaN and infinite coordinates, whose tangents are NaN
    too: never read, weight-0 padding). No one PyTorch call computes the
    function (library_ms null). Returns per shape its numbers, and the max
    error over all shapes; run_derivative_images adds the real window's."""
    import torch

    out = {"max_abs_err": 0.0, "by_shape": {}}
    for tag, T, n, H, W in JVP_SHAPES:
        px, py, wt = _events(rng, n, H, W, (1, 1), "cuda")
        tpx, tpy = (torch.tensor(rng.normal(size=(T, n)).astype(np.float32), device="cuda")
                    for _ in range(2))
        k = n // 5
        tpx[:, k:k + 3] = float("nan")
        entry = jvp_case(tag, px, py, wt, tpx, tpy, H, W, _dropped(n), floor_ms)
        out["max_abs_err"] = max(out["max_abs_err"], entry["max_abs_err"])
        out["by_shape"][tag] = entry
    rep = out["by_shape"][JVP_SHAPES[0][0]]
    T, n, H, W = JVP_SHAPES[0][1:]
    out.update(shape=f"{JVP_SHAPES[0][0]} {T}x{n}@{H}x{W}", ms=rep["ms"],
               device_ms=rep["device_ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
               bound_by=rep["bound_by"], floor_ms=floor_ms)
    return out


# K6's shapes (tag, candidates, events, measure, events' kind, camera): the
# ijrr preset's packet (a value and gradient) and sweep (the vector ladder's
# 9 rungs), the default preset's (30 000 events), the mean square at the
# ijrr packet, a packet of weight-0 padding alone, and the default packet's
# events folded into 20 rows ("band": two blocks of the cluster hold them
# all, more than their warps' lists take, so K6 votes the rest at once and
# its gather reads every event again), on make_stream's 240x180 camera
# (None); live_davis' packet (5 000 events) and sweep on a 346x260 camera
# (the presets phase's).
LIVE_CAMERA = (346, 260, 260.0)
PACKET_SHAPES = (("packet", 1, 10_000, 0, "stream", None),
                 ("sweep", 9, 10_000, 0, "stream", None),
                 ("default_packet", 1, 30_000, 0, "stream", None),
                 ("default_sweep", 9, 30_000, 0, "stream", None),
                 ("mean_square", 1, 10_000, 1, "stream", None),
                 ("padding", 1, 10_000, 0, "padding", None),
                 ("band", 1, 30_000, 0, "band", None),
                 ("live_packet", 1, 5_000, 0, "stream", LIVE_CAMERA),
                 ("live_sweep", 9, 5_000, 0, "stream", LIVE_CAMERA))
# K6 against the chain (K1/K2, the band matmuls, autograd) on the card: the
# value within PACKET_F_RTOL of it, the gradient within PACKET_G_RTOL of its
# largest component (the votes sum with atomics in a run-dependent order,
# and the blur's sums run in another order than the matmuls').
PACKET_F_RTOL, PACKET_G_RTOL = 1e-5, 2e-3


def _stream_packet(n: int, kind: str = "stream", camera: tuple | None = None):
    """(packet, camera, omega, u) for n consecutive events of make_stream's
    stream on ``camera`` from 0.5 s, packed as the front-end packs them
    (100-event batches, dts from the packet's middle), with 200 weight-0
    events after them; ``kind`` "padding": weight 0 for all, "band": every
    event's row folded into rows 80-99; omega the stream's truth and u a
    unit direction for the rungs."""
    import torch
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.ops import warp_local

    ev, omega, calib = make_stream(2.0, camera=camera or STREAM_CAMERA)
    cam = _cam(calib)
    i0 = int(np.searchsorted(ev.ts, 0.5))
    S = n + 200
    xs, ys, ts = np.zeros(S, np.int32), np.zeros(S, np.int32), np.zeros(S, np.float32)
    xs[:n], ys[:n] = ev.xs[i0:i0 + n], ev.ys[i0:i0 + n]
    if kind == "band":
        ys[:n] = 80 + ys[:n] % 20
    ts[:n] = ev.ts[i0:i0 + n] - ev.ts[i0]
    valid = np.zeros(S, bool) if kind == "padding" else np.arange(S) < n
    lut = torch.as_tensor(bearing_lut(calib), device="cuda")
    packet = warp_local.make_packet(*(torch.as_tensor(a, device="cuda") for a in (xs, ys, ts)),
                                    torch.as_tensor(valid, device="cuda"), lut, cam, 100,
                                    float(np.float32(0.5 * ts[n - 1])))
    u = np.array([0.3, 0.5, -0.8])
    return packet, cam, np.float32(omega), u / np.linalg.norm(u)


def _lists_overflow(packet, cam, x, measure) -> bool:
    """Whether K6's per-warp lists overflow at the first candidate of x: in
    some block of its cluster some warp warps more events with taps in the
    block's rows than its list holds (cuda_packet.plan_packet_vg's cap)."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_packet, warp_local

    H, W, n = cam.height, cam.width, packet.dts.shape[0]
    plan = cuda_packet.plan_packet_vg(1, n, H, W, 1.0, measure,
                                      cuda_iwe.device_attrs(packet.dts.device)[1])
    px, py = warp_local.warp_events(x.reshape(-1, 3)[:1], packet, cam)
    fx, fy = torch.floor(px[0]), torch.floor(py[0])
    kept = (fx >= 1) & (fx < W - 2) & (fy >= 1) & (fy < H - 2) & (packet.weights != 0)
    warp = (torch.arange(n, device=fy.device) % cuda_packet.THREADS) // 32
    for k in range(cuda_packet.CLUSTER):
        r0, r1 = k * H // cuda_packet.CLUSTER, (k + 1) * H // cuda_packet.CLUSTER
        mine = kept & (fy >= r0 - 1) & (fy < r1)
        per_warp = torch.bincount(warp[mine], minlength=cuda_packet.WARPS)
        if int(per_warp.max()) > plan.cap // cuda_packet.WARPS:
            return True
    return False


def _graph_of(fn, x):
    """``fn(x)`` captured alone into a CUDA graph (after a warm-up on a side
    stream), launches recorded, not counted: (graph, its nodes)."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, device_loop

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), cuda_iwe.recording([]):
        fn(x)
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side), cuda_iwe.recording([]):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn(x)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    nodes = device_loop.graph_nodes(graph)
    graph.instantiate()
    return graph, nodes


def check_packet_objective(floor_ms: float) -> dict:
    """K6 (ops/cuda_packet.py) against the chain at PACKET_SHAPES on the
    card: both forms ("vg" value and gradient, "f" the value), each
    candidate of a sweep, the planner's route at each shape, the launches
    counted; padding alone gives exactly the chain's value and gradient
    (zero). Prints per shape the value's relative error and the gradient's
    largest error against its scale, each form's device time (torch.profiler
    over graph replays, the kernels of one evaluation summed) and replay
    time beside the chain's, the nodes of each captured evaluation, and the
    bound (the events read once and the outputs written once over
    HBM_BYTES_PER_S)."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, warp_local

    out = {"by_shape": {}, "f_rel_err": 0.0, "g_err_over_scale": 0.0, "ok": True}
    for tag, b, n, measure, kind, camera in PACKET_SHAPES:
        packet, cam, omega, u = _stream_packet(n, kind, camera)
        padding = kind == "padding"
        x = torch.as_tensor(omega[None] + (0.05 * 2.0 ** np.arange(-(b // 2), b - b // 2))[:, None]
                            * u[None], dtype=torch.float32, device="cuda")
        x = x[None] if b > 1 else x  # the sweep as (1, M, 3), as the ladder calls f
        route = warp_local.objective_route(packet, cam, 1.0, measure)
        fused = warp_local.make_local_objective(packet, cam, 1.0, measure, route="fused")
        chain = warp_local.make_local_objective(packet, cam, 1.0, measure, route="chain")
        before = dict(cuda_iwe.LAUNCHES)
        v, g = fused[1](x)
        f = fused[0](x)
        launched = {k: cuda_iwe.LAUNCHES[k] - before[k] for k in ("packet_vg", "packet_f")}
        v_ref, g_ref = chain[1](x)
        f_ref = chain[0](x)
        torch.cuda.synchronize()
        scale = float(g_ref.abs().max())
        f_err = float(((v - v_ref).abs() / v_ref.abs().clamp(min=1e-30)).max())
        f_only_err = float(((f - f_ref).abs() / f_ref.abs().clamp(min=1e-30)).max())
        g_err = float((g - g_ref).abs().max())
        if padding:
            ok = (torch.equal(v.abs(), v_ref.abs()) and torch.equal(g.abs(), g_ref.abs())
                  and scale == 0.0)
        else:
            ok = (max(f_err, f_only_err) < PACKET_F_RTOL and g_err < PACKET_G_RTOL * scale
                  and scale > 0)
        ok &= route == "fused" and launched == {"packet_vg": 1, "packet_f": 1}
        overflow = _lists_overflow(packet, cam, x, measure)
        ok &= overflow == (kind == "band")  # the band packet takes K6's other path
        entry = {"b": b, "n": n, "hw": [cam.height, cam.width], "measure": measure,
                 "route": route, "lists_overflow": overflow, "value": v.tolist(),
                 "f_rel_err": max(f_err, f_only_err), "g_abs_err": g_err, "g_scale": scale,
                 "g_err_over_scale": g_err / scale if scale else 0.0, "ok": bool(ok)}
        nbytes = 20 * n + 12 * b + 4 * b
        entry["bound_us"] = nbytes / HBM_BYTES_PER_S * 1e6
        for name, fn in (("vg", fused[1]), ("f", fused[0]), ("chain_vg", chain[1]),
                         ("chain_f", chain[0])):
            graph, (nodes, kernels) = _graph_of(fn, x)
            dev_ms, ev_ms = device_ms(graph.replay, reps=50)
            entry[name] = {"nodes": nodes, "kernel_nodes": kernels, "device_us": dev_ms * 1e3,
                           "replay_us": ev_ms * 1e3,
                           "share": entry["bound_us"] / (dev_ms * 1e3) if dev_ms else None}
            del graph
        entry["wrapper_ms"] = _time_ms(lambda: fused[1](x), reps=20)
        entry["chain_wrapper_ms"] = _time_ms(lambda: chain[1](x), reps=20)
        out["by_shape"][tag] = entry
        out["ok"] &= bool(ok)
        if not padding:
            out["f_rel_err"] = max(out["f_rel_err"], entry["f_rel_err"])
            out["g_err_over_scale"] = max(out["g_err_over_scale"], entry["g_err_over_scale"])
        _log(f"packet_objective {tag} (B {b}, N {n}, {cam.height}x{cam.width}, measure "
             f"{measure}): route "
             f"{route}, lists overflow {overflow}; value rel err {entry['f_rel_err']:.3e} (tol {PACKET_F_RTOL}), gradient "
             f"abs err {g_err:.3e} of scale {scale:.4e} (tol {PACKET_G_RTOL} of it); K6 vg "
             f"{entry['vg']['device_us']:.2f} us device ({entry['vg']['nodes']} nodes), f "
             f"{entry['f']['device_us']:.2f} us; chain vg {entry['chain_vg']['device_us']:.2f} "
             f"us ({entry['chain_vg']['nodes']} nodes), f {entry['chain_f']['device_us']:.2f} "
             f"us; replay vg {entry['vg']['replay_us']:.2f} against the chain's "
             f"{entry['chain_vg']['replay_us']:.2f} us; bound {entry['bound_us']:.4f} us; "
             f"wrapper {entry['wrapper_ms']:.4f} ms (chain {entry['chain_wrapper_ms']:.4f}); "
             f"floor {floor_ms * 1e3:.2f} us; ok {ok}")
    return out


def pano_bound(kernel: str, M: int, N: int, live: int, B: int, K: int, order: int, H: int,
               W: int) -> dict:
    """The least time of one K4 or K5 launch (see HBM_BYTES_PER_S): the
    bearings and weights read once (16 bytes per event), the spline basis,
    knots and increments, and the M images written (K4) or gathered (K5,
    which also writes dL/ddelta); operations counted on the ``live``
    (weight != 0) events of each candidate."""
    nbytes = 4 * (4 * N + B * (1 + order) + 5 * K + 3 * M * K + M * H * W)
    if kernel == "pano_bwd":
        nbytes += 4 * 3 * M * K
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = PANO_FLOPS_PER_EVENT[kernel] * M * live / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def pano_case(order: int, span: float, n_events: int, image: tuple, device: str = "cuda",
              seed: int = 0):
    """A back-end window of the stream for K4/K5 (make_window: the true
    trajectory perturbed, the first knot frozen, batches of 100), cut or
    padded with weight-0 events to ``n_events`` as the back-end buckets
    them; ``image`` ("crop", H, W) places an H x W crop on the 512x1024
    panorama, shifted right of the events' footprint so its border drops
    some of them, ("full", H, W) is the H x W panorama with the window
    turned onto the atan2 seam. Returns (window, panorama, spline basis,
    origin or None, (H, W))."""
    import torch
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.calib import EquirectCamera
    from cmax_slam_tpu_torch.ops import warp_pano

    ev, omega, calib = make_stream(2.0)
    kind, H, W = image
    pano_hw = (512, 1024) if kind == "crop" else (H, W)
    pano = EquirectCamera(width=pano_hw[1], height=pano_hw[0])
    t_lo = 0.5 if span < 1.0 else 0.0
    win = make_window(ev, omega, calib, pano_hw, device, t_lo=t_lo, span=span, seed=seed)
    bs = 100
    n = min(win.weights.shape[0], n_events - n_events // 20 // bs * bs)  # 5% padding
    win = win._replace(bearings=win.bearings[:, :n], batch_times=win.batch_times[:n // bs],
                       weights=win.weights[:n], is_old=win.is_old[:n])
    if n < n_events:  # padding as the back-end's: pixel 0's bearing, weight 0, time 0 - t_lo
        pad = n_events - n
        win = win._replace(
            bearings=torch.cat([win.bearings, win.bearings[:, :1].expand(3, pad)], 1).contiguous(),
            batch_times=torch.cat([win.batch_times, torch.full((pad // bs,), -t_lo,
                                                               device=device)]),
            weights=torch.cat([win.weights, torch.zeros(pad, device=device)]),
            is_old=torch.cat([win.is_old, torch.zeros(pad, dtype=torch.bool, device=device)]))
    knots = win.knots.cpu().numpy().astype(np.float64)
    K = knots.shape[0]
    if kind == "full":  # turn the window about y so its middle looks along phi = pi
        d = spline._np_quat_rotmat_batch(knots[K // 2][None])[0] @ np.array([0.0, 0.0, 1.0])
        q_yaw = spline._np_quat_exp(np.array([0.0, np.pi - np.arctan2(d[0], d[2]), 0.0]))
        knots = np.stack([spline._np_quat_mul(q_yaw, q) for q in knots])
        win = win._replace(knots=torch.tensor(knots, dtype=torch.float32, device=device))
    basis = spline.segment_basis(win.batch_times, win.t0, win.dt_knots, K, order)
    origin = None
    if kind == "crop":
        with torch.no_grad():
            px, py = warp_pano.warp_to_pano(torch.zeros((K, 3), device=device), win, pano, order,
                                            basis)
        live = win.weights > 0
        cx, cy = (0.5 * float(t[live].min() + t[live].max()) for t in (px, py))
        x0 = min(max(int(round(cx - W / 2)) + W // 8, 0), pano.width - W)
        y0 = min(max(int(round(cy - H / 2)), 0), pano.height - H)
        origin = torch.tensor([x0, y0], dtype=torch.float32, device=device)
    return win, pano, basis, origin, (H, W)


class ParentPanoVote:
    """K4/K5 of another commit's tree (``chip_smoke.py --parent DIR``): its
    csrc/pano_vote.cu built beside this tree's and driven by this tree's
    launch plan (cuda_pano_vote.fwd_events, bwd_events and bwd_scratch) for
    phase 3's comparison in turns and the captured crop evaluation through
    it (``_images_by(PARENT)``). The C interface of both kernels is read
    from the parent's source (_c_signature): each must take this tree's
    parameters, or the parent is refused (the first K4/K5 design, before the
    redesign, took a completion counter in K5). Its launcher checks the plan
    against its own limits and returns an error for one it cannot take.
    Launches are counted under this tree's keys."""

    KERNELS = ("iwe_pano_vote_fwd", "iwe_pano_vote_bwd")

    def __init__(self, root: str):
        from cmax_slam_tpu_torch.ops import cuda_pano_vote, nvcc

        self.src = Path(root) / "cmax_slam_tpu_torch" / "csrc" / "pano_vote.cu"
        for name in self.KERNELS:
            mine, theirs = (_c_signature(f, name) for f in (cuda_pano_vote.SOURCE, self.src))
            if theirs != mine:
                raise RuntimeError(f"the parent's {name} takes ({theirs}), not this tree's "
                                   f"({mine}): its K4/K5 cannot be launched here")
        self.flags = cuda_pano_vote.nvcc_flags()
        self.path = nvcc.library_path(self.src, self.flags, "libpano_vote_parent")
        self.lib = None

    def build_job(self) -> tuple:
        return self.src, self.flags, self.path

    def build(self):
        import ctypes
        from cmax_slam_tpu_torch.ops import cuda_pano_vote

        if self.lib is None:
            lib, mine = ctypes.CDLL(str(self.path)), cuda_pano_vote.build()
            for name in self.KERNELS:
                getattr(lib, name).argtypes = getattr(mine, name).argtypes
                getattr(lib, name).restype = ctypes.c_int
            self.lib = lib
        return self.lib

    def _call(self, name: str, *args) -> None:
        import torch

        err = getattr(self.build(), name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {name} launch failed: error {err}")

    def launch_fwd(self, ops, out, height: int, width: int) -> None:
        """One raw K4 launch, as cuda_pano_vote.launch_fwd plans it."""
        from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote

        M, K, B, ebs = cuda_pano_vote.check_operands(ops)
        per_block = cuda_pano_vote.fwd_events(ebs, M * B * ebs,
                                              cuda_iwe.device_attrs(ops.delta.device)[0])
        self._call("iwe_pano_vote_fwd",
                   *cuda_pano_vote._args(ops, M, K, B, ebs, height, width, per_block),
                   out.data_ptr())

    def launch_bwd(self, ops, g, part, out) -> None:
        """One raw K5 launch, as cuda_pano_vote.launch_bwd plans it, with
        ``part`` from cuda_pano_vote.bwd_scratch(ops)."""
        from cmax_slam_tpu_torch.ops import cuda_pano_vote

        M, K, B, ebs = cuda_pano_vote.check_operands(ops)
        self._call("iwe_pano_vote_bwd",
                   *cuda_pano_vote._args(ops, M, K, B, ebs, g.shape[1], g.shape[2],
                                         cuda_pano_vote.bwd_events(ebs)),
                   g.data_ptr(), part.data_ptr(), out.data_ptr())

    def pano_vote_fwd(self, ops, height: int, width: int):
        """cuda_pano_vote.pano_vote_fwd through these kernels."""
        import torch
        from cmax_slam_tpu_torch.ops import cuda_iwe

        M = ops.delta.shape[0]
        out = torch.zeros((M, height, width), device=ops.delta.device)
        self.launch_fwd(ops, out, height, width)
        cuda_iwe._launched("pano_fwd", f"o{ops.order}", (M, ops.weights.shape[0], height, width))
        return out

    def pano_vote_bwd(self, ops, g):
        """cuda_pano_vote.pano_vote_bwd through these kernels."""
        import torch
        from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote

        out = torch.empty_like(ops.delta)
        self.launch_bwd(ops, g, cuda_pano_vote.bwd_scratch(ops), out)
        cuda_iwe._launched("pano_bwd", f"o{ops.order}",
                           (g.shape[0], ops.weights.shape[0], g.shape[1], g.shape[2]))
        return out


PARENT: ParentPanoVote | None = None  # set by --parent DIR


def check_pano_vote(rng, floor_ms: float) -> dict:
    """Phase 3's K4/K5 part: the back-end objective's event chain through
    the kernels against its plain version (warp_pano.pano_vote_plain, with
    autograd for the gradient) on the card at PANO_SHAPES, through the
    route (warp_pano.pano_vote) and through the raw launches, of this tree
    and, with --parent, of the parent's (PARENT): the image within 1e-5 of
    its largest pixel (K4 rounds its coordinates as the plain version does;
    the atomics sum in a run-dependent order), the pixels past that bound
    counted; dL/ddelta within rtol 2e-3, atol 2e-6 of its scale, exactly 0
    on the frozen knot, and two K5 launches on the same inputs torch.equal.
    Device times in turns (parent, this, this, parent; K4 with the zero
    fill of its images and alone, K5; the fill alone) beside
    the bound and the launch floor; the wrapper's, the plain version's and
    the composed route's (warp_to_pano in torch, K1/K2) times. No one
    PyTorch call computes the function (library_ms null). Returns per
    kernel its numbers per shape (this tree's at the top level of each
    shape, each tree's under "designs") and the max error. The ecrot
    phase adds its crop window's shape (pano_check)."""
    out = {k: {"max_abs_err": 0.0, "by_shape": {}} for k in ("pano_fwd", "pano_bwd")}
    for tag, order, M, span, n_events, image in PANO_SHAPES:
        win, pano, basis, origin, _ = pano_case(order, span, n_events, image)
        pano_check(out, tag, order, M, win, pano, basis, origin, image, rng, floor_ms)
    for k, v in out.items():
        rep = v["by_shape"][PANO_SHAPES[0][0]]
        v.update(shape=PANO_SHAPES[0][0], ms=rep["wrapper_ms"], device_ms=rep["device_ms"],
                 plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                 floor_ms=floor_ms)
    return out


def pano_check(out: dict, tag: str, order: int, M: int, win, pano, basis, origin, image: tuple,
               rng, floor_ms: float) -> None:
    """One shape of check_pano_vote: K4/K5 on the window ``win`` (its spline
    basis ``basis``; ``origin`` the crop's (x0, y0) on the panorama ``pano``
    or None for the whole panorama; ``image`` (kind, H, W)) against the
    plain version, timed, into ``out[kernel]["by_shape"][tag]``. The
    window's tensors are only read."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote, warp_pano

    trees = ["this"] + (["parent"] if PARENT is not None else [])
    hw = tuple(image[1:])
    K, B, N = win.knots.shape[0], win.batch_times.shape[0], win.weights.shape[0]
    ebs = N // B
    live = int((win.weights != 0).sum())
    delta = torch.tensor(rng.normal(size=(M, K, 3)) * 2e-3, dtype=torch.float32,
                         device="cuda")
    if M > 1:
        delta[0] = 0.0  # the zero increment: exp's small-angle branch at every knot
    args = (win, pano, order, hw, origin, basis)
    ref = warp_pano.pano_vote_plain(delta, *args)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    g = torch.tensor(rng.normal(size=(M, *hw)), dtype=torch.float32, device="cuda")
    d = delta.clone().requires_grad_(True)
    g_ref = torch.autograd.grad(warp_pano.pano_vote_plain(d, *args), d, g)[0]
    scale = float(g_ref.abs().max())
    g_tol = 2e-3 * scale + 2e-6
    frozen = win.free_mask == 0

    def held(img, dd):
        diff = (img - ref).abs()
        err, parted = float(diff.max()), int((diff > tol).sum())
        g_err = float((dd - g_ref).abs().max())
        frozen_zero = not bool(dd[:, frozen].any())
        ok = (img.shape == ref.shape and bool(torch.isfinite(img).all()) and err <= tol
              and bool(torch.isfinite(dd).all()) and g_err <= g_tol and frozen_zero)
        return {"max_abs_err": err, "pixels_past_tol": parted, "g_max_abs_err": g_err,
                "frozen_knot_zero": frozen_zero, "ok": ok}

    # The route: warp_pano.pano_vote and autograd.
    d = delta.clone().requires_grad_(True)
    got = warp_pano.pano_vote(d, *args)
    route = held(got.detach(), torch.autograd.grad(got, d, g)[0])
    ops = cuda_pano_vote.prepare(delta, win, basis, pano, order, origin)
    sms = cuda_iwe.device_attrs(delta.device)[0]
    plan = {"this": {"fwd": cuda_pano_vote.fwd_events(ebs, M * N, sms),
                     "bwd": cuda_pano_vote.bwd_events(ebs)}}
    if PARENT is not None:  # the parent runs this tree's plan (ParentPanoVote)
        plan["parent"] = plan["this"]
    per, timed = {}, {}
    for tree in trees:
        img = torch.zeros((M, *hw), device="cuda")
        dd = [torch.empty_like(ops.delta) for _ in range(2)]
        part = cuda_pano_vote.bwd_scratch(ops)
        kernels = cuda_pano_vote if tree == "this" else PARENT

        def fwd(img=img, kernels=kernels):
            kernels.launch_fwd(ops, img, *hw)

        def bwd(x, part=part, kernels=kernels):
            kernels.launch_bwd(ops, g, part, x)
        fwd()
        for x in dd:  # twice on the same inputs: deterministic
            bwd(x)
        torch.cuda.synchronize()
        per[tree] = held(img, dd[0]) | {"k5_repeat_equal": bool(torch.equal(*dd))}

        def k4(fill=True, img=img, fwd=fwd):
            if fill:
                img.zero_()
            fwd()

        timed[tree] = {"K4": k4, "K4_alone": lambda k4=k4: k4(False),
                       "K5": lambda bwd=bwd, x=dd[0]: bwd(x)}
    timed["fills"] = {"fill": img.zero_}
    dev_t = {tree: {v: [] for v in fns} for tree, fns in timed.items()}
    turns = trees[::-1] + trees  # parent, this, this, parent
    for v in ("K4", "K5", "K4_alone"):
        for tree in turns:
            dev_t[tree][v].append(device_ms(timed[tree][v])[0])
    for v, fn in timed["fills"].items():
        dev_t["fills"][v] += [device_ms(fn)[0] for _ in range(2)]
    d = delta.clone().requires_grad_(True)
    plain_img = warp_pano.pano_vote_plain(d, *args)
    ms = {
        "pano_fwd": _time_ms(lambda: warp_pano.pano_vote(delta, *args)),
        "pano_bwd": _time_ms(lambda: cuda_pano_vote.pano_vote_bwd(ops, g)),
        "plain_fwd": _time_ms(lambda: warp_pano.pano_vote_plain(delta, *args)),
        "plain_bwd": _time_ms(lambda: torch.autograd.grad(plain_img, d, g,
                                                          retain_graph=True)),
        "composed_fwd": _time_ms(lambda: warp_pano.pano_vote_composed(delta, *args)),
    }
    routes = {"fused": warp_pano.pano_vote, "composed": warp_pano.pano_vote_composed,
              "plain": warp_pano.pano_vote_plain}
    for name, images in routes.items():
        def fwd_bwd(images=images):
            dl = delta.clone().requires_grad_(True)
            torch.autograd.grad(images(dl, *args), dl, g)
        ms[f"{name}_fwd_bwd"] = _time_ms(fwd_bwd)
    del plain_img, d
    ok = route["ok"] and all(v["ok"] and v["k5_repeat_equal"] for v in per.values())
    fills = {v: float(np.mean(t)) for v, t in dev_t["fills"].items()}
    entry = {"order": order, "M": M, "events": N, "live_events": live, "batches": B,
             "knots": K, "image": list(image), "tol": tol, "g_tol": g_tol, "g_scale": scale,
             "floor_ms": floor_ms, "fill_ms": fills["fill"],
             "ms": ms}
    for k, key in (("pano_fwd", "K4"), ("pano_bwd", "K5")):
        bd = pano_bound(k, M, N, live, B, K, order, *hw)
        by_tree = {
            tree: {"device_ms": float(np.mean(dev_t[tree][key])),
                   "device_ms_turns": dev_t[tree][key],
                   "share": bd["bound_ms"] / float(np.mean(dev_t[tree][key])),
                   "per_block": plan[tree]["fwd" if k == "pano_fwd" else "bwd"]}
            | ({"alone_ms": float(np.mean(dev_t[tree]["K4_alone"])),
                "alone_ms_turns": dev_t[tree]["K4_alone"]} if k == "pano_fwd" else {})
            | {x: per[tree][x] for x in ("max_abs_err", "pixels_past_tol", "g_max_abs_err",
                                         "frozen_knot_zero", "k5_repeat_equal")}
            for tree in trees}
        e = entry | bd | by_tree["this"] | {
            "route_max_abs_err": route["max_abs_err"],
            "route_pixels_past_tol": route["pixels_past_tol"],
            "route_g_max_abs_err": route["g_max_abs_err"], "wrapper_ms": ms[k],
            "plain_ms": ms["plain_fwd" if k == "pano_fwd" else "plain_bwd"],
            "designs": by_tree}
        out[k]["by_shape"][tag] = e
        out[k]["max_abs_err"] = max(
            out[k]["max_abs_err"],
            *((v["max_abs_err"] if k == "pano_fwd" else v["g_max_abs_err"])
              for v in (route, *per.values())))

    def turns_of(tree, v):
        return "/".join(f"{a * 1e3:.2f}" for a in dev_t[tree][v])

    bf, bb = (out[k]["by_shape"][tag]["bound_ms"] for k in ("pano_fwd", "pano_bwd"))
    _log(f"pano_vote {tag:8s} order {order} M={M} N={N} ({live} live) B={B} K={K} "
         f"{image[0]} {hw[0]}x{hw[1]}: route K4 max_abs_err {route['max_abs_err']:.3e} "
         f"(tol {tol:.3e}, {route['pixels_past_tol']} pixels past it), K5 "
         f"{route['g_max_abs_err']:.3e} (tol {g_tol:.3e}, scale {scale:.3e}); bound K4 "
         f"{bf * 1e3:.2f} us, K5 {bb * 1e3:.2f} us "
         f"({out['pano_fwd']['by_shape'][tag]['bound_by']}); floor {floor_ms * 1e3:.2f} us;"
         f" fills " + ", ".join(f"{v} {t * 1e3:.2f} us" for v, t in fills.items()))
    for tree in trees:
        v = per[tree]
        _log(f"pano_vote {tag:8s} {tree} (K4 {plan[tree]['fwd']}, K5 {plan[tree]['bwd']} "
             f"events a block): K4 err "
             f"{v['max_abs_err']:.3e} ({v['pixels_past_tol']} past), K5 err "
             f"{v['g_max_abs_err']:.3e}, frozen 0 {v['frozen_knot_zero']}, K5 twice equal "
             f"{v['k5_repeat_equal']}; device us in turns K4 with fill "
             f"{turns_of(tree, 'K4')} ({bf / np.mean(dev_t[tree]['K4']):.1%} of bound), "
             f"alone {turns_of(tree, 'K4_alone')}; K5 {turns_of(tree, 'K5')} "
             f"({bb / np.mean(dev_t[tree]['K5']):.1%})")
    _log(f"pano_vote {tag:8s} ms {json.dumps(ms)}")
    if not ok:
        raise AssertionError(f"pano_vote {tag}: route {route}, trees {per}")
    del got, ref, ops, timed, img, part, dd


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


STREAM_OMEGA = (0.9, -1.3, 1.9)
STREAM_CAMERA = (240, 180, 180.0)  # width, height, fx = fy


def make_stream(duration: float = 2.0, omega: tuple = STREAM_OMEGA, rate: int = 390_000,
                camera: tuple = STREAM_CAMERA):
    """The examples/tpu_realtime_check.py stream (240x180, fx = fy = 180,
    omega = [0.9, -1.3, 1.9], 1200 landmarks, 390k ev/s, seed 11) with the
    landmarks spread over the whole sphere instead of a 120-degree cone:
    in 2 s the camera turns 286 degrees, and with the cone its view leaves
    the landmarks around t = 1.3 s (windows fall to 20k events), where the
    JAX system on the CPU ends 3.3 deg RMS off the truth on this 2 s cut.
    On the sphere every view keeps texture. ``omega``, ``rate`` (events/s)
    and ``camera`` ((width, height, focal length), centred) change the
    motion and the sensor; the draws are the same generator's from seed
    11. Returns (events, omega, calib); cached per argument, so every phase
    reads the same arrays (read-only)."""
    return _make_stream(float(duration), tuple(float(w) for w in omega), int(rate),
                        tuple(camera))


@functools.lru_cache(maxsize=4)
def _make_stream(duration: float, omega: tuple, rate: int, camera: tuple):
    from cmax_slam_tpu_torch.calib import CameraCalibration
    from cmax_slam_tpu_torch.io import synthetic

    W, H, F = camera
    omega = np.array(omega)
    rng = np.random.default_rng(11)
    landmarks = synthetic.make_landmarks(rng, 1200, fov_deg=360.0)
    ev = synthetic.rotating_camera_events(rng, int(rate * duration), duration, omega,
                                          F, F, W / 2, H / 2, W, H,
                                          rot_fn=_rot_fn(omega), landmarks=landmarks)
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]]))
    return ev, omega, calib


def _launches() -> dict:
    """K1/K2 launches by kernel and variant since _reset_launches, and as
    "graph_<key>" the part of them that ran inside CUDA graphs; as
    "host_<function>" the calls of the host data plane's library
    (io/native.py)."""
    from cmax_slam_tpu_torch.io import native
    from cmax_slam_tpu_torch.ops import cuda_iwe

    return (dict(cuda_iwe.LAUNCHES)
            | {f"graph_{k}": v for k, v in cuda_iwe.GRAPH_LAUNCHES.items()}
            | {f"host_{k}": v for k, v in native.CALLS.items()})


def _fused_share(launches: dict):
    """The share of the packet objective's evaluations on the card that K6
    served (None where none ran)."""
    total = launches["packet"] + launches["packet_chain"]
    return launches["packet"] / total if total else None


def _votes_launched(launches: dict) -> bool:
    """K1 launched, and the packet objectives' gradients through K2 (the
    chain) or K6."""
    return launches["fwd"] > 0 and launches["bwd"] + launches["packet_vg"] > 0


def _reset_launches():
    """Every kernel count to 0: K1/K2 by variant, the loop predicate, the
    graph launches and captures of the device programs, the host data
    plane's library calls."""
    from cmax_slam_tpu_torch.io import native
    from cmax_slam_tpu_torch.ops import cuda_iwe, device_loop

    for k in cuda_iwe.LAUNCHES:
        cuda_iwe.LAUNCHES[k] = cuda_iwe.GRAPH_LAUNCHES[k] = 0
    native.CALLS.update(dict.fromkeys(native.CALLS, 0))
    device_loop.LAUNCHES["pred"] = 0
    device_loop.RUNS.clear()
    device_loop.CAPTURES.update(graphs=0, s=0.0)


def _rms_unnormalized(q_ref, q_est) -> float:
    """rotation_rms_deg's reading with the quaternions taken as they are, as
    the JAX package's evaluate.quat_to_rotmats takes them; the port's
    normalizes them first (float32 knots are unit only to ~1e-7)."""
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.utils.evaluate import align_global, angle_deg

    R_ref, R_est = (spline._np_quat_rotmat_batch(np.asarray(q, np.float64))
                    for q in (q_ref, q_est))
    A = align_global(R_ref, R_est)
    errs = np.array([angle_deg(a, A @ b) for a, b in zip(R_ref, R_est)])
    return float(np.sqrt(np.mean(errs ** 2)))


def _rms_vs_truth(traj, omega, samples: int = 80):
    """(RMS against the ground truth in deg, the same unnormalized)."""
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

    grid = np.linspace(traj.t_beg + 1e-6, traj.max_time() - 1e-6, samples)
    q_gt = np.stack([spline._np_quat_exp(omega * t) for t in grid])
    q = traj.evaluate(grid)
    return rotation_rms_deg(grid, q_gt, q, "global")[0], _rms_unnormalized(q_gt, q)


def _spy_packets(fe) -> dict:
    """Hold every packet the front-end ``fe`` solves from its device ring
    against the packet gathered from the host store for the same span
    (dtypes, shapes and values): the ring gather run alone for each live
    lane of a launch from the ring, and the packet the launch's program
    itself gathered last (its static buffers) against its host packet. The
    values are compared on the device, queued behind the launch, so the
    checks wait for nothing; _read_spy reads them after the run. Counts the
    lanes solved from each source. Returns the live tally: ring, host,
    unequal (after _read_spy), program (packets checked in the program's
    buffers, launches whose last lane is live), and s, the host seconds the
    checks took (kept out of the walls)."""
    import torch

    tally = {"ring": 0, "host": 0, "unequal": 0, "program": 0, "s": 0.0, "bad": []}
    launch = fe._launch

    def unequal(a, b):
        """A 0-dim bool on the device: whether the packets differ."""
        if any(x.dtype != y.dtype or x.shape != y.shape for x, y in zip(a, b)):
            return torch.ones((), dtype=torch.bool, device=fe.device)
        return torch.stack([(x != y).any() for x, y in zip(a, b)]).any()

    def spied(ests, flags):
        live = [e for e, f in zip(ests, flags) if f > 0]
        ring = [e for e in live if fe._from_ring(e.span[0])]
        launch(ests, flags)
        t0 = time.perf_counter()
        tally["ring"] += len(ring)
        tally["host"] += len(live) - len(ring)
        for e in ring:
            beg, end = e.span
            t_ref = float(np.float32(e.t - fe._t0))
            xs, ys, ts, _ = fe.store.slice_abs(beg, end)
            host = fe._packet(xs, ys, ts, t_ref)
            tally["bad"].append(unequal(fe._ring_packet(beg, end - beg, t_ref), host))
        if flags[-1] > 0:  # the program's buffers hold the last lane's packet
            beg, end = live[-1].span
            xs, ys, ts, _ = fe.store.slice_abs(beg, end)
            host = fe._packet(xs, ys, ts, float(np.float32(live[-1].t - fe._t0)))
            tally["bad"].append(unequal(fe._solver(len(flags)).packet, host))
            tally["program"] += 1
        tally["s"] += time.perf_counter() - t0

    fe._launch = spied
    return tally


def _read_spy(tally: dict) -> dict:
    """Read a _spy_packets tally's comparisons (one read, after the run)."""
    import torch

    bad, tally["bad"] = tally["bad"], []
    tally["unequal"] += int(torch.stack(bad).sum()) if bad else 0
    return tally


def _spy_steps(be) -> list:
    """The indices of the windows each Backend.step() returns, in order."""
    returned = []
    step = be.step

    def spied():
        out = step()
        returned.extend(r.index for r in out)
        return out

    be.step = spied
    return returned


def _spy_rejected_maps(be, rec: list):
    """Keep on the device, for each window solve of the back-end ``be`` that
    max_ba_correction_rad rejects (Backend._finish_solve), its (index, IG
    and update_times before it, the same after it) in ``rec``, compared
    after the run. Returns the function that removes the spy."""
    finish = be._finish_solve

    def finished(p):
        before = (be.IG.clone(), be.update_times.clone())
        out = finish(p)
        if out[3]:
            rec.append((p["index"], *before, be.IG.clone(), be.update_times.clone()))
        return out

    be._finish_solve = finished
    return lambda: delattr(be, "_finish_solve")


def window_corrections(slam) -> list:
    """Each window solve of the run in order (the one-time bootstrap
    re-solve's at the window that ran it): its index, its pass ("online" or
    "bootstrap"), whether max_ba_correction_rad rejected it, and its largest
    knot correction in deg (WindowResult.correction_rad, the angle that cap
    is held to)."""
    be = slam.backend
    online = [r for r in slam.window_results() if r.ran_ba]
    boot = [r for r in be.bootstrap_results if r.ran_ba]
    at = be.cfg.bootstrap_resolve_window
    rows = [("online", r) for r in online if at is None or r.index < at]
    rows += [("bootstrap", r) for r in boot]
    rows += [("online", r) for r in online if at is not None and r.index >= at]
    return [{"index": r.index, "pass": kind, "deg": math.degrees(r.correction_rad),
             "rejected": r.rejected} for kind, r in rows]


def trust_cap_deg(corrections: list) -> float:
    """The trust run's cap C in deg: TRUST_FRACTION of the largest knot
    correction of a stock run's first online window (``window_corrections``).
    That window solves against an empty map from the front-end's
    trajectory, so its correction varies little between runs (0.158-0.168
    deg in the stock runs of phase 4 measured on an H100, where the median
    over a run's windows ranged 0.066-0.135). Rejections cascade (a rejected
    window leaves the next one farther from its optimum), so the count a
    cap gives is measured, not derived: at 0.6 of it the trust run
    rejected 5-13 of its 18 windows in 6 runs (PERF.md §7)."""
    first = min((c for c in corrections if c["pass"] == "online"), key=lambda c: c["index"])
    return TRUST_FRACTION * first["deg"]


def _site(frame, skip=()) -> str:
    """'file:line function' of the first frame from ``frame`` outward whose
    function is not in ``skip``, the file relative to the checkout."""
    while frame.f_back is not None and frame.f_code.co_name in skip:
        frame = frame.f_back
    path = os.path.relpath(frame.f_code.co_filename, REPO)
    return f"{path}:{frame.f_lineno} {frame.f_code.co_name}"


class SyncAudit:
    """Counts the host's waits for the card over a block, by call site.
    "syncs": every call that synchronizes the host with the card as
    torch.cuda.set_sync_debug_mode("warn") reports it (a blocking copy,
    .item(), a stream or device synchronize), apart from those made while a
    device program captures its graphs (its first run): the waits the loop
    should not have. "waits": the explicit waits of the loop, each
    device_loop Result's event (one per launch fetched; a fused fetch waits
    on several). Counts nothing on the CPU."""

    _WAIT_FRAMES = ("_wait", "fetch_all", "fetch", "finalize_batch", "_fetch", "counted_wait")

    def __init__(self, device: str = "cuda"):
        self.on = device == "cuda"
        self.syncs, self.waits, self.capturing = {}, {}, 0

    def __enter__(self):
        if not self.on:
            return self
        import warnings

        from cmax_slam_tpu_torch.ops import device_loop

        audit = self
        self._capture, self._wait = device_loop.Program._capture, device_loop.Result._wait
        capture, wait = self._capture, self._wait

        def counted_capture(prog):
            audit.capturing += 1
            try:
                return capture(prog)
            finally:
                audit.capturing -= 1

        def counted_wait(res):
            if res._event is not None:
                site = _site(sys._getframe(1), self._WAIT_FRAMES)
                audit.waits[site] = audit.waits.get(site, 0) + 1
            return wait(res)

        device_loop.Program._capture, device_loop.Result._wait = counted_capture, counted_wait
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            if audit.capturing:
                return None
            site = f"{os.path.relpath(filename, REPO)}:{lineno}"
            frame = sys._getframe(1)  # the repository's innermost frame below the call
            while frame is not None and not (
                    frame.f_code.co_filename.startswith(REPO)
                    and frame.f_code.co_filename != filename
                    and frame.f_code.co_name not in ("show", "counted_capture")):
                frame = frame.f_back
            if frame is not None:
                site += " <- " + _site(frame)
            audit.syncs[site] = audit.syncs.get(site, 0) + 1
            return None

        self._set_mode("warn")  # the switch itself synchronizes: not counted
        warnings.showwarning = show
        return self

    @staticmethod
    def _set_mode(mode: str) -> None:
        import warnings

        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode(mode)

    def __exit__(self, *exc):
        if not self.on:
            return False
        from cmax_slam_tpu_torch.ops import device_loop

        self._warnings.__exit__(*exc)
        self._set_mode("default")
        device_loop.Program._capture, device_loop.Result._wait = self._capture, self._wait
        return False

    def report(self, strides: int, windows: int) -> dict:
        """Totals, per front-end launch and per completed window, by site."""
        syncs, waits = sum(self.syncs.values()), sum(self.waits.values())
        return {"syncs": syncs, "syncs_per_stride": syncs / max(strides, 1),
                "syncs_per_window": syncs / max(windows, 1), "event_waits": waits,
                "syncs_by_site": dict(sorted(self.syncs.items(), key=lambda kv: -kv[1])),
                "event_waits_by_site": dict(sorted(self.waits.items(), key=lambda kv: -kv[1]))}


class ScanAudit:
    """The front-end's trigger scans over a block (Frontend._scan_triggers,
    one per push): wraps io/native.scan_triggers, times each library call
    on the host and keeps its operands (the store's times are never written
    in place: a push replaces the array). ``report`` then scans the same
    operands again through the library and through the plain version, in
    turns (library, plain, plain, library), and compares their results."""

    def __enter__(self):
        from cmax_slam_tpu_torch.io import native

        self.native, self.scan, self.calls = native, native.scan_triggers, []

        def timed(*args):
            t0 = time.perf_counter()
            out = self.scan(*args)
            self.calls.append((args, out, time.perf_counter() - t0))
            return out

        native.scan_triggers = timed
        return self

    def __exit__(self, *exc):
        self.native.scan_triggers = self.scan
        return False

    def report(self) -> dict:
        lib_s, plain_s, equal, triggers = [], [], True, 0
        for args, out, _ in self.calls:
            for fn, acc in ((self.scan, lib_s), (self.native.scan_triggers_plain, plain_s),
                            (self.native.scan_triggers_plain, plain_s), (self.scan, lib_s)):
                t0 = time.perf_counter()
                res = fn(*args)
                acc.append(time.perf_counter() - t0)
                equal &= bool(np.array_equal(res[0], out[0])) and res[1:] == out[1:]
            triggers += len(out[0])
        n = len(self.calls)
        return {"calls": n, "triggers": triggers, "equal": equal,
                "in_run_us_per_call": sum(c[2] for c in self.calls) / max(n, 1) * 1e6,
                "library_us_per_call": float(np.mean(lib_s)) * 1e6 if n else None,
                "plain_us_per_call": float(np.mean(plain_s)) * 1e6 if n else None,
                "events_per_call": float(np.mean([len(c[0][0]) for c in self.calls]))
                if n else None}


PUSH_EVENTS = 39_000  # events per push_events call in the system runs


def _push(slam, ev, lo: int, hi: int, chunk: int = PUSH_EVENTS) -> None:
    for i in range(lo, hi, chunk):
        j = min(i + chunk, hi)
        slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])


# Phase 4 runs the stock front-end schedule (the device ring) and then the
# per-packet chain gathered from the host store; the cubic phase sets the
# reference's spline_degree=3 launch knob.
HOST_SCHEDULE = {"frontend.device_store": False, "frontend.batch_sweeps": 0}
CUBIC_KEY = "backend.trajectory.spline_degree"
CUBIC = {CUBIC_KEY: 3}


def _fwd_bucket(b: int, H: int, W: int, cam_hw, pano_hw) -> str:
    """The phase-3 shape a K1 launch of the paths stands for: the packet
    and the rung sweep on the camera image, the old/new split on the
    panorama, the back-end crop on any other image."""
    if (H, W) == cam_hw:
        return {1: "packet", 9: "sweep"}.get(b, f"camera b={b}")
    if (H, W) == pano_hw:
        return "split" if b == 2 else f"panorama b={b}"
    return "crop" if b == 1 else f"crop b={b}"


def _spy_fwd_shapes(tally: dict, cam_hw, pano_hw, pano_tally: dict | None = None):
    """Count each executed K1 launch into ``tally`` by its shape bucket:
    launches, events and launches per planned variant, from the wrapper's
    own counts by shape (cuda_iwe.SHAPE_LAUNCHES: a launch inside a CUDA
    graph counts once per execution); K4 and K5 launches likewise into
    ``pano_tally``, by kernel and image ("pano_fwd crop", "pano_bwd
    panorama", "... M=3" for a batch of candidates), variant the spline
    order. Returns the function that fills the tallies and stops the
    counting."""
    from cmax_slam_tpu_torch.ops import cuda_iwe

    cuda_iwe.SHAPE_LAUNCHES = {}

    def restore():
        seen, cuda_iwe.SHAPE_LAUNCHES = cuda_iwe.SHAPE_LAUNCHES, None
        for (kernel, variant, b, n, height, width), count in seen.items():
            if kernel == "fwd":
                bucket, into = _fwd_bucket(b, height, width, cam_hw, pano_hw), tally
            elif kernel.startswith("pano_") and pano_tally is not None:
                image = "panorama" if (height, width) == pano_hw else "crop"
                bucket, into = f"{kernel} {image}" + (f" M={b}" if b > 1 else ""), pano_tally
            else:
                continue
            s = into.setdefault(bucket, {"launches": 0, "events": 0, "variants": {}})
            s["launches"] += count
            s["events"] += count * b * n
            s["variants"][variant] = s["variants"].get(variant, 0) + count

    return restore


def run_system(device: str = "cuda", overrides=None, label: str = "system",
               duration: float = 2.0, shapes: dict | None = None, audit: bool = False,
               pano_shapes: dict | None = None, min_ba: int = 15,
               rms_deg: float | None = 0.3):
    """Phase 4 (and the cubic and option runs): the stock preset, with
    ``overrides`` (dotted config keys), through the public entry points.
    Returns (launches during the run, {check: passed}, the (T, 4)
    ang_vel_log, the wall in s without the ring-packet checks, the
    CMaxSLAM, _graph_stats). The wall runs from the first push to the last
    result on the host: the pushes, the flush of the window in flight and
    the ang-vel log. ``shapes``, if given, is filled with the run's K1
    launches by shape bucket (``_spy_fwd_shapes``); ``audit`` counts the
    host's waits in the push loop (SyncAudit); the run must take BA in
    ``min_ba`` windows and track the truth within ``rms_deg`` (None: no
    gate)."""
    from cmax_slam_tpu_torch.config import ijrr_config, replace

    overrides = dict(overrides or {})
    t0 = time.perf_counter()
    ev, omega, calib = make_stream(duration)
    _log(f"{label}: {len(ev.ts)} events over {duration} s ({time.perf_counter() - t0:.1f} s to "
         f"generate), overrides {overrides}")
    cfg = replace(ijrr_config(), **overrides)
    launches, checks, log, wall, slam, graphs = drive(
        cfg, ev, omega, calib, device, label, duration, len(ev.ts), PUSH_EVENTS, shapes,
        audit, pano_shapes, rms_deg=rms_deg)
    n_ba = sum(w.ran_ba for w in slam.window_results())
    checks[f">= {min_ba} BA windows"] = n_ba >= min_ba
    checks["spline order"] = (
        slam.backend.traj.order == (4 if overrides.get(CUBIC_KEY) == 3 else 2))
    return launches, checks, log, wall, slam, graphs


def drive(cfg, ev, omega, calib, device: str, label: str, duration: float, n: int,
          push: int, shapes: dict | None = None, audit: bool = False,
          pano_shapes: dict | None = None, spy=None, rms_deg: float | None = 0.3):
    """One CMaxSLAM of ``cfg`` fed the first ``n`` events of the stream
    ``ev`` (true angular velocity ``omega``; ``duration`` s of it) through
    push_events in pushes of ``push`` events, with the packet, step, shape,
    sync and scan spies of phase 4; ``spy(slam)``, if given, is
    called before the run and returns a function called after it. Returns
    what run_system returns, the checks common to every preset's run (RMS
    against the truth under ``rms_deg``, unless None); with
    max_ba_correction_rad set, also that each rejected window left the
    maps torch.equal to what they were before it."""
    import torch
    from cmax_slam_tpu_torch.system import CMaxSLAM

    slam = CMaxSLAM(calib, cfg, device=device)
    tally = _spy_packets(slam.frontend)
    returned = _spy_steps(slam.backend)
    trusted = cfg.backend.max_ba_correction_rad is not None
    rejected_maps = []
    unspy = _spy_rejected_maps(slam.backend, rejected_maps) if trusted else (lambda: None)
    after = spy(slam) if spy is not None else (lambda: None)
    pano = cfg.backend.pano_map
    restore = (_spy_fwd_shapes(shapes, (calib.height, calib.width),
                               (pano.pano_height, pano.pano_width), pano_shapes)
               if shapes is not None else (lambda: None))

    _reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sync_audit = SyncAudit(device if audit else "cpu")
    scans = ScanAudit()
    t0 = time.perf_counter()
    try:
        with sync_audit, scans:
            _push(slam, ev, 0, n, push)
        loop = dict(slam.metrics.counters)  # the push loop's counts alone
        loop["windows_completed"] = len(slam.backend.results)
        tail = slam.backend.flush()
        log = slam.ang_vel_log
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0 - tally["s"]
    after()
    unspy()
    _read_spy(tally)
    launches = _launches()
    graphs = _graph_stats(slam, device, loop, sync_audit)
    graphs["scan"] = scan = scans.report()
    pushes = len(range(0, n, push))

    be = slam.backend
    wins = slam.window_results()
    n_ba = sum(w.ran_ba for w in wins)
    rms, rms_raw = _rms_vs_truth(be.traj, omega)
    graphs["rms_deg"], graphs["rms_unnormalized_deg"] = rms, rms_raw
    graphs["corrections"] = window_corrections(slam)
    counters = slam.metrics.counters
    timers = {k: round(v.total, 3) for k, v in slam.metrics.timers.items()}
    _log(f"{label}: wall {wall:.2f} s for {duration} s of stream (and {tally['s']:.2f} s "
         f"of ring-packet checks), realtime factor {duration / wall:.3f}; packets "
         f"{len(log)}, windows {len(wins)} ({n_ba} with BA); spline order {be.traj.order}; "
         f"trajectory RMS {rms:.4f} deg ({rms_raw:.4f} unnormalized); packets gathered "
         f"from the ring {tally['ring']} (unequal to the host packet {tally['unequal']}), "
         f"from the host store {tally['host']}; timers_s "
         f"{json.dumps(timers)}; counters {json.dumps(dict(counters))}; launches {launches}; "
         f"crop shapes {sorted(be._crop_shapes)}; graphs {json.dumps(graphs)}")
    _log(f"{label}: waits in the push loop: front-end {graphs['frontend_waits']} "
         f"({graphs['host_reads_per_packet']:.4f} per packet, "
         f"{graphs['host_reads_per_stride']:.4f} per launch), back-end "
         f"{graphs['backend_waits']} ({graphs['host_reads_per_window']:.4f} per completed "
         f"window, {graphs['resolves']} synchronous re-solves); sync-debug "
         f"{json.dumps(graphs.get('audit'))}")
    _log(f"{label}: largest knot correction per window in deg (index, pass, rejected) "
         + ", ".join(f"{c['index']} {c['pass']}{' rejected' if c['rejected'] else ''} "
                     f"{c['deg']:.5f}" for c in graphs["corrections"]))
    _log(f"{label}: trigger scans through the host library {launches['host_scan_triggers']} "
         f"for {pushes} pushes ({scan['triggers']} triggers, {scan['events_per_call']} stored "
         f"events per scan); host us per scan {scan['in_run_us_per_call']:.2f} in the run, "
         f"{scan['library_us_per_call']:.2f} library against {scan['plain_us_per_call']:.2f} "
         f"plain on the same stored times (in turns); results equal {scan['equal']}")
    checks = {
        "state on the device": all(t.device.type == device for t in (
            be.IG, be.update_times, be.lut_dev, slam.frontend.lut)),
        "K1 launched, and K2 or K6": _votes_launched(launches),
        "K4 and K5 launched": launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0,
        "every push scanned through the host library": (
            launches["host_scan_triggers"] == scan["calls"] == pushes > 0),
        "library scans equal the plain version's": scan["equal"],
        "finite omega log": log.shape[1] == 4 and bool(np.isfinite(log).all()),
        "each window returned once by step/flush": (
            returned + ([tail.index] if tail is not None else []) == [w.index for w in wins]),
    }
    routes = sorted({r for p in slam.frontend._entry.programs.values() for r in p.routes})
    graphs["objective_routes"] = routes
    graphs["fused_share"] = _fused_share(launches) if device == "cuda" else None
    _log(f"{label}: front-end objectives by route {routes}; packet objective evaluations: "
         f"K6 {launches['packet']} ({launches['packet_vg']} vg, {launches['packet_f']} f), "
         f"chain {launches['packet_chain']} ({launches['packet_chain_vg']} vg, "
         f"{launches['packet_chain_f']} f); K6's share {graphs['fused_share']}")
    if device == "cuda":
        checks["each objective evaluated on its route"] = all(
            (launches[k] > 0) == (r in routes) for k, r in (("packet", "fused"),
                                                           ("packet_chain", "chain")))
    if rms_deg is not None:
        checks[f"RMS < {rms_deg} deg"] = rms < rms_deg
    checks |= _graph_checks(graphs, cfg, device)
    if trusted:
        checks["a rejected window leaves IG and update_times torch.equal to before it"] = all(
            torch.equal(a, c) and torch.equal(b, d)
            for _, a, b, c, d in rejected_maps)
        graphs["rejected_windows"] = [m[0] for m in rejected_maps]
    if cfg.frontend.device_store:  # the stock schedule gathers from the ring
        checks["packets gathered from the ring"] = (
            tally["ring"] == counters["frontend.ring_packets"] > 0)
        checks["ring packets torch.equal host packets"] = tally["unequal"] == 0
    else:
        checks["no ring packets"] = tally["ring"] == 0 and "frontend.ring_packets" not in counters
    return launches, checks, log, wall, slam, graphs


def _graph_stats(slam, device: str, loop: dict, sync_audit=None) -> dict:
    """What the run's device programs did: graph launches per program, loop
    predicate executions, captures and their seconds, the waits of the push
    loop (``loop``: its counters) per packet, per front-end launch and per
    completed window, the synchronous re-solves, peak device memory, and
    the SyncAudit's counts. The counts were reset with the launches
    (_reset_launches); the estimates are finalized."""
    import torch
    from cmax_slam_tpu_torch.ops import device_loop

    be = slam.backend
    packets = sum(1 for e in slam.frontend.estimates if e.iters > 0)
    windows = loop["windows_completed"]
    launches = loop.get("frontend.launches", 0)
    resolves = (loop.get("backend.crop_escapes", 0)
                + sum(r.ran_ba for r in be.bootstrap_results))
    out = {
        "runs": dict(device_loop.RUNS), "pred": device_loop.LAUNCHES["pred"],
        "captures": dict(device_loop.CAPTURES),
        "frontend_launches": launches,
        "stride_launches": loop.get("frontend.stride_launches", 0),
        "frontend_waits": loop.get("frontend.host_reads", 0),
        "backend_waits": loop.get("backend.host_reads", 0),
        "host_reads_per_packet": loop.get("frontend.host_reads", 0) / max(packets, 1),
        "host_reads_per_stride": loop.get("frontend.host_reads", 0) / max(launches, 1),
        "host_reads_per_window": loop.get("backend.host_reads", 0) / max(windows, 1),
        "resolves": resolves, "windows_completed_in_loop": windows,
        "solved_packets": packets, "ba_windows": sum(w.ran_ba for w in be.results),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0),
    }
    if sync_audit is not None and sync_audit.on:
        out["audit"] = sync_audit.report(launches, windows)
    return out


def _graph_checks(graphs: dict, cfg, device: str) -> dict:
    """Every solve of the run went through captured graphs (on the card);
    the push loop's front-end waited no time, and its back-end at most once
    per completed window, besides the stream's start (the first estimate,
    the integrator's anchor, and the first window's estimates, fetched
    before any window is in flight) and the synchronous re-solves; with the
    sync audit, no hidden wait outside the captures."""
    runs = graphs["runs"]
    out = {
        "front-end: no wait in the loop": (
            graphs["frontend_waits"] == 0 and graphs["frontend_launches"] > 0),
        "back-end: <= 1 wait per completed window + 2 at the start + re-solves": (
            graphs["backend_waits"]
            <= graphs["windows_completed_in_loop"] + 2 + graphs["resolves"]),
    }
    if "audit" in graphs:
        out["no synchronizing call in the loop outside captures"] = graphs["audit"]["syncs"] == 0
    if device == "cuda":
        out["front-end solves ran as graphs"] = (
            runs.get("frontend", 0) == graphs["frontend_launches"] > 0)
        out["window solves ran as graphs"] = (
            runs.get("backend.crop", 0) + runs.get("backend.full", 0) > 0)
    if cfg.frontend.batch_sweeps > 0:
        out["strides launched"] = graphs["stride_launches"] > 0
    return out


def run_ring_wrap(device: str = "cuda", duration: float = 0.6, capacity: int = 1 << 15):
    """The stock preset with a device ring of ``capacity`` events on
    ``duration`` s of phase 4's stream, cut halfway at a push, saved and
    resumed in a fresh CMaxSLAM: 39 000-event pushes split into appends
    that wrap, packets that wrap, a resync of more events than the ring
    holds, and packets the ring has lapped gathered from the host store.
    Every ring packet must be torch.equal to its host packet. The host's
    waits in both runs are counted (SyncAudit) and printed. Returns
    (launches, {check: passed})."""
    from cmax_slam_tpu_torch.config import ijrr_config, replace
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.system import CMaxSLAM

    ev, omega, calib = make_stream(duration)
    n, chunk = len(ev.ts), 39_000
    cfg = replace(ijrr_config(), **{"frontend.device_store_capacity": capacity})
    _reset_launches()
    t0 = time.perf_counter()
    audit = SyncAudit(device)
    first = CMaxSLAM(calib, cfg, device=device)
    tallies = [_spy_packets(first.frontend)]
    cut = (n // 2) // chunk * chunk
    with audit:
        _push(first, ev, 0, cut, chunk)
        with tempfile.TemporaryDirectory(prefix="cmax_ring_") as tmp:
            path = os.path.join(tmp, "cut.npz")
            first.save_checkpoint(path)
            resumed = CMaxSLAM(calib, cfg, device=device)
            resumed.load_checkpoint(path)
        ring = resumed.frontend._ring
        window = resumed.store.total - resumed.store.base
        tallies.append(_spy_packets(resumed.frontend))
        _push(resumed, ev, resumed.raw_count, n, chunk)
    resumed.flush()
    log = np.concatenate([first.ang_vel_log, resumed.ang_vel_log])
    wall = time.perf_counter() - t0
    launches = _launches()
    tally = {k: sum(_read_spy(t)[k] for t in tallies) for k in ("ring", "host", "unequal")}
    err = np.linalg.norm(log[:, 1:] - omega, axis=1)
    strides = sum(s.metrics.counters.get("frontend.launches", 0) for s in (first, resumed))
    _log("ring_wrap: host waits (both runs, the save and the load included) "
         + json.dumps(audit.report(strides, len(resumed.backend.results)
                                   + len(first.backend.results))))
    _log(f"ring_wrap: ring of {ring.capacity} events, {n} events over {duration} s cut at "
         f"{cut}; resync of {window} stored events; packets {len(log)}: from the ring "
         f"{tally['ring']} (unequal to the host packet {tally['unequal']}), lapped and "
         f"gathered from the host store {tally['host']}; median |omega - omega_true| "
         f"{np.median(err):.4f} rad/s; wall {wall:.2f} s; launches {launches}")
    return launches, {
        "ring wrapped": ring.hi > 2 * ring.capacity,
        "resync of more events than the ring holds": window > ring.capacity,
        "packets gathered from the ring": tally["ring"] > 0,
        "ring packets torch.equal host packets": tally["unequal"] == 0,
        "lapped packets gathered from the host store": tally["host"] > 0,
        "every packet gathered once": tally["ring"] + tally["host"] == len(log),
        "median omega error < 0.1 rad/s": bool(np.median(err) < 0.1),
    }


def packet_solver(slam, ev, k: int):
    """A function that solves packet ``k`` of a finished run again, alone,
    from a given warm start, on a fresh front-end that gathers it from the
    host store, and returns (omega, cost, iterations)."""
    from cmax_slam_tpu_torch.config import replace
    from cmax_slam_tpu_torch.frontend import Frontend

    fe0 = slam.frontend
    est = fe0.estimates[k]
    beg, end = est.span
    fe = Frontend(fe0.cam, fe0.lut.cpu().numpy(), replace(fe0.cfg, device_store=False),
                  device=fe0.device)
    fe.store.append(ev.xs[:end], ev.ys[:end], ev.ts[:end], ev.pols[:end])
    fe._t0 = fe0._t0

    def solve(omega0):
        fe.omega = omega0
        fe._t_packet = est.t
        e = fe._process_packet(beg, end)
        fe.finalize_batch([e])
        return e.omega, e.cost, e.iters

    return solve


def compare_schedules(slam_stock, wall_stock, slam_host, wall_host, duration: float = 2.0,
                      reach: float = 0.02, max_rounds: int = 48) -> dict:
    """Phase 4's stream on both schedules: the same packet grid, and per-packet
    omega apart only by K1's atomic sum order (the schedules give bit-equal
    solver inputs, which run_system holds packet by packet). The packet that
    differs most is solved again alone from each schedule's warm start (its
    left neighbour's omega in that run) on the card, four rounds, and where
    the two logs differ there by 0.1 rad/s or more, up to ``max_rounds``
    until the re-solves have reached each logged value (within ``reach``
    rad/s): both must be optima that the same inputs lead to. Returns
    {check: passed}."""
    ev, omega, _ = make_stream(duration)
    log_stock, log_host = slam_stock.ang_vel_log, slam_host.ang_vel_log
    same_grid = log_stock.shape == log_host.shape and np.allclose(
        log_stock[:, 0], log_host[:, 0], atol=1e-9)
    diff = (np.linalg.norm(log_stock[:, 1:] - log_host[:, 1:], axis=1) if same_grid
            else np.array([np.inf]))
    k = int(np.argmax(diff))
    checks = {"same packet grid": same_grid,
              "median omega difference < 0.01 rad/s": float(np.median(diff)) < 0.01}
    _log(f"schedules: stock (ring) wall {wall_stock:.2f} s, host per-packet wall "
         f"{wall_host:.2f} s; per-packet |omega difference| median {np.median(diff):.3e} "
         f"max {diff.max():.3e} rad/s, {int((diff == 0).sum())} of {len(diff)} packets equal")
    if not same_grid:
        return checks
    logged = {"stock": log_stock[k, 1:], "host": log_host[k, 1:]}
    warm = {name: (log[k - 1, 1:] if k else np.zeros(3))
            for name, log in (("stock", log_stock), ("host", log_host))}
    solve = packet_solver(slam_stock, ev, k)
    solves = []  # (warm start, omega, cost)
    for r in range(max_rounds):
        solves += [(name, *solve(w)[:2]) for name, w in warm.items()]
        reached = {name: min(np.linalg.norm(o - v) for _, o, _ in solves)
                   for name, v in logged.items()}
        if r >= 3 and (diff[k] < 0.1 or max(reached.values()) < reach):
            break
    ends = []  # distinct end points: [omega, cost, {warm start: count}]
    for name, o, c in solves:
        e = next((e for e in ends if np.linalg.norm(e[0] - o) < reach), None)
        if e is None:
            e = [o, c, {}]
            ends.append(e)
        e[2][name] = e[2].get(name, 0) + 1
    _log(f"schedules: worst packet {k} at t = {log_stock[k, 0] - log_stock[0, 0]:.3f} s "
         f"({diff[k]:.4f} rad/s apart); |omega - omega_true| stock "
         f"{np.linalg.norm(logged['stock'] - omega):.4f}, host "
         f"{np.linalg.norm(logged['host'] - omega):.4f}; warm starts "
         f"{np.linalg.norm(warm['stock'] - warm['host']):.3e} rad/s apart; {len(solves)} "
         f"re-solves end at: " + "; ".join(
             f"omega {np.round(o, 4).tolist()} cost {c:.6f} (|omega - omega_true| "
             f"{np.linalg.norm(o - omega):.4f}; from the warm start of {n})"
             for o, c, n in ends)
         + f"; nearest to the stock value {reached['stock']:.4f}, to the host value "
         f"{reached['host']:.4f} rad/s")
    checks["largest difference < 0.1 rad/s, or both values optima of the same inputs"] = bool(
        diff[k] < 0.1 or max(reached.values()) < reach)
    return checks


def run_resume(device: str = "cuda", duration: float = 1.0):
    """The resume pair: phase 4's stream (``duration`` s) run uninterrupted,
    and cut once two windows have completed, saved with save_checkpoint,
    loaded by load_checkpoint into a fresh CMaxSLAM (which rebuilds its
    device ring from the restored store) and fed the remaining events. The
    resumed trajectory must lie within 0.05 deg RMS of the uninterrupted one
    on their common span (the JAX package's gate, tests/
    test_checkpoint_resume.py). The cut run also goes on to the end: its gap
    to the resumed run is the resume's alone, its gap to the uninterrupted
    run the card's run-to-run spread (K1 sums in a run-dependent order).
    Returns (launches of the three runs, {check: passed})."""
    import torch
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.system import CMaxSLAM
    from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

    ev, omega, calib = make_stream(duration)
    n, chunk = len(ev.ts), 39_000
    _reset_launches()
    t0 = time.perf_counter()
    audit = SyncAudit(device)
    with audit:
        whole = CMaxSLAM(calib, ijrr_config(), device=device)
        _push(whole, ev, 0, n, chunk)
        cut_run = CMaxSLAM(calib, ijrr_config(), device=device)
        cut = 0
        while cut_run.backend.count_window < 2 and cut < n:
            _push(cut_run, ev, cut, cut + chunk, chunk)
            cut = min(cut + chunk, n)
        with tempfile.TemporaryDirectory(prefix="cmax_resume_") as tmp:
            path = os.path.join(tmp, "cut.npz")
            cut_run.save_checkpoint(path)
            resumed = CMaxSLAM(calib, ijrr_config(), device=device)
            resumed.load_checkpoint(path)
        windows_at_cut = cut_run.backend.count_window
        ring = resumed.frontend._ring
        resynced = ring.hi == resumed.store.total and resumed.store.base < cut
        _push(resumed, ev, resumed.raw_count, n, chunk)
        _push(cut_run, ev, cut, n, chunk)  # the cut run goes on as if never saved
    runs = (whole, cut_run, resumed)
    for s in runs:
        s.flush()
        s.ang_vel_log  # finalizes every estimate: their launches are counted
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    _log("resume: host waits (three runs, the save and the load included) " + json.dumps(
        audit.report(sum(s.metrics.counters.get("frontend.launches", 0) for s in runs),
                     sum(len(s.backend.results) for s in runs))))

    def gap(a, c):
        ta, tc = a.backend.traj, c.backend.traj
        grid = np.linspace(max(ta.t_beg, tc.t_beg) + 1e-6,
                           min(ta.max_time(), tc.max_time()) - 1e-6, 100)
        rms, errs = rotation_rms_deg(grid, ta.evaluate(grid), tc.evaluate(grid), "global")
        return rms, errs.max(), grid[-1] - grid[0]

    rms, worst, span = gap(whole, resumed)
    ta, tr = whole.backend.traj, resumed.backend.traj
    grid = np.linspace(max(ta.t_beg, tr.t_beg) + 1e-6, min(ta.max_time(), tr.max_time()) - 1e-6,
                       100)
    rms_raw = _rms_unnormalized(ta.evaluate(grid), tr.evaluate(grid))
    rms_saved, _, _ = gap(cut_run, resumed)
    rms_runs, _, _ = gap(whole, cut_run)
    t_a = [t for t, _ in whole.backend.trajectory_log]
    t_c = [t for t, _ in resumed.backend.trajectory_log]
    ring_packets = resumed.metrics.counters.get("frontend.ring_packets", 0)
    _log(f"resume: {duration} s stream cut at {cut} of {n} events after "
         f"{windows_at_cut} windows; resumed vs uninterrupted RMS {rms:.4f} deg "
         f"(max {worst:.4f}; {rms_raw:.4f} unnormalized) over {span:.3f} s; resumed vs the saved run gone on "
         f"{rms_saved:.4f} deg; the two unresumed runs {rms_runs:.4f} deg; windows "
         f"{resumed.backend.count_window} vs {whole.backend.count_window}; ring rebuilt from "
         f"{resumed.store.total - resumed.store.base} stored events, {ring_packets:.0f} "
         f"packets gathered from it after the resume; wall {wall:.2f} s for three runs; "
         f"launches {launches}")
    checks = {
        "cut after >= 2 windows, before the end": windows_at_cut >= 2 and cut < n,
        "ring resynced on restore": resynced,
        "resumed packets gathered from the ring": ring_packets > 0,
        "same window count": resumed.backend.count_window == whole.backend.count_window,
        "same refined-pose times": len(t_a) == len(t_c) and np.allclose(t_a, t_c, atol=1e-9),
        "resumed vs uninterrupted RMS < 0.05 deg": bool(rms < 0.05),
        "K1 launched, and K2 or K6": _votes_launched(launches),
        "K4 and K5 launched": launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0,
    }
    return launches, checks


def run_cli(device: str = "cuda", duration: float = 2.0, extra: tuple = (),
            label: str = "cli"):
    """Phase 5: the port's CLI on the make_stream recording written as an
    IJRR text file, stock ijrr preset, ``extra`` arguments (e.g. --set)
    added to each of its runs. Returns (launches during the full run,
    {check: passed})."""
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
        _log(f"{label}: wrote {n} events to a text file in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        n_parsed = sum(len(c[2]) for c in iter_events(events, 1 << 16))
        _log(f"{label}: text parse alone {time.perf_counter() - t0:.2f} s for {n_parsed} events")

        def argv(out, *more):
            return ["--device", device, "--events", events, "--calib", calib_txt,
                    "--width", str(calib.width), "--height", str(calib.height),
                    "--preset", "ijrr", "--out-dir", os.path.join(tmp, out), *extra, *more]

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
        audit = SyncAudit(device)
        Frontend.render_iwe_pair = counted_render
        try:
            _reset_launches()
            t0 = time.perf_counter()
            with audit:
                rc = cli.main(argv("full", "--refine-passes", "1", "--save-iwe-every", "50",
                                   "--save-maps-every", "6"))
            walls["full"] = time.perf_counter() - t0
            launches = _launches()
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
        _log(f"{label}: host waits of the full run (the renders, checkpoints and refine included) "
             + json.dumps(audit.report(stats["metrics"]["counters"].get("frontend.launches", 0),
                                       stats["windows"])))
        _log(f"{label}: full run rc {rc} wall {walls['full']:.2f} s "
             f"(events_per_second {stats['events_per_second']:.0f}, "
             f"{stats['events']} events, {stats['windows']} windows, "
             f"{stats['ang_vel_estimates']} packets); trajectory_tum RMS {rms:.4f} deg; "
             f"launches {launches}, K1 in IWE renders {render_launches[0]}; "
             f"timers_s {json.dumps(timers)}; "
             f"counters {json.dumps(stats['metrics']['counters'])}")
        _log(f"{label}: cut at {cut} events rc {rc_cut} wall {walls['cut']:.2f} s; resumed rc "
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
            "K1 launched, and K2 or K6": _votes_launched(launches),
            "K4 and K5 launched": launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0,
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


def _cam(calib):
    from cmax_slam_tpu_torch.ops.warp_local import CameraParams

    K = calib.K
    return CameraParams(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                        cy=float(K[1, 2]), width=calib.width, height=calib.height)


def run_batched(device: str = "cuda", seq_log=None, duration: float = 2.0):
    """Phase 6: throughput-mode tracking of the whole stream at full width,
    called twice in the process: the first call captures the round
    programs, the second takes them from the pool (and captures only a
    bucket the first call did not meet). Per call: wall and
    packets/s, rounds (graph launches of the round programs), captures, and
    the host's waits (SyncAudit): one per round, the round's status read,
    plus the call's final result, and none inside a round. The cut's calls
    of the host library are counted, and the cut is timed through the
    library and the plain versions (cut_in_turns). Returns (launches during
    the second call, {check: passed}, {"calls": per-call stats, "cut": the
    cut's})."""
    import torch
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.ops import cuda_iwe, device_loop, program_pool
    from cmax_slam_tpu_torch.parallel import batched

    ev, omega, calib = make_stream(duration)
    cfg = ijrr_config().frontend
    cam = _cam(calib)
    _reset_launches()
    t0 = time.perf_counter()
    pb = batched.cut_packets(ev.xs, ev.ys, ev.ts, bearing_lut(calib), cam, cfg, device=device)
    t_cut = time.perf_counter() - t0
    n = pb.bearings.shape[0]
    cut_calls = {k: v for k, v in _launches().items() if k.startswith("host_")}
    cut = cut_in_turns(ev, calib, cfg, device, pb)
    _log(f"batched: cut_packets through the host library: {json.dumps(cut_calls)} for {n} "
         f"packets; s per call in turns (library, plain, plain, library) "
         f"{json.dumps(cut['s'])}, of which the gather {json.dumps(cut['gather_s'])}; "
         f"packets equal both ways {cut['equal']}")
    max_ls = cfg.optim.max_line_searches

    # Widest K1 launch, read through a wrapper of the kernel wrapper (counts
    # are untouched; a graph's launches pass through it while it is captured).
    widest = [0]
    vote_fwd = cuda_iwe.vote_fwd

    def widest_vote(px, py, w, height, width, b=None, **kw):
        widest[0] = max(widest[0], px.shape[0] if b is None else b)
        return vote_fwd(px, py, w, height, width, b, **kw)

    calls, checks = [], {}
    cuda_iwe.vote_fwd = widest_vote
    try:
        for call in ("first", "second"):
            _reset_launches()
            pool0 = program_pool.stats()
            audit = SyncAudit(device)
            t0 = time.perf_counter()
            with audit:
                times, om, _, iters = batched.track_batched_compacted(pb, cam, cfg, sweeps=2)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rounds = device_loop.RUNS.get("batched.round", 0)
            rep = audit.report(rounds, 0)
            err = np.linalg.norm(om - omega, axis=1)
            stats = {"call": call, "wall_s": wall, "packets_per_s": n / wall, "rounds": rounds,
                     "graph_runs": dict(device_loop.RUNS), "captures": dict(device_loop.CAPTURES),
                     "programs_built": program_pool.stats()["programs"] - pool0["programs"],
                     "event_waits": rep["event_waits"], "syncs": rep["syncs"],
                     "reads_per_round": (rep["event_waits"] + rep["syncs"]) / max(rounds, 1),
                     "syncs_by_site": rep["syncs_by_site"],
                     "median_err": float(np.median(err)), "max_err": float(err.max()),
                     "iters": [int(iters.min()), float(iters.mean()), int(iters.max())],
                     "launches": _launches()}
            calls.append(stats)
            _log(f"batched {call} call: {n} packets x {pb.bearings.shape[1]} events (cut in "
                 f"{t_cut:.2f} s) tracked in {wall:.2f} s ({n / wall:.1f} packets/s, "
                 f"{n * pb.bearings.shape[1] / wall:.0f} events/s); {rounds} rounds as graph "
                 f"launches, {stats['captures']['graphs']} captures "
                 f"({stats['captures']['s']:.2f} s), {stats['programs_built']} programs built; "
                 f"host waits {rep['event_waits']} + syncs {rep['syncs']} "
                 f"({stats['reads_per_round']:.3f} per round; syncs by site "
                 f"{json.dumps(rep['syncs_by_site'])}); median |omega - omega_true| "
                 f"{np.median(err):.4f} rad/s (max {err.max():.4f}); iters min {iters.min()} "
                 f"mean {iters.mean():.1f} max {iters.max()}; launches {stats['launches']}")
            checks[f"{call}: median omega error < 0.2 rad/s"] = float(np.median(err)) < 0.2
            checks[f"{call}: iters in (0, max_line_searches]"] = bool(
                np.all((iters > 0) & (iters <= max_ls)))
            checks[f"{call}: every round a graph launch"] = rounds > 0 and (
                device != "cuda" or stats["graph_runs"].get("batched.round", 0) == rounds)
            checks[f"{call}: one wait per round, one read of the result, none in a round"] = (
                rep["event_waits"] == rounds and rep["syncs"] <= 1) if device == "cuda" else True
    finally:
        cuda_iwe.vote_fwd = vote_fwd
    first, second = calls
    launches = second["launches"]
    vs_seq = "n/a"
    if seq_log is not None and len(seq_log):
        m = min(len(seq_log), n)
        if np.allclose(seq_log[:m, 0], times[:m], atol=1e-9):
            vs_seq = f"{np.median(np.linalg.norm(om[:m] - seq_log[:m, 1:], axis=1)):.4f} rad/s"
    _log(f"batched: first call {first['packets_per_s']:.1f} packets/s ({first['wall_s']:.2f} s, "
         f"{first['captures']['graphs']} captures), second call {second['packets_per_s']:.1f} "
         f"packets/s ({second['wall_s']:.2f} s, {second['captures']['graphs']} captures); median "
         f"vs sequential log {vs_seq}; widest K1 launch B={widest[0]}; pool "
         f"{json.dumps(program_pool.stats())}")
    checks |= {
        "the cut scanned once and gathered every packet through the host library": (
            cut_calls["host_scan_triggers"] == 1 and cut_calls["host_gather_packet"] == n > 0),
        "cut packets equal through the library and the plain version": cut["equal"],
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
        "a K1 launch of >= 224 lanes' images": widest[0] >= 224,
        # A lane's convergence differs between calls by K1's atomic sum order,
        # so the second call may meet a bucket the first did not: it captures
        # only the programs it builds, never a pooled one again.
        "second call captures only the programs it builds": (
            second["captures"]["graphs"] == second["programs_built"]),
    }
    return launches, checks, {"calls": calls,
                              "cut": cut | {"calls": cut_calls, "first_s": t_cut}}


def cut_in_turns(ev, calib, cfg, device: str, pb) -> dict:
    """``batched.cut_packets`` on the same stream through the host library
    and through the plain versions (io/native.py's ``*_plain`` swapped in),
    in turns (library, plain, plain, library): seconds per call, the part
    spent in gather_packet, and whether every packet equals ``pb``."""
    import torch
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.io import native
    from cmax_slam_tpu_torch.parallel import batched

    lut = bearing_lut(calib)
    lib = (native.scan_triggers, native.gather_packet)
    plain = (native.scan_triggers_plain, native.gather_packet_plain)
    out = {"s": {"library": [], "plain": []}, "gather_s": {"library": [], "plain": []},
           "equal": True}
    try:
        for route in ("library", "plain", "plain", "library"):
            scan, gather = lib if route == "library" else plain
            spent = [0.0]

            def timed_gather(*a, gather=gather, spent=spent):
                t0 = time.perf_counter()
                res = gather(*a)
                spent[0] += time.perf_counter() - t0
                return res

            native.scan_triggers, native.gather_packet = scan, timed_gather
            t0 = time.perf_counter()
            got = batched.cut_packets(ev.xs, ev.ys, ev.ts, lut, _cam(calib), cfg, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            out["s"][route].append(time.perf_counter() - t0)
            out["gather_s"][route].append(spent[0])
            out["equal"] &= all(torch.equal(a, b) for a, b in zip(got[:3], pb[:3])) and bool(
                np.array_equal(got.times, pb.times))
    finally:
        native.scan_triggers, native.gather_packet = lib
    return out


def make_window(ev, omega, calib, pano_hw, device, t_lo=0.5, span=0.2, dt_knots=0.05,
                bs=100, seed=0):
    """A back-end window of the stream: ``span`` s of events from ``t_lo``
    in batches of ``bs``, linear-spline knots every ``dt_knots`` s at the
    true pose perturbed by ~0.004 rad (the first frozen), an empty map."""
    import torch
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.ops.warp_pano import PanoWindow

    a, b = np.searchsorted(ev.ts, [t_lo, t_lo + span])
    n = ((b - a) // bs) * bs
    xs, ys, ts = ev.xs[a:a + n], ev.ys[a:a + n], ev.ts[a:a + n]
    bearings = bearing_lut(calib)[ys.astype(np.int64) * calib.width + xs].T
    tb = ts.reshape(-1, bs)
    mid = tb[:, 0] + 0.5 * (tb[:, -1] - tb[:, 0])
    K = int(round(span / dt_knots)) + 1
    rng = np.random.default_rng(seed)
    knots = np.stack([spline._np_quat_exp(omega * (t_lo + k * dt_knots)
                                          + 0.004 * rng.normal(size=3)) for k in range(K)])

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return PanoWindow(
        bearings=t(bearings).contiguous(), batch_times=t(mid - t_lo),
        weights=t(np.ones(n)), is_old=t(np.zeros(n, bool), torch.bool), knots=t(knots),
        free_mask=t(np.r_[0.0, np.ones(K - 1)]), t0=0.0, dt_knots=float(np.float32(dt_knots)),
        ig_prime=t(np.zeros(pano_hw)), alpha=t(0.0))


def run_window_shard(device: str = "cuda", devices=("cuda:0", "cuda:0"),
                     panos=((512, 1024), (2048, 4096)), duration: float = 2.0):
    """Phase 7a: the event-sharded window objective against the
    single-device one, both through K4/K5 (warp_pano.pano_vote), on a
    window whose batch count the device list does not divide (a padding
    batch). Value and gradient compared, K5 on each shard's operands
    checked (k5_on_shards), and value_and_grad timed in turns (sharded,
    single, single, sharded). Returns (launches of the sharded
    evaluations, {check: passed}, {panorama: ms})."""
    import torch
    from cmax_slam_tpu_torch.calib import EquirectCamera
    from cmax_slam_tpu_torch.ops import warp_pano
    from cmax_slam_tpu_torch.parallel.window_shard import (
        make_sharded_pano_objective, shard_window_events)

    ev, omega, calib = make_stream(duration)

    def timed(fn, x, reps=5):
        fn(x)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(x)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps * 1e3

    checks, launches, times = {}, dict.fromkeys(_launches(), 0), {}
    for hw in panos:
        win = make_window(ev, omega, calib, hw, device)
        B = win.batch_times.shape[0]
        if B % len(devices) == 0:  # one batch fewer: the last shard takes a padding batch
            E = win.weights.shape[0] // B
            win = win._replace(bearings=win.bearings[:, :-E].contiguous(),
                               batch_times=win.batch_times[:-1], weights=win.weights[:-E],
                               is_old=win.is_old[:-E])
            B -= 1
        pano = EquirectCamera(width=hw[1], height=hw[0])
        K = win.knots.shape[0]
        x = torch.as_tensor(0.01 * np.random.default_rng(1).normal(size=3 * K),
                            dtype=torch.float32, device=device)
        _, vg_ref = warp_pano.make_pano_objective(win, pano, 2, 1.0, 0)
        _reset_launches()
        shards = shard_window_events(win, list(devices))
        _, vg_sh = make_sharded_pano_objective(list(devices), shards, pano, 2, 1.0, 0)
        (v_sh, g_sh), ms_sh = timed(vg_sh, x)
        for k, v in _launches().items():
            launches[k] += v
        (v_ref, g_ref), ms_ref = timed(vg_ref, x)
        ms_ref2, ms_sh2 = timed(vg_ref, x)[1], timed(vg_sh, x)[1]
        k5 = k5_on_shards(shards, pano) if device == "cuda" else {}
        v_sh, v_ref, g_sh, g_ref = (float(v_sh), float(v_ref), g_sh.cpu().numpy(),
                                    g_ref.cpu().numpy())
        tag = f"{hw[0]}x{hw[1]}"
        times[tag] = {"sharded_ms": [ms_sh, ms_sh2], "single_ms": [ms_ref, ms_ref2]}
        _log(f"window_shard {tag}: {win.weights.shape[0]} events in {B} batches over "
             f"{len(devices)} devices ({shards[0].batch_times.shape[0]} batches a shard, "
             f"{len(devices) * shards[0].batch_times.shape[0] - B} padding); value "
             f"{v_sh:.9g} vs single-device {v_ref:.9g} (rel {abs(v_sh - v_ref) / abs(v_ref):.2e});"
             f" grad max abs diff {np.abs(g_sh - g_ref).max():.3e} (max |g| "
             f"{np.abs(g_ref).max():.3e}); K5 on the shards {json.dumps(k5)}; "
             f"value_and_grad ms in turns: sharded {ms_sh:.2f}, single-device {ms_ref:.2f}, "
             f"{ms_ref2:.2f}, sharded {ms_sh2:.2f}")
        checks[f"{tag} value rtol 2e-5"] = bool(np.isfinite(v_sh)) and np.isclose(
            v_sh, v_ref, rtol=2e-5, atol=0)
        checks[f"{tag} gradient rtol 2e-3 atol 2e-6"] = bool(
            np.allclose(g_sh, g_ref, rtol=2e-3, atol=2e-6))
        checks |= {f"{tag} {k}": v for k, v in k5.items()}
    _log(f"window_shard: launches of the sharded evaluations {json.dumps(launches)}")
    checks["K4 and K5 launched"] = launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0
    checks["no K1 or K2 launch (no composed route)"] = launches["fwd"] == launches["bwd"] == 0
    return launches, checks, times


def k5_on_shards(shards, pano, order: int = 2) -> dict:
    """K5 on each shard's own operands (on a repeated device, views at
    offsets into one window), by raw launches (not counted): two launches
    with one upstream gradient torch.equal (its fixed-order sum), and the
    shard with every weight 0 (all padding) exactly 0."""
    import torch
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.ops import cuda_pano_vote

    gen = torch.Generator(device=shards[0].weights.device).manual_seed(5)
    same = zero = True
    for sh in shards:
        K = sh.knots.shape[0]
        basis = spline.segment_basis(sh.batch_times, sh.t0, sh.dt_knots, K, order)
        d = torch.full((1, K, 3), 0.01, device=sh.weights.device)
        g = torch.rand((1, pano.height, pano.width), device=sh.weights.device, generator=gen)
        outs = []
        for w in (sh, sh, sh._replace(weights=torch.zeros_like(sh.weights))):
            ops = cuda_pano_vote.prepare(d, w, basis, pano, order, None)
            out = torch.empty_like(ops.delta)
            cuda_pano_vote.launch_bwd(ops, g, cuda_pano_vote.bwd_scratch(ops), out)
            outs.append(out)
        same &= bool(torch.equal(outs[0], outs[1]))
        zero &= bool(torch.all(outs[2] == 0))
    return {"K5 twice on one g torch.equal per shard": same,
            "K5 of all-padding events exactly 0": zero}


def run_replay(devices=("cuda:0", "cuda:0"), duration: float = 2.0):
    """Phase 7b: 2-segment replay on the stock preset, one segment per
    device entry. Returns (launches, {check: passed})."""
    import torch
    from cmax_slam_tpu_torch import spline
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.parallel import replay
    from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

    ev, omega, calib = make_stream(duration)
    _reset_launches()
    t0 = time.perf_counter()
    times, quats, segs = replay.replay_multichip(
        ev.xs, ev.ys, ev.ts, ev.pols, calib, ijrr_config(), n_segments=2, overlap=0.4,
        devices=list(devices))
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    q_gt = np.stack([spline._np_quat_exp(omega * t) for t in times])
    rms, errs = rotation_rms_deg(times, q_gt, quats, "global")
    wins = [len(s.slam.window_results()) for s in segs]
    entries = [(s.slam.frontend._entry, s.slam.backend._entry) for s in segs]
    _log(f"replay: 2 segments on {list(devices)}, wall {wall:.2f} s for {duration} s of "
         f"stream; windows per segment {wins}; stitched RMS {rms:.4f} deg (max "
         f"{errs.max():.3f}) over {len(times)} samples; pool entries (front-end, back-end) "
         f"leases {[[e.leases for e in pair] for pair in entries]}; launches {launches}")
    checks = {
        "stitched RMS < 0.5 deg": rms < 0.5,
        "the live segments lease distinct entries": all(
            a is not b for a, b in zip(*entries)),
        "every segment ran its back-end": all(w >= 2 for w in wins),
        "K1 launched, and K2 or K6": _votes_launched(launches),
        "K4 and K5 launched": launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0,
    }
    return launches, checks


# The ecrot phase's stream: examples/tpu_ecrot_realtime_check.py's at its
# defaults (ECRT_RATE 5e6 events/s, ECRT_DURATION 1.2 s), pushed in 0.1 s
# chunks as it pushes them. ECROT_SHED is its ECRT_SHED=1: the reference's
# live-mode shedding (launch/live_davis.launch: 10x front-end and 5x
# back-end decimation) with packets of a tenth the events, so that a packet
# spans the same time.
ECROT_RATE = 5_000_000
ECROT_DURATION = 1.2
ECROT_SHED = {"frontend_event_sample_rate": 10, "frontend.num_events_per_packet": 20_000,
              "backend.warp.event_sample_rate": 5}


@functools.lru_cache(maxsize=2)  # the ecrot phase's stream stays for the options phase
def make_ecrot_stream(duration: float = ECROT_DURATION, rate: int = ECROT_RATE):
    """examples/tpu_ecrot_realtime_check.py's stream: a 640x480 pinhole
    (fx = fy = 335, centred), omega = [0.5, -0.9, 1.3], 1200 landmarks in
    the generator's default 120-degree cone, seed 3, ``rate`` events/s for
    ``duration`` s, through the port's generator with the vectorized
    rotation (_rot_fn; the random draws are the example's). Returns
    (events, omega, calib, seconds to generate); cached."""
    from cmax_slam_tpu_torch.calib import CameraCalibration
    from cmax_slam_tpu_torch.io import synthetic

    W, H, F = 640, 480, 335.0
    omega = np.array([0.5, -0.9, 1.3])
    t0 = time.perf_counter()
    ev = synthetic.rotating_camera_events(np.random.default_rng(3), int(rate * duration),
                                          duration, omega, F, F, W / 2, H / 2, W, H,
                                          n_points=1200, rot_fn=_rot_fn(omega))
    calib = CameraCalibration(width=W, height=H,
                              K=np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]]))
    return ev, omega, calib, time.perf_counter() - t0


class ProgramTimes:
    """Device time of each device program's launches over a block, by
    program name ("frontend", "backend.crop", "backend.full"): a CUDA event
    before and after each launch of a program whose graphs were captured
    before it (a first run, which captures, is not timed). The launches
    queue on one stream in order, so the events bracket each graph's
    execution. Times nothing on the CPU."""

    def __init__(self, device: str = "cuda"):
        self.on, self.marks = device == "cuda", []

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from cmax_slam_tpu_torch.ops import device_loop

        self._run = run = device_loop.Program.run
        marks = self.marks

        def timed(prog):
            if prog._exec is None or prog.device.type != "cuda":
                return run(prog)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = run(prog)
            b.record()
            marks.append((prog.name, a, b))
            return out

        device_loop.Program.run = timed
        return self

    def __exit__(self, *exc):
        if self.on:
            from cmax_slam_tpu_torch.ops import device_loop

            device_loop.Program.run = self._run
        return False

    def report(self) -> dict:
        """{program: {"launches", "ms"}}; waits for the last event."""
        out = {}
        if self.marks:
            self.marks[-1][2].synchronize()
        for name, a, b in self.marks:
            t = out.setdefault(name, {"launches": 0, "ms": 0.0})
            t["launches"] += 1
            t["ms"] += a.elapsed_time(b)
        return out


def _spy_windows(slam, rec: dict):
    """Record into ``rec`` what the system ``slam`` does with its events:
    ``frontend_events``, the events its front-end receives (after the
    front-end's decimation), and ``windows``, each window's events (in the
    window, padded, after the in-batch decimation) and pass ("online", or
    the re-solve that Backend.refine_pass runs: "bootstrap" inside the push
    loop, "refine" after it, ``rec["state"]`` saying which). Returns the
    function that removes the spies."""
    fe, be = slam.frontend, slam.backend
    fe_push, arrays, refine = fe.push_events, be._window_arrays, be.refine_pass
    rec.update(frontend_events=0, windows=[], **{"pass": "online"})

    def pushed(xs, ys, ts, ps):
        rec["frontend_events"] += len(ts)
        return fe_push(xs, ys, ts, ps)

    def window_arrays(xs, ys, ts, idx):
        out = arrays(xs, ys, ts, idx)
        rec["windows"].append({"events": len(ts), "padded": len(out["valid"]),
                               "after_decimation": int(out["valid"].sum()),
                               "pass": rec["pass"]})
        return out

    def refine_pass(*a, **kw):
        rec["pass"] = "refine" if rec.get("state") == "after" else "bootstrap"
        try:
            return refine(*a, **kw)
        finally:
            rec["pass"] = "online"

    fe.push_events, be._window_arrays, be.refine_pass = pushed, window_arrays, refine_pass

    def after():
        del fe.push_events, be._window_arrays, be.refine_pass

    return after


def _cut_as_reference(bcfg, windows: list, dropped: int) -> bool:
    """A window of more events than the back-end's cap (rounded up to whole
    batches) keeps its first ``cap`` events, as the JAX package's does
    (cmax_slam_tpu/backend.py:921-938): the events dropped are each
    window's excess (``windows`` as _spy_windows records them), and no
    window is padded past the cap."""
    bs = bcfg.warp.event_batch_size
    cap = -(-bcfg.max_events_per_window // bs) * bs
    return (dropped == sum(max(0, w["events"] - cap) for w in windows)
            and all(w["padded"] <= cap for w in windows))


def run_ecrot(device: str = "cuda", label: str = "ecrot", shed: bool = False,
              upto: float | None = None, duration: float = ECROT_DURATION,
              rate: int = ECROT_RATE, overrides=None, min_ba: int | None = None,
              no_capture: bool = False, shapes: dict | None = None,
              pano_shapes: dict | None = None):
    """A run of the ecrot phase: ecrot_real_config() (``shed``:
    ecrot_mount_config() with ECROT_SHED), with ``overrides`` (dotted
    config keys), on the first ``upto`` s (default all) of
    make_ecrot_stream(duration, rate) in 0.1 s pushes, through ``drive``
    (phase 4's spies and checks). Also checks: a window's events cut only
    past max_events_per_window, the loop predicate run, BA in at least
    ``min_ba`` windows (if given), no graph captured (``no_capture``), and
    with front-end decimation the front-end's events the raw count over the
    rate within one per push. Prints the wall, the timers, the windows and
    their events before and after the in-batch decimation, the crop shapes
    and the blur path of each objective's image, the launches by kernel and
    variant, captures, waits, peak memory and the pool's entries, bytes and
    drops, and the RMS against the truth. Returns (launches, checks, stats,
    the CMaxSLAM)."""
    import torch
    from cmax_slam_tpu_torch.config import ecrot_mount_config, ecrot_real_config, replace
    from cmax_slam_tpu_torch.ops import blur, program_pool

    cfg = ecrot_mount_config() if shed else ecrot_real_config()
    cfg = replace(cfg, **{**(ECROT_SHED if shed else {}), **dict(overrides or {})})
    ev, omega, calib, gen_s = make_ecrot_stream(duration, rate)
    span = duration if upto is None else upto
    n = len(ev.ts) if upto is None else int(np.searchsorted(ev.ts, upto))
    push = rate // 10
    fe_rate, bcfg = cfg.frontend_event_sample_rate, cfg.backend
    pano_hw = (bcfg.pano_map.pano_height, bcfg.pano_map.pano_width)
    _log(f"{label}: {n} events over {span} s of a {calib.width}x{calib.height} stream at "
         f"{rate} ev/s (generated in {gen_s:.2f} s, outside every wall), pushes of {push}; "
         f"packets of {cfg.frontend.num_events_per_packet}, decimation front-end {fe_rate} "
         f"back-end {bcfg.warp.event_sample_rate}, windows {bcfg.sliding_window.time_window_size}/"
         f"{bcfg.sliding_window.sliding_window_stride} s, panorama {pano_hw[0]}x{pano_hw[1]} at y_angle "
         f"{bcfg.pano_map.y_angle_deg} deg, max_events_per_window "
         f"{bcfg.max_events_per_window}; overrides {overrides or {}}")
    rec = {}

    def spy(slam):
        return _spy_windows(slam, rec)

    pool0 = program_pool.stats()
    with ProgramTimes(device) as times:
        launches, checks, _, wall, slam, stats = drive(
            cfg, ev, omega, calib, device, label, span, n, push, shapes, True, pano_shapes, spy)
    stats["device_ms_by_program"] = device_ms_by_program = times.report()
    be = slam.backend
    wins = slam.window_results()
    n_ba = sum(w.ran_ba for w in wins)
    counters = slam.metrics.counters
    pushes = len(range(0, n, push))
    stats |= {
        "wall_s": wall, "realtime_factor": span / wall, "stream_s": span, "raw_events": n,
        "generate_s": gen_s,
        "timers": {k: {"total_s": t.total, "count": t.count}
                   for k, t in slam.metrics.timers.items()
                   if k in ("frontend.solve", "backend.fetch", "backend.solve")},
        "windows": len(wins), "ba_windows_run": n_ba, "window_events": rec["windows"],
        "events_dropped_at_cap": counters.get("backend.events_dropped", 0),
        "frontend_events": rec["frontend_events"],
        "crop_shapes": sorted(be._crop_shapes),
        "blur_paths": {f"crop {h}x{w}": blur.blur_path(h, w) for h, w in sorted(be._crop_shapes)}
        | {f"panorama {pano_hw[0]}x{pano_hw[1]}": blur.blur_path(*pano_hw)},
        "window_solves": {k: stats["runs"].get(f"backend.{k}", 0) for k in ("crop", "full")},
        "launches": {k: launches[k] for k in ("fwd_P", "fwd_G", "bwd_S", "bwd_G", "pano_fwd",
                                              "pano_bwd")},
        "pool_before": pool0, "pool_after": program_pool.stats(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0}
    _log(f"{label}: wall {wall:.3f} s, realtime factor {span / wall:.4f}; timers "
         f"{json.dumps(stats['timers'])}; BA in {n_ba} of {len(wins)} windows; events per "
         f"window (in the window, padded, after the in-batch decimation, pass) "
         f"{json.dumps(rec['windows'])}; cut at the cap of "
         f"{bcfg.max_events_per_window} {stats['events_dropped_at_cap']}; front-end events {rec['frontend_events']} of "
         f"{n} raw; crop shapes {stats['crop_shapes']}, blur paths "
         f"{json.dumps(stats['blur_paths'])}, window solves {json.dumps(stats['window_solves'])}")
    busy = sum(t["ms"] for t in device_ms_by_program.values()) / 1e3
    _log(f"{label}: device time by program (CUDA events around each launch of a program "
         f"captured before it; first runs, which capture, not counted) "
         f"{json.dumps(device_ms_by_program)}: {busy:.3f} s, {busy / wall:.1%} of the wall")
    _log(f"{label}: launches K1 P/G {launches['fwd_P']}/{launches['fwd_G']}, K2 S/G "
         f"{launches['bwd_S']}/{launches['bwd_G']}, K4 {launches['pano_fwd']}, K5 "
         f"{launches['pano_bwd']}, loop predicate {stats['pred']}; captures "
         f"{json.dumps(stats['captures'])}; waits front-end {stats['frontend_waits']}, back-end "
         f"{stats['backend_waits']} for {stats['windows_completed_in_loop']} windows completed "
         f"in the loop and {stats['resolves']} re-solves, event waits by site "
         f"{json.dumps(stats.get('audit', {}).get('event_waits_by_site'))}; peak device memory "
         f"{stats['peak_gib']:.3f} GiB; pool before {json.dumps(pool0)}, after "
         f"{json.dumps(stats['pool_after'])}; RMS against the truth {stats['rms_deg']:.4f} deg "
         f"({stats['rms_unnormalized_deg']:.4f} unnormalized)")
    # The stream's rate varies with the landmarks in view, so a 0.2 s window
    # may hold more than 2^20 events.
    checks["events cut only past the cap, as the reference cuts them"] = _cut_as_reference(
        bcfg, rec["windows"], stats["events_dropped_at_cap"])
    checks["loop predicate ran"] = device != "cuda" or stats["pred"] > 0
    if min_ba is not None:
        checks[f"BA in >= {min_ba} windows"] = n_ba >= min_ba
    if no_capture:
        checks["captures no graph"] = stats["captures"]["graphs"] == 0
    if fe_rate > 1:
        checks["front-end events = raw / rate within 1 per push"] = (
            abs(rec["frontend_events"] - n / fe_rate) <= pushes)
    return launches, checks, stats, slam


GATE_LANES = (1, 24, 2016)  # a packet solve, a stride's lanes, phase 6's widest round
GATE_PATTERNS = ("first", "middle", "last", "all", "none")  # where the live lanes are


def _gate_program(L: int, pattern: str):
    """A program over a gate of L lanes: each live lane's register counts
    down under a WHILE node gated on the lanes' mask (reg > 0) and on an
    iteration counter under a limit of 7 (folded into the predicate), with
    an IF node on every third iteration; live lanes start at 3 + lane % 7."""
    import torch
    from cmax_slam_tpu_torch.ops import device_loop

    dev = torch.device("cuda")
    lanes = np.arange(L)
    live = {"first": lanes < 3, "middle": lanes == L // 2, "last": lanes == L - 1,
            "all": lanes >= 0, "none": lanes < 0}[pattern]
    start = torch.tensor(np.where(live, 3 + lanes % 7, 0).astype(np.float32), device=dev)
    reg, hits = torch.zeros(L, device=dev), torch.zeros(1, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    mask, third = device_loop.gate(dev, L), device_loop.gate(dev)
    gate = device_loop.Gate(mask, it, device_loop.limit(7, dev))

    def init():
        reg.copy_(start)
        hits.zero_()
        it.zero_()
        torch.gt(reg, 0, out=mask)

    def step():
        reg.sub_(mask.float())
        it.add_(1)
        torch.gt(reg, 0, out=mask)
        torch.eq(torch.remainder(it, 3), 0, out=third)

    def build(b):
        b.seg(init)

        def body():
            b.seg(step)
            b.when(third, lambda: b.seg(lambda: hits.add_(1.0)))

        b.repeat(gate, body)
        b.seg(lambda: prog.out.copy_(torch.cat([reg, hits, it.float()])))

    prog = device_loop.Program(build, L + 2, dev, name=f"gate_check_{L}")
    return prog


def check_loop_pred() -> dict:
    """The loop predicate (csrc/loop.cu) against its plain version, the host
    gate (device_loop.Gate.holds), at gate lengths GATE_LANES with the live
    lanes first, in the middle, last, all and none (_gate_program): run as
    one graph on the card and eagerly with its gates read on the host, the
    same values and the same predicate executions (max_abs_err 0). The
    predicate kernel's own device time at each length (torch.profiler, mean
    over its executions in 20 runs of the "all" program; None if the
    profiler records no kernel inside the graph). Then the loop's time per
    iteration over tools/loop_latency.py's bodies (the "check" body's in the
    graph and with the host gate are the JSON's ms and plain_ms), and three
    launches of one program queued behind a sleeping kernel, in flight
    together: each must fetch its own number."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmax_slam_tpu_torch.ops import device_loop

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loop_latency

    dev = torch.device("cuda")
    err, cases, kernel_us = 0.0, {}, {}
    ok = True
    for L in GATE_LANES:
        for pattern in GATE_PATTERNS:
            prog = _gate_program(L, pattern)
            before = device_loop.LAUNCHES["pred"]
            got = prog.run().fetch()
            preds = device_loop.LAUNCHES["pred"] - before
            prog.build_fn(device_loop.Eager())
            plain = prog.out.cpu().numpy()
            iters = int(plain[-1])
            expect = 1 + 2 * iters  # the WHILE's iters + 1 tests, the IF's iters
            e = float(np.abs(got - plain).max())
            err = max(err, e)
            ok = ok and e == 0 and preds == expect
            cases[f"{L} {pattern}"] = {"iterations": iters, "executions": preds,
                                       "expected": expect, "max_abs_err": e}
            if pattern == "all":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        prog.run().fetch()
                    torch.cuda.synchronize()
                k = [ev for ev in prof.key_averages() if "loop_pred" in ev.key and ev.count]
                kernel_us[L] = (sum(ev.self_device_time_total for ev in k)
                                / sum(ev.count for ev in k) if k else None)
    bodies = loop_latency.bodies(device_loop)
    ms = bodies["check"]["us_per_iteration"] / 1e3
    plain_ms = bodies["check"]["host_gate_us_per_iteration"] / 1e3

    reg = torch.zeros(1, device=dev)

    def count_build(b):
        b.seg(lambda: reg.add_(1.0))
        b.seg(lambda: counter.out.copy_(reg))

    counter = device_loop.Program(count_build, 1, dev, name="in_flight_check")
    counter.run().fetch()  # captures
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the launches below queue behind it
    flight = [counter.run() for _ in range(3)]
    queued = not any(r.fetched for r in flight) and not flight[0]._event.query()
    own = [float(v[0]) for v in device_loop.fetch_all(flight[::-1])][::-1]
    in_flight_ok = queued and own[1] == own[0] + 1 and own[2] == own[1] + 1
    _log("loop predicate against the host gate, per gate length and live lanes "
         "(iterations, executions / expected, max_abs_err): " + "; ".join(
             f"{k} {c['iterations']}, {c['executions']}/{c['expected']}, {c['max_abs_err']}"
             for k, c in cases.items()))
    _log("loop predicate kernel device time by gate length: " + ", ".join(
        f"{L} lanes {'not recorded' if us is None else f'{us:.3f} us'}"
        for L, us in kernel_us.items())
         + f"; the check body: graph {ms * 1e3:.3f} us per iteration, host gate "
         f"{plain_ms * 1e3:.3f} us; three launches in flight (queued {queued}) fetched {own}")
    _log("loop iteration by body (tools/loop_latency.py, this tree): " + json.dumps(bodies))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_device_us_by_lanes": kernel_us, "bodies": bodies,
            "bound_ms": (1 + 4) / HBM_BYTES_PER_S * 1e3, "ok": ok,  # the check body: 1 lane
            "in_flight_ok": in_flight_ok, "cases": cases,
            "executions": sum(c["executions"] for c in cases.values())}


def loop_in_turns(parent: str, card: str) -> dict:
    """tools/loop_latency.py on the parent's tree and on this one, in turns
    (parent, this, this, parent), each turn a process of its own: the time
    per loop iteration of each body and its nodes."""
    out = {"parent": [], "change": []}
    tool = os.path.join(REPO, "tools", "loop_latency.py")
    for name in ("parent", "change", "change", "parent"):
        tree = parent if name == "parent" else REPO
        proc = subprocess.run([sys.executable, tool, "--tree", tree], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"loop_latency.py on {tree} failed:\n{proc.stderr[-3000:]}")
        out[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        _log(f"turns: {name} loop bodies {out[name][-1]}")
    _log(f"loop bodies in turns on {card}: us per iteration " + json.dumps(
        {t: [{b: round(r[b]["us_per_iteration"], 3) for b in r}
             for r in runs] for t, runs in out.items()}))
    return out


def cg_iteration_nodes(slam) -> dict:
    """Nodes, kernel nodes and gates of one CG iteration (tools/
    loop_latency.iteration_nodes) of the front-end's widest packet program
    and of a crop-window program of this system."""
    from cmax_slam_tpu_torch.ops import device_loop

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loop_latency

    fe = slam.frontend._entry.programs
    packet = fe[max(fe)].program
    crop = next(s.program for k, s in slam.backend._entry.programs.items() if k[3] is not None)
    return {"packet": loop_latency.iteration_nodes(device_loop, packet),
            "crop_window": loop_latency.iteration_nodes(device_loop, crop)}


@contextlib.contextmanager
def _images_by(images):
    """While the block runs, the back-end objectives take their images from
    ``images``: warp_pano.pano_vote_composed or pano_vote_plain in place of
    warp_pano.pano_vote (K4/K5), or, given a ParentPanoVote, K4/K5 through
    the parent's kernels; None changes nothing."""
    from cmax_slam_tpu_torch.ops import cuda_pano_vote, warp_pano

    saved = warp_pano.pano_vote, cuda_pano_vote.pano_vote_fwd, cuda_pano_vote.pano_vote_bwd
    if isinstance(images, ParentPanoVote):
        cuda_pano_vote.pano_vote_fwd = images.pano_vote_fwd
        cuda_pano_vote.pano_vote_bwd = images.pano_vote_bwd
    elif images is not None:
        warp_pano.pano_vote = images
    try:
        yield
    finally:
        warp_pano.pano_vote, cuda_pano_vote.pano_vote_fwd, cuda_pano_vote.pano_vote_bwd = saved


def _objective_cases(slam, ev) -> dict:
    """Phase 4's objectives at its shapes, {name: (f, value_and_grad, x,
    images)}: the packet objective of a solved packet on the planner's route
    (K6 at the stock preset's) and on the chain ("packet_chain"; "packet_plain"
    is the chain the plain vote serves), and on the window
    loaded last into a crop program (none if phase 4 ran no crop window) the
    crop objective and the full-panorama objective, each through K4/K5
    ("fused", the main path: images None) and the composed route
    (warp_to_pano in torch, K1/K2: the route before K4/K5), the crop
    objective through the parent's K4/K5 with --parent ("fused_parent") and
    on the plain version ("plain"), at increments of 1e-3; a case runs
    under ``_images_by(images)``."""
    import torch
    from cmax_slam_tpu_torch.ops import warp_local, warp_pano

    fe, be = slam.frontend, slam.backend
    est = next(e for e in fe.estimates[5:] if e.iters > 0)
    beg, end = est.span
    packet = fe._packet(ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end],
                        float(np.float32(est.t - fe._t0)))
    x = torch.tensor([est.omega], dtype=torch.float32, device="cuda")
    cases = {name: (*warp_local.make_local_objective(packet, fe.cam, fe.cfg.warp.blur_sigma,
                                                     fe.cfg.contrast_measure, route=route),
                    x, None)
             for name, route in (("packet", None), ("packet_chain", "chain"),
                                 ("packet_plain", "chain"))}
    solver = next((s for key, s in be._entry.programs.items() if key[3] is not None), None)
    if solver is not None:
        K = solver.win.knots.shape[0]
        x = torch.full((1, 3 * K), 1e-3, device="cuda")
        sigma, measure = be.cfg.warp.blur_sigma, be.cfg.contrast_measure
        crop = warp_pano.make_crop_objective(
            solver.win, be.pano, be.order, sigma, measure, solver.a_crop.shape, None, None,
            solver.a_crop, solver.mask, solver.out_s1, solver.out_s2, origin=solver.origin,
            basis=solver.basis)
        pano = warp_pano.make_pano_objective(solver.win, be.pano, be.order, sigma, measure,
                                             basis=solver.basis)
        routes = {"fused": None, "composed": warp_pano.pano_vote_composed,
                  "plain": warp_pano.pano_vote_plain}
        for route, images in routes.items():
            cases[f"crop_{route}"] = (*crop, x, images)
            if route != "plain":
                cases[f"pano_{route}"] = (*pano, x, images)
        if PARENT is not None:
            cases["crop_fused_parent"] = (*crop, x, PARENT)
    return cases


def _objective_program(vg, x, name: str):
    """A device program of one evaluation of ``vg`` at ``x`` (1, D): its
    ``out`` holds the value and the gradient, captured at its first run."""
    import torch
    from cmax_slam_tpu_torch.ops import device_loop

    def build(b):
        def seg():
            v, g = vg(x)
            prog.out.copy_(torch.cat([v, g[0]]))
        b.seg(seg)

    prog = device_loop.Program(build, 1 + x.shape[1], "cuda", name=name)
    return prog


def check_captured_objectives(slam, ev) -> dict:
    """A captured evaluation (value and gradient) of the packet objective
    (K6 inside the graph at the stock preset's shapes) against the chain on
    the plain vote on the card, and of the back-end crop objective through K4/K5
    against the composed route (K1/K2) and the plain version, at phase 4's
    shapes, and with --parent the same crop evaluation through the parent's
    K4/K5. The votes sum with atomics in a run-dependent order: f within
    rtol 1e-5, g within rtol 2e-3, atol 2e-6 of its scale."""
    import torch
    from cmax_slam_tpu_torch.ops import scatter, warp_local

    cases = _objective_cases(slam, ev)
    refs = {}
    vote = warp_local.vote
    warp_local.vote = scatter.bilinear_accumulate  # the plain version, on the card
    try:
        v, g = cases["packet_plain"][1](cases["packet_plain"][2])
        refs["packet"] = ("plain vote", torch.cat([v, g[0]]).cpu().numpy())
    finally:
        warp_local.vote = vote
    out, ok = {}, True
    for name in ("packet", "crop_fused", "crop_fused_parent"):
        if name not in cases:
            continue
        _, vg, x, images = cases[name]
        prog = _objective_program(vg, x, f"objective_{name}")
        with _images_by(images):  # the capture at the first run takes the design
            got = prog.run().fetch()
        against = [refs["packet"]] if name == "packet" else []
        for route in ([] if name == "packet" else ["composed", "plain"]):
            _, ref_vg, _, ref_images = cases[f"crop_{route}"]
            with _images_by(ref_images):
                v, g = ref_vg(x)
            against.append((route, torch.cat([v, g[0]]).cpu().numpy()))
        with _images_by(images):
            buf = {"graph_ms": _time_ms(lambda: prog.run().fetch(), reps=20),
                   "eager_ms": _time_ms(lambda: vg(x), reps=20)}
        for what, ref in against:
            f_err = abs(got[0] - ref[0]) / abs(ref[0])
            g_err = np.abs(got[1:] - ref[1:]).max()
            g_tol = 2e-3 * np.abs(ref[1:]).max() + 2e-6
            buf[what] = {"f_rel_err": float(f_err), "g_abs_err": float(g_err),
                         "g_tol": float(g_tol)}
            ok &= f_err < 1e-5 and g_err < g_tol
        out[name] = buf
        _log(f"captured {name} objective vs {', '.join(w for w, _ in against)}: "
             f"{json.dumps(buf)}")
    return {"captured objectives match their references": bool(ok)} | {"_": out}


def split_objectives(slam, ev, reps: int = 20, only=None) -> dict:
    """One evaluation of each of phase 4's objectives (_objective_cases),
    value-only and value-and-grad, captured alone into a CUDA graph: the
    graph's nodes and kernel nodes, its replay time (CUDA events over
    ``reps`` replays), and the device time of each kernel per evaluation
    (torch.profiler over ``reps`` replays; empty if the profiler records no
    kernel inside graphs). For the back-end objectives also the torch ops
    of one eager evaluation that launch a kernel on a tensor of the
    window's event or batch count ("event_ops"; K4/K5 are not torch ops):
    none through K4/K5. ``only``: the names of the cases to split (None:
    all). Prints one line per objective and mode and the leading kernels;
    returns {objective: {mode: numbers}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmax_slam_tpu_torch.ops import cuda_iwe, device_loop

    cases = _objective_cases(slam, ev)
    solver = next((s for key, s in slam.backend._entry.programs.items() if key[3] is not None),
                  None)
    # The window's event and batch counts, less any the case's image shares
    # (phase 4's 1 024 batches and the panorama's 1 024 columns).
    sizes = {} if solver is None else {
        kind: {solver.win.weights.shape[0], solver.win.batch_times.shape[0]} - set(hw)
        for kind, hw in (("crop", solver.a_crop.shape), ("pano", tuple(solver.ig_in.shape)))}
    out = {}
    for name, (f, vg, x, images) in cases.items():
        if name.endswith("_plain") or (only is not None and name not in only):
            continue
        out[name] = {}
        for mode, fn in (("value", f), ("value_and_grad", vg)):
            event_ops = None
            if not name.startswith("packet"):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             record_shapes=True) as prof, _images_by(images):
                    fn(x)
                    torch.cuda.synchronize()
                event_ops = sum(1 for e in prof.events()
                                if e.name.startswith("aten::") and e.self_device_time_total > 0
                                and any(sizes[name.split("_")[0]] & set(shape)
                                        for shape in e.input_shapes if shape))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), _images_by(images):
                fn(x)  # warm-up
            side.synchronize()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.stream(side), cuda_iwe.recording([]), _images_by(images):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn(x)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            nodes, kernels = device_loop.graph_nodes(graph)
            graph.instantiate()
            ms = _time_ms(graph.replay, reps)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    graph.replay()
                torch.cuda.synchronize()
            per = sorted(((e.key, e.self_device_time_total / reps / 1e3)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0), key=lambda kv: -kv[1])
            total = sum(t for _, t in per)
            out[name][mode] = {"nodes": nodes, "kernel_nodes": kernels, "graph_ms": ms,
                               "kernel_ms_sum": total, "event_ops": event_ops,
                               "kernels": {k[:80]: t for k, t in per[:12]}}
            _log(f"split {name} {mode}: {nodes} nodes ({kernels} kernels), replay {ms:.4f} ms, "
                 f"kernels' device time {total:.4f} ms; torch ops on event- or batch-sized "
                 f"tensors {event_ops}; kernels: "
                 + "; ".join(f"{k[:60]} {t * 1e3:.2f} us" for k, t in per))
            del graph
    return out


def derivative_window(slam) -> tuple:
    """(window, panorama, order, blur sigma) of the derivative-images
    phase: the window loaded last into phase 4's widest window program."""
    be = slam.backend
    solver = max(be._entry.programs.values(), key=lambda p: p.win.weights.shape[0])
    return solver.win, be.pano, be.order, be.cfg.warp.blur_sigma


def run_derivative_images(slam) -> tuple:
    """The derivative-images phase on one phase-4 window: the window loaded
    last into phase 4's widest window program (its events, knots, map term
    and alpha, on the ijrr 512x1024 panorama). derivative_images through K3
    against the same function on the plain tangent vote on the card, and
    torch.func.jvp of pano_iwe (Vote.jvp: K3 and K1) along two knot
    parameters against the matching slices of the derivative images; both
    within 1e-5 of the images' scale (K3 sums with atomics in a run-dependent
    order). Prints the times of both versions. Returns (launches on the
    path, {check: passed}, {numbers})."""
    import torch
    from cmax_slam_tpu_torch.ops import scatter, warp_pano

    win, pano, order, sigma = derivative_window(slam)
    K = win.knots.shape[0]
    N = win.weights.shape[0]

    def derive():
        return warp_pano.derivative_images(win, pano, order, sigma)

    dev = win.knots.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    _reset_launches()
    from cmax_slam_tpu_torch.ops import cuda_iwe

    seen, vote_jvp = [], cuda_iwe.vote_jvp

    def spy(*args):  # K3's operands at this window, for its times on real data
        seen.append(args)
        return vote_jvp(*args)

    cuda_iwe.vote_jvp = spy
    try:
        got = derive()
    finally:
        cuda_iwe.vote_jvp = vote_jvp
    zeros = torch.zeros((K, 3), device=dev)
    free = [k for k in range(K) if float(win.free_mask[k]) > 0]
    dirs = [(free[0], 2), (free[-1], 0)]
    jvp_err, jvp_tol = [], []
    for k, c in dirs:
        v = torch.zeros((K, 3), device=dev)
        v[k, c] = 1.0
        _, tan = torch.func.jvp(lambda d: warp_pano.pano_iwe(d, win, pano, order, sigma)[2],
                                (zeros,), (v,))
        jvp_err.append(float((tan - got[k, c]).abs().max()))
        jvp_tol.append(1e-5 * max(1.0, float(got[k, c].abs().max())))
    sync()
    launches = _launches()
    ms = _time_ms(derive, reps=5) if dev.type == "cuda" else float("nan")
    tangent_vote = warp_pano.tangent_vote
    warp_pano.tangent_vote = scatter.bilinear_accumulate_jvp  # the plain version, on the card
    try:
        ref = derive()
        plain_ms = _time_ms(derive, reps=5) if dev.type == "cuda" else float("nan")
    finally:
        warp_pano.tangent_vote = tangent_vote
    sync()
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    out = {"events": N, "knots": K, "shape": list(got.shape), "max_abs_err": err, "tol": tol,
           "jvp_errs": jvp_err, "jvp_tols": jvp_tol, "ms": ms, "plain_ms": plain_ms,
           "scale": float(ref.abs().max())}
    _log(f"derivative images of a phase-4 window ({N} events, {K} knots, "
         f"{pano.height}x{pano.width}): {json.dumps(out)}; launches {launches}")
    if dev.type == "cuda":  # K3 (and the parent's) on this window's coordinates and tangents
        px, py, wt, tpx, tpy, H, W, _ = seen[0]
        dropped = ~(scatter.inbounds_mask(px[0], py[0], H, W) & (wt[0] != 0))
        out["real_window"] = jvp_case("real", px, py, wt, tpx, tpy, H, W, dropped,
                                      JVP_FLOOR_MS)
    checks = {
        "derivative images vs the plain tangent vote": bool(
            got.shape == (K, 3, pano.height, pano.width) and torch.isfinite(got).all()
            and err <= tol),
        "jvp of pano_iwe equals the derivative images' slice": all(
            e <= t for e, t in zip(jvp_err, jvp_tol)),
        "K3 launched": launches["jvp"] > 0 or dev.type != "cuda",
    }
    return launches, checks, out


def compare_host_loop(slam, ev) -> dict:
    """Phase 4's graphed packet solves against minimize_fr_cg, the host
    loop, on the card: each packet solved again from the warm start the
    run gave it (the estimate before it), its events gathered from the host
    store. The median |omega difference| must stay under 0.01 rad/s (the
    same inputs, float32 sums in another order on the device); packet 0's
    cold start has a second optimum (compare_schedules) and is left out."""
    import torch
    from cmax_slam_tpu_torch.ops import optim, warp_local

    fe = slam.frontend
    o = fe.cfg.optim
    t0 = time.perf_counter()
    diffs = []
    prev = np.zeros(3)
    for k, est in enumerate(fe.estimates):
        x0, prev = prev, est.omega
        if est.iters == 0 or k == 0:
            continue
        beg, end = est.span
        packet = fe._packet(ev.xs[beg:end], ev.ys[beg:end], ev.ts[beg:end],
                            float(np.float32(est.t - fe._t0)))
        f, vg = warp_local.make_local_objective(packet, fe.cam, fe.cfg.warp.blur_sigma,
                                                fe.cfg.contrast_measure)
        res = optim.minimize_fr_cg(
            vg, torch.tensor(x0, dtype=torch.float32, device=fe.device), f_fn=f,
            max_line_searches=o.max_line_searches, initial_step=o.initial_step,
            line_search_tol=o.line_search_tol, grad_tol=o.grad_tol, fun_tol=o.fun_tol,
            max_fevals_per_linesearch=o.max_fevals_per_linesearch,
            stagnation_patience=o.stagnation_patience,
            secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
            cg_variant=o.cg_variant)
        diffs.append(np.linalg.norm(res.x.numpy() - est.omega))
    d = np.asarray(diffs)
    _log(f"graphed solves vs minimize_fr_cg on the card over {len(d)} packets: |omega "
         f"difference| median {np.median(d):.3e} max {d.max():.3e} rad/s, "
         f"{int((d < 1e-6).sum())} within 1e-6; host loop {time.perf_counter() - t0:.1f} s")
    return {"graphed vs host loop: median < 0.01 rad/s": bool(np.median(d) < 0.01)}


def _require(phase: str, checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


_WALL_PROBE = """
import json, sys, time
sys.path.insert(0, ".")
sys.path.insert(0, {tools!r})
import chip_smoke, loop_latency
from cmax_slam_tpu_torch.ops import device_loop
walls, captures, nodes = [], [], None
for _ in range(2):  # the first run's system is released before the second
    run = chip_smoke.run_system(label="turn")
    walls.append(run[3])
    captures.append(run[5]["captures"])
    if nodes is None:  # one CG iteration of the packet and crop-window programs
        slam = run[4]
        fe = slam.frontend._entry.programs
        crop = next(s.program for k, s in slam.backend._entry.programs.items()
                    if k[3] is not None)
        nodes = {{"packet": loop_latency.iteration_nodes(device_loop, fe[max(fe)].program),
                  "crop_window": loop_latency.iteration_nodes(device_loop, crop)}}
        del slam, fe, crop
    del run
print("WALLS " + json.dumps(walls))
print("CAPTURES " + json.dumps(captures))
print("NODES " + json.dumps(nodes))
"""


def run_ecrot_phase(phase, graphs: dict, pano: dict, rng, floor_ms: float) -> dict:
    """The ecrot phase (after replay): the pool's bytes held by the ijrr
    phases, then (a) ecrot_real_config() on make_ecrot_stream() with phase
    4's spies and gates, BA in at least all windows but one; K4/K5 on the
    crop window it solved last, its own operands, against the plain
    version as phase 3 holds them (into ``pano``'s shapes as
    "ecrot_crop"); (b) a second system of the same configuration on the
    first 0.6 s, which must capture no graph (its wall: the warm realtime
    factor); (c) ecrot_mount_config() with ECROT_SHED on the same stream.
    ``phase`` is main's wrapper (pooled programs, pool and peak memory
    printed, checks required); the runs' stats go into ``graphs``. Returns
    the launches by path."""
    from cmax_slam_tpu_torch.ops import program_pool

    _log("ecrot: the pool before the phase (the ijrr phases' entries): "
         + json.dumps(program_pool.stats(detail=True)))
    windows = round(ECROT_DURATION / 0.2)
    buckets, pano_buckets = {}, {}
    launches, _, graphs["ecrot"], slam = phase(
        "ecrot", run_ecrot, label="ecrot", min_ba=windows - 1, shapes=buckets,
        pano_shapes=pano_buckets)
    graphs["ecrot"] |= {"k1_by_shape": buckets, "pano_by_shape": pano_buckets}
    _log("ecrot: K1 launches by shape bucket " + json.dumps(buckets) + "; K4/K5 "
         + json.dumps(pano_buckets))
    be = slam.backend
    solver = max((s for key, s in be._entry.programs.items() if key[3] is not None),
                 key=lambda s: s.win.weights.shape[0])
    pano_check(pano, "ecrot_crop", be.order, 1, solver.win, be.pano, solver.basis,
               solver.origin, ("crop", *solver.a_crop.shape), rng, floor_ms)
    del slam, be, solver
    out = {"ecrot": launches}
    for label, kw in (("ecrot_warm", {"upto": ECROT_DURATION / 2, "no_capture": True}),
                      ("ecrot_mount_shed", {"shed": True, "min_ba": windows - 1})):
        res = phase(label, run_ecrot, label=label, **kw)
        out[label], graphs[label] = res[0], res[2]
        del res  # its system, before the next run
    _log("ecrot: the pool after the phase: " + json.dumps(program_pool.stats(detail=True)))
    return out


# The presets phase: the CLI's three presets that no other phase runs, each
# through cli.main on a stream at its own scale. "default" (no --preset,
# SystemConfig()) on make_stream's camera turning at 0.54 rad/s, slow
# enough that a map pixel stays in view past the cap of 10 updates;
# "ecrot_synth" on the ecrot phase's camera and motion at 2 Mev/s in
# chunks of 2^17 events: its 70 000-event packets must span at most 10 x
# its 0.005 s (the front-end's degenerate-packet guard, as the JAX
# package's: a longer packet gives omega = 0 and no solve), which needs
# more than 1.4 Mev/s, and a chunk then completes 13-20 packets, which the
# front-end solves as one stride; its 2^18-event window cap cuts each
# 0.2 s window (322 000-469 000 events) as the JAX package cuts it;
# "live_davis" on a
# DAVIS346 (346x260) at 1 Mev/s and a handheld 1.0 rad/s, fed through a
# pipe as --events -. Each run's gates: BA windows, RMS (the live preset's
# wider: it sheds load), and what the preset exists for.
PRESET_RUNS = {
    "default": {"stream": {"duration": 1.5, "omega": (0.2, -0.3, 0.4)}, "file": "txt",
                "argv": ["--refine-passes", "1"], "min_ba": 12, "rms_deg": 0.3},
    "ecrot_synth": {"stream": {"duration": 0.8, "rate": 2_000_000}, "file": "npz",
                    "argv": ["--preset", "ecrot_synth", "--chunk-size", str(1 << 17)],
                    "min_ba": 5, "rms_deg": 0.3},
    "live_davis": {"stream": {"duration": 1.0, "omega": (0.3, -0.5, 0.8), "rate": 1_000_000,
                              "camera": (346, 260, 260.0)},
                   "file": "pipe", "argv": ["--preset", "live_davis"], "min_ba": 7,
                   "rms_deg": 1.5},
}
LIVE_BLOCK_S = 0.05  # stream seconds per write into the live run's pipe


@contextlib.contextmanager
def _cli_system(audit, rec: dict):
    """For one cli.main call, cli.CMaxSLAM is a subclass that records the
    system it makes (``rec["slam"]``) and, through _spy_windows, its
    front-end's events and each window's events and pass, and holds
    ``audit`` (a SyncAudit) open over its
    push loop: from the first push_events to the first flush, which the
    CLI makes once its source is exhausted; the loop's counters are kept
    at that flush (``rec["loop"]``)."""
    from cmax_slam_tpu_torch import cli

    base = cli.CMaxSLAM
    rec["state"] = "before"

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["slam"] = self
            rec["unspy"] = _spy_windows(self, rec)

        def push_events(self, *a):
            if rec["state"] == "before":
                rec["state"] = "loop"
                audit.__enter__()
            return super().push_events(*a)

        def flush(self):
            if rec["state"] == "loop":
                audit.__exit__(None, None, None)
                rec["state"] = "after"
                rec["loop"] = dict(self.metrics.counters)
                rec["loop"]["windows_completed"] = len(self.backend.results)
            return super().flush()

    cli.CMaxSLAM = Recorded
    try:
        yield
    finally:
        cli.CMaxSLAM = base
        if rec["state"] == "loop":
            audit.__exit__(None, None, None)
        if "unspy" in rec:
            rec.pop("unspy")()


def _pipe_stdin(ev, block_s: float):
    """A real pipe as sys.stdin, and a writer thread that fills it with the
    stream's 't x y p' lines, ``block_s`` s of the stream a write (the lines
    are formatted before the thread starts, so that it holds no Python
    lock while the CLI reads). Returns (the seconds the formatting took, a
    function that joins the writer and restores sys.stdin)."""
    import threading

    t0 = time.perf_counter()
    edges = np.searchsorted(ev.ts, np.arange(0.0, ev.ts[-1] + block_s, block_s))
    edges = np.unique(np.append(edges, len(ev.ts)))
    blocks = ["".join(f"{t:.9f} {x} {y} {int(p > 0)}\n" for t, x, y, p in zip(
        ev.ts[lo:hi].tolist(), ev.xs[lo:hi].tolist(), ev.ys[lo:hi].tolist(),
        ev.pols[lo:hi].tolist())).encode() for lo, hi in zip(edges[:-1], edges[1:])]
    fmt_s = time.perf_counter() - t0
    r, w = os.pipe()

    def write():
        try:
            with os.fdopen(w, "wb", buffering=0) as out:
                for block in blocks:
                    out.write(block)
        except BrokenPipeError:  # the reader stopped early (its error is the one raised)
            pass

    stdin, sys.stdin = sys.stdin, os.fdopen(r, "r")
    writer = threading.Thread(target=write, daemon=True)
    writer.start()

    def restore():
        sys.stdin.close()  # the read end first: a writer still blocked on it gets an error
        writer.join()
        sys.stdin = stdin

    return fmt_s, restore


def run_preset(name: str, device: str = "cuda", stream: dict | None = None,
               overrides: dict | None = None):
    """One run of the presets phase: PRESET_RUNS[name]'s stream (make_stream,
    or make_ecrot_stream for ecrot_synth; ``stream`` overrides its
    arguments) through cli.main in this process, as a text file, an .npz
    file or a pipe, with ``overrides`` as --set (CPU rehearsals). The push
    loop is audited (SyncAudit) and phase 4's loop gates apply
    (_graph_checks); the run must read every event, write the six outputs,
    launch K1, K2, K4, K5 and the loop predicate, run BA in PRESET_RUNS'
    windows and track the truth within its RMS; each window's events are
    cut only past its cap, as the JAX package cuts them; and the preset's
    own: default's map cap bound (update_times past max_update_times),
    ecrot_synth's strides (8 or more packets a front-end launch),
    live_davis's front-end decimation (its events the raw count over 10,
    within one per chunk) and omega (median within 0.05 rad/s of the
    truth). Prints the wall, events/s and realtime factor, the timers,
    packets, windows and their events, the crop shapes and blur paths,
    launches by kernel and variant, captures, waits, the pool's new
    entries and their bytes, peak memory and the RMS both ways. Returns
    (launches, checks, stats)."""
    import torch
    from cmax_slam_tpu_torch import cli, spline
    from cmax_slam_tpu_torch.ops import blur
    from cmax_slam_tpu_torch.utils.evaluate import read_tum_trajectory, rotation_rms_deg

    run = PRESET_RUNS[name]
    label = f"preset_{name}"
    kw = run["stream"] | dict(stream or {})
    t0 = time.perf_counter()
    if name == "ecrot_synth":
        ev, omega, calib, _ = make_ecrot_stream(kw["duration"], kw["rate"])
    else:
        ev, omega, calib = make_stream(**kw)
    gen_s = time.perf_counter() - t0
    n, span = len(ev.ts), kw["duration"]
    pool0 = _pool_ids()
    rec, audit = {}, SyncAudit(device)
    with tempfile.TemporaryDirectory(prefix="cmax_preset_") as tmp:
        t0 = time.perf_counter()
        events = "-"
        if run["file"] == "txt":
            events = os.path.join(tmp, "events.txt")
            np.savetxt(events, np.column_stack([ev.ts, ev.xs, ev.ys, (ev.pols > 0).astype(int)]),
                       fmt="%.9f %d %d %d")
        elif run["file"] == "npz":
            events = os.path.join(tmp, "events.npz")
            np.savez(events, x=ev.xs, y=ev.ys, t=ev.ts, p=ev.pols)
        K = calib.K
        calib_txt = os.path.join(tmp, "calib.txt")
        with open(calib_txt, "w") as f:
            f.write(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} 0 0 0 0 0\n")
        write_s = time.perf_counter() - t0
        out = os.path.join(tmp, "out")
        argv = ["--device", device, "--events", events, "--calib", calib_txt,
                "--width", str(calib.width), "--height", str(calib.height), "--out-dir", out,
                *run["argv"], *(a for k, v in (overrides or {}).items()
                                for a in ("--set", f"{k}={json.dumps(v)}"))]
        restore = None
        if events == "-":  # the lines are formatted here, outside the wall
            fmt_s, restore = _pipe_stdin(ev, LIVE_BLOCK_S)
            write_s += fmt_s
        try:
            _log(f"{label}: {n} events over {span} s of a {calib.width}x{calib.height} stream "
                 f"(omega {omega.tolist()}, generated in {gen_s:.2f} s, written as "
                 f"{run['file']} in {write_s:.2f} s, outside the wall); argv "
                 f"{' '.join(argv[2:])}")
            _reset_launches()
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _cli_system(audit, rec):
                rc = cli.main(argv)
        finally:
            if restore is not None:
                restore()
        wall = time.perf_counter() - t0
        launches = _launches()
        files = sorted(os.listdir(out))
        stats = json.load(open(os.path.join(out, "stats.json")))
        times, quats = read_tum_trajectory(os.path.join(out, "trajectory_tum.txt"))
        q_gt = np.stack([spline._np_quat_exp(omega * t) for t in times])
        rms = rotation_rms_deg(times, q_gt, quats, "global")[0]
        rms_raw = _rms_unnormalized(q_gt, quats)
        av = np.atleast_2d(np.loadtxt(os.path.join(out, "angular_velocity.txt")))
        with np.load(os.path.join(out, "final_state.npz")) as z:
            upd = z["update_times"]
    slam = rec["slam"]
    cfg, be, fe = slam.cfg, slam.backend, slam.frontend
    graphs = _graph_stats(slam, device, rec["loop"], audit)
    wins = slam.window_results()
    n_ba = sum(w.ran_ba for w in wins)
    counters = stats["metrics"]["counters"]
    timers = {k: {"total_s": v["total_s"], "count": v["count"]}
              for k, v in stats["metrics"]["timers"].items()}
    packets = stats["ang_vel_estimates"]
    chunk = int(argv[argv.index("--chunk-size") + 1]) if "--chunk-size" in argv else 1 << 16
    chunks = -(-n // chunk)
    omega_err = np.linalg.norm(av[:, 1:] - omega, axis=1)
    cap = cfg.backend.pano_map.max_update_times
    graphs |= {
        "wall_s": wall, "stream_s": span, "realtime_factor": span / wall, "raw_events": n,
        "events_per_second": stats["events_per_second"], "generate_s": gen_s,
        "write_s": write_s, "timers": timers, "packets": packets,
        "frontend_events": rec["frontend_events"], "windows": len(wins), "ba_windows_run": n_ba,
        "window_events": rec["windows"],
        "events_dropped_at_cap": counters.get("backend.events_dropped", 0),
        "knots_per_window": be.K_win, "knot_stride": be.cp_stride,
        "ba_threshold_events": be.min_events_per_win,
        "window_programs": sorted(str(k) for k in be._entry.programs),
        "update_times_max": int(upd.max()), "pixels_past_cap": int((upd > cap).sum()),
        "crop_shapes": sorted(be._crop_shapes),
        "blur_paths": {f"crop {h}x{w}": blur.blur_path(h, w) for h, w in sorted(be._crop_shapes)}
        | {f"panorama {be.pano.height}x{be.pano.width}": blur.blur_path(be.pano.height,
                                                                       be.pano.width)},
        "launches": {k: launches[k] for k in ("fwd_P", "fwd_G", "bwd_S", "bwd_G", "pano_fwd",
                                              "pano_bwd")},
        "omega_err_median": float(np.median(omega_err)), "omega_err_max": float(omega_err.max()),
        "new_pool_entries": _new_entries(pool0),
        "rms_deg": rms, "rms_unnormalized_deg": rms_raw}
    del slam, be, fe, rec["slam"]
    _log(f"{label}: rc {rc}, wall {wall:.3f} s for {span} s of stream, realtime factor "
         f"{span / wall:.4f}, events_per_second {stats['events_per_second']:.0f} "
         f"({stats['events']} events read of {n}); timers {json.dumps(timers)}; packets "
         f"{packets} (front-end launches {graphs['frontend_launches']}, "
         f"{packets / max(graphs['frontend_launches'], 1):.2f} a launch), front-end events "
         f"{rec['frontend_events']}; windows {len(wins)}, {n_ba} with BA (threshold "
         f"{graphs['ba_threshold_events']} events), {graphs['knots_per_window']} knots a window "
         f"at a stride of {graphs['knot_stride']}; events per window (in the window, padded, "
         f"after the in-batch decimation, pass) {json.dumps(rec['windows'])}; cut at the window cap "
         f"of {cfg.backend.max_events_per_window} {graphs['events_dropped_at_cap']}")
    _log(f"{label}: update_times largest {graphs['update_times_max']}, pixels past the cap of "
         f"{cap} {graphs['pixels_past_cap']}; crop shapes {graphs['crop_shapes']}, blur paths "
         f"{json.dumps(graphs['blur_paths'])}; window programs {graphs['window_programs']}")
    _log(f"{label}: launches K1 P/G {launches['fwd_P']}/{launches['fwd_G']}, K2 S/G "
         f"{launches['bwd_S']}/{launches['bwd_G']}, K4 {launches['pano_fwd']}, K5 "
         f"{launches['pano_bwd']}, loop predicate {graphs['pred']}; captures "
         f"{json.dumps(graphs['captures'])}; waits in the push loop front-end "
         f"{graphs['frontend_waits']}, back-end {graphs['backend_waits']} for "
         f"{graphs['windows_completed_in_loop']} windows completed in it and "
         f"{graphs['resolves']} re-solves; sync-debug {json.dumps(graphs.get('audit'))}")
    _log(f"{label}: new pool entries {json.dumps(graphs['new_pool_entries'])}; peak device "
         f"memory {graphs['peak_gib']:.3f} GiB; omega error median "
         f"{graphs['omega_err_median']:.4f} rad/s, largest {graphs['omega_err_max']:.4f}; "
         f"trajectory_tum RMS against the truth {rms:.4f} deg ({rms_raw:.4f} unnormalized)")
    outputs = ("angular_velocity.txt", "angular_velocity_deg.txt", "trajectory_tum.txt",
               "pano_map.png", "final_state.npz", "stats.json")
    checks = {
        "cli rc 0": rc == 0,
        "every event read": stats["events"] == n,
        "six outputs": all(f in files for f in outputs),
        "K1 launched, and K2 or K6": _votes_launched(launches),
        "K4 and K5 launched": launches["pano_fwd"] > 0 and launches["pano_bwd"] > 0,
        "loop predicate ran": device != "cuda" or graphs["pred"] > 0,
        f"BA in >= {run['min_ba']} windows": n_ba >= run["min_ba"],
        f"trajectory_tum RMS < {run['rms_deg']} deg": rms < run["rms_deg"],
        "events cut only past the cap, as the reference cuts them": _cut_as_reference(
            cfg.backend, rec["windows"], graphs["events_dropped_at_cap"]),
    }
    checks |= _graph_checks(graphs, cfg, device)
    if name == "default":
        checks[f"update_times past the cap of {cap}"] = graphs["update_times_max"] > cap
    if name == "ecrot_synth":
        checks[">= 8 packets a front-end launch"] = (
            packets >= 8 * graphs["frontend_launches"] > 0)
    if name == "live_davis":
        rate = cfg.frontend_event_sample_rate
        checks["front-end events = raw / rate within 1 per chunk"] = (
            abs(rec["frontend_events"] - n / rate) <= chunks)
        checks["front-end omega median within 0.05 rad/s of the truth"] = (
            graphs["omega_err_median"] < 0.05)
    return launches, checks, graphs


def run_presets_phase(phase, graphs: dict) -> dict:
    """The presets phase (after ecrot): run_preset for each of PRESET_RUNS
    through main's ``phase`` wrapper (pooled programs, pool and peak memory
    printed, checks required); each run's stats into ``graphs`` under
    "preset_<name>". Returns the launches by path."""
    out, t0 = {}, time.perf_counter()
    for name in PRESET_RUNS:
        launches, _, graphs[f"preset_{name}"] = phase(f"preset_{name}", run_preset, name)
        out[f"preset_{name}"] = launches
    _log(f"presets: the phase took {time.perf_counter() - t0:.1f} s, the streams' generation "
         f"and writing included")
    return out


# The options phase: every solver option of the configuration that no other
# phase sets, each on phase 4's stream and stock ijrr preset with its
# dotted-key overrides, through the same entry points and path checks
# (run_system), and the full 2048x4096 panorama at ECRot scale
# (run_ecrot_full_pano). "rms_deg" is each run's RMS gate against the
# truth; for the two other contrast measures it is G: 0.3 deg where the JAX
# package on the CPU tests' stream tracks under 0.15 deg, else twice its
# figure (tests/test_torch_options.py's stream: mean square 0.0732,
# gradient magnitude 0.0703 deg, so 0.3 both). "trust" takes its cap C at
# run time (trust_cap_deg of phase 4's corrections: None below stands for
# it), "refine_prior" runs through cli.main as phase 5 (run_cli).
OPTION_RUNS = {
    "mean_square": {"overrides": {"frontend.contrast_measure": 1,
                                  "backend.contrast_measure": 1}, "rms_deg": 0.3},
    "gradient_magnitude": {"overrides": {"frontend.contrast_measure": 2,
                                         "backend.contrast_measure": 2}, "rms_deg": 0.3},
    "polak_ribiere": {"overrides": {"frontend.optim.cg_variant": "pr",
                                    "backend.optim.cg_variant": "pr"}, "rms_deg": 0.3},
    "fe_sequential": {"overrides": {"frontend.optim.ladder": "sequential"}, "rms_deg": 0.3},
    "grid": {"overrides": {"frontend.optim.ladder": "grid", "backend.optim.ladder": "grid"},
             "rms_deg": 0.3},
    "coarse_to_fine": {"overrides": {"frontend.coarse_to_fine": True}, "rms_deg": 0.3},
    "full_pano": {"overrides": {"backend.crop_solver": False}, "rms_deg": 0.3},
    "trust": {"overrides": {"backend.max_ba_correction_rad": None}, "rms_deg": None},
    "refine_prior": {"overrides": {"backend.refine_prior_lambda": 100.0}, "cli": True},
}
OPTION_DURATION = 2.0  # stream seconds of each ijrr option run (phase 4's)
OPTION_MIN_BA = 15  # of the 18 windows of 2.0 s, as phase 4
TRUST_FRACTION = 0.6  # of phase 4's first window's correction: the trust run's cap C


def cold_start_frontend(device: str = "cuda") -> dict:
    """tests/test_frontend.py's coarse-to-fine cold start on the port's
    front-end alone: omega [2.0, -3.5, 4.0] (5.7 rad/s) on 240x180 (fx = fy
    = 180), 30 000 events over 0.12 s from seed 42 (300 landmarks), 8 000-event
    packets every 0.02 s, the first from omega = 0. Returns the errors and
    {check: passed} (median error < 0.25 rad/s, at least 3 packets)."""
    from cmax_slam_tpu_torch.config import FrontendConfig, WarpOptions
    from cmax_slam_tpu_torch.frontend import Frontend
    from cmax_slam_tpu_torch.io import synthetic
    from cmax_slam_tpu_torch.ops.warp_local import CameraParams

    W, H, F = 240, 180, 180.0
    omega = np.array([2.0, -3.5, 4.0])
    ev = synthetic.rotating_camera_events(np.random.default_rng(42), 30000, 0.12, omega,
                                          F, F, W / 2, H / 2, W, H, n_points=300)
    cfg = FrontendConfig(num_events_per_packet=8000, dt_ang_vel=0.02,
                         warp=WarpOptions(blur_sigma=1.0, event_batch_size=100),
                         coarse_to_fine=True)
    fe = Frontend(CameraParams(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H),
                  synthetic.identity_lut(W, H, F, F, W / 2, H / 2), cfg, device=device)
    fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    errs = [float(np.linalg.norm(e.omega - omega)) for e in fe.estimates]
    out = {"errors": errs, "median": float(np.median(errs)) if errs else float("nan")}
    _log(f"coarse_to_fine cold start (front-end alone, {len(errs)} packets): omega errors "
         f"{np.round(errs, 4).tolist()} rad/s, median {out['median']:.4f}")
    return out | {"checks": {">= 3 cold-start packets": len(errs) >= 3,
                             "cold-start median omega error < 0.25 rad/s": out["median"] < 0.25}}


def _pool_ids() -> set:
    from cmax_slam_tpu_torch.ops import program_pool

    return {id(e) for group in list(program_pool.ENTRIES.values()) for e in group}


def _new_entries(before: set) -> list:
    """The pool's entries made since ``before`` (_pool_ids), with their
    programs and bytes."""
    from cmax_slam_tpu_torch.ops import program_pool

    return [{"kind": str(e.key[0]), "programs": len(e.programs),
             "state_bytes": e.state_bytes(), "allocated_bytes": e.allocated,
             "reserved_bytes": e.reserved}
            for group in list(program_pool.ENTRIES.values()) for e in group
            if id(e) not in before]


def run_option(name: str, device: str = "cuda", duration: float = OPTION_DURATION,
               min_ba: int = OPTION_MIN_BA, cap_deg: float | None = None,
               phase4_pred: int | None = None, overrides: dict | None = None):
    """One run of the options phase: OPTION_RUNS[name] on ``duration`` s of
    phase 4's stream (make_stream) with the stock ijrr preset, through
    run_system (phase 4's path checks: every solve a graph, no front-end
    wait, the back-end's waits bounded, no synchronizing call outside the
    captures, BA in ``min_ba`` windows, K1, K2, K4, K5 and the loop
    predicate launched), with ``overrides`` added (CPU rehearsals: a
    smaller panorama); "refine_prior" through run_cli instead (phase 5's
    checks). Each run's own gate: its RMS (OPTION_RUNS), and
    gradient_magnitude: the crop halo h = r + 1; coarse_to_fine: the cold
    start of cold_start_frontend; full_pano: no crop window, every window
    solve a full-panorama program on the panorama; trust: ``cap_deg`` (C)
    as max_ba_correction_rad, between 1 and windows - 1 windows rejected
    and their maps left as they were; refine_prior: the refine pass ran a
    window program with the prior's weight. Prints the wall, captures,
    the pool's new entries and bytes, peak memory, the RMS both ways and
    the launches; fe_sequential its loop predicate's executions beside
    phase 4's (``phase4_pred``). Returns (launches, checks, stats)."""
    from cmax_slam_tpu_torch.ops import blur, program_pool

    run = OPTION_RUNS[name]
    label = f"option_{name}"
    opts = dict(run["overrides"])
    if name == "trust":
        opts["backend.max_ba_correction_rad"] = math.radians(cap_deg)
        _log(f"{label}: cap C = {cap_deg:.6f} deg ({TRUST_FRACTION} of phase 4's first "
             f"window's largest knot correction) = "
             f"{opts['backend.max_ba_correction_rad']:.8f} rad")
    pool0 = _pool_ids()
    if run.get("cli"):
        lam = opts["backend.refine_prior_lambda"]
        arg = f"backend.refine_prior_lambda={json.dumps(lam)}"
        launches, checks = run_cli(device, duration, extra=("--set", arg), label=label)
        priors = sorted({k[5] for group in list(program_pool.ENTRIES.values()) for e in group
                         if e.key[0] == "backend" for k in e.programs})
        checks[f"the refine pass ran a window program of prior weight {lam}"] = lam in priors
        stats = {"prior_weights_of_window_programs": priors,
                 "new_pool_entries": _new_entries(pool0)}
        _log(f"{label}: window programs' prior weights {priors}; new pool entries "
             f"{json.dumps(stats['new_pool_entries'])}")
        return launches, checks, stats
    pano_buckets = {}
    launches, checks, _, wall, slam, stats = run_system(
        device, opts | dict(overrides or {}), label=label, duration=duration, audit=True,
        shapes={}, pano_shapes=pano_buckets, min_ba=min_ba, rms_deg=run["rms_deg"])
    be, counters = slam.backend, slam.metrics.counters
    wins = slam.window_results()
    solves = (sum(w.ran_ba for w in wins) + sum(w.ran_ba for w in be.bootstrap_results))
    pano_hw = (be.pano.height, be.pano.width)
    stats |= {"wall_s": wall, "stream_s": duration, "windows": len(wins),
              "ba_windows_run": sum(w.ran_ba for w in wins), "window_solves": solves,
              "crop_windows": counters.get("backend.crop_windows", 0),
              "crop_escapes": counters.get("backend.crop_escapes", 0),
              "rejected": counters.get("backend.ba_rejected", 0),
              "crop_shapes": sorted(be._crop_shapes),
              "blur_paths": {f"crop {h}x{w}": blur.blur_path(h, w)
                             for h, w in sorted(be._crop_shapes)}
              | {f"panorama {pano_hw[0]}x{pano_hw[1]}": blur.blur_path(*pano_hw)},
              "pano_by_shape": pano_buckets, "new_pool_entries": _new_entries(pool0),
              "launches": {k: launches[k] for k in ("fwd", "bwd", "pano_fwd", "pano_bwd")}}
    _log(f"{label}: wall {wall:.3f} s for {duration} s of stream; windows {len(wins)} "
         f"({stats['ba_windows_run']} with BA, {solves} window solves with the bootstrap's), "
         f"crop windows {stats['crop_windows']}, escapes {stats['crop_escapes']}, rejected "
         f"{stats['rejected']}; captures {json.dumps(stats['captures'])}; new pool entries "
         f"{json.dumps(stats['new_pool_entries'])}; peak device memory "
         f"{stats['peak_gib']:.3f} GiB; RMS {stats['rms_deg']:.4f} deg "
         f"({stats['rms_unnormalized_deg']:.4f} unnormalized); launches K1 {launches['fwd']}, "
         f"K2 {launches['bwd']}, K4 {launches['pano_fwd']}, K5 {launches['pano_bwd']}, loop "
         f"predicate {stats['pred']}; K4/K5 by image {json.dumps(pano_buckets)}")
    checks["loop predicate ran"] = device != "cuda" or stats["pred"] > 0
    if name == "gradient_magnitude":
        r = blur.opencv_ksize(be.cfg.warp.blur_sigma) // 2
        stats["crop_halo"] = be._crop_halo()
        _log(f"{label}: the crop objective's halo h = {stats['crop_halo']} (blur radius r = {r})")
        checks["crop halo h = r + 1"] = stats["crop_halo"] == r + 1
    if name == "fe_sequential":
        _log(f"{label}: loop predicate executions {stats['pred']} against phase 4's "
             f"{phase4_pred}")
    if name == "coarse_to_fine":
        cold = cold_start_frontend(device)
        stats["cold_start"] = {k: cold[k] for k in ("errors", "median")}
        checks |= cold["checks"]
    if name == "full_pano":
        runs = stats["runs"]
        checks["no crop window counted"] = stats["crop_windows"] == 0 == stats["crop_escapes"]
        checks["every window solved on the full panorama"] = (
            not stats["crop_shapes"] and not any(" crop" in b for b in pano_buckets)
            and (device != "cuda" or runs.get("backend.crop", 0) == 0
                 and runs.get("backend.full", 0) == solves > 0))
    if name == "trust":
        online = sum(w.rejected for w in wins)
        boot = sum(w.rejected for w in be.bootstrap_results)
        stats |= {"cap_deg": cap_deg, "rejected_online": online, "rejected_bootstrap": boot}
        _log(f"{label}: rejected {online} of {len(wins)} windows and {boot} of "
             f"{len(be.bootstrap_results)} bootstrap re-solves (backend.ba_rejected "
             f"{stats['rejected']:.0f} of {solves} window solves)")
        checks[f"rejected windows between 1 and {len(wins) - 1}"] = 1 <= online <= len(wins) - 1
        checks["each rejection counted and its maps kept"] = (
            online + boot == stats["rejected"] == len(stats["rejected_windows"]))
    del slam, be
    return launches, checks, stats


def captured_window_objective(solver, scale: float = 1e-3) -> dict:
    """The value and gradient of a full-panorama window program's own
    objective (``solver.cg.vg``: K4/K5, the blur, the contrast) on the
    window loaded into it last, at increments of ``scale``, as one captured
    evaluation, against the same function evaluated eagerly on the plain
    route on the card (warp_pano.pano_vote_plain and autograd, through the
    same blur): value within rtol 2e-5, gradient within 2e-3 of its scale +
    2e-6. Returns the errors, the tolerances and ok."""
    import torch
    from cmax_slam_tpu_torch.ops import warp_pano

    vg = solver.cg.vg
    x = torch.full((1, 3 * solver.win.knots.shape[0]), scale, device="cuda")
    prog = _objective_program(vg, x, "objective_window_full")
    got = prog.run().fetch()
    with _images_by(warp_pano.pano_vote_plain):
        v, g = vg(x)
    ref = torch.cat([v, g[0]]).detach().cpu().numpy()
    f_err = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    g_err = float(np.abs(got[1:] - ref[1:]).max())
    g_scale = float(np.abs(ref[1:]).max())
    g_tol = 2e-3 * g_scale + 2e-6
    out = {"f": float(got[0]), "f_plain": float(ref[0]), "f_rel_err": f_err,
           "g_abs_err": g_err, "g_scale": g_scale, "g_tol": g_tol,
           "ok": bool(f_err <= 2e-5 and g_err <= g_tol and np.isfinite(got).all())}
    del prog
    return out


def run_ecrot_full_pano(pano: dict, rng, floor_ms: float, device: str = "cuda"):
    """The options phase's ECRot run: ecrot_real_config() with
    backend.crop_solver=False on the ecrot phase's stream (make_ecrot_stream,
    cached) through run_ecrot (phase 8's spies and gates, RMS < 0.3 deg),
    BA in all windows but one, every window solve a full-panorama program
    whose objective blurs by shift-and-add, K4/K5 launched on the
    panorama. Then, on the window loaded last into the widest
    full-panorama program (about 10^6 events, 2048x4096, order 2): K4 and
    K5 against their plain version as phase 3 holds them (into ``pano``'s
    shapes as "ecrot_pano"), and the program's own objective captured
    against the plain route (captured_window_objective). Returns
    (launches, checks, stats)."""
    from cmax_slam_tpu_torch.ops import program_pool

    label = "ecrot_full_pano"
    windows = round(ECROT_DURATION / 0.2)
    buckets, pano_buckets = {}, {}
    launches, checks, stats, slam = run_ecrot(
        device, label, overrides={"backend.crop_solver": False}, min_ba=windows - 1,
        shapes=buckets, pano_shapes=pano_buckets)
    be = slam.backend
    pano_hw = (be.pano.height, be.pano.width)
    solves = (sum(w.ran_ba for w in slam.window_results())
              + sum(w.ran_ba for w in be.bootstrap_results))
    stats |= {"k1_by_shape": buckets, "pano_by_shape": pano_buckets}
    checks["every window objective blurs by shift-and-add"] = (
        not stats["crop_shapes"] and set(stats["blur_paths"].values()) == {"shift_add"})
    checks["every window solved on the full panorama"] = (
        not stats["crop_shapes"] and (device != "cuda" or stats["window_solves"]["crop"] == 0
                                      and stats["window_solves"]["full"] == solves > 0))
    checks["K4 and K5 launched on the panorama"] = all(
        pano_buckets.get(f"{k} panorama", {}).get("launches", 0) > 0
        for k in ("pano_fwd", "pano_bwd"))
    _log(f"{label}: K4/K5 launches by image {json.dumps(pano_buckets)}; K1 by shape "
         f"{json.dumps(buckets)}")
    if device == "cuda":
        solver = max((s for key, s in be._entry.programs.items() if key[3] is None),
                     key=lambda s: s.win.weights.shape[0])
        pano_check(pano, "ecrot_pano", be.order, 1, solver.win, be.pano, solver.basis, None,
                   ("full", *pano_hw), rng, floor_ms)
        stats["captured_objective"] = cap = captured_window_objective(solver)
        _log(f"{label}: the widest full-panorama program's objective ("
             f"{solver.win.weights.shape[0]} events, {pano_hw[0]}x{pano_hw[1]}) captured "
             f"against the plain route: {json.dumps(cap)}")
        checks["captured window objective matches the plain route"] = cap["ok"]
        del solver
    stats["pool"] = program_pool.stats(detail=True)
    _log(f"{label}: the pool {json.dumps(stats['pool'])}; peak device memory "
         f"{stats['peak_gib']:.3f} GiB")
    del slam, be
    return launches, checks, stats


def run_options_phase(phase, graphs: dict, pano: dict, rng, floor_ms: float) -> dict:
    """The options phase (after presets): run_option for each of OPTION_RUNS
    and run_ecrot_full_pano, each through main's ``phase`` wrapper (pooled
    programs, pool and peak memory printed, checks required); the trust
    run's cap C is trust_cap_deg of phase 4's corrections
    (``graphs["system"]``). Each run's stats into ``graphs`` under
    "option_<name>" (not the CLI's). Returns the launches by path."""
    out, t0 = {}, time.perf_counter()
    cap = trust_cap_deg(graphs["system"]["corrections"])
    for name in OPTION_RUNS:
        launches, _, stats = phase(f"option_{name}", run_option, name, cap_deg=cap,
                                   phase4_pred=graphs["system"]["pred"])
        out[f"option_{name}"] = launches
        if not OPTION_RUNS[name].get("cli"):
            graphs[f"option_{name}"] = stats
    launches, _, graphs["ecrot_full_pano"] = phase("ecrot_full_pano", run_ecrot_full_pano,
                                                   pano, rng, floor_ms)
    out["ecrot_full_pano"] = launches
    _log(f"options: the phase took {time.perf_counter() - t0:.1f} s")
    return out


def _pool_snapshot() -> tuple:
    """({id of each pooled program: captured}, {id of each entry: leases})."""
    from cmax_slam_tpu_torch.ops import program_pool

    entries = [e for group in list(program_pool.ENTRIES.values()) for e in group]
    return ({id(p): p.program._exec is not None for e in entries for p in e.programs.values()},
            {id(e): e.leases for e in entries})


def walls_in_turns(parent: str, card: str, fewer_per_gate: float | None = None) -> dict:
    """Phase 4's wall on this tree and on ``parent`` (an unpacked checkout
    of another commit), in turns: parent, this, this, parent, each turn a
    process of its own that runs phase 4 twice (the first run pays the
    captures and the library set-up, the second is warm: a tree with the
    program pool captures nothing in it). Returns {tree: [[first, warm],
    ...]}, prints each run's captures and the nodes of one CG iteration of
    each tree's packet and crop-window programs, and how many fewer per
    gate this tree's take; with ``fewer_per_gate`` it fails unless both
    programs take at least that many fewer per gate."""
    out = {"parent": [], "change": []}
    nodes = {}
    probe = _WALL_PROBE.format(tools=os.path.join(REPO, "tools"))
    for name in ("parent", "change", "change", "parent"):
        cwd = parent if name == "parent" else REPO
        proc = subprocess.run([sys.executable, "-c", probe], cwd=cwd,
                              capture_output=True, text=True, timeout=900)
        lines = {ln.split(" ", 1)[0]: ln.split(" ", 1)[1] for ln in proc.stdout.splitlines()
                 if ln.startswith(("WALLS ", "CAPTURES ", "NODES "))}
        if proc.returncode != 0 or "WALLS" not in lines:
            raise RuntimeError(f"phase 4 in {cwd} failed:\n{proc.stderr[-3000:]}")
        out[name].append(json.loads(lines["WALLS"]))
        nodes[name] = json.loads(lines["NODES"])
        _log(f"turns: {name} phase 4 walls (first, warm) {out[name][-1]} s, captures "
             f"{lines.get('CAPTURES')}")
    _log(f"phase 4 wall in turns on {card}: parent {out['parent']}, this tree "
         f"{out['change']} (s, first run then warm run per process)")
    _log(f"nodes per CG iteration (nodes, kernel nodes, gates; each inner loop's body once): "
         f"parent {json.dumps(nodes['parent'])}, this tree {json.dumps(nodes['change'])}")
    fewer = {}
    for prog in ("packet", "crop_window"):
        p, c = nodes["parent"][prog], nodes["change"][prog]
        fewer[prog] = ((p["nodes"] - c["nodes"]) / c["gates"]
                       if c["gates"] and p["gates"] == c["gates"] else None)
    _log(f"nodes per CG iteration fewer per gate than the parent's: {json.dumps(fewer)}")
    if fewer_per_gate is not None and not all(
            f is not None and f >= fewer_per_gate for f in fewer.values()):
        raise AssertionError(f"nodes per CG iteration not {fewer_per_gate} fewer per gate than "
                             f"the parent's: {json.dumps(fewer)}")
    out["nodes"] = nodes
    out["fewer_nodes_per_gate"] = fewer
    return out


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
    from cmax_slam_tpu_torch.io import native
    from cmax_slam_tpu_torch.ops import (cuda_iwe, cuda_packet, cuda_pano_vote, device_loop,
                                         nvcc, program_pool)

    card = card_line()
    _log(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    if not native.available():
        native.build()  # raises with the compiler's output
    host_build_s = time.perf_counter() - t0
    _log(f"host data plane: {native.library_path().name} built from "
         f"{os.path.relpath(native.SOURCE, REPO)} with {native.compiler()} "
         f"{' '.join(native.CXX_FLAGS)} in {host_build_s:.2f} s")
    global PARENT
    parent = (os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
              if "--parent" in sys.argv else None)
    fewer_per_gate = (float(sys.argv[sys.argv.index("--fewer-nodes-per-gate") + 1])
                      if "--fewer-nodes-per-gate" in sys.argv else None)
    t0 = time.perf_counter()
    jobs = [cuda_iwe.build_job(), device_loop.build_job(), cuda_pano_vote.build_job(),
            cuda_packet.build_job()]
    global PARENT_JVP, JVP_FLOOR_MS
    if parent is not None:  # the parent's K3 and K4/K5, for phase 3 in turns
        PARENT_JVP = ParentJvp(parent)
        jobs.append(PARENT_JVP.build_job())
        pano = ParentPanoVote(parent)
        if pano.src.read_bytes() != cuda_pano_vote.SOURCE.read_bytes():
            PARENT = pano
            jobs.append(PARENT.build_job())
        else:
            _log("the parent's csrc/pano_vote.cu is this tree's: its K4/K5 are not timed apart")
    nvcc.compile_all(jobs)  # one nvcc each, all at once
    cuda_iwe.build()
    device_loop.build()
    cuda_pano_vote.build()
    cuda_packet.build()
    _log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(j[2].name for j in jobs)})")
    rng = np.random.default_rng(0)
    kernels = check_kernels(rng)
    JVP_FLOOR_MS = kernels["bwd"]["floor_ms"]
    jvp = check_jvp(rng, JVP_FLOOR_MS)
    pano = check_pano_vote(rng, kernels["bwd"]["floor_ms"])
    packet_obj = check_packet_objective(kernels["bwd"]["floor_ms"])
    _require("packet objective", {"K6 matches the chain at every shape": packet_obj["ok"]})
    pred = check_loop_pred()
    _require("loop predicate", {"graph and host gate agree": pred["ok"],
                                "launches in flight fetch their own numbers":
                                    pred["in_flight_ok"]})
    fwd_buckets, pano_buckets = {}, {}
    launches, checks, seq_log, wall, slam, stats = run_system(shapes=fwd_buckets, audit=True,
                                                              pano_shapes=pano_buckets)
    graphs = {"system": stats}
    _log("system: K1 launches by shape bucket "
         + json.dumps(dict(sorted(fwd_buckets.items(), key=lambda kv: -kv[1]["launches"])))
         + "; K4/K5 " + json.dumps(pano_buckets))
    checks["K1 launches counted by shape"] = (
        sum(s["launches"] for s in fwd_buckets.values()) == launches["fwd"])
    # K4/K5 took the crop objective: K1 votes on a crop once per crop window
    # (its constants), where it voted at every evaluation before.
    crop_windows = slam.metrics.counters.get("backend.crop_windows", 0)
    _log(f"system: K1 launches in the crop bucket {fwd_buckets.get('crop', {}).get('launches', 0)}"
         f" for {crop_windows:.0f} crop windows")
    checks["K1 votes on a crop once per crop window"] = (
        fwd_buckets.get("crop", {}).get("launches", 0) <= crop_windows)
    checks["K6 serves every front-end objective evaluation"] = _fused_share(launches) == 1.0
    _require("system", checks)
    cg_nodes = cg_iteration_nodes(slam)
    _log("system: nodes per CG iteration (nodes, kernel nodes, gates; each inner loop's body "
         "once) " + json.dumps(cg_nodes))
    ev = make_stream(2.0)[0]
    objectives = check_captured_objectives(slam, ev)
    _require("captured objectives", {k: v for k, v in objectives.items() if k != "_"})
    split = split_objectives(slam, ev)
    _require("objective split", {
        "no torch op on event- or batch-sized tensors through K4/K5": all(
            m["event_ops"] == 0 for name in split if name.startswith(("crop_fused", "pano_fused"))
            for m in split[name].values())})
    _require("host loop", compare_host_loop(slam, ev))
    deriv_launches, checks, deriv = run_derivative_images(slam)
    _require("derivative images", checks)
    host_launches, checks, _, host_wall, host_slam, graphs["system_host"] = run_system(
        overrides=HOST_SCHEDULE, label="system_host", audit=True)
    _require("system_host", checks)
    _require("schedules", compare_schedules(slam, wall, host_slam, host_wall))
    stock_entries = (slam.frontend._entry, slam.backend._entry)
    del slam, host_slam
    # The same configuration again, after phase 4's system is released: it
    # leases phase 4's pool entries and captures nothing.
    warm_launches, checks, _, warm_wall, warm_slam, graphs["system_warm"] = run_system(
        label="system_warm", audit=True)
    checks["leases phase 4's pool entries"] = all(
        a is b for a, b in zip((warm_slam.frontend._entry, warm_slam.backend._entry),
                               stock_entries))
    checks["captures no graph"] = graphs["system_warm"]["captures"]["graphs"] == 0
    _log(f"system_warm: wall {warm_wall:.2f} s against phase 4's first {wall:.2f} s; captures "
         f"{graphs['system_warm']['captures']}; pool {json.dumps(program_pool.stats())}")
    del warm_slam
    _require("system_warm", checks)
    captures = {}  # later phases: pooled programs captured and built, entries leased again

    def phase(name, fn, *a, **kw):
        (progs0, leases0), res = _pool_snapshot(), fn(*a, **kw)
        progs, leases = _pool_snapshot()
        captures[name] = {
            "captured": sum(c and not progs0.get(i, False) for i, c in progs.items()),
            "built": len(progs.keys() - progs0.keys()),
            "entries_leased_again": sum(n > leases0[i] for i, n in leases.items() if i in leases0)}
        _log(f"{name}: pooled programs {json.dumps(captures[name])}, pool "
             f"{json.dumps(program_pool.stats())}, peak memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        _require(name, res[1])
        return res

    ring_launches = phase("ring_wrap", run_ring_wrap)[0]
    cubic = phase("cubic", run_system, overrides=CUBIC, label="cubic", audit=True)
    cubic_launches, graphs["cubic"] = cubic[0], cubic[5]
    _log("cubic: the crop objective's evaluation split")
    cubic_split = split_objectives(cubic[4], ev, only=("crop_fused", "crop_composed"))
    del cubic  # its system: the later phases lease its entries
    resume_launches = phase("resume", run_resume)[0]
    cli_launches = phase("cli", run_cli)[0]
    batched_launches, _, batched_calls = phase("batched", run_batched, seq_log=seq_log)
    shard_launches, _, shard_ms = phase("window_shard", run_window_shard)
    replay_launches = phase("replay", run_replay)[0]
    ecrot_launches = run_ecrot_phase(phase, graphs, pano, rng, kernels["bwd"]["floor_ms"])
    preset_launches = run_presets_phase(phase, graphs)
    option_launches = run_options_phase(phase, graphs, pano, rng, kernels["bwd"]["floor_ms"])
    loop_turns = walls = None
    if parent is not None:  # the loop and phase 4's wall against another commit, in turns
        loop_turns = loop_in_turns(parent, card)
        walls = walls_in_turns(parent, card, fewer_per_gate)

    _log("host data plane: " + json.dumps({
        "library": native.library_path().name, "build_s": host_build_s,
        "scans_by_path": {p: g["scan"] for p, g in graphs.items() if "scan" in g},
        "cut_packets": batched_calls["cut"], "card": card}))
    _log(f"window_shard value_and_grad ms in turns on {card}: {json.dumps(shard_ms)}")
    _log("device programs per path: " + json.dumps(graphs))
    _log("captures per later phase: " + json.dumps(captures))
    _log(f"program pool at the end: {json.dumps(program_pool.stats())}; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    src = "cmax_slam_tpu_torch/csrc/iwe.cu"
    real = deriv.pop("real_window")  # K3 on the derivative images' own operands heads its row
    replaces = {"fwd": "cmax_slam_tpu/ops/pallas_iwe.py:276 (_fwd_impl, pallas_call at :289)",
                "bwd": "cmax_slam_tpu/ops/pallas_iwe.py:307 (_vjp_bwd, pallas_call at :350; "
                       "kernel bodies _bwd_kernel_lanes :200 and _bwd_kernel :149)"}
    names = {"fwd": "vote_fwd", "bwd": "vote_bwd"}
    paths = {"system": launches, "derivative_images": deriv_launches,
             "system_host": host_launches, "system_warm": warm_launches,
             "ring_wrap": ring_launches, "cubic": cubic_launches,
             "resume": resume_launches, "cli": cli_launches, "batched": batched_launches,
             "window_shard": shard_launches, "replay": replay_launches} | ecrot_launches
    paths |= preset_launches | option_launches

    def by_path(key):
        return {p: counts[key] for p, counts in paths.items()}

    idle = [key for key in cuda_iwe.LAUNCHES if not any(by_path(key).values())]
    idle += [] if graphs["system"]["pred"] else ["loop_pred"]
    if idle:
        raise AssertionError(f"kernels or variants no path launched: {idle}")

    rows = []
    for k, v in kernels.items():
        rep = v["by_shape"][REPORTED[k]]
        row = {"name": names[k], "route": "cuda", "source": src, "replaces": replaces[k],
               "launches": launches[k], "launches_by_path": by_path(k),
               "launches_in_graphs_by_path": by_path(f"graph_{k}"),
               "max_abs_err": v["max_abs_err"], "ms": v["ms"], "device_ms": v["device_ms"],
               "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
               "library_ms": None,
               "shape": v["shape"], "by_shape": {
                   tag: {key: s[key] for key in ("device_ms", "ms", "plain_ms", "bound_ms")}
                   | {"plan": s["plan"]["variant"]}
                   for tag, s in v["by_shape"].items()}}
        if k == "fwd":
            row["launches_by_shape"] = fwd_buckets  # the system path's K1 launches
            row["launches_by_shape_ecrot"] = graphs["ecrot"]["k1_by_shape"]
            for tag, s in v["by_shape"].items():
                row["by_shape"][tag] |= {"fill_ms": s["fill_ms"], "g_alone_ms": s["g_alone_ms"]}
            row["variants"] = {
                var: {"launches": launches[f"fwd_{var}"],
                      "launches_by_path": by_path(f"fwd_{var}"),
                      "device_ms": float(np.mean(rep["variants"][var]["device_ms"])),
                      "by_shape": {tag: s["variants"][var] for tag, s in v["by_shape"].items()}}
                for var in cuda_iwe.VARIANTS}
        else:  # K2: device ms, bound and ms per mode ("paths" is the top level's)
            row["floor_ms"] = v["floor_ms"]
            row["gather_library_ms"] = rep["gather_library_ms"]
            for tag, s in v["by_shape"].items():
                row["by_shape"][tag] |= {
                    "floor_ms": s["floor_ms"], "gather_library_ms": s["gather_library_ms"],
                    "modes": {m: {key: x[key] for key in ("device_ms", "bound_ms", "ms")}
                              for m, x in s["modes"].items()}}
            row["variants"] = {
                var: {"launches": launches[f"bwd_{var}"],
                      "launches_by_path": by_path(f"bwd_{var}"),
                      "device_ms": float(np.mean(
                          rep["modes"]["paths"]["variants"][var]["device_ms"])),
                      "by_shape": {tag: {m: x["variants"][var] for m, x in s["modes"].items()}
                                   for tag, s in v["by_shape"].items()
                                   if var in s["modes"]["paths"]["variants"]}}
                for var in cuda_iwe.BWD_VARIANTS}
        rows.append(row)
    pano_src = "cmax_slam_tpu_torch/csrc/pano_vote.cu"
    pano_replaces = {
        "pano_fwd": "cmax_slam_tpu/ops/warp_pano.py:288 (make_crop_objective) and :193 "
                    "(make_pano_objective): warp_to_pano :71 fused by XLA around the Pallas "
                    "vote, cmax_slam_tpu/ops/pallas_iwe.py:276 (_fwd_impl, pallas_call at :289)",
        "pano_bwd": "the VJP of the same: cmax_slam_tpu/ops/pallas_iwe.py:307 (_vjp_bwd, "
                    "pallas_call at :350) and XLA's differentiation of warp_to_pano "
                    "(cmax_slam_tpu/ops/warp_pano.py:71) and of the spline"}
    crop_split = {m: {route: {k: split.get(f"crop_{route}", {}).get(m, {}).get(k)
                              for k in ("nodes", "kernel_nodes", "graph_ms")}
                      for route in ("fused", "composed", "fused_parent")}
                  for m in ("value", "value_and_grad")}  # in K4's row
    crop_split["cubic"] = {m: {route: {k: cubic_split.get(f"crop_{route}", {}).get(m, {}).get(k)
                                       for k in ("nodes", "kernel_nodes", "graph_ms",
                                                 "kernel_ms_sum")}
                               for route in ("fused", "composed")}
                           for m in ("value", "value_and_grad")}
    crop_split["f_rel_err_vs_composed"] = {
        name: buf["composed"]["f_rel_err"] for name, buf in objectives["_"].items()
        if name.startswith("crop_fused")}
    for k, name in (("pano_fwd", "pano_vote_fwd"), ("pano_bwd", "pano_vote_bwd")):
        v = pano[k]
        rows.append({
            "name": name, "route": "cuda", "source": pano_src, "replaces": pano_replaces[k],
            "launches": launches[k], "launches_by_path": by_path(k),
            "launches_in_graphs_by_path": by_path(f"graph_{k}"),
            "launches_by_order_by_path": {o: by_path(f"{k}_o{o}") for o in cuda_pano_vote.ORDERS},
            "launches_by_shape": {b: t for b, t in pano_buckets.items() if b.startswith(k)},
            "launches_by_shape_ecrot": {b: t for b, t in graphs["ecrot"]["pano_by_shape"].items()
                                        if b.startswith(k)},
            "launches_by_shape_ecrot_full_pano": {
                b: t for b, t in graphs["ecrot_full_pano"]["pano_by_shape"].items()
                if b.startswith(k)},
            "max_abs_err": v["max_abs_err"], "ms": v["ms"], "device_ms": v["device_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "floor_ms": v["floor_ms"], "shape": v["shape"],
            "by_shape": {tag: {key: e[key] for key in (
                "order", "M", "events", "image", "device_ms", "wrapper_ms", "plain_ms",
                "bound_ms", "max_abs_err", "pixels_past_tol", "g_max_abs_err", "per_block")}
                | {"composed_fwd_bwd_ms": e["ms"]["composed_fwd_bwd"],
                   "fused_fwd_bwd_ms": e["ms"]["fused_fwd_bwd"],
                   "designs": {d: {x: r[x] for x in ("device_ms", "alone_ms", "share", "per_block")
                                   if x in r}
                               for d, r in e["designs"].items()}}
                for tag, e in v["by_shape"].items()}}
            | ({"captured_crop_evaluation": crop_split} if k == "pano_fwd" else {}))
    rows.append({
        "name": "vote_jvp", "route": "cuda", "source": src,
        "replaces": "no Pallas kernel: JAX's forward mode through its XLA scatter vote "
                    "(cmax_slam_tpu/ops/scatter.py:193 bilinear_accumulate_scatter, reached "
                    "through :139 bilinear_accumulate_two) inside jax.jacfwd "
                    "(cmax_slam_tpu/ops/warp_pano.py:236, derivative_images)",
        "launches": deriv_launches["jvp"], "launches_by_path": by_path("jvp"),
        "max_abs_err": max(jvp["max_abs_err"], real["max_abs_err"]),
        "ms": real["ms"], "device_ms": real["device_ms"], "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"], "bound_by": real["bound_by"], "library_ms": None,
        "floor_ms": jvp["floor_ms"], "design": real["design"],
        "shape": f"real: a phase-4 window's derivative images, {deriv['knots'] * 3}x"
                 f"{deriv['events']}@{deriv['shape'][2]}x{deriv['shape'][3]}",
        "by_shape": jvp["by_shape"] | {"real": real}, "derivative_images": deriv})
    rows.append({
        "name": "packet_objective", "route": "cuda", "source": "cmax_slam_tpu_torch/csrc/packet.cu",
        "replaces": "the chain of ops/warp_local.make_local_objective (warp_events, K1, the "
                    "blur's band matmuls, the measure, autograd with K2); no Pallas kernel: "
                    "cmax_slam_tpu/ops/warp_local.py's objective, which XLA fuses around "
                    "cmax_slam_tpu/ops/pallas_iwe.py:289 and :350",
        "launches": launches["packet"], "launches_by_path": by_path("packet"),
        "launches_in_graphs_by_path": by_path("graph_packet"),
        "forms_by_path": {form: by_path(f"packet_{form}") for form in ("vg", "f")},
        "chain_evaluations_by_path": by_path("packet_chain"),
        "fused_share_by_path": {p: _fused_share(c) for p, c in paths.items()},
        "max_f_rel_err": packet_obj["f_rel_err"],
        "max_g_err_over_scale": packet_obj["g_err_over_scale"],
        "tolerances": {"f_rtol": PACKET_F_RTOL, "g_rtol_of_scale": PACKET_G_RTOL},
        "ms": packet_obj["by_shape"]["packet"]["wrapper_ms"],
        "device_ms": packet_obj["by_shape"]["packet"]["vg"]["device_us"] / 1e3,
        "bound_ms": packet_obj["by_shape"]["packet"]["bound_us"] / 1e3, "bound_by": "bytes",
        "library_ms": None, "by_shape": packet_obj["by_shape"]})
    rows.append({
        "name": "loop_pred", "route": "cuda", "source": "cmax_slam_tpu_torch/csrc/loop.cu",
        "replaces": "cmax_slam_tpu/ops/optim.py:573 (lax.while_loop's cond; the lax.cond of "
                    "cmax_slam_tpu/frontend.py:288; no Pallas kernel)",
        "launches": graphs["system"]["pred"],
        "launches_by_path": {p: g["pred"] for p, g in graphs.items()},
        "max_abs_err": pred["max_abs_err"], "ms": pred["ms"], "plain_ms": pred["plain_ms"],
        "kernel_device_us_by_lanes": pred["kernel_device_us_by_lanes"],
        "bound_ms": pred["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "executions_checked": pred["executions"], "gate_cases": pred["cases"],
        "bodies": pred["bodies"], "bodies_in_turns": loop_turns,
        "nodes_per_cg_iteration": cg_nodes,
        "nodes_per_cg_iteration_in_turns": None if walls is None else walls["nodes"],
        "graph_runs_by_path": {p: g["runs"] for p, g in graphs.items()}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
