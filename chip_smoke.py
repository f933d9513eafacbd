#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (cmax_slam_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: prints ``nvidia-smi --query-gpu=name,power.limit`` as it reports them;
2. build: compiles the vote kernels from csrc/iwe.cu with nvcc, prints the seconds;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (front-end rung sweep, back-end window on a crop,
   old/new split on the full panorama, the batched tracker's lanes) and at
   the kernel-alone headroom shape (2^20 events on 240x180), with dropped
   events, padding and integer coordinates, and operands shared across
   images read in place; both K1 variants (P, G; cuda_iwe.plan_vote_fwd)
   forced at every shape, so P meets band edges on the 384x384 crop, K2's G
   forced at every shape and its S (cuda_iwe.plan_vote_bwd) at every shape
   whose image it stages whole (not the 384x384 crop or the 512x1024
   panorama), and the planners' picks through autograd. K2 runs in two
   modes: "full" (dw too, the TPU kernel's whole function) and "paths" (no
   dw, as every path calls it, weights read in place); a small unaligned
   shape with a ragged row end checks the scalar loads, and a launch of
   more than 2^31 events G's 64-bit indexing. Prints per shape the
   planners' variants, each
   variant's device time in turns (G, P, P, G; G, S, S, G per K2 mode)
   beside the bound in bytes and us, the launch floor (an empty kernel's
   device time), then the wrapper and plain times and, for K2, the
   bilinear gather of F.grid_sample as a yardstick;
4. system: CMaxSLAM on the stock ijrr preset, driven through push_events on a
   2.0 s synthetic 240x180 stream at 390k ev/s (make_stream), must keep its
   state on the card, gather its packets from the device event ring (the
   stock front-end schedule), each torch.equal to the packet gathered from
   the host store, run at least 15 BA windows through both kernels and
   track the ground truth to < 0.3 deg RMS; then the same stream on the
   per-packet schedule from the host store (frontend.device_store=False,
   batch_sweeps=0), with the same checks, the same packet grid and a median
   omega difference under 0.01 rad/s (the schedules give bit-equal solver
   inputs: what differs is K1's atomic sum order); the largest difference
   must stay under 0.1 rad/s, or the packet that carries it, solved again
   alone from both schedules' warm starts, must reach both logged values;
   both walls are printed. Then a ring of 2^15 events on 0.6 s of the
   stream, cut, saved and resumed: appends and packets wrap, the resync
   wraps, lapped packets are gathered from the host store, and every ring
   packet equals its host packet. Then the cubic system: the stock preset
   with backend.trajectory.spline_degree=3 on the same stream, with phase
   4's checks; and the resume pair: 1.0 s of the stream run whole, and cut
   after two windows, saved, loaded into a fresh CMaxSLAM (its ring rebuilt
   from the restored store) and fed the rest: the same window count and
   refined-pose times, the resumed trajectory within 0.05 deg RMS of the
   uninterrupted one. RMS readings are printed also with the quaternions
   left unnormalized, the JAX package's yardstick;
5. cli: the same stream written to an IJRR 't x y p' text file and run
   through ``cmax_slam_tpu_torch.cli.main`` on the stock ijrr preset with a
   refine pass, IWE-pair and map dumps: all outputs written, every event
   read back, >= 15 windows, both kernels launched (K1 also inside the IWE
   renders), the TUM trajectory < 0.3 deg RMS; then a run cut at 1.0 s and
   one resuming its final_state.npz must continue the packet grid;
6. batched: ``cut_packets`` and ``track_batched_compacted(sweeps=2)`` on the
   same stream at full width (240x180, 10 000-event packets, the stock ijrr
   front-end): median |omega - omega_true| < 0.2 rad/s, every lane's
   iterations in (0, max_line_searches], both kernels launched, and one K1
   launch of at least 224 lanes' images; prints packets per second, the
   rounds and the median difference against phase 4's sequential log;
7. multi-device on one card, with the device list ["cuda:0", "cuda:0"]: the
   event-sharded window objective against the single-device one on a
   back-end window of the stream, at the ijrr 512x1024 panorama and at
   2048x4096 (the blur's shift-and-add path), value within rtol 2e-5 and
   gradient within rtol 2e-3, atol 2e-6; then the 2-segment replay
   (overlap 0.4 s) on the stock preset, stitched RMS < 0.5 deg.

Before the last line it prints one JSON object with every kernel's route,
source, launches on each path (the two system runs of phase 4, the small
ring, the cubic system, the resume pair, the CLI run of phase 5, the batched run of phase
6 and the window and replay runs of phase 7, each counted from 0), error,
times and bound, and the same per
variant; the last line is ``{"ok": true, "device": {...}}``. Imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

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
)
# The shape whose times go into the JSON line, per kernel: its widest
# launch on the paths, the batched tracker's.
REPORTED = {"fwd": "lanes", "bwd": "lanegrad"}
# The least time of a kernel: its bytes (each input read once, each output
# written once) over the H100 SXM's 3.35 TB/s, or its float32 operations
# over 67 TFLOP/s (non-tensor), whichever is larger. Operations per event:
# K1 2 floors, 4 differences, 8 products and 4 adds; K2 2 floors, 4
# differences and 21 products, sums and differences over its four gathers.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLOPS_PER_EVENT = {"fwd": 18, "bwd": 27}
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
    turns = cuda_iwe.VARIANTS + cuda_iwe.VARIANTS[::-1]
    for tag, b, n, H, W, kernels, rows in SHAPES:
        px, py, wt = _events(rng, n, H, W, rows, "cuda")
        r0 = min(rows)
        grouped = [_lead(t, r0) for t in (px, py, wt)]
        ref = scatter.bilinear_accumulate(*grouped, H, W).reshape(b, H, W)
        torch.cuda.synchronize()
        # Atomic adds land in run-dependent order: float32 sums agree to a
        # few ulps of the largest pixel.
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        plans = {v: cuda_iwe.plan_vote_fwd(b, n, H, W, *attrs, variant=v)
                 for v in (None,) + cuda_iwe.VARIANTS}
        errs = {}
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
        del img, ref
        img = torch.empty((b, H, W), device="cuda")
        dev_t = {v: [] for v in cuda_iwe.VARIANTS}
        evs = {v: [] for v in cuda_iwe.VARIANTS}
        for v in turns:
            plan = plans[v]

            def launch(plan=plan):
                if plan.variant != "P":
                    img.zero_()
                cuda_iwe.launch_fwd(plan, px, py, wt, img, b, H, W)

            kern, ev = device_ms(launch)
            dev_t[v].append(kern)
            evs[v].append(ev)
        del img
        ms = _time_ms(lambda: cuda_iwe.vote_fwd(px, py, wt, H, W, b))
        plain_ms = _time_ms(lambda: scatter.bilinear_accumulate(*grouped, H, W))
        planned = plans[None]
        bd = bound("fwd", b, n, H, W, rows)
        dev_ms = float(np.mean(dev_t[planned.variant]))
        entry = {"plan": planned._asdict(), **bd, "device_ms": dev_ms, "ms": ms,
                 "plain_ms": plain_ms, "variants": {
                     v: {"max_abs_err": errs[v], "device_ms": dev_t[v], "events_ms": evs[v]}
                     for v in cuda_iwe.VARIANTS}}
        _log(f"vote_fwd {tag:8s} B={b} N={n} {H}x{W} rows {rows}: planner "
             f"{planned.variant} ({planned.rows} rows x {planned.bands} bands, "
             f"{planned.smem_bytes} B); max_abs_err {errs['planned']:.3e} planned, "
             + ", ".join(f"{v} {errs[v]:.3e} ({plans[v].bands} bands)"
                         for v in cuda_iwe.VARIANTS)
             + f" (tol {tol:.3e}); device ms in turns "
             + ", ".join(f"{v} {a:.4f}/{c:.4f} (events {evs[v][0]:.4f}/{evs[v][1]:.4f})"
                         for v, (a, c) in dev_t.items())
             + f"; bound {bd['bytes'] / 1e6:.3f} MB, {bd['bound_ms'] * 1e3:.2f} us "
             f"({bd['bound_by']}), planned at {bd['bound_ms'] / dev_ms:.1%} of it; "
             f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms")
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


@functools.lru_cache(maxsize=2)
def make_stream(duration: float = 2.0):
    """The examples/tpu_realtime_check.py stream (240x180, fx = fy = 180,
    omega = [0.9, -1.3, 1.9], 1200 landmarks, 390k ev/s, seed 11) with the
    landmarks spread over the whole sphere instead of a 120-degree cone:
    in 2 s the camera turns 286 degrees, and with the cone its view leaves
    the landmarks around t = 1.3 s (windows fall to 20k events), where the
    JAX system on the CPU ends 3.3 deg RMS off the truth on this 2 s cut.
    On the sphere every view keeps texture. Returns (events, omega, calib);
    cached, so every phase reads the same arrays (read-only)."""
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
    """Hold every packet the front-end ``fe`` gathers from its device ring
    against the packet gathered from the host store for the same span
    (torch.equal, dtypes too), and count both gathers. Returns the live
    tally: ring, host, unequal, and s, the seconds the checks took (kept
    out of the walls)."""
    import torch

    tally = {"ring": 0, "host": 0, "unequal": 0, "s": 0.0}
    ring_gather, host_gather = fe._ring_packet, fe._packet

    def ring_packet(beg, n, t_ref):
        packet = ring_gather(beg, n, t_ref)
        t0 = time.perf_counter()
        xs, ys, ts, _ = fe.store.slice_abs(beg, beg + n)
        host = host_gather(xs, ys, ts, t_ref)
        tally["ring"] += 1
        tally["unequal"] += not all(a.dtype == b.dtype and torch.equal(a, b)
                                    for a, b in zip(packet, host))
        tally["s"] += time.perf_counter() - t0
        return packet

    def packet(xs, ys, ts, t_ref):
        tally["host"] += 1
        return host_gather(xs, ys, ts, t_ref)

    fe._ring_packet, fe._packet = ring_packet, packet
    return tally


def _push(slam, ev, lo: int, hi: int, chunk: int = 39_000) -> None:
    for i in range(lo, hi, chunk):
        j = min(i + chunk, hi)
        slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])


# Phase 4 runs the stock front-end schedule (the device ring) and then the
# per-packet chain gathered from the host store; the cubic phase sets the
# reference's spline_degree=3 launch knob.
HOST_SCHEDULE = {"frontend.device_store": False, "frontend.batch_sweeps": 0}
CUBIC_KEY = "backend.trajectory.spline_degree"
CUBIC = {CUBIC_KEY: 3}


def run_system(device: str = "cuda", overrides=None, label: str = "system",
               duration: float = 2.0):
    """Phase 4 (and the cubic phase): the stock preset, with ``overrides``
    (dotted config keys), through the public entry points. Returns
    (launches during the run, {check: passed}, the (T, 4) ang_vel_log, the
    wall in s without the ring-packet checks, the CMaxSLAM)."""
    import torch
    from cmax_slam_tpu_torch.config import ijrr_config, replace
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.system import CMaxSLAM

    overrides = dict(overrides or {})
    t0 = time.perf_counter()
    ev, omega, calib = make_stream(duration)
    n = len(ev.ts)
    _log(f"{label}: {n} events over {duration} s ({time.perf_counter() - t0:.1f} s to "
         f"generate), overrides {overrides}")
    cfg = replace(ijrr_config(), **overrides)
    slam = CMaxSLAM(calib, cfg, device=device)
    tally = _spy_packets(slam.frontend)

    _reset_launches()
    t0 = time.perf_counter()
    _push(slam, ev, 0, n)
    slam.flush()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - tally["s"]
    launches = dict(cuda_iwe.LAUNCHES)

    be = slam.backend
    wins = slam.window_results()
    n_ba = sum(w.ran_ba for w in wins)
    log = slam.ang_vel_log
    rms, rms_raw = _rms_vs_truth(be.traj, omega)
    counters = slam.metrics.counters
    timers = {k: round(v.total, 3) for k, v in slam.metrics.timers.items()}
    _log(f"{label}: wall {wall:.2f} s for {duration} s of stream (and {tally['s']:.2f} s "
         f"of ring-packet checks), realtime factor {duration / wall:.3f}; packets "
         f"{len(log)}, windows {len(wins)} ({n_ba} with BA); spline order {be.traj.order}; "
         f"trajectory RMS {rms:.4f} deg ({rms_raw:.4f} unnormalized); packets gathered "
         f"from the ring {tally['ring']} (unequal to the host packet {tally['unequal']}), "
         f"from the host store {tally['host']}; timers_s "
         f"{json.dumps(timers)}; counters {json.dumps(dict(counters))}; launches {launches}; "
         f"crop shapes {sorted(be._crop_shapes)}")
    checks = {
        "state on the device": all(t.device.type == device for t in (
            be.IG, be.update_times, be.lut_dev, slam.frontend.lut)),
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
        ">= 15 BA windows": n_ba >= 15,
        "finite omega log": log.shape[1] == 4 and bool(np.isfinite(log).all()),
        "RMS < 0.3 deg": rms < 0.3,
        "spline order": be.traj.order == (4 if overrides.get(CUBIC_KEY) == 3 else 2),
    }
    if cfg.frontend.device_store:  # the stock schedule gathers from the ring
        checks["packets gathered from the ring"] = (
            tally["ring"] == counters["frontend.ring_packets"] > 0)
        checks["ring packets torch.equal host packets"] = tally["unequal"] == 0
    else:
        checks["no ring packets"] = tally["ring"] == 0 and "frontend.ring_packets" not in counters
    return launches, checks, log, wall, slam


def run_ring_wrap(device: str = "cuda", duration: float = 0.6, capacity: int = 1 << 15):
    """The stock preset with a device ring of ``capacity`` events on
    ``duration`` s of phase 4's stream, cut halfway at a push, saved and
    resumed in a fresh CMaxSLAM: 39 000-event pushes split into appends
    that wrap, packets that wrap, a resync of more events than the ring
    holds, and packets the ring has lapped gathered from the host store.
    Every ring packet must be torch.equal to its host packet. Returns
    (launches, {check: passed})."""
    from cmax_slam_tpu_torch.config import ijrr_config, replace
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.system import CMaxSLAM

    ev, omega, calib = make_stream(duration)
    n, chunk = len(ev.ts), 39_000
    cfg = replace(ijrr_config(), **{"frontend.device_store_capacity": capacity})
    _reset_launches()
    t0 = time.perf_counter()
    first = CMaxSLAM(calib, cfg, device=device)
    tallies = [_spy_packets(first.frontend)]
    cut = (n // 2) // chunk * chunk
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
    wall = time.perf_counter() - t0
    launches = dict(cuda_iwe.LAUNCHES)
    tally = {k: sum(t[k] for t in tallies) for k in tallies[0]}
    log = np.concatenate([first.ang_vel_log, resumed.ang_vel_log])
    err = np.linalg.norm(log[:, 1:] - omega, axis=1)
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
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_iwe.LAUNCHES)

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
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
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


def _cam(calib):
    from cmax_slam_tpu_torch.ops.warp_local import CameraParams

    K = calib.K
    return CameraParams(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                        cy=float(K[1, 2]), width=calib.width, height=calib.height)


def run_batched(device: str = "cuda", seq_log=None, duration: float = 2.0):
    """Phase 6: throughput-mode tracking of the whole stream at full width.
    Returns (launches during the tracking, {check: passed})."""
    import torch
    from cmax_slam_tpu_torch.calib import bearing_lut
    from cmax_slam_tpu_torch.config import ijrr_config
    from cmax_slam_tpu_torch.ops import cuda_iwe
    from cmax_slam_tpu_torch.parallel import batched

    ev, omega, calib = make_stream(duration)
    cfg = ijrr_config().frontend
    cam = _cam(calib)
    t0 = time.perf_counter()
    pb = batched.cut_packets(ev.xs, ev.ys, ev.ts, bearing_lut(calib), cam, cfg, device=device)
    t_cut = time.perf_counter() - t0

    # Widest K1 launch and the number of compaction rounds, read through
    # wrappers of the kernel wrapper and of the round (counts are untouched).
    widest, rounds = [0], [0]
    vote_fwd, run_round = cuda_iwe.vote_fwd, batched._run_round

    def widest_vote(px, py, w, height, width, b=None, **kw):
        widest[0] = max(widest[0], px.shape[0] if b is None else b)
        return vote_fwd(px, py, w, height, width, b, **kw)

    def counted_round(*a, **kw):
        rounds[0] += 1
        return run_round(*a, **kw)

    cuda_iwe.vote_fwd, batched._run_round = widest_vote, counted_round
    try:
        _reset_launches()
        t0 = time.perf_counter()
        times, om, _, iters = batched.track_batched_compacted(pb, cam, cfg, sweeps=2)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_iwe.LAUNCHES)
    finally:
        cuda_iwe.vote_fwd, batched._run_round = vote_fwd, run_round
    n = len(times)
    err = np.linalg.norm(om - omega, axis=1)
    vs_seq = "n/a"
    if seq_log is not None and len(seq_log):
        m = min(len(seq_log), n)
        if np.allclose(seq_log[:m, 0], times[:m], atol=1e-9):
            vs_seq = f"{np.median(np.linalg.norm(om[:m] - seq_log[:m, 1:], axis=1)):.4f} rad/s"
    max_ls = cfg.optim.max_line_searches
    _log(f"batched: {n} packets x {pb.bearings.shape[1]} events cut in {t_cut:.2f} s; "
         f"tracked in {wall:.2f} s ({n / wall:.1f} packets/s, {n * pb.bearings.shape[1] / wall:.0f}"
         f" events/s), {rounds[0]} rounds over 2 sweeps; median |omega - omega_true| "
         f"{np.median(err):.4f} rad/s (max {err.max():.4f}); median vs sequential log "
         f"{vs_seq}; iters min {iters.min()} mean {iters.mean():.1f} max {iters.max()}; "
         f"launches {launches}, widest K1 launch B={widest[0]}")
    checks = {
        "median omega error < 0.2 rad/s": float(np.median(err)) < 0.2,
        "iters in (0, max_line_searches]": bool(np.all((iters > 0) & (iters <= max_ls))),
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
        "a K1 launch of >= 224 lanes' images": widest[0] >= 224,
    }
    return launches, checks


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
    single-device one. Returns (launches, {check: passed})."""
    import torch
    from cmax_slam_tpu_torch.calib import EquirectCamera
    from cmax_slam_tpu_torch.ops import cuda_iwe, warp_pano
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

    checks, launches = {}, dict.fromkeys(cuda_iwe.LAUNCHES, 0)
    for hw in panos:
        win = make_window(ev, omega, calib, hw, device)
        pano = EquirectCamera(width=hw[1], height=hw[0])
        K = win.knots.shape[0]
        x = torch.as_tensor(0.01 * np.random.default_rng(1).normal(size=3 * K),
                            dtype=torch.float32, device=device)
        _, vg_ref = warp_pano.make_pano_objective(win, pano, 2, 1.0, 0)
        _reset_launches()
        shards = shard_window_events(win, list(devices))
        _, vg_sh = make_sharded_pano_objective(list(devices), shards, pano, 2, 1.0, 0)
        (v_sh, g_sh), ms_sh = timed(vg_sh, x)
        for k, v in cuda_iwe.LAUNCHES.items():
            launches[k] += v
        (v_ref, g_ref), ms_ref = timed(vg_ref, x)
        v_sh, v_ref, g_sh, g_ref = (float(v_sh), float(v_ref), g_sh.cpu().numpy(),
                                    g_ref.cpu().numpy())
        tag = f"{hw[0]}x{hw[1]}"
        _log(f"window_shard {tag}: {win.weights.shape[0]} events in "
             f"{win.batch_times.shape[0]} batches over {len(devices)} devices; value "
             f"{v_sh:.9g} vs single-device {v_ref:.9g} (rel {abs(v_sh - v_ref) / abs(v_ref):.2e});"
             f" grad max abs diff {np.abs(g_sh - g_ref).max():.3e} (max |g| "
             f"{np.abs(g_ref).max():.3e}); value_and_grad {ms_sh:.2f} ms sharded, "
             f"{ms_ref:.2f} ms single-device")
        checks[f"{tag} value rtol 2e-5"] = bool(np.isfinite(v_sh)) and np.isclose(
            v_sh, v_ref, rtol=2e-5, atol=0)
        checks[f"{tag} gradient rtol 2e-3 atol 2e-6"] = bool(
            np.allclose(g_sh, g_ref, rtol=2e-3, atol=2e-6))
    checks["both kernels launched"] = launches["fwd"] > 0 and launches["bwd"] > 0
    return launches, checks


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
    launches = dict(cuda_iwe.LAUNCHES)
    q_gt = np.stack([spline._np_quat_exp(omega * t) for t in times])
    rms, errs = rotation_rms_deg(times, q_gt, quats, "global")
    wins = [len(s.slam.window_results()) for s in segs]
    _log(f"replay: 2 segments on {list(devices)}, wall {wall:.2f} s for {duration} s of "
         f"stream; windows per segment {wins}; stitched RMS {rms:.4f} deg (max "
         f"{errs.max():.3f}) over {len(times)} samples; launches {launches}")
    checks = {
        "stitched RMS < 0.5 deg": rms < 0.5,
        "every segment ran its back-end": all(w >= 2 for w in wins),
        "both kernels launched": launches["fwd"] > 0 and launches["bwd"] > 0,
    }
    return launches, checks


def _require(phase: str, checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


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
    launches, checks, seq_log, wall, slam = run_system()
    _require("system", checks)
    host_launches, checks, _, host_wall, host_slam = run_system(overrides=HOST_SCHEDULE,
                                                                label="system_host")
    _require("system_host", checks)
    _require("schedules", compare_schedules(slam, wall, host_slam, host_wall))
    del slam, host_slam
    ring_launches, checks = run_ring_wrap()
    _require("ring_wrap", checks)
    cubic_launches, checks, _, _, _ = run_system(overrides=CUBIC, label="cubic")
    _require("cubic", checks)
    resume_launches, checks = run_resume()
    _require("resume", checks)
    cli_launches, checks = run_cli()
    _require("cli", checks)
    batched_launches, checks = run_batched(seq_log=seq_log)
    _require("batched", checks)
    shard_launches, checks = run_window_shard()
    _require("window_shard", checks)
    replay_launches, checks = run_replay()
    _require("replay", checks)

    src = "cmax_slam_tpu_torch/csrc/iwe.cu"
    replaces = {"fwd": "cmax_slam_tpu/ops/pallas_iwe.py:276 (_fwd_impl, pallas_call at :289)",
                "bwd": "cmax_slam_tpu/ops/pallas_iwe.py:307 (_vjp_bwd, pallas_call at :350; "
                       "kernel bodies _bwd_kernel_lanes :200 and _bwd_kernel :149)"}
    names = {"fwd": "vote_fwd", "bwd": "vote_bwd"}
    paths = {"system": launches, "system_host": host_launches, "ring_wrap": ring_launches,
             "cubic": cubic_launches,
             "resume": resume_launches, "cli": cli_launches, "batched": batched_launches,
             "window_shard": shard_launches, "replay": replay_launches}

    def by_path(key):
        return {p: counts[key] for p, counts in paths.items()}

    idle = [key for key in cuda_iwe.LAUNCHES if not any(by_path(key).values())]
    if idle:
        raise AssertionError(f"kernels or variants no path launched: {idle}")

    rows = []
    for k, v in kernels.items():
        rep = v["by_shape"][REPORTED[k]]
        row = {"name": names[k], "route": "cuda", "source": src, "replaces": replaces[k],
               "launches": launches[k], "launches_by_path": by_path(k),
               "max_abs_err": v["max_abs_err"], "ms": v["ms"], "device_ms": v["device_ms"],
               "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
               "library_ms": None,
               "shape": v["shape"], "by_shape": {
                   tag: {key: s[key] for key in ("device_ms", "ms", "plain_ms", "bound_ms")}
                   | {"plan": s["plan"]["variant"]}
                   for tag, s in v["by_shape"].items()}}
        if k == "fwd":
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
