"""Batched (throughput-mode) front-end tracking: solve many packets at once;
counterpart of cmax_slam_tpu/parallel/batched.py.

The reference's live mode sheds load by decimating events
(launch/live_davis.launch: keep 10 percent). The alternative here is to
batch: cut the whole stream into packets up front, stack them into one
(P, S) tensor, and run every packet's CMax solve at once as lanes of the
lane-batched CG (ops/optim.py), optionally split over a device list.

Warm starting, which the sequential front-end gets for free, is recovered
with Jacobi-style sweeps: sweep 1 solves all packets from zero, sweep 2
re-solves each packet from its left neighbour's sweep-1 solution. Two
parallel sweeps recover nearly all of the sequential accuracy while keeping
every solve independent.

On the card, each step of a sweep evaluates every active lane's objective
with one vote launch: a vector-ladder bracket over a bucket of 224 packets
votes 224 x 9 = 2016 images in one K1 launch. Lanes run in lockstep inside
a step, so ``track_batched_compacted`` drops converged lanes between rounds.
Each round is one launch of a pooled device program (sharding.LaneSolver,
the JAX package's jitted ``_run_round``) and one host read, the lanes'
status and line-search counts that decide the next compaction.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrontendConfig
from ..io import native
from ..ops import optim, program_pool, warp_local
from ..utils.device import resolve_device, resolve_devices, to_device
from ..utils.metrics import TRACE, logger
from .sharding import (batched_packet_solve, cg_body, lane_objective, lane_solver,
                       make_dp_cmax_step, map_shards)


class PacketBatch(NamedTuple):
    bearings: torch.Tensor  # (P, S, 3)
    dts: torch.Tensor       # (P, S)
    weights: torch.Tensor   # (P, S)
    times: np.ndarray       # (P,) packet grid timestamps (host)


def cut_packets(
    xs: np.ndarray,
    ys: np.ndarray,
    ts: np.ndarray,
    lut: np.ndarray,
    cam: warp_local.CameraParams,
    cfg: FrontendConfig,
    *,
    device,
) -> PacketBatch:
    """Cut a whole stream into fixed-size packets with the reference's
    centered-window semantics (ang_vel_estimator.cpp:74-97); the packet
    tensors are put on ``device``. Traced (utils.metrics.TRACE), a
    ``batched.cut`` span holding the trigger scan, the packets' gather and
    the upload (a device span, and a wait: the copy is from pageable
    memory)."""
    with TRACE.span("batched.cut"):
        return _cut_packets(xs, ys, ts, lut, cam, cfg, resolve_device(device))


def _cut_packets(xs, ys, ts, lut, cam, cfg, device) -> PacketBatch:
    half = cfg.num_events_per_packet // 2
    bs = cfg.warp.event_batch_size
    S = ((2 * half + bs - 1) // bs) * bs

    # once here, not per packet: the library reads arrays of its dtypes in place
    xs, ys = np.ascontiguousarray(xs, np.int32), np.ascontiguousarray(ys, np.int32)
    ts, lut = np.ascontiguousarray(ts, np.float64), np.ascontiguousarray(lut, np.float32)
    t0 = float(ts[0])
    with TRACE.span("batched.cut_scan"):
        trig, _, _ = native.scan_triggers(ts, t0 + 0.5 * cfg.dt_ang_vel, 0, cfg.dt_ang_vel,
                                          max_out=1 << 22)
    trig = trig[(trig + 1 + half) <= len(ts)]  # keep only complete packets
    Pn = len(trig)
    bearings = np.zeros((Pn, S, 3), np.float32)
    dts = np.zeros((Pn, S), np.float32)
    weights = np.zeros((Pn, S), np.float32)
    times = np.zeros(Pn, np.float64)

    with TRACE.span("batched.cut_gather"):
        for k, idx in enumerate(trig):
            count = int(idx) + 1
            beg = max(count - half, 0)
            end = count + half
            # rigid output grid: t0 + dt/2 + k*dt (ang_vel_estimator.cpp:84-97)
            t_packet = t0 + 0.5 * cfg.dt_ang_vel + k * cfg.dt_ang_vel
            b, _, w = native.gather_packet(xs, ys, ts, beg, end, S, lut, cam.width, t_packet)
            bearings[k] = b
            weights[k] = w
            # batch-midpoint dts, relative to the packet grid time
            n = end - beg
            valid = np.zeros(S, bool)
            valid[:n] = True
            tsb = np.zeros(S)
            tsb[:n] = ts[beg:end] - t_packet
            t2 = tsb.reshape(S // bs, bs)
            v2 = valid.reshape(S // bs, bs)
            tf = np.where(v2.any(1), np.where(v2, t2, np.inf).min(1), 0.0)
            tl = np.where(v2.any(1), np.where(v2, t2, -np.inf).max(1), 0.0)
            dts[k] = np.repeat(tf + 0.5 * (tl - tf), bs).astype(np.float32)
            times[k] = t_packet

    def put(a):
        return torch.as_tensor(a, device=device)

    with TRACE.span("batched.cut_upload", device=True, wait=True):
        return PacketBatch(bearings=put(bearings), dts=put(dts), weights=put(weights),
                           times=times)


def _init_states(bearings, dts, weights, omega0s, cam, blur_sigma, measure, opt):
    with torch.no_grad():
        f = lane_objective(bearings, dts, weights, cam, blur_sigma, measure)
        return optim.cg_init(warp_local.value_and_grad(f), omega0s, opt.initial_step)


def _run_round(bearings, dts, weights, states, cam, blur_sigma, measure, opt, round_iters):
    """One round on the host-gated lane CG (optim.cg_run_rounds): the eager
    reference of the round programs."""
    with torch.no_grad():
        f = lane_objective(bearings, dts, weights, cam, blur_sigma, measure)
        return optim.cg_run_rounds(cg_body(f, opt), states, round_iters,
                                   opt.max_line_searches)


def _quantize_bucket(n: int, min_bucket: int) -> int:
    """Round lane count up to {1, 1.25, 1.5, 1.75} x 2^k (few distinct shapes:
    <= 4 sizes per octave, <= 25% padding vs 100% for pure pow2)."""
    n = max(n, min_bucket)
    if n <= 8:
        return 8
    k = (n - 1).bit_length() - 1  # n in (2^k, 2^(k+1)]
    base = 1 << k
    quarter = base // 4
    return base + ((n - base + quarter - 1) // quarter) * quarter


def track_batched_compacted(
    batch: PacketBatch,
    cam: warp_local.CameraParams,
    cfg: FrontendConfig,
    sweeps: int = 2,
    round_schedule: tuple = (4, 4, 8, 8, 16),
    min_bucket: int = 8,
    cold_decimate: int = 4,
    devices=None,
):
    """Batched tracking without the lockstep-straggler tax.

    Each CMax solve advances in rounds of ``round_iters`` line searches
    (one launch of a LaneSolver program whose round count is read from a
    device buffer, so one program serves every round of a bucket); between
    rounds the host reads every lane's status and iteration count (the
    program's ``out``, one wait per round), drops converged lanes and
    re-packs the survivors into a quantized bucket: their packets and CG
    state are copied into the program's buffers with ``index_select`` on
    the device. Total work is ~the sum of per-lane iteration counts instead
    of lanes x max-lane.

    Jacobi warm-start sweeps as in track_batched. The cold sweep only seeds
    the warm one, so it votes every ``cold_decimate``-th event of each packet
    (the reference sheds load the same way with event_sample_rate,
    src/cmax_slam.cpp:155-156). Every sweep runs in float32: unlike the JAX
    package there is no lower-precision matmul mode for the cold sweep.

    With ``devices``, the host compacts survivors globally every round and
    splits the bucket evenly over the list (the bucket is rounded up to a
    multiple of the device count); each device solves its share locally
    with a program of its own and the states are gathered on ``devices[0]``.

    Returns (times, omegas, costs, iters) as numpy, like track_batched.

    Traced (utils.metrics.TRACE), a ``batched.track`` span holding each
    sweep (``batched.sweep``: its data, ``init``, and each round's load,
    launch, wait and compaction) and the answers' copy to the host.
    """
    with TRACE.span("batched.track"):
        return _track_batched_compacted(batch, cam, cfg, sweeps, round_schedule, min_bucket,
                                        cold_decimate, devices)


def _track_batched_compacted(batch, cam, cfg, sweeps, round_schedule, min_bucket,
                             cold_decimate, devices):
    opt = cfg.optim
    blur_sigma = cfg.warp.blur_sigma
    measure = cfg.contrast_measure
    Pn = batch.bearings.shape[0]
    max_ls = opt.max_line_searches
    if devices is not None:
        devices = resolve_devices(devices)
        min_bucket = max(min_bucket, 4 * len(devices))  # the smallest bucket must split
        home = devices[0]
    else:
        home = batch.bearings.device
    devs = devices if devices is not None else [home]
    owners = [program_pool.Owner() for _ in devs]  # each shard leases programs of its own

    def init(dev, part):
        """The CG state of the lanes ``part`` from omega0 (eager: one
        value-and-grad of every lane)."""
        sel = to_device(part, dev)
        b, d, w = (t.index_select(0, sel) for t in data[dev])
        return _init_states(b, d, w, omega0.index_select(0, to_device(part, home)).to(dev),
                            cam, blur_sigma, measure, opt)

    def round_shard(i, part, round_iters):
        """One round of the lanes ``part`` on device i: (their new CG state,
        their status and line searches on the host)."""
        dev = devs[i]
        lanes = idx[part]
        prog = lane_solver(owners[i], cam, blur_sigma, measure, opt, dev, len(lanes),
                           data[dev][1].shape[1], rounds=True)
        with torch.no_grad():
            with TRACE.span("batched.round_load"):
                sel, sel_home = to_device(lanes, dev), to_device(lanes, home)
                prog.load(data[dev], sel)
                for buf, t in zip(prog.cg.s, st):
                    buf.copy_(t.index_select(0, sel_home))
                prog.round_iters.fill_(round_iters)
            with TRACE.span("batched.launch"):
                result = prog.program.run()
            vals = result.fetch()
        return optim.CGState(*(t.to(home) for t in prog.cg.s)), vals

    def gather(outs):
        return optim.CGState(*(torch.cat([o[k] for o in outs])
                               for k in range(len(optim.CGState._fields))))

    st = None
    for sweep in range(max(sweeps, 1)):
        with TRACE.span("batched.sweep"):
            final = sweep == max(sweeps, 1) - 1
            with TRACE.span("batched.data", device=True):
                if sweep > 0:
                    omega0 = torch.cat([st.x[:1], st.x[:-1]])  # left neighbour's solution
                    k = 1
                else:
                    omega0 = torch.zeros((Pn, 3), dtype=torch.float32, device=home)
                    k = 1 if final else max(cold_decimate, 1)
                sweep_data = [t[:, ::k] for t in (batch.bearings, batch.dts, batch.weights)]
                data = {dev: [t.to(dev).contiguous() for t in sweep_data] for dev in set(devs)}
            parts = np.array_split(np.arange(Pn), len(devs))
            with TRACE.span("batched.init"):
                st = gather(map_shards(devs, init, parts))
            # cg_init leaves every lane RUNNING at 0 line searches: nothing to read.
            status = np.full(Pn, optim.RUNNING, np.int64)
            it = np.zeros(Pn, np.int64)
            active = np.arange(Pn)
            t_sweep = time.perf_counter()
            rounds = 0
            while True:
                active = active[(status[active] == optim.RUNNING) & (it[active] < max_ls)]
                n = len(active)
                if n == 0:
                    break
                bucket = _quantize_bucket(n, min_bucket)
                # {1,1.25,1.5,1.75}x2^k sizes divide evenly only over power-of-two
                # device counts: round up (e.g. 6 devices: 28 -> 30).
                bucket = -(-bucket // len(devs)) * len(devs)
                idx = np.resize(active, bucket)  # pad by cycling (extras ignored)
                round_iters = min(round_schedule[min(rounds, len(round_schedule) - 1)], max_ls)
                shards = np.array_split(np.arange(bucket), len(devs))
                outs = map_shards(range(len(devs)),
                                  lambda i, part: round_shard(i, part, round_iters), shards)
                with TRACE.span("batched.compact"):
                    out = gather([o[0] for o in outs])
                    vals = np.concatenate([o[1].reshape(2, -1) for o in outs], axis=1)
                    act = to_device(active, home)
                    st = optim.CGState(*(t.index_copy(0, act, o[:n]) for t, o in zip(st, out)))
                    status[active], it[active] = vals[0, :n], vals[1, :n]
                rounds += 1
                logger.debug("[batched] sweep %d round %d: %d active (bucket %d)",
                             sweep, rounds, n, bucket)
            logger.info("[batched] sweep %d: %d rounds, %.3fs, mean iters %.1f", sweep, rounds,
                        time.perf_counter() - t_sweep, float(it.mean()))
    with TRACE.span("batched.to_host", device=True, wait=True):
        return (batch.times, *_to_host(st.x, st.f, st.it))


def _to_host(x, f, it):
    """(omegas, costs, iters) as numpy in one copy to the host."""
    host = torch.cat([x, f[:, None], it[:, None].float()], dim=1).cpu().numpy()
    return host[:, :3], host[:, 3], host[:, 4].astype(np.int32)


def track_batched(
    batch: PacketBatch,
    cam: warp_local.CameraParams,
    cfg: FrontendConfig,
    devices=None,
    sweeps: int = 2,
    chunk_size: int = 16,
):
    """Solve all packets' angular velocities in parallel, in lockstep chunks.

    Returns (times (P,), omegas (P, 3), costs (P,), iters (P,)) as numpy. With
    ``devices`` the lanes of each chunk are split over the list (pure data
    parallelism; the packet count must divide the device count).

    Packets go in chunks of ``chunk_size``: a lockstep solve runs every lane
    until the SLOWEST lane stops, so one stubborn packet in a huge batch
    would make every packet pay its iteration count; chunking bounds that.
    """
    Pn = batch.bearings.shape[0]
    if devices is not None:
        devices = resolve_devices(devices)
        n_dev = len(devices)
        if Pn % n_dev:
            raise ValueError(f"packet count {Pn} not divisible by {n_dev} devices")
        solve = make_dp_cmax_step(devices, cam, cfg.warp.blur_sigma, cfg.contrast_measure,
                                  cfg.optim)
        chunk_size = max((chunk_size // n_dev) * n_dev, n_dev)
        home = devices[0]
    else:
        solve = batched_packet_solve(cam, cfg.warp.blur_sigma, cfg.contrast_measure, cfg.optim)
        home = batch.bearings.device

    omegas = torch.zeros((Pn, 3), dtype=torch.float32, device=home)
    for sweep in range(max(sweeps, 1)):
        if sweep > 0:
            omegas = torch.cat([omegas[:1], omegas[:-1]])  # Jacobi warm start
        outs = [solve(batch.bearings[lo:lo + chunk_size], batch.dts[lo:lo + chunk_size],
                      batch.weights[lo:lo + chunk_size], omegas[lo:lo + chunk_size])
                for lo in range(0, Pn, chunk_size)]
        omegas, costs, iters = (torch.cat([o[i].to(home) for o in outs]) for i in range(3))
    return (batch.times, *_to_host(omegas, costs, iters))
