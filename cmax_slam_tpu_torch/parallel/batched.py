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
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrontendConfig
from ..io import native
from ..ops import optim, warp_local
from ..utils.device import resolve_device, resolve_devices
from ..utils.metrics import logger
from .sharding import (batched_packet_solve, cg_body, lane_objective, make_dp_cmax_step,
                       map_shards)


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
    tensors are put on ``device``."""
    device = resolve_device(device)
    half = cfg.num_events_per_packet // 2
    bs = cfg.warp.event_batch_size
    S = ((2 * half + bs - 1) // bs) * bs

    t0 = float(ts[0])
    trig, _, _ = native.scan_triggers(ts, t0 + 0.5 * cfg.dt_ang_vel, 0, cfg.dt_ang_vel)
    trig = trig[(trig + 1 + half) <= len(ts)]  # keep only complete packets
    Pn = len(trig)
    bearings = np.zeros((Pn, S, 3), np.float32)
    dts = np.zeros((Pn, S), np.float32)
    weights = np.zeros((Pn, S), np.float32)
    times = np.zeros(Pn, np.float64)

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

    return PacketBatch(bearings=put(bearings), dts=put(dts), weights=put(weights), times=times)


def _init_states(bearings, dts, weights, omega0s, cam, blur_sigma, measure, opt):
    with torch.no_grad():
        f = lane_objective(bearings, dts, weights, cam, blur_sigma, measure)
        return optim.cg_init(warp_local.value_and_grad(f), omega0s, opt.initial_step)


def _run_round(bearings, dts, weights, states, cam, blur_sigma, measure, opt, round_iters):
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
    (optim.cg_run_rounds); between rounds the host reads every lane's status
    and iteration count, drops converged lanes and re-packs the survivors
    into a quantized bucket with ``index_select`` on the device. Total work
    is ~the sum of per-lane iteration counts instead of lanes x max-lane.

    Jacobi warm-start sweeps as in track_batched. The cold sweep only seeds
    the warm one, so it votes every ``cold_decimate``-th event of each packet
    (the reference sheds load the same way with event_sample_rate,
    src/cmax_slam.cpp:155-156). Every sweep runs in float32: unlike the JAX
    package there is no lower-precision matmul mode for the cold sweep.

    With ``devices``, the host compacts survivors globally every round and
    splits the bucket evenly over the list (the bucket is rounded up to a
    multiple of the device count); each device solves its share locally and
    the states are gathered on ``devices[0]``.

    Returns (times, omegas, costs, iters) as numpy, like track_batched.
    """
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

    def run(fn, idx, lane_args):
        """fn(bearings, dts, weights, *lane_args) on the lanes ``idx`` of the
        sweep's packets, split evenly over the devices; a CGState on home."""

        def shard(dev, part):
            lanes = idx[part]
            sel = torch.as_tensor(lanes, device=dev)
            sel_home = torch.as_tensor(lanes, device=home)
            return fn(*(t.index_select(0, sel) for t in data[dev]),
                      *(a.index_select(0, sel_home).to(dev) for a in lane_args))

        outs = map_shards(devs, shard, np.array_split(np.arange(len(idx)), len(devs)))
        return optim.CGState(*(torch.cat([o[i].to(home) for o in outs])
                               for i in range(len(optim.CGState._fields))))

    def init(b, d, w, x0):
        return _init_states(b, d, w, x0, cam, blur_sigma, measure, opt)

    st = None
    for sweep in range(max(sweeps, 1)):
        final = sweep == max(sweeps, 1) - 1
        if sweep > 0:
            omega0 = torch.cat([st.x[:1], st.x[:-1]])  # left neighbour's solution
            k = 1
        else:
            omega0 = torch.zeros((Pn, 3), dtype=torch.float32, device=home)
            k = 1 if final else max(cold_decimate, 1)
        sweep_data = [t[:, ::k] for t in (batch.bearings, batch.dts, batch.weights)]
        data = {dev: [t.to(dev).contiguous() for t in sweep_data] for dev in set(devs)}
        st = run(init, np.arange(Pn), [omega0])
        active = np.arange(Pn)
        t_sweep = time.perf_counter()
        rounds = 0
        while True:
            status, it = st.status.cpu().numpy(), st.it.cpu().numpy()
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

            def step(b, d, w, *s, round_iters=round_iters):
                return _run_round(b, d, w, optim.CGState(*s), cam, blur_sigma, measure, opt,
                                  round_iters)

            out = run(step, idx, list(st))
            act = torch.as_tensor(active, device=home)
            st = optim.CGState(*(t.index_copy(0, act, o[:n]) for t, o in zip(st, out)))
            rounds += 1
            logger.debug("[batched] sweep %d round %d: %d active (bucket %d)",
                         sweep, rounds, n, bucket)
        logger.info("[batched] sweep %d: %d rounds, %.3fs, mean iters %.1f", sweep, rounds,
                    time.perf_counter() - t_sweep, float(st.it.float().mean()))
    return batch.times, st.x.cpu().numpy(), st.f.cpu().numpy(), st.it.cpu().numpy()


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
    return batch.times, omegas.cpu().numpy(), costs.cpu().numpy(), iters.cpu().numpy()
