"""Offline tracking through the batched tracker: each call cuts one period
of the stream into packets (``parallel/batched.cut_packets``) and solves
them all with ``track_batched_compacted``; calls run back to back. Set-up
makes the stream and calls until the programs' captures stop (at least
``warmup_calls`` calls, then until ``warmup_calm_calls`` in a row capture
no program, at most ``warmup_calls_max``); the window calls until
``seconds`` of wall have passed. The back-end is bypassed."""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np

from pb import harness, reference, stream as streams


def packets_of(ts: np.ndarray, dt: float, half: int) -> list:
    """The reference's cut of a stream into centred packets: the k-th
    trigger is the first event after t0 + dt/2 + k dt (and after the previous
    trigger; the cursor advances by dt from each trigger), the packet is
    the ``half - 1`` events before it, it, and the ``half`` after, kept when
    whole at the end; its grid time is t0 + dt/2 + k dt. Returns [(beg, end,
    grid time)]."""
    t0 = float(ts[0])
    cursor = t0 + 0.5 * dt
    out, i, k = [], 0, 0
    while True:
        idx = max(int(np.searchsorted(ts, cursor, side="right")), i)
        if idx >= len(ts):
            break
        count = idx + 1
        if count + half > len(ts):
            break
        out.append((max(count - half, 0), count + half, t0 + 0.5 * dt + k * dt))
        cursor += dt
        i, k = idx + 1, k + 1
    return out


def drive(spec: dict, seed: int, seconds: float, trace: bool, device: str,
          t_start: float, plant=None) -> dict:
    import torch
    from cmax_slam_tpu_torch.calib import CameraCalibration, bearing_lut
    from cmax_slam_tpu_torch.ops.warp_local import CameraParams
    from cmax_slam_tpu_torch.parallel import batched
    from cmax_slam_tpu_torch.utils.device import to_device
    from cmax_slam_tpu_torch.utils.metrics import Metrics

    from pb import cell

    traffic = spec["traffic"]
    sensor = streams.Sensor.from_config(spec["config"]["sensor"])
    cfg = cell.system_config(spec["config"]["settings"]).frontend
    calib = CameraCalibration(width=sensor.width, height=sensor.height, K=sensor.K)
    lut = bearing_lut(calib)
    cam = CameraParams(fx=sensor.fx, fy=sensor.fy, cx=sensor.cx, cy=sensor.cy,
                       width=sensor.width, height=sensor.height)
    t1 = time.perf_counter()
    st = streams.make_stream(sensor, traffic, seed, device)
    sweeps = int(traffic["sweeps"])
    track = batched.track_batched_compacted if plant is None else plant(
        batched.track_batched_compacted)

    def call(p: int):
        xs, ys, ts, _ = st.slice(p * st.n, (p + 1) * st.n)
        packets = batched.cut_packets(xs, ys, ts, lut, cam, cfg, device=device)
        return track(packets, cam, cfg, sweeps=sweeps)

    # Warm-up: at least warmup_calls calls, then until warmup_calm_calls in
    # a row capture no program (the lanes' buckets vary from call to call).
    t2 = time.perf_counter()
    caps = harness.Captures()
    warm, calm = 0, 0
    while warm < int(traffic["warmup_calls_max"]) and (
            warm < int(traffic["warmup_calls"]) or calm < int(traffic["warmup_calm_calls"])):
        n0 = caps.mark()
        call(warm)
        warm += 1
        calm = calm + 1 if caps.new(n0) == 0 else 0
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = harness.counters(Metrics())
    t3 = time.perf_counter()
    setup_s = t3 - t_start
    parts = {"imports": t1 - t_start, "stream": t2 - t1, "warmup": t3 - t2,
             "warmup_calls": warm, "warmup_captures": before["captures"],
             "warmup_capture_s": before["capture_s"]}
    n_caps = caps.mark()

    tr = harness.Tracer(None, trace and on_card)
    calls, result = [], None
    p = warm
    with tr:
        t_first = time.perf_counter()
        tr.begin()
        while True:
            t0 = time.perf_counter()
            if t0 - t_first >= seconds and calls:
                break
            with tr.span("batched.call"):
                result = call(p)
            calls.append((p, t0, time.perf_counter()))
            p += 1
        if on_card:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        tr.end()
    after = harness.counters(Metrics())
    window_s = t_end - t_first
    rec = harness.record(setup_s=setup_s, window_s=window_s,
                         stream_s=len(calls) * st.period, attempted=len(calls), failed=0,
                         before=before, after=after, tracer=tr,
                         calls=len(calls), setup_parts=parts,
                         captured_in_window=caps.new(n_caps))
    rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # The last call's answers, read once the window has closed.
    p_last = calls[-1][0]
    _, omegas, costs, _ = result
    ts = st.ts + p_last * st.period
    cut = packets_of(ts, cfg.dt_ang_vel, cfg.num_events_per_packet // 2)
    rng = np.random.default_rng(seed)
    n_check = min(int(traffic["check_packets"]), len(cut), len(omegas))
    pick = sorted(rng.choice(min(len(cut), len(omegas)), size=n_check, replace=False))
    base = p_last * st.n
    packets = [{"span": (base + cut[i][0], base + cut[i][1]), "t": cut[i][2],
                "omega": np.array(omegas[i], np.float64), "contrast": -float(costs[i]),
                "warm": np.array(omegas[i - 1] if i > 0 else np.zeros(3), np.float64)}
               for i in pick]
    out = {"packets": packets, "count": (len(cut), len(omegas))}
    if trace and on_card:
        S = ((cfg.num_events_per_packet + cfg.warp.event_batch_size - 1)
             // cfg.warp.event_batch_size) * cfg.warp.event_batch_size
        fe = SimpleNamespace(lut=to_device(lut, device), cam=cam, cfg=cfg, packet_size=S)
        rec["objectives"] = harness.objective_times(fe, None, st, sensor, packets[-1])
    rec["check"] = check(spec, st, sensor, out, device)
    rec["outputs"], rec["stream"], rec["sensor"] = out, st, sensor
    return rec


def check(spec: dict, st, sensor, out: dict, device: str) -> dict:
    """Every packet of the call answered, and the checked answers against
    the plain reference."""
    res = reference.packet_numbers(spec["config"]["settings"], st, sensor, out["packets"],
                                   device)
    n_cut, n_answers = out["count"]
    if n_cut != n_answers:
        res = dict.fromkeys(res, math.inf)
    return res
