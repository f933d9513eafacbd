"""Closed-loop replay through ``CMaxSLAM.push_events``: each push is one
event array of 1/push_hz s of stream, issued when the previous push
returns. Set-up builds the system, makes the stream and replays whole
periods on the same system (at least ``warmup_periods``, then until
``warmup_calm_periods`` in a row capture no program, at most
``warmup_periods_max``), so that the window
meets only captured programs and a filled map; the window then pushes until
``seconds`` of wall have passed and ends with the flush that joins the work
in flight."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from pb import harness, reference, stream as streams


def _system(spec: dict, device: str):
    from cmax_slam_tpu_torch.calib import CameraCalibration
    from cmax_slam_tpu_torch.system import CMaxSLAM

    from pb import cell

    sensor = streams.Sensor.from_config(spec["config"]["sensor"])
    cfg = cell.system_config(spec["config"]["settings"])
    calib = CameraCalibration(width=sensor.width, height=sensor.height, K=sensor.K)
    return sensor, cfg, CMaxSLAM(calib, cfg, device=device)


def _push(slam, st, k: int, hz: float):
    g0, g1 = st.push_bounds(k, hz)
    xs, ys, ts, ps = st.slice(g0, g1)
    return g0, g1, (xs, ys, ts, ps)


def drive(spec: dict, seed: int, seconds: float, trace: bool, device: str,
          t_start: float, plant=None) -> dict:
    import torch

    traffic = spec["traffic"]
    hz = float(traffic["push_hz"])
    t0 = time.perf_counter()
    sensor, cfg, slam = _system(spec, device)
    t1 = time.perf_counter()
    st = streams.make_stream(sensor, traffic, seed, device)
    t2 = time.perf_counter()
    if plant is not None:
        plant(slam)
    # Warm-up: whole periods, at least warmup_periods, then until
    # warmup_calm_periods in a row capture no program (at most
    # warmup_periods_max): rare shapes (a crop, an escape to the whole
    # panorama) are captured here and not in the window.
    caps = harness.Captures()
    per = math.ceil(st.period * hz)
    warm, calm = 0, 0
    while warm < int(traffic["warmup_periods_max"]) * per and (
            warm < int(traffic["warmup_periods"]) * per
            or calm < int(traffic["warmup_calm_periods"])):
        n0 = caps.mark()
        for k in range(warm, warm + per):
            _, _, ev = _push(slam, st, k, hz)
            slam.push_events(*ev)
        warm += per
        calm = calm + 1 if caps.new(n0) == 0 else 0
    be = slam.backend
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = harness.counters(slam.metrics)
    n_results0 = len(be.results)
    t3 = time.perf_counter()
    setup_s = t3 - t_start
    parts = {"imports": t0 - t_start, "system": t1 - t0, "stream": t2 - t1, "warmup": t3 - t2,
             "warmup_pushes": warm, "warmup_captures": before["captures"],
             "warmup_capture_s": before["capture_s"]}
    n_caps = caps.mark()

    tr = harness.Tracer(slam, trace and on_card)
    pushes, seen, captured_at = [], {}, []
    k = warm
    with tr:
        t_first = time.perf_counter()
        tr.begin()
        while True:
            g0, g1, ev = _push(slam, st, k, hz)
            t_issue = time.perf_counter()
            if t_issue - t_first >= seconds and pushes:
                break
            n0 = caps.mark()
            with tr.span("system.push"):
                slam.push_events(*ev)
            t_ret = time.perf_counter()
            pushes.append((k, g0, g1, t_issue, t_ret))
            if caps.new(n0):
                captured_at.append(k / hz)
            for i in range(len(seen) + n_results0, len(be.results)):
                seen[i] = t_ret
            k += 1
        with tr.span("system.flush"):
            slam.flush()
            if on_card:
                torch.cuda.synchronize()
        t_end = time.perf_counter()
        for i in range(len(seen) + n_results0, len(be.results)):
            seen[i] = t_end
        tr.end()
    after = harness.counters(slam.metrics)
    window_s = t_end - t_first
    stream_s = len(pushes) / hz

    # Each window's latency: from the issue of the push carrying its last
    # event to the first poll that found its result.
    first_g = pushes[0][1]
    push_g0 = np.array([p[1] for p in pushes])
    latencies = []
    for i, r in enumerate(be.results):
        g_last = st.index(r.t_end - 1e-6) - 1
        if g_last < first_g or i not in seen:
            continue
        j = int(np.searchsorted(push_g0, g_last, side="right")) - 1
        latencies.append((seen[i] - pushes[j][3]) * 1e3)
    due = sum(1 for r in be.results[n_results0:] if st.index(r.t_end - 1e-6) - 1 >= first_g)

    rec = harness.record(
        setup_s=setup_s, window_s=window_s, stream_s=stream_s, attempted=len(pushes),
        failed=0, before=before, after=after, tracer=tr,
        latencies_ms=latencies, windows=len(be.results) - n_results0, windows_due=due,
        push_host_s=sum(p[4] - p[3] for p in pushes),
        poll_ms=1e3 * window_s / len(pushes), setup_parts=parts,
        captured_in_window=caps.new(n_caps), captured_at_stream_s=captured_at)
    rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # What the window produced, read once it has closed.
    t_lo, t_hi = pushes[0][0] / hz, (pushes[-1][0] + 1) / hz
    ests = [e for e in slam.frontend.estimates if t_lo <= e.t < t_hi]
    slam.frontend.finalize_batch(ests)
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(len(ests), size=min(int(traffic["check_packets"]), len(ests)),
                             replace=False))
    packets = [{"span": ests[i].span, "t": ests[i].t, "omega": np.array(ests[i].omega),
                "contrast": -float(ests[i].cost),
                "warm": np.array(ests[i - 1].omega if i > 0 else np.zeros(3))} for i in pick]
    traj = be.traj
    t_max = min(traj.max_time() - 1e-6, t_hi)
    times = np.arange(t_lo, t_max, cfg.backend.trajectory.dt_knots / 2)
    out = {"packets": packets, "times": times, "quats": traj.evaluate(times),
           "map": be.IG.cpu().numpy()}
    if trace and on_card:
        rec["objectives"] = harness.objective_times(slam.frontend, be, st, sensor, packets[-1])
    del slam, be, traj, ests
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["check"] = check(spec, st, sensor, out, device)
    rec["outputs"], rec["stream"], rec["sensor"] = out, st, sensor
    return rec


def check(spec: dict, st, sensor, out: dict, device: str) -> dict:
    """Every number of the comparison with the plain reference."""
    res = reference.packet_numbers(spec["config"]["settings"], st, sensor, out["packets"],
                                   device)
    q_truth = reference.truth_quats(st.omega, out["times"])
    res["rms_deg"], A = reference.rms_deg(q_truth, out["quats"])
    # Landmarks in the map's frame: R_truth ~ A R_est, so world_est = A^T world_truth.
    res.update(reference.map_numbers(out["map"], st.landmarks @ A, device))
    return res
