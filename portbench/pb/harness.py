"""One run of one cell: set-up and window by the cell's driver, then its
metrics by their readers, the device's numbers, and the comparison with the
plain reference, as the result's line."""

from __future__ import annotations

import json
import math
import sys
import time
from contextlib import contextmanager

from pb import cell, roofline, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "cmax_slam_tpu", "chip_smoke", "tests")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is one the benchmark may not load."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


class Captures:
    """The device programs' captures, from the program's public counter
    device_loop.CAPTURES: ``mark()`` notes the count now, ``new(since)`` the
    captures after a mark."""

    def __init__(self):
        from cmax_slam_tpu_torch.ops import device_loop

        self._counts = device_loop.CAPTURES

    def mark(self) -> int:
        return int(self._counts["graphs"])

    def new(self, since: int) -> int:
        return self.mark() - since


def counters(metrics) -> dict:
    """The program's counts that the per-layer metrics read, now."""
    from cmax_slam_tpu_torch.ops import device_loop

    return {"captures": device_loop.CAPTURES["graphs"],
            "capture_s": device_loop.CAPTURES["s"],
            "pred": device_loop.LAUNCHES["pred"],
            "timers": {k: v.total for k, v in metrics.timers.items()}}


class Tracer:
    """The traced window's hooks (ProgramTimes, spans around the system's
    layers, torch.profiler, SyncAudit); with ``on`` False it does nothing,
    and its ``span`` records nothing."""

    def __init__(self, system, on: bool):
        self.on = on
        self.spans = trace.Spans()
        self._managers = []
        if on:
            self.device = trace.DeviceTrace()
            self.programs = trace.ProgramTimes(self.device.anchor)
            self.audit = trace.SyncAudit(str(cell.ROOT))
            self._managers = [self.programs, self.audit]
            slam = system
            if hasattr(slam, "frontend"):
                self.spans.wrap(slam.frontend, "push_events", "frontend.push")
                self.spans.wrap(slam.backend, "step", "backend.step")

    def __enter__(self):
        """Put the hooks on and start the profiler (whose start takes
        seconds) before the window."""
        for m in self._managers:
            m.__enter__()
        if self.on:
            self.device.open()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.device.close()
        for m in reversed(self._managers):
            m.__exit__(*exc)
        return False

    def begin(self) -> None:
        """The window's start: device time 0."""
        if self.on:
            self.device.start()

    def end(self) -> None:
        """The window's end, after the driver's last synchronize."""
        if self.on:
            self.device.stop()

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.spans.append((name, t0, time.perf_counter()))


def record(*, setup_s, window_s, stream_s, attempted, failed, before, after, tracer,
           **extra) -> dict:
    """The run's record, which the metric readers read: the host clock's
    numbers, the counters' deltas over the window and, traced, the device
    timeline with its busy time and breakdown."""
    timers = {k: v - before["timers"].get(k, 0.0) for k, v in after["timers"].items()}
    rec = {"setup_s": setup_s, "window_s": window_s, "stream_s": stream_s,
           "attempted": attempted, "failed": failed,
           "captures": after["captures"] - before["captures"],
           "pred": after["pred"] - before["pred"], "timers": timers, **extra}
    if tracer.on:
        rec.update(timeline(tracer))
    return rec


def timeline(tracer: Tracer) -> dict:
    """Busy time (the union of the device programs' intervals and the
    kernels the profiler saw) over the window, device time by program and
    by kernel outside the programs, and the longest idle gaps named by the
    host's innermost span at their middle."""
    import bisect

    dev = tracer.device
    end = dev.end_ms()
    programs = tracer.programs.intervals()
    kernels = dev.kernels()
    busy = trace.union([(a, b) for _, a, b in programs] + [(a, b) for _, a, b in kernels],
                       0.0, end)
    by_name: dict = {}
    launches: dict = {}
    for name, a, b in programs:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        launches[name] = launches.get(name, 0) + 1
    graph = trace.union([(a, b) for _, a, b in programs], 0.0, end)
    starts = [a for a, _ in graph]
    eager: dict = {}
    for name, a, b in kernels:
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or b > graph[i][1]:  # not inside a program's interval
            eager[name[:60]] = eager.get(name[:60], 0.0) + (b - a) / 1e3
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    ops += sorted(((f"kernel {k}", v) for k, v in eager.items()), key=lambda kv: -kv[1])
    gaps, last = [], 0.0
    for a, b in busy + [[end, end]]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = [(tracer.spans.at(dev.host0 + (a + b) / 2e3), (b - a) / 1e3) for a, b in longest]
    return {"busy_s": sum(b - a for a, b in busy) / 1e3, "device_window_s": end / 1e3,
            "program_s": by_name, "program_launches": launches,
            "breakdown": {"device_ops": [[k, v] for k, v in ops[:10]],
                          "idle_gaps": [[k, v] for k, v in named[:10]]},
            "audit": tracer.audit.report(),
            "host_spans_s": _span_totals(tracer.spans.spans)}


def _span_totals(spans) -> dict:
    out: dict = {}
    for name, a, b in spans:
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def objective_times(fe, be, st, sensor, packet) -> dict:
    """The front-end packet objective on one of the window's packets, and the
    back-end crop objective on the last window that ran its bundle
    adjustment (none without a back-end ``be``), each made through the
    port's public builders (warp_local, warp_pano) from the stream's events
    and the program's public state, captured alone and replayed
    (roofline.capture_and_time), with its work counted from its shapes."""
    import numpy as np
    import torch
    from cmax_slam_tpu_torch.ops import warp_local

    out = {}
    (beg, end), t_ref, omega = packet["span"], packet["t"], packet["omega"]
    xs, ys, ts, _ = st.slice(beg, end)
    S = fe.packet_size
    n = len(ts)

    def pad(a, dtype):
        buf = np.zeros(S, dtype)
        buf[:n] = a
        return torch.as_tensor(buf, device="cuda")

    t0 = float(ts[0])
    pk = warp_local.make_packet(pad(xs, np.int32), pad(ys, np.int32),
                                pad(ts - t0, np.float32), pad(np.ones(n, bool), bool),
                                fe.lut, fe.cam, fe.cfg.warp.event_batch_size,
                                float(np.float32(t_ref - t0)))
    _, vg = warp_local.make_local_objective(pk, fe.cam, fe.cfg.warp.blur_sigma,
                                            fe.cfg.contrast_measure)
    x = torch.as_tensor(np.asarray(omega, np.float32)[None], device="cuda")
    out["packet"] = {"seconds": roofline.capture_and_time(vg, x),
                     "work": roofline.packet_objective_work(n, sensor.height, sensor.width)}
    crop = None
    if be is not None:
        for r in reversed(be.results[-8:]):
            crop = window_objective(be, st, sensor, r, fe.lut) if r.ran_ba else None
            if crop is not None:
                break
    if crop is not None:
        vg, x, work, info = crop
        out["window"] = {"seconds": roofline.capture_and_time(vg, x), "work": work, **info}
    return out


def window_objective(be, st, sensor, result, lut):
    """The crop objective of the back-end window ``result`` (a WindowResult),
    rebuilt from its public fields (times, index), the stream's events in
    it, the trajectory's knots and the map (``be.traj``, ``be.IG``), through
    warp_pano's public builders: (value-and-grad, a point, its work, its
    shapes), or None where the window's events cover 0.7 of the panorama or
    more (the program solves such a window on the whole panorama)."""
    import numpy as np
    import torch
    from cmax_slam_tpu_torch.ops import warp_pano

    cfg, pano, order, traj = be.cfg, be.pano, be.order, be.traj
    bs = cfg.warp.event_batch_size
    dt = cfg.trajectory.dt_knots
    K = int(round(cfg.sliding_window.time_window_size / dt)) + order - 1
    k0 = int(round((result.t_beg - traj.t_beg) / dt))
    if k0 < 0 or k0 + K > traj.size:
        return None
    g0, g1 = st.index(result.t_beg), st.index(result.t_end)
    xs, ys, ts, _ = st.slice(g0, min(g1, g0 + cfg.max_events_per_window))
    n = len(ts)
    size = -(-n // bs) * bs
    tb = np.concatenate([ts, np.full(size - n, ts[-1])]).reshape(-1, bs)
    dev = be.IG.device
    idx = torch.as_tensor(np.concatenate([ys.astype(np.int64) * sensor.width + xs, np.zeros(size - n, np.int64)]),
                          device=dev)
    weights = torch.zeros(size, device=dev)
    weights[:n] = 1.0
    mid = tb[:, 0] + 0.5 * (tb[:, -1] - tb[:, 0]) - traj.knot_time(k0)
    win = warp_pano.PanoWindow(
        bearings=torch.as_tensor(lut, device=dev)[idx].T.contiguous(),
        batch_times=torch.as_tensor(mid, dtype=torch.float32, device=dev),
        weights=weights, is_old=torch.zeros(size, dtype=torch.bool, device=dev),
        knots=torch.as_tensor(traj.knots[k0:k0 + K], dtype=torch.float32, device=dev),
        free_mask=torch.ones(K, device=dev), t0=0.0, dt_knots=float(np.float32(dt)),
        ig_prime=be.IG, alpha=torch.zeros((), device=dev))
    zeros = torch.zeros((K, 3), device=dev)
    pxm, pxM, pym, pyM = (float(v) for v in warp_pano.warp_bbox(zeros, win, pano, order))
    sigma, measure = cfg.warp.blur_sigma, cfg.contrast_measure
    halo = int(np.ceil(4 * sigma)) + 1
    pad = max(32.0, cfg.crop_margin_rad * pano.width / (2 * np.pi)) + 2 * halo + 2
    H, W = pano.height, pano.width
    Hc = min(-(-int(pyM - pym + 2 * pad) // 128) * 128, H)
    Wc = min(-(-int(pxM - pxm + 2 * pad) // 128) * 128, W)
    if Hc * Wc >= 0.7 * H * W:
        return None
    x0 = min(max(int(round(0.5 * (pxm + pxM) - Wc / 2)), 0), W - Wc)
    y0 = min(max(int(round(0.5 * (pym + pyM) - Hc / 2)), 0), H - Hc)
    ints = [y0, x0, halo if y0 > 0 else 0, Hc - (halo if y0 + Hc < H else 0),
            halo if x0 > 0 else 0, Wc - (halo if x0 + Wc < W else 0)]
    win, x0f, y0f, a_crop, mask, s1, s2 = warp_pano.crop_window_constants(
        win, pano, order, sigma, measure, (Hc, Wc), ints)
    _, vg = warp_pano.make_crop_objective(win, pano, order, sigma, measure, (Hc, Wc),
                                          x0f, y0f, a_crop, mask, s1, s2)
    x = torch.full((1, 3 * K), 1e-3, device=dev)
    work = roofline.window_objective_work(n, K, Hc, Wc, sensor.width * sensor.height)
    return vg, x, work, {"events": n, "crop": [Hc, Wc], "window": result.index}


def judged(limits: dict, values: dict) -> dict:
    """{number: {"value", "limit"}} for each number the cell's limits name; a
    number over its limit, one that is not finite, or one that the run did
    not read, fails."""
    return {k: {"value": values.get(k, math.inf), "limit": lim} for k, lim in limits.items()}


def correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def device_info(chips: int, rec: dict, trace_on: bool) -> dict:
    info = {"platform": "cpu" if rec["device_kind"] == "cpu" else "gpu",
            "kind": rec["device_kind"], "count": chips,
            "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    if trace_on:
        info["busy_s"] = rec.get("busy_s", 0.0)
        info["window_s"] = rec["window_s"]
    return info


def run(workload: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        t_start: float | None = None, root=cell.ROOT, plant=None, keep=None,
        overrides=None) -> dict:
    """The result's line of one run, as a dict (``checks`` last). ``plant``
    is handed to the driver (a test's fault), ``overrides`` replace settings
    of the configuration (a fault through the program's own options);
    ``keep``, a dict, receives the cell's spec and the run's record."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = cell.benchmark(root)
    spec = cell.spec(bench, workload, root)
    if overrides:
        spec["config"]["settings"] = {**spec["config"]["settings"], **overrides}
    drv = cell.driver(spec["traffic"]["driver"])
    rec = drv.drive(spec, seed, seconds, trace_on, device, t_start, plant=plant)
    rec["device_kind"] = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    if keep is not None:
        keep.update(spec=spec, rec=rec)
    metrics = {}
    for m in spec["per_layer" if trace_on else "end_to_end"]:
        value = cell.reader(m["name"], root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rec["readings"] = rec.pop("check")
    checks = judged(spec["limits"], rec["readings"])
    line = {"correct": correct(checks), "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": device_info(spec["cell"]["chips"], rec, trace_on)}
    if trace_on and "breakdown" in rec:
        line["breakdown"] = rec["breakdown"]
    line["notes"] = notes(rec)
    line["notes"]["readings"] = rec["readings"]
    line["checks"] = checks
    return line


def notes(rec: dict) -> dict:
    """What the run saw besides its metrics, for a reader of its line."""
    keys = ("setup_s", "window_s", "stream_s", "windows", "windows_due", "poll_ms",
            "captures", "pred", "program_s", "program_launches", "audit", "host_spans_s",
            "objectives", "calls", "busy_s", "setup_parts", "captured_in_window", "captured_at_stream_s")
    out = {k: rec[k] for k in keys if k in rec}
    if "latencies_ms" in rec:
        out["latency_samples"] = len(rec["latencies_ms"])
    return json.loads(json.dumps(out, default=float))
