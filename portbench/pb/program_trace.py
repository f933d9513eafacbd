"""What the port's own trace (cmax_slam_tpu_torch.utils.metrics.TRACE) says
about a run: the readers of six per-layer metrics and the traced
breakdown's two fields, each from a run's record holding the trace's
records under ``"program_trace"`` (``TRACE.records()``, recorded from the
window's first push or call to its end, the trace armed before the system
was built).

``pb/harness.py`` does not record the trace yet: nothing here is read by a
cell of BENCHMARK.json. A run records it when the trace is armed before
``harness.run`` (``TRACE.enable()``), started at ``Tracer.begin`` and
stopped at ``Tracer.end``, and its records are put in the record that
``harness.record`` returns.

Every reader returns None where the record holds no trace, or nothing the
metric reads.
"""

from __future__ import annotations

import numpy as np

BELOW = ("frontend.push", "backend.step", "batched.cut", "batched.track")


def _trace(rec: dict):
    return rec.get("program_trace")


def _metrics():
    from cmax_slam_tpu_torch.utils import metrics

    return metrics


def window_latencies_s(rec: dict) -> list:
    """[(window, seconds)]: each window completed in the window, from the
    start of the push that carried its last event to its result's mark."""
    tr = _trace(rec)
    return [] if tr is None else _metrics().window_latencies(tr)


def system_window_result_p95_ms(rec: dict):
    """``system.window_result_p95_ms``: the 95th percentile of the windows'
    latencies inside the program (window_latencies_s), in ms."""
    lat = [s for _, s in window_latencies_s(rec)]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def backend_held_ms_per_window(rec: dict):
    """``backend.held_ms_per_window``: the mean, over the bundle-adjusted
    windows finished in the window, of the time from their program's end on
    the card to the start of their finish on the host, in ms."""
    tr = _trace(rec)
    held = [] if tr is None else [s for _, s in _metrics().held_times(tr)]
    return float(np.mean(held)) * 1e3 if held else None


def backend_host_self_ms_per_window(rec: dict):
    """``backend.host_self_ms_per_window``: host time in ``backend.step``
    spans less the waits inside them, per window completed, in ms."""
    tr = _trace(rec)
    if tr is None or not rec.get("windows") or not any(
            s["name"] == "backend.step" for s in tr["spans"]):
        return None
    return 1e3 * _metrics().self_time(tr, "backend.step") / rec["windows"]


def frontend_host_self_ms_per_stream_s(rec: dict):
    """``frontend.host_self_ms_per_stream_s``: host time in
    ``frontend.push`` spans less the waits inside them, per stream second,
    in ms/s."""
    tr = _trace(rec)
    if tr is None or rec.get("stream_s", 0) <= 0 or not any(
            s["name"] == "frontend.push" for s in tr["spans"]):
        return None
    return 1e3 * _metrics().self_time(tr, "frontend.push") / rec["stream_s"]


def device_loop_wait_ms_per_stream_s(rec: dict):
    """``device_loop.wait_ms_per_stream_s``: host time in wait spans per
    stream second, in ms/s."""
    tr = _trace(rec)
    if tr is None or rec.get("stream_s", 0) <= 0 or not tr["spans"]:
        return None
    return 1e3 * _metrics().wait_time(tr) / rec["stream_s"]


def device_idle_share_program(rec: dict):
    """``device.idle_share_program``: 1 - the union of the trace's device
    intervals (program launches and device spans, between CUDA events) over
    the window's wall, in percent."""
    tr = _trace(rec)
    if tr is None or rec.get("window_s", 0) <= 0 or not (
            tr["launches"] or any(s["device"] for s in tr["spans"])):
        return None
    m = _metrics()
    if not m.device_intervals(tr):
        return None
    return 100.0 * (1.0 - m.busy_time(tr) / rec["window_s"])


READERS = {
    "system.window_result_p95_ms": system_window_result_p95_ms,
    "backend.held_ms_per_window": backend_held_ms_per_window,
    "backend.host_self_ms_per_window": backend_host_self_ms_per_window,
    "frontend.host_self_ms_per_stream_s": frontend_host_self_ms_per_stream_s,
    "device_loop.wait_ms_per_stream_s": device_loop_wait_ms_per_stream_s,
    "device.idle_share_program": device_idle_share_program,
}


def breakdown(rec: dict, n: int = 10):
    """The traced breakdown from the trace alone, or None: ``device_ops``,
    device seconds by program split into its outermost loop nodes
    (``<program>/<node>``) and ``<program>/rest``, and by device span
    outside the programs; ``idle_gaps``, the ``n`` longest gaps in the
    union of the device intervals, each named by the innermost span open
    at its middle (``host.between_calls`` where none is)."""
    tr = _trace(rec)
    if tr is None:
        return None
    m = _metrics()
    ops = dict(m.loop_split(tr))
    clocked = {r["program"] for r in tr["launches"] if r["loops"] is not None}
    for r in tr["launches"]:
        if r["device"] and r["program"] not in clocked:
            ops[r["program"]] = ops.get(r["program"], 0.0) + r["device"][1] - r["device"][0]
    for s in tr["spans"]:
        if s["device"]:
            ops[s["name"]] = ops.get(s["name"], 0.0) + s["device"][1] - s["device"][0]
    lo, hi = tr["t_start"], tr["t_stop"]
    busy = m.union([(a, b) for _, a, b in m.device_intervals(tr)], lo, hi)
    gaps, last = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    named = [[m.innermost(tr, (a + b) / 2) or "host.between_calls", b - a] for a, b in longest]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:n],
            "idle_gaps": named}


def split(rec: dict) -> dict:
    """Host seconds by span name (each span's own time less its children's)
    and the share of each of ``BELOW``'s host time its direct children
    cover: the split of the host's work that the window's record shows."""
    tr = _trace(rec)
    if tr is None:
        return {}
    spans = tr["spans"]
    child = [0.0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] += s["t1"] - s["t0"]
    own: dict = {}
    for i, s in enumerate(spans):
        own[s["name"]] = own.get(s["name"], 0.0) + (s["t1"] - s["t0"]) - child[i]
    m = _metrics()
    return {"self_s": dict(sorted(own.items(), key=lambda kv: -kv[1])),
            "coverage": {name: m.coverage(tr, name) for name in BELOW
                         if m.coverage(tr, name) is not None}}
