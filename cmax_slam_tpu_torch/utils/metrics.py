"""Timing, counters and the trace; host-only copy of cmax_slam_tpu/utils/metrics.py.

The reference only has VLOG counters for function/gradient evaluations
(src/frontend/local_focus_funcs.cpp:80, local_optim_contrast_gsl.cpp:222-223);
SURVEY.md section 5 calls for proper step timing + events/sec metrics in the
rebuild — this module provides them.

``TRACE`` is the process's trace: host spans and marks on
``time.perf_counter`` and, once armed, the card's intervals placed on that
clock (see Trace). The functions after it read what it recorded.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

logger = logging.getLogger("cmax_slam_tpu_torch")


def configure_logging(verbosity: int = 0) -> None:
    """glog-style verbosity (the reference runs with --v N, src/node.cpp:11):
    0 = warnings, 1 = info (packets/windows), 2+ = debug (solver detail)."""
    level = (
        logging.WARNING if verbosity <= 0
        else logging.INFO if verbosity == 1
        else logging.DEBUG
    )
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname).1s %(message)s",
                          datefmt="%H:%M:%S")
    )
    logger.handlers[:] = [handler]
    logger.setLevel(level)


@dataclass
class TimerStat:
    count: int = 0
    total: float = 0.0
    minimum: float = float("inf")
    maximum: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.minimum = min(self.minimum, dt)
        self.maximum = max(self.maximum, dt)

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class Metrics:
    """Lightweight process-local metrics registry."""

    def __init__(self):
        self.timers: Dict[str, TimerStat] = defaultdict(TimerStat)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Times the block into ``timers[name]``; it is also a span of that
        name in the trace."""
        t0 = time.perf_counter()
        try:
            with TRACE.span(name):
                yield
        finally:
            self.timers[name].add(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def summary(self) -> dict:
        return {
            "timers": {
                k: {"count": v.count, "total_s": v.total, "mean_s": v.mean}
                for k, v in self.timers.items()
            },
            "counters": dict(self.counters),
        }


# -- the trace -------------------------------------------------------------

class _Noop:
    """The span of a trace that is not recording: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One recorded span (see Trace.span). ``events`` holds the CUDA events
    of a device span until Trace.stop places them on the host clock in
    ``device``."""

    __slots__ = ("trace", "name", "t0", "t1", "parent", "window", "launch", "program",
                 "t_event", "wait", "events", "device")

    def __enter__(self):
        trace = self.trace
        stack = trace._stack()
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            if self.window is None:
                self.window = self.parent.window
            if self.launch is None:
                self.launch = self.parent.launch
        stack.append(self)
        trace.spans.append(self)
        if self.events is not None:
            self.events = trace._event_pair()
            if self.events is not None:
                self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        stack = self.trace._stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class Launch:
    """One launch of a device program while recording: its name, the span
    it was made in, its CUDA events (placed on the host clock in ``device``
    by Trace.stop) and, for a program captured armed, each loop node's
    device seconds (``loops``, set when its Result is fetched)."""

    __slots__ = ("program", "parent", "events", "device", "loops")

    def __init__(self, program: str, parent, events):
        self.program, self.parent, self.events = program, parent, events
        self.device = None
        self.loops = None


class Trace:
    """The process's trace (``TRACE``). ``start()`` clears it and records
    until ``stop()``; ``span(name, ...)`` is a context manager that records a
    host span on time.perf_counter with its parent (the innermost open span
    of its thread) and a few attributes (``window``, ``launch``: inherited
    from the parent where not given; ``program``; ``t_event``, an event
    time; ``wait``: the host blocks on the card there); ``mark`` records an
    instant. While not recording, ``span`` returns one shared no-op context
    manager and ``mark`` returns at once: nothing else is done and the card
    is not touched.

    ``enable()`` arms the device clocks: a program built after it
    (ops/device_loop.Program) times its loop nodes on the card, and while
    recording with a CUDA anchor each launch (``Launch``) and each span
    opened with ``device=True`` records a CUDA event at each end. ``start()``
    on an armed trace synchronizes the card, records the anchor event and
    notes perf_counter; ``stop()`` synchronizes and places every event on the
    spans' clock."""

    def __init__(self):
        self.recording = False
        self.armed = False
        self._local = threading.local()
        self.spans: list = []
        self.marks: list = []
        self.launches: list = []
        self._anchor = None
        self.host0 = self.t_start = self.t_stop = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- arming and recording ---------------------------------------------
    def enable(self) -> None:
        self.armed = True

    def disable(self) -> None:
        self.armed = False

    def start(self) -> None:
        """Clear everything recorded and record from now on."""
        self.spans, self.marks, self.launches = [], [], []
        self._local = threading.local()
        self._anchor = None
        if self.armed:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
                self._anchor = torch.cuda.Event(enable_timing=True)
                self._anchor.record()
        self.host0 = self.t_start = time.perf_counter()
        self.t_stop = None
        self.recording = True

    def stop(self) -> None:
        """Stop recording; place the device events on the host clock."""
        self.recording = False
        self.t_stop = time.perf_counter()
        anchor = self._anchor
        if anchor is None:
            return
        import torch

        torch.cuda.synchronize()

        def place(events):
            try:
                return (self.host0 + anchor.elapsed_time(events[0]) / 1e3,
                        self.host0 + anchor.elapsed_time(events[1]) / 1e3)
            except RuntimeError:  # an event on another device, or never recorded
                return None

        for rec in self.spans + self.launches:
            if rec.events is not None and rec.device is None:
                rec.device = place(rec.events)

    def _event_pair(self):
        if self._anchor is None:
            return None
        import torch

        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    # -- records ------------------------------------------------------------
    def span(self, name: str, *, device: bool = False, wait: bool = False, window=None,
             launch=None, program=None, t_event=None):
        if not self.recording:
            return _NOOP
        s = Span()
        s.trace, s.name, s.t1, s.wait = self, name, None, wait
        s.window, s.launch, s.program, s.t_event = window, launch, program, t_event
        s.events = () if device else None
        s.device = None
        return s

    def mark(self, name: str, *, window=None, t_end=None, t_event=None) -> None:
        if self.recording:
            self.marks.append((name, time.perf_counter(), window, t_end, t_event))

    def launch(self, program: str):
        """A Launch of ``program`` whose events the caller records around
        the launch, or None (not recording, or no CUDA anchor)."""
        if not self.recording or self._anchor is None:
            return None
        stack = self._stack()
        rec = Launch(program, stack[-1] if stack else None, self._event_pair())
        self.launches.append(rec)
        return rec

    def records(self) -> dict:
        """Everything recorded, as plain data on the spans' clock (seconds of
        time.perf_counter): spans (``parent`` the index of the parent span),
        marks, launches (``parent`` likewise; ``device`` [start, end] or
        None; ``loops`` {node path: seconds} or None) and, where a span or a
        launch recorded CUDA events, their intervals."""
        ids = {id(s): i for i, s in enumerate(self.spans)}
        t_stop = self.t_stop if self.t_stop is not None else time.perf_counter()

        def parent(s):
            return None if s.parent is None else ids.get(id(s.parent))

        spans = [{"name": s.name, "t0": s.t0, "t1": s.t1 if s.t1 is not None else t_stop,
                  "parent": parent(s), "window": s.window, "launch": s.launch,
                  "program": s.program, "t_event": s.t_event, "wait": s.wait,
                  "device": None if s.device is None else list(s.device)}
                 for s in self.spans]
        marks = [{"name": n, "t": t, "window": w, "t_end": te, "t_event": tv}
                 for n, t, w, te, tv in self.marks]
        launches = [{"program": r.program, "parent": parent(r),
                     "device": None if r.device is None else list(r.device),
                     "loops": r.loops} for r in self.launches]
        return {"t_start": self.t_start, "t_stop": t_stop, "spans": spans, "marks": marks,
                "launches": launches}


TRACE = Trace()


# -- what the records say ---------------------------------------------------

def _children(spans: list) -> dict:
    kids: dict = defaultdict(list)
    for i, s in enumerate(spans):
        kids[s["parent"]].append(i)
    return kids


def _outer_waits(spans: list, kids: dict, i: int) -> float:
    """Host seconds of the wait spans inside span ``i`` (a wait inside a
    wait counted once)."""
    total = 0.0
    for k in kids.get(i, ()):
        s = spans[k]
        total += s["t1"] - s["t0"] if s["wait"] else _outer_waits(spans, kids, k)
    return total


def self_time(rec: dict, name: str) -> float:
    """Host seconds in the spans named ``name`` (none counted twice where
    one holds another) less the wait spans inside them."""
    spans = rec["spans"]
    kids = _children(spans)
    total = 0.0
    for i, s in enumerate(spans):
        if s["name"] != name or any(spans[a]["name"] == name for a in _ancestors(spans, i)):
            continue
        total += (s["t1"] - s["t0"]) - _outer_waits(spans, kids, i)
    return total


def wait_time(rec: dict) -> float:
    """Host seconds in wait spans (a wait inside a wait counted once)."""
    spans = rec["spans"]
    total = 0.0
    for i, s in enumerate(spans):
        if s["wait"] and not any(spans[a]["wait"] for a in _ancestors(spans, i)):
            total += s["t1"] - s["t0"]
    return total


def _ancestors(spans: list, i: int):
    p = spans[i]["parent"]
    while p is not None:
        yield p
        p = spans[p]["parent"]


def coverage(rec: dict, name: str) -> float | None:
    """The share of the host time of the spans named ``name`` that their
    direct children cover; None where there is no such span."""
    spans = rec["spans"]
    kids = _children(spans)
    whole = covered = 0.0
    for i, s in enumerate(spans):
        if s["name"] != name:
            continue
        whole += s["t1"] - s["t0"]
        covered += sum(spans[k]["t1"] - spans[k]["t0"] for k in kids.get(i, ()))
    return covered / whole if whole > 0 else None


def window_latencies(rec: dict) -> list:
    """[(window index, seconds)] for each ``backend.result`` mark that
    carries its window's last event time: from the start of the first
    ``system.push`` whose last event is at or after that time to the mark.
    A window whose push would be the first one recorded is left out: its
    last event may have come in a push before the recording."""
    pushes = sorted((s["t0"], s["t_event"]) for s in rec["spans"]
                    if s["name"] == "system.push" and s["t_event"] is not None)
    out = []
    for m in rec["marks"]:
        if m["name"] != "backend.result" or m["t_event"] is None:
            continue
        k = next((k for k, (_, tv) in enumerate(pushes) if tv >= m["t_event"]), None)
        if k and pushes[k][0] <= m["t"]:
            out.append((m["window"], m["t"] - pushes[k][0]))
    return out


def held_times(rec: dict) -> list:
    """[(window index, seconds)] for each window whose program ran while
    recording and whose finish began while recording: from the device end
    of the window's program (its first launch under ``backend.solve``) to
    the start of its ``backend.finish`` span."""
    spans = rec["spans"]
    ends = {}
    for r in rec["launches"]:
        p = r["parent"]
        if r["device"] is None or p is None:
            continue
        names = {spans[a]["name"] for a in (p, *_ancestors(spans, p))}
        w = spans[p]["window"]
        if "backend.solve" in names and w is not None and w not in ends:
            ends[w] = r["device"][1]
    out = []
    for s in spans:
        if s["name"] == "backend.finish" and s["window"] in ends:
            out.append((s["window"], s["t0"] - ends[s["window"]]))
    return out


def device_intervals(rec: dict) -> list:
    """[(name, start, end)] of every device interval: each launch under its
    program's name, each device span under its own."""
    out = [(r["program"], *r["device"]) for r in rec["launches"] if r["device"]]
    out += [(s["name"], *s["device"]) for s in rec["spans"] if s["device"]]
    return out


def union(intervals, lo: float, hi: float) -> list:
    """The union of [(start, end)] clipped to [lo, hi], as sorted disjoint
    [start, end] pairs."""
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_time(rec: dict, lo: float | None = None, hi: float | None = None) -> float:
    """Seconds in [lo, hi] (default: the recording) in which some device
    interval was open."""
    lo = rec["t_start"] if lo is None else lo
    hi = rec["t_stop"] if hi is None else hi
    return sum(b - a for a, b in union([(a, b) for _, a, b in device_intervals(rec)], lo, hi))


def loop_split(rec: dict) -> dict:
    """Device seconds of each program split into its outermost loop nodes
    (``<program>/<node>``) and the rest (``<program>/rest``): over the
    launches that timed their loops, the parts sum to their launch
    intervals."""
    out: dict = defaultdict(float)
    for r in rec["launches"]:
        if r["device"] is None or r["loops"] is None:
            continue
        whole = r["device"][1] - r["device"][0]
        outer = 0.0
        for path, s in r["loops"].items():
            if "/" not in path:
                out[f"{r['program']}/{path}"] += s
                outer += s
        out[f"{r['program']}/rest"] += whole - outer
    return dict(out)


def innermost(rec: dict, t: float) -> str | None:
    """The name of the innermost (shortest) span open at host time ``t``."""
    best = None
    for s in rec["spans"]:
        if s["t0"] <= t <= s["t1"] and (best is None or s["t1"] - s["t0"] < best[1]):
            best = (s["name"], s["t1"] - s["t0"])
    return best[0] if best else None


def chrome_trace(rec: dict) -> dict:
    """The records as one Chrome-trace JSON object (chrome://tracing,
    Perfetto): the host's spans and marks by thread 1, each device interval
    by thread 2, each loop node's total as a counter on its launch, all in
    microseconds from the start of the recording."""
    t0 = rec["t_start"] or 0.0

    def us(t):
        return (t - t0) * 1e6

    events = [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "cmax_slam_tpu_torch"}},
              {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1, "args": {"name": "host"}},
              {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2, "args": {"name": "device"}}]
    for s in rec["spans"]:
        args = {k: s[k] for k in ("window", "launch", "program", "t_event") if s[k] is not None}
        if s["wait"]:
            args["wait"] = True
        events.append({"name": s["name"], "ph": "X", "pid": 1, "tid": 1, "ts": us(s["t0"]),
                       "dur": (s["t1"] - s["t0"]) * 1e6, "args": args})
    for m in rec["marks"]:
        args = {k: m[k] for k in ("window", "t_end", "t_event") if m[k] is not None}
        events.append({"name": m["name"], "ph": "i", "s": "t", "pid": 1, "tid": 1,
                       "ts": us(m["t"]), "args": args})
    for name, a, b in device_intervals(rec):
        events.append({"name": name, "ph": "X", "pid": 1, "tid": 2, "ts": us(a),
                       "dur": (b - a) * 1e6})
    for r in rec["launches"]:
        if r["device"] and r["loops"]:
            events.append({"name": f"{r['program']} loops", "ph": "C", "pid": 1,
                           "ts": us(r["device"][0]),
                           "args": {k: v * 1e3 for k, v in r["loops"].items()}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str) -> None:
    """Write TRACE's records to ``path`` as Chrome-trace JSON."""
    with open(path, "w") as f:
        json.dump(chrome_trace(TRACE.records()), f)
