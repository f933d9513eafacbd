"""What a traced run records: the device programs' CUDA-event intervals
(ProgramTimes), the host's spans around the calls into each layer, the
kernels torch.profiler sees, and the host's synchronizing calls (SyncAudit).
Nothing here is imported by the program; each hook is put on for the traced
window and taken off after it."""

from __future__ import annotations

import os
import sys
import time


class ProgramTimes:
    """Device time of each device program's launches over a block, by program
    name ("frontend", "backend.crop", "backend.full", "batched.round"): a
    CUDA event before and after each launch of a program, kept where the
    launch captured no graph (device_loop.CAPTURES does not move: a first
    run, which captures, is not timed). The launches queue on one stream in
    order, so the events bracket each graph's execution. Copied from
    chip_smoke.py's ProgramTimes; here each interval is also placed on the
    window's device clock (``anchor``), and only the program's public names
    are read (Program.run, Program.name, Program.device, CAPTURES)."""

    def __init__(self, anchor):
        self.anchor, self.marks = anchor, []

    def __enter__(self):
        import torch
        from cmax_slam_tpu_torch.ops import device_loop

        self._run = run = attach(device_loop.Program, "run")
        marks, captures = self.marks, device_loop.CAPTURES

        def timed(prog):
            if prog.device.type != "cuda":
                return run(prog)
            n = captures["graphs"]
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = run(prog)
            b.record()
            if captures["graphs"] == n:
                marks.append((prog.name, a, b))
            return out

        device_loop.Program.run = timed
        return self

    def __exit__(self, *exc):
        from cmax_slam_tpu_torch.ops import device_loop

        device_loop.Program.run = self._run
        return False

    def intervals(self) -> list:
        """[(name, start ms, end ms)] on the anchor's clock; waits for the
        last event."""
        if self.marks:
            self.marks[-1][2].synchronize()
        return [(name, self.anchor.elapsed_time(a), self.anchor.elapsed_time(b))
                for name, a, b in self.marks]


def attach(obj, attr: str):
    """``obj.attr``, a public callable of the program that a hook replaces;
    fails loudly where the program no longer has it."""
    fn = getattr(obj, attr, None)
    if attr.startswith("_") or not callable(fn):
        raise AttributeError(f"portbench: no public callable {type(obj).__name__}.{attr} "
                             "to attach a hook to")
    return fn


class Spans:
    """Host spans (name, start, end) on time.perf_counter, kept in memory."""

    def __init__(self):
        self.spans = []

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.attr`` (a public bound method) by one that records a
        span."""
        fn = attach(obj, attr)
        spans = self.spans

        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter()))

        setattr(obj, attr, spanned)

    def at(self, t: float) -> str:
        """The innermost (shortest) span around host time ``t``."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host.between_calls"


def _site(frame, root: str, skip=()) -> str:
    while frame.f_back is not None and frame.f_code.co_name in skip:
        frame = frame.f_back
    path = os.path.relpath(frame.f_code.co_filename, root)
    return f"{path}:{frame.f_lineno} {frame.f_code.co_name}"


class SyncAudit:
    """The host's waits for the card over a block, by call site: every call
    that synchronizes the host with the card as
    torch.cuda.set_sync_debug_mode("warn") reports it, and the explicit waits
    on device programs' results (device_loop.fetch_all with a result not yet
    fetched). Copied from chip_smoke.py's SyncAudit, reading only the
    program's public names; a capture inside the block counts its syncs too."""

    _WAIT_FRAMES = ("fetch_all", "fetch", "finalize_batch", "_fetch", "counted_fetch")

    def __init__(self, root: str):
        self.root = root
        self.syncs, self.waits = {}, {}

    def __enter__(self):
        import warnings

        from cmax_slam_tpu_torch.ops import device_loop

        audit, root = self, self.root
        self._fetch_all = fetch_all = attach(device_loop, "fetch_all")

        def counted_fetch(results):
            if any(not r.fetched for r in results):
                site = _site(sys._getframe(1), root, self._WAIT_FRAMES)
                audit.waits[site] = audit.waits.get(site, 0) + 1
            return fetch_all(results)

        device_loop.fetch_all = counted_fetch
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            site = f"{os.path.relpath(filename, root)}:{lineno}"
            audit.syncs[site] = audit.syncs.get(site, 0) + 1
            return None

        self._set_mode("warn")
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
        from cmax_slam_tpu_torch.ops import device_loop

        self._warnings.__exit__(*exc)
        self._set_mode("default")
        device_loop.fetch_all = self._fetch_all
        return False

    def report(self) -> dict:
        return {"syncs": sum(self.syncs.values()), "event_waits": sum(self.waits.values()),
                "syncs_by_site": dict(sorted(self.syncs.items(), key=lambda kv: -kv[1])[:8]),
                "event_waits_by_site": dict(sorted(self.waits.items(),
                                                   key=lambda kv: -kv[1])[:8])}


class DeviceTrace:
    """The traced window's device timeline: torch.profiler's kernels, copies
    and fills (those it sees), the device programs' CUDA-event intervals,
    and a marker that puts the profiler's clock on the anchor's. ``open``
    starts the profiler and synchronizes; ``start``, on an idle device,
    records the anchor, notes the host time and launches the marker, so
    device time 0 is host time ``host0``; ``stop`` records the end and
    synchronizes; ``close`` stops the profiler."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self._marker = torch.empty(7, device="cuda")

    def open(self) -> None:
        self.prof.__enter__()
        self.torch.cuda.synchronize()

    def start(self) -> None:
        self.anchor.record()
        self.host0 = time.perf_counter()
        self._marker.fill_(1.0)

    def stop(self) -> None:
        self.end.record()
        self.torch.cuda.synchronize()

    def close(self) -> None:
        self.prof.__exit__(None, None, None)

    def kernels(self) -> list:
        """[(name, start ms, end ms)] of the device activity the profiler
        recorded, on the anchor's clock (read from kineto's raw events)."""
        cuda = self.torch.autograd.DeviceType.CUDA
        evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda and e.duration_ns() > 0]
        if not evs:
            return []
        fills = [a for name, a, _ in evs if "fill" in name.lower()]
        zero = min(fills) if fills else min(a for _, a, _ in evs)
        return [(name, (a - zero) / 1e6, (b - zero) / 1e6) for name, a, b in evs]

    def end_ms(self) -> float:
        return self.anchor.elapsed_time(self.end)


def union(intervals, lo: float, hi: float) -> list:
    """The union of [(start, end)] clipped to [lo, hi], as sorted disjoint
    intervals."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
