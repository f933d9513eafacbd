"""The port's trace (utils/metrics.TRACE) on the CPU, and its loop clocks on
a card.

(1) A small system run with the trace off and on gives bit-identical
    estimates, knots and map; off, it records nothing.
(2) On, each ``system.push`` holds its ``frontend.push`` and
    ``backend.step``; each completed window has one ``backend.result``
    mark with its index; every window's latency is at least 0; the timers
    keep their counts, and each is a span of its name.
(3) The readers of the records (self time, waits, coverage, latencies,
    held times, busy time, the loop split) on a hand-built tree of spans.
(4) Card only (``card`` marker; skips without a card): a ``repeat`` whose
    body sleeps on the card reads its loop time within 10% of the sleeps'
    CUDA-event time, and the same program built unarmed has no clock slot
    and the same counts. Run on a card without tests/conftest.py (which
    imports jax): ``python -m pytest --noconftest -p no:cacheprovider
    tests/test_torch_trace.py -m card``.

This file imports neither jax nor another test module.
"""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import ijrr_config, replace
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops import device_loop
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils import metrics
from cmax_slam_tpu_torch.utils.metrics import TRACE

W, H, F = 120, 90, 90.0
OVERRIDES = {"frontend.dt_ang_vel": 0.02, "backend.pano_map.pano_height": 256,
             "backend.pano_map.pano_width": 512}
CHUNKS = (3000, 8000, 1500, 6000)  # cycled: strides and single-packet launches


def _run(traced: bool):
    """The system on a 0.5 s stream in chunks of mixed sizes; traced, the
    trace armed before the system is built and recording over the pushes
    and the flush. Returns (system, the trace's records or None)."""
    ev = synthetic.rotating_camera_events(np.random.default_rng(3), 40_000, 0.5,
                                          np.array([0.4, -0.6, 0.9]), F, F, W / 2, H / 2, W, H,
                                          n_points=250)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    if traced:
        TRACE.enable()
    try:
        slam = CMaxSLAM(CameraCalibration(width=W, height=H, K=K),
                        replace(ijrr_config(num_events_per_packet=4000), **OVERRIDES),
                        device="cpu")
        if traced:
            TRACE.start()
        i, k = 0, 0
        while i < len(ev.ts):
            j = min(i + CHUNKS[k % len(CHUNKS)], len(ev.ts))
            slam.push_events(ev.xs[i:j], ev.ys[i:j], ev.ts[i:j], ev.pols[i:j])
            i, k = j, k + 1
        slam.flush()
        rec = None
        if traced:
            TRACE.stop()
            rec = TRACE.records()
    finally:
        TRACE.stop()
        TRACE.disable()
    return slam, rec


@pytest.fixture(scope="module")
def runs():
    TRACE.start()  # clears what an earlier test recorded
    TRACE.stop()
    off, _ = _run(False)
    untouched = (len(TRACE.spans), len(TRACE.marks), len(TRACE.launches))
    on, rec = _run(True)
    return off, on, rec, untouched


def test_tracing_changes_no_number_and_off_records_nothing(runs):
    off, on, _, untouched = runs
    assert untouched == (0, 0, 0)
    assert np.array_equal(off.ang_vel_log, on.ang_vel_log)
    assert np.array_equal(off.backend.traj.knots, on.backend.traj.knots)
    assert torch.equal(off.backend.IG, on.backend.IG)
    assert torch.equal(off.backend.update_times, on.backend.update_times)
    assert len(off.backend.results) == len(on.backend.results) >= 3


def test_each_push_holds_its_frontend_push_and_backend_steps(runs):
    _, on, rec, _ = runs
    spans = rec["spans"]
    pushes = [i for i, s in enumerate(spans) if s["name"] == "system.push"]
    assert pushes
    for name in ("frontend.push", "backend.step"):
        found = [s for s in spans if s["name"] == name]
        assert found
        assert all(spans[s["parent"]]["name"] == "system.push" for s in found)
    fronts = [s["parent"] for s in spans if s["name"] == "frontend.push"]
    assert sorted(fronts) == pushes  # one front-end push in each push
    for s in spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]


def test_each_window_has_one_result_mark_and_a_latency_of_at_least_zero(runs):
    _, on, rec, _ = runs
    marks = [m for m in rec["marks"] if m["name"] == "backend.result"]
    assert sorted(m["window"] for m in marks) == sorted(r.index for r in on.backend.results)
    for m in marks:
        r = next(r for r in on.backend.results if r.index == m["window"])
        assert m["t_end"] == r.t_end and m["t_event"] < r.t_end
    lat = metrics.window_latencies(rec)
    assert len(lat) == len(marks)
    assert all(s >= 0 for _, s in lat)
    # Every window that ran its bundle adjustment was finished by a
    # backend.finish span carrying its index, once.
    finished = [s["window"] for s in rec["spans"] if s["name"] == "backend.finish"]
    assert sorted(finished) == sorted(r.index for r in on.backend.results if r.ran_ba)


def test_timers_keep_their_counts_and_are_spans(runs):
    off, on, rec, _ = runs
    assert {k: v.count for k, v in off.metrics.timers.items()} == \
        {k: v.count for k, v in on.metrics.timers.items()}
    assert {"frontend.solve", "backend.fetch", "backend.solve"} <= set(on.metrics.timers)
    for name, stat in on.metrics.timers.items():
        assert sum(s["name"] == name for s in rec["spans"]) == stat.count
    assert off.metrics.counters == on.metrics.counters


def test_no_span_is_made_while_not_recording():
    assert not TRACE.recording
    assert TRACE.span("a") is TRACE.span("b", device=True, window=3)
    with TRACE.span("a") as s:
        assert s is TRACE.span("c")
    TRACE.mark("backend.result", window=1)
    TRACE.start()
    TRACE.stop()
    assert TRACE.records()["spans"] == [] and TRACE.records()["marks"] == []


def _span(name, t0, t1, parent=None, **kw):
    s = {"name": name, "t0": t0, "t1": t1, "parent": parent, "window": None, "launch": None,
         "program": None, "t_event": None, "wait": False, "device": None}
    s.update(kw)
    return s


def _tree():
    """Three pushes: one recorded first, then one that holds a front-end
    push (a wait inside its launch) and a back-end step (a fetch with a wait
    inside, a finish of window 3, a dispatch of window 4 whose program runs
    on the card), then one with a front-end push."""
    spans = [
        _span("system.push", 0.0, 10.0, t_event=1.00),                        # 0
        _span("frontend.push", 0.0, 4.0, 0),                                  # 1
        _span("frontend.launch", 1.0, 3.0, 1, launch=7),                      # 2
        _span("device_loop.wait", 1.5, 2.5, 2, launch=7, wait=True),          # 3
        _span("backend.step", 4.0, 9.5, 0, window=4),                         # 4
        _span("backend.fetch", 4.0, 6.0, 4, window=4),                        # 5
        _span("device_loop.wait", 4.5, 5.5, 5, window=4, wait=True),          # 6
        _span("device_loop.wait", 5.0, 5.2, 6, window=4, wait=True),          # 7: inside 6
        _span("backend.finish", 6.0, 7.0, 4, window=3),                       # 8
        _span("backend.solve", 7.0, 9.0, 4, window=4),                        # 9
        _span("backend.upload", 7.2, 7.4, 9, window=4, device=[7.3, 7.8]),    # 10
        _span("system.push", 12.0, 15.0, t_event=1.05),                       # 11
        _span("frontend.push", 12.0, 14.0, 11),                               # 12
        _span("system.push", -3.0, -1.0, t_event=0.95),                       # 13: the first
    ]
    launches = [
        {"program": "backend.crop", "parent": 9, "device": [7.8, 11.0],
         "loops": {"cg": 2.0, "cg/secant": 1.5, "cg/bracket": 0.2}},
        {"program": "frontend", "parent": 2, "device": [1.2, 2.4],
         "loops": {"lanes": 1.0, "lanes/live/fine": 0.9}},
        {"program": "backend.full", "parent": 8, "device": [6.5, 6.9], "loops": None},
    ]
    marks = [{"name": "backend.result", "t": 6.9, "window": 3, "t_end": 1.0, "t_event": 0.99},
             {"name": "backend.result", "t": 14.5, "window": 4, "t_end": 1.1,
              "t_event": 1.02},
             {"name": "backend.result", "t": 16.0, "window": 5, "t_end": 1.2,
              "t_event": 1.2}]  # no push carried its last event yet
    return {"t_start": 0.0, "t_stop": 20.0, "spans": spans, "marks": marks,
            "launches": launches}


def test_readers_on_a_hand_built_tree():
    rec = _tree()
    # Host time less the waits inside (the nested wait counted once).
    assert metrics.self_time(rec, "frontend.push") == pytest.approx((4.0 - 1.0) + 2.0)
    assert metrics.self_time(rec, "backend.step") == pytest.approx(5.5 - 1.0)
    assert metrics.self_time(rec, "system.push") == pytest.approx(10.0 - 2.0 + 3.0 + 2.0)
    assert metrics.wait_time(rec) == pytest.approx(1.0 + 1.0)
    # Direct children over the parents: backend.step 5.0 of 5.5.
    assert metrics.coverage(rec, "backend.step") == pytest.approx(5.0 / 5.5)
    assert metrics.coverage(rec, "frontend.push") == pytest.approx(2.0 / 6.0)
    assert metrics.coverage(rec, "no.such.span") is None
    # Window 3's last event (0.99) was in the push at 0.0; window 4's (1.02)
    # in the one at 12.0; window 5's in none. A window whose last event
    # matched the first push recorded (at -3.0) would be left out.
    assert metrics.window_latencies(rec) == [(3, pytest.approx(6.9)),
                                             (4, pytest.approx(14.5 - 12.0))]
    # Window 4's program (launched under backend.solve) ended at 11.0; its
    # finish is not in the records. Window 3's program is not either.
    assert metrics.held_times(rec) == []
    rec["spans"].append(_span("backend.finish", 13.0, 13.5, 12, window=4))
    assert metrics.held_times(rec) == [(4, pytest.approx(2.0))]
    # Busy: [1.2, 2.4] + [6.5, 6.9] + [7.3, 11.0].
    assert metrics.busy_time(rec) == pytest.approx(1.2 + 0.4 + 3.7)
    assert metrics.busy_time(rec, 2.0, 7.5) == pytest.approx(0.4 + 0.4 + 0.2)
    split = metrics.loop_split(rec)
    assert split == {"backend.crop/cg": pytest.approx(2.0),
                     "backend.crop/rest": pytest.approx(3.2 - 2.0),
                     "frontend/lanes": pytest.approx(1.0),
                     "frontend/rest": pytest.approx(1.2 - 1.0)}
    assert metrics.innermost(rec, 5.1) == "device_loop.wait"
    assert metrics.innermost(rec, 11.0) is None
    trace = metrics.chrome_trace(rec)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"system.push", "backend.result", "backend.crop", "backend.upload",
            "backend.crop loops"} <= names


def test_loop_split_takes_a_restarted_solve_apart():
    """A window program with a restarted solve: its loop nodes (``restart/cg``
    and its children) are timed apart from the first solve's ``cg``."""
    rec = _tree()
    rec["launches"] = [{"program": "backend.crop", "parent": 9, "device": [7.8, 11.0],
                        "loops": {"cg": 2.0, "cg/bracket": 1.2, "cg/secant": 0.5,
                                  "restart/cg": 0.7, "restart/cg/bracket": 0.4,
                                  "restart/cg/secant": 0.2}}]
    assert metrics.loop_split(rec) == {"backend.crop/cg": pytest.approx(2.0),
                                       "backend.crop/restart/cg": pytest.approx(0.7),
                                       "backend.crop/rest": pytest.approx(3.2 - 2.7)}


def test_a_recording_trace_nests_spans_by_thread_and_inherits_attributes():
    import threading

    TRACE.start()
    try:
        with TRACE.span("outer", window=5):
            with TRACE.span("inner", launch=2) as inner:
                TRACE.mark("m", window=1)
            other = []
            t = threading.Thread(target=lambda: other.append(TRACE.span("side").__enter__()))
            t.start()
            t.join()
    finally:
        TRACE.stop()
    rec = TRACE.records()
    by = {s["name"]: s for s in rec["spans"]}
    assert by["inner"]["parent"] == 0 and by["inner"]["window"] == 5
    assert by["inner"]["launch"] == 2 and inner.device is None
    assert by["side"]["parent"] is None  # another thread's stack
    assert rec["marks"][0]["window"] == 1


def test_cli_writes_its_trace(tmp_path):
    """``--trace FILE``: the run's spans and marks as Chrome-trace JSON."""
    import json

    from cmax_slam_tpu_torch import cli

    ev = synthetic.rotating_camera_events(np.random.default_rng(5), 30_000, 0.4,
                                          np.array([0.3, -0.5, 0.7]), F, F, W / 2, H / 2, W, H,
                                          n_points=250)
    events = tmp_path / "events.txt"
    np.savetxt(events, np.stack([ev.ts, ev.xs, ev.ys, ev.pols], 1), fmt="%.9f %d %d %d")
    calib = tmp_path / "calib.txt"
    calib.write_text(f"{F} {F} {W / 2} {H / 2} 0 0 0 0 0\n")
    out = tmp_path / "trace.json"
    rc = cli.main(["--device", "cpu", "--events", str(events), "--calib", str(calib),
                   "--width", str(W), "--height", str(H), "--out-dir", str(tmp_path / "out"),
                   "--preset", "ijrr", "--chunk-size", "5000", "--trace", str(out),
                   "--set", "frontend.num_events_per_packet=4000",
                   "--set", "frontend.dt_ang_vel=0.02",
                   "--set", "backend.pano_map.pano_height=256",
                   "--set", "backend.pano_map.pano_width=512"])
    assert rc == 0
    events_out = json.loads(out.read_text())["traceEvents"]
    names = [e["name"] for e in events_out]
    assert names.count("system.push") >= 5 and "backend.result" in names
    assert not TRACE.recording and not TRACE.armed


# -- on a card ----------------------------------------------------------------

SLEEP_CYCLES = 2_000_000  # about a millisecond on an H100
TRIPS = 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sleepy(dev, name="sleepy"):
    """A program whose one loop runs TRIPS bodies, each a sleep on the card
    and the counter's step."""
    mask = device_loop.gate(dev)
    n = torch.zeros(1, dtype=torch.int32, device=dev)
    trips = device_loop.limit(TRIPS, dev)

    def start():
        n.zero_()
        mask.fill_(True)

    def body():
        torch.cuda._sleep(SLEEP_CYCLES)
        n.add_(1)

    def build(b):
        b.seg(start)
        b.repeat(device_loop.Gate(mask, n, trips), lambda: b.seg(body), name=name)
        b.seg(lambda: prog.out.copy_(n.float()))

    prog = device_loop.Program(build, 1, dev, name="sleepy")
    return prog


@pytest.mark.card
def test_loop_clock_reads_the_sleeps_cuda_event_time(card):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(TRIPS):
        torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    sleeps_s = a.elapsed_time(b) / 1e3

    TRACE.enable()
    try:
        armed = _sleepy(card)
    finally:
        TRACE.disable()
    unarmed = _sleepy(card)
    assert armed.clocked and not unarmed.clocked and unarmed._clocks is None
    assert unarmed._readback.numel() == 1 + device_loop.MAX_CONDS
    for prog in (armed, unarmed):
        prog.run().fetch()  # captures
    counts = {}
    for prog in (armed, unarmed):
        before = device_loop.LAUNCHES["pred"]
        TRACE.enable()
        TRACE.start()
        try:
            assert prog.run().fetch()[0] == TRIPS
        finally:
            TRACE.stop()
            TRACE.disable()
        counts[prog.clocked] = device_loop.LAUNCHES["pred"] - before
        rec = TRACE.records()
        (launch,) = rec["launches"]
        if prog.clocked:
            loop_s = launch["loops"]["sleepy"]
            assert abs(loop_s - sleeps_s) <= 0.1 * sleeps_s, (loop_s, sleeps_s)
            whole = launch["device"][1] - launch["device"][0]
            assert loop_s <= whole
        else:
            assert launch["loops"] is None
    assert counts[True] == counts[False] == TRIPS + 1
