"""The readers of pb/program_trace.py on synthetic records: a run's record
whose "program_trace" holds the port's trace records (spans, marks,
launches), built by hand, so each reading is known."""

import pytest

from pb import program_trace


def _span(name, t0, t1, parent=None, **kw):
    s = {"name": name, "t0": t0, "t1": t1, "parent": parent, "window": None, "launch": None,
         "program": None, "t_event": None, "wait": False, "device": None}
    s.update(kw)
    return s


def _record():
    """A 20 s window of 2 stream seconds: three pushes (the first recorded
    carries no window), a back-end step that waits, finishes window 3 and
    dispatches window 4, a flush that finishes window 4."""
    spans = [
        _span("system.push", 0.0, 1.0, t_event=0.90),                        # 0
        _span("system.push", 2.0, 10.0, t_event=1.00),                       # 1
        _span("frontend.push", 2.0, 4.0, 1),                                 # 2
        _span("device_loop.wait", 2.5, 3.0, 2, wait=True),                   # 3
        _span("backend.step", 4.0, 9.0, 1, window=4),                        # 4
        _span("backend.fetch", 4.0, 6.0, 4),                                 # 5
        _span("device_loop.wait", 4.0, 5.5, 5, wait=True),                   # 6
        _span("backend.finish", 6.0, 7.0, 4, window=3),                      # 7
        _span("backend.solve", 7.0, 8.5, 4, window=4),                       # 8
        _span("system.push", 11.0, 13.0, t_event=1.10),                      # 9
        _span("frontend.push", 11.0, 12.0, 9),                               # 10
        _span("system.flush", 14.0, 16.0),                                   # 11
        _span("backend.finish", 14.5, 15.5, 11, window=4),                   # 12
        _span("backend.upload", 7.5, 7.6, 8, device=[7.6, 8.0]),             # 13
    ]
    launches = [{"program": "backend.crop", "parent": 8, "device": [8.0, 12.0],
                 "loops": {"cg": 3.0, "cg/secant": 2.0}},
                {"program": "frontend", "parent": 2, "device": [2.2, 2.9],
                 "loops": {"lanes": 0.5}}]
    marks = [{"name": "backend.result", "t": 6.8, "window": 3, "t_end": 1.0, "t_event": 0.95},
             {"name": "backend.result", "t": 15.4, "window": 4, "t_end": 1.1,
              "t_event": 1.05}]
    trace = {"t_start": 0.0, "t_stop": 20.0, "spans": spans, "marks": marks,
             "launches": launches}
    return {"window_s": 20.0, "stream_s": 2.0, "windows": 2, "program_trace": trace}


def test_the_six_readers_read_the_hand_built_record():
    rec = _record()
    # Window 3's last event (0.95) came in the push at 2.0, window 4's (1.05)
    # in the one at 11.0: latencies 4.8 and 4.4 s.
    assert program_trace.window_latencies_s(rec) == [(3, pytest.approx(4.8)),
                                                     (4, pytest.approx(4.4))]
    p95 = program_trace.system_window_result_p95_ms(rec)
    assert p95 == pytest.approx(1e3 * (4.4 + 0.95 * 0.4))
    # Window 4's program ended at 12.0 and its finish began at 14.5.
    assert program_trace.backend_held_ms_per_window(rec) == pytest.approx(2.5e3)
    # backend.step: 5.0 s less its 1.5 s wait, over 2 windows.
    assert program_trace.backend_host_self_ms_per_window(rec) == pytest.approx(1.75e3)
    # frontend.push: 2.0 - 0.5 + 1.0 s over 2 stream seconds.
    assert program_trace.frontend_host_self_ms_per_stream_s(rec) == pytest.approx(1.25e3)
    assert program_trace.device_loop_wait_ms_per_stream_s(rec) == pytest.approx(1e3)
    # Busy: [2.2, 2.9] and [7.6, 12.0] of 20 s.
    assert program_trace.device_idle_share_program(rec) == pytest.approx(
        100 * (1 - (0.7 + 4.4) / 20))
    assert set(program_trace.READERS) == {
        "system.window_result_p95_ms", "backend.held_ms_per_window",
        "backend.host_self_ms_per_window", "frontend.host_self_ms_per_stream_s",
        "device_loop.wait_ms_per_stream_s", "device.idle_share_program"}


def test_readers_read_nothing_without_a_trace():
    for rec in ({"window_s": 1.0, "stream_s": 1.0, "windows": 3},
                {"window_s": 1.0, "stream_s": 1.0, "windows": 3,
                 "program_trace": {"t_start": 0.0, "t_stop": 1.0, "spans": [], "marks": [],
                                   "launches": []}}):
        for name, read in program_trace.READERS.items():
            assert read(rec) is None, name
    assert program_trace.breakdown({"window_s": 1.0}) is None


def test_breakdown_splits_programs_by_loop_node_and_names_gaps_by_span():
    rec = _record()
    bd = program_trace.breakdown(rec)
    ops = dict(bd["device_ops"])
    assert ops == {"backend.crop/cg": pytest.approx(3.0), "backend.crop/rest": pytest.approx(1.0),
                   "frontend/lanes": pytest.approx(0.5), "frontend/rest": pytest.approx(0.2),
                   "backend.upload": pytest.approx(0.4)}
    gaps = {round(d, 6): name for name, d in bd["idle_gaps"]}
    # [0, 2.2]: its middle (1.1) in no span; [2.9, 7.6]: its middle (5.25)
    # in the back-end's wait; [12.0, 20.0]: its middle (16.0) at the
    # flush's end.
    assert gaps == {2.2: "host.between_calls", 4.7: "device_loop.wait", 8.0: "system.flush"}
    sp = program_trace.split(rec)
    assert sp["coverage"]["backend.step"] == pytest.approx(4.5 / 5.0)
    assert sp["self_s"]["device_loop.wait"] == pytest.approx(2.0)
