"""The module-level pool of device programs (cmax_slam_tpu_torch/ops/
program_pool.py), the counterpart of the JAX package's lru_cache'd solver
builders, on the CPU, where the programs run eagerly and the pool's leasing
rules hold all the same.

(a) The lease rules: an owner gets back the entry it holds; a second live
    owner of the same key gets a second entry; an entry whose owner was
    collected goes to the next owner, reset first.
(b) A system built after another of the same configuration is collected
    leases the same front-end and back-end entries, builds no program, and
    reads the same ring; its knots, IG, update_times and ang_vel_log are
    torch.equal to the first's (a reused entry gives a fresh one's results).
(c) Two live systems lease distinct entries and, run concurrently in host
    threads, give the results one system gives alone.
(d) A checkpoint restored into a reused entry continues as one restored
    into a fresh entry, bit for bit, and within the resume gate of
    tests/test_torch_checkpoint_resume.py (0.05 deg RMS) of the
    uninterrupted run.
(e) The replay's concurrent segments lease distinct entries, and a second
    replay, on the entries the first left, stitches the same trajectory.
(f) Memory: a build or capture that runs out of device memory
    (torch.cuda.OutOfMemoryError, raised here by a stand-in) drops the free
    entries of its device, least recently leased first, and succeeds on its
    one retry; a leased entry is never dropped; a second failure raises,
    and other errors are not retried; stats() reports the entries' bytes
    and drops. A system whose window program fails once gives the results
    of one that never failed.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch import spline
from cmax_slam_tpu_torch.io import synthetic
from cmax_slam_tpu_torch.ops import program_pool
from cmax_slam_tpu_torch.parallel import replay
from cmax_slam_tpu_torch.system import CMaxSLAM
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_torch_checkpoint_resume import (CHUNK, FXY, H, OMEGA_TRUE, W, _calib, _cfg,
                                          _push_range)

torch.set_num_threads(1)

N_EVENTS = 40_000


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(21)
    return synthetic.rotating_camera_events(rng, N_EVENTS, 0.5, OMEGA_TRUE, FXY, FXY, W / 2,
                                            H / 2, W, H, n_points=250)


def _system():
    return CMaxSLAM(_calib(), _cfg(), device="cpu")


def _entries(slam):
    return slam.frontend._entry, slam.backend._entry


def _programs(slam):
    return {(i, key): prog for i, e in enumerate(_entries(slam))
            for key, prog in e.programs.items()}


def _result(slam):
    slam.flush()
    be = slam.backend
    return (torch.tensor(be.traj.knots), be.IG.clone(), be.update_times.clone(),
            torch.tensor(slam.ang_vel_log))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _run(stream, slam=None):
    slam = slam if slam is not None else _system()
    _push_range(slam, stream, 0, N_EVENTS)
    return slam, _result(slam)


def test_lease_rules():
    key = ("test_torch_program_pool", "lease rules")
    a, b = program_pool.Owner(), program_pool.Owner()
    ea = program_pool.lease(key, a)
    assert program_pool.lease(key, a) is ea and ea.leases == 1
    eb = program_pool.lease(key, b)
    assert eb is not ea and not ea.free and not eb.free
    del a  # collected: its entry is free for the next owner, reset first
    assert ea.free
    resets = []
    c = program_pool.Owner()
    assert program_pool.lease(key, c, reset=resets.append) is ea and resets == [ea]
    assert ea.leases == 2 and not ea.free
    d = program_pool.Owner()  # both live: a third entry
    ed = program_pool.lease(key, d, reset=resets.append)
    assert ed not in (ea, eb) and resets == [ea] and ed.leases == 1
    del c
    assert ea.free and not eb.free
    assert len(program_pool.ENTRIES[key]) == 3
    stats = program_pool.stats()
    assert stats["entries"] >= 2 and stats["leased"] >= 1


def test_a_later_system_reuses_the_entries_and_builds_nothing(stream):
    first, ref = _run(stream)
    entries, programs, ring = _entries(first), _programs(first), first.frontend._ring
    assert programs and ring is not None
    del first  # the system is collected: its entries are free
    second = _system()
    assert all(a is b for a, b in zip(_entries(second), entries))
    assert second.frontend._ring is ring and ring.hi == 0
    _, got = _run(stream, second)
    assert _programs(second).keys() == programs.keys()
    assert all(_programs(second)[k] is p for k, p in programs.items())
    assert _equal(got, ref)


def test_two_live_systems_lease_distinct_entries(stream):
    _, ref = _run(stream)
    a, b = _system(), _system()
    for ea, eb in zip(_entries(a), _entries(b)):
        assert ea is not eb and ea.key == eb.key
    assert a.frontend._ring is not b.frontend._ring
    results = {}

    def feed(name, slam):
        results[name] = _run(stream, slam)[1]

    threads = [threading.Thread(target=feed, args=item) for item in (("a", a), ("b", b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _equal(results["a"], ref) and _equal(results["b"], ref)


def test_restore_into_a_reused_entry(stream, tmp_path):
    whole, ref = _run(stream)
    entries = _entries(whole)
    del whole
    cut = _system()  # on the entries the uninterrupted run left
    assert all(a is b for a, b in zip(_entries(cut), entries))
    i = 0
    while cut.backend.count_window < 2:
        _push_range(cut, stream, i, i + CHUNK)
        i += CHUNK
    path = str(tmp_path / "cut.npz")
    cut.save_checkpoint(path)
    del cut
    resumed, fresh = _system(), None
    assert all(a is b for a, b in zip(_entries(resumed), entries))
    fresh = _system()  # the reused entries are leased: a fresh pair
    assert all(a is not b for a, b in zip(_entries(fresh), entries))
    out = []
    for slam in (resumed, fresh):
        slam.load_checkpoint(path)
        _push_range(slam, stream, slam.raw_count, N_EVENTS)
        out.append(_result(slam))
    assert _equal(out[0], out[1])
    ta = resumed.backend.traj
    grid = np.linspace(ta.t_beg + 1e-6, ta.max_time() - 1e-6, 100)
    knots = ref[0].numpy()
    q_ref = spline.evaluate_np(knots, grid, ta.t_beg, ta.dt_knots, ta.order)
    rms, _ = rotation_rms_deg(grid, q_ref, ta.evaluate(grid), "global")
    assert rms < 0.05, f"resumed-vs-uninterrupted RMS {rms:.4f} deg"


def test_concurrent_replay_segments_lease_distinct_entries():
    rng = np.random.default_rng(5)
    duration, n = 1.2, 96_000
    ev = synthetic.rotating_camera_events(rng, n, duration, OMEGA_TRUE, FXY, FXY, W / 2, H / 2,
                                          W, H, n_points=250)
    cfg = _cfg()
    runs = []
    for _ in range(2):
        times, quats, segs = replay.replay_multichip(ev.xs, ev.ys, ev.ts, ev.pols, _calib(), cfg,
                                                     n_segments=2, overlap=0.25,
                                                     devices=["cpu", "cpu"])
        a, b = (_entries(s.slam) for s in segs)
        assert all(x is not y for x, y in zip(a, b))
        runs.append((times, quats, [e for s in segs for e in _entries(s.slam)]))
        del segs, a, b
    (t0, q0, e0), (t1, q1, e1) = runs
    assert sorted(map(id, e0)) == sorted(map(id, e1))  # the second replay leased the first's
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(q0, q1)


META = torch.device("meta")  # a device of the tests' own: relieve() drops only its entries


def _oom_once(value="built", times=1):
    """A build that raises torch.cuda.OutOfMemoryError ``times`` times,
    then returns ``value``; ``calls`` counts its calls."""
    calls = []

    def make():
        calls.append(1)
        if len(calls) <= times:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
        return value

    return make, calls


def _meta_entries():
    return [e for entries in program_pool.ENTRIES.values() for e in entries if e.device == META]


def test_out_of_memory_drops_free_entries_oldest_lease_first():
    owners = [program_pool.Owner() for _ in range(4)]
    entries = [program_pool.lease(("oom drop", META, i), o) for i, o in enumerate(owners)]
    for e in entries:
        e.state["buf"] = torch.zeros(4)
        e.programs["p"] = object()
    # Free entries 2 and 0 (leased before 1 and 3); lease entry 2 again, to
    # a new owner that is then collected: its last lease is the newest.
    owners[0] = owners[2] = None
    again = program_pool.Owner()
    assert program_pool.lease(("oom drop", META, 2), again) is entries[2]
    del again
    free = sorted((e for e in _meta_entries() if e.free), key=lambda e: e.last_lease)
    assert free[-2:] == [entries[0], entries[2]]
    dropped0, stats0 = len(program_pool.DROPPED), program_pool.stats()["dropped"]
    make, calls = _oom_once()
    assert entries[1].build(make) == "built" and len(calls) == 2
    assert program_pool.DROPPED[dropped0:] == [(e.key, e.last_lease) for e in free]
    assert program_pool.stats()["dropped"] == stats0 + len(free)
    live = _meta_entries()
    assert entries[1] in live and entries[3] in live
    assert entries[0] not in live and entries[2] not in live
    assert not entries[0].programs and not entries[0].state  # released
    assert entries[1].programs and entries[1].state


def test_a_leased_entry_is_never_dropped():
    owners = [program_pool.Owner() for _ in range(3)]
    entries = [program_pool.lease(("oom leased", META, i), o) for i, o in enumerate(owners)]
    program_pool.relieve(META)  # no free entry of this device is left
    dropped0 = len(program_pool.DROPPED)
    make, calls = _oom_once()
    assert entries[0].build(make) == "built" and len(calls) == 2
    assert program_pool.DROPPED[dropped0:] == []
    assert all(e in _meta_entries() and not e.free for e in entries)


def test_a_second_failure_raises_and_other_errors_are_not_retried():
    owner = program_pool.Owner()
    entry = program_pool.lease(("oom twice", META), owner)
    make, calls = _oom_once(times=2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        entry.build(make)
    assert len(calls) == 2

    def broken():
        calls.append(1)
        raise ValueError("not a memory error")

    with pytest.raises(ValueError):
        entry.build(broken)
    assert len(calls) == 3
    # An error raised while handling an out-of-memory error (a capture
    # that ends after failing) counts as one.
    chained = []

    def capture():
        chained.append(1)
        if len(chained) == 1:
            try:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
            finally:
                raise RuntimeError("capture invalidated")
        return "captured"

    assert entry.build(capture) == "captured" and len(chained) == 2


def test_stats_report_bytes_and_drops(stream):
    slam = _system()
    fe, be = _entries(slam)
    ring = slam.frontend._ring
    assert fe.state_bytes() == ring.capacity * 8 + slam.frontend.lut.untyped_storage().nbytes()
    _push_range(slam, stream, 0, 10_000)
    slam.flush()
    for e in (fe, be):
        for prog in e.programs.values():  # each first capture runs under the entry's build
            assert prog.program.capture_guard == e.build
    stats = program_pool.stats(detail=True)
    for k in ("state_bytes", "allocated_bytes", "reserved_bytes", "dropped"):
        assert k in stats
    assert stats["state_bytes"] >= fe.state_bytes() + be.state_bytes() > 0
    assert stats["allocated_bytes"] == stats["reserved_bytes"] == 0  # the CPU's allocator
    kinds = {p["kind"] for p in stats["by_entry"] if p["leased"]}
    assert {"frontend", "backend"} <= kinds
    assert len(stats["by_entry"]) == stats["entries"]


def test_a_window_program_that_runs_out_of_memory_once(stream, monkeypatch):
    from cmax_slam_tpu_torch import backend
    from cmax_slam_tpu_torch.config import replace

    _, ref = _run(stream)
    cpu = torch.device("cpu")
    gc.collect()
    program_pool.relieve(cpu)  # the next system of this configuration builds from nothing
    other = CMaxSLAM(_calib(), replace(_cfg(), **{"frontend.warp.blur_sigma": 0.9,
                                                  "backend.warp.blur_sigma": 0.9}),
                     device="cpu")
    _push_range(other, stream, 0, N_EVENTS)
    other.flush()
    held = _entries(other)
    assert held[1].programs
    del other
    gc.collect()
    assert all(e.free for e in held)
    make = backend._WindowSolver
    fails = []

    def solver(*args, **kw):
        if not fails:
            fails.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
        return make(*args, **kw)

    monkeypatch.setattr(backend, "_WindowSolver", solver)
    dropped0 = len(program_pool.DROPPED)
    slam, got = _run(stream)
    assert fails == [1]
    assert program_pool.DROPPED[dropped0:] == [
        (e.key, e.last_lease) for e in sorted(held, key=lambda e: e.last_lease)]
    assert not held[1].programs and all(e not in held for e in _entries(slam))
    assert _equal(got, ref)  # the retried build gives the results of one never failed
