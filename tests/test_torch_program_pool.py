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
"""

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
