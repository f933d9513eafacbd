"""The asynchronous system loop of the port against the JAX package's, on the
CPU. As in the JAX system, the front-end's estimates stay in flight until
the back-end integrates them, and each window's solve completes one step
late: the next step() fetches the window's result and the estimates the
next window needs in one wait.

Two streams, each in chunks of mixed sizes (strides of several packets and
single-packet launches), through tests/test_torch_slice.py's configuration
(120x90 camera, stock ijrr preset with its dataset-scale overrides,
bootstrap re-solve at window 2): "dense" is test_torch_slice.py's stream
(0.5 s, smooth rotation); "sparse" is the same rotation on 0.8 s with the
events of [0.25, 0.55) s thinned to one in 40: the packets there span more
than 10 * dt_ang_vel (degenerate, omega 0) and a window there holds too few
events for BA, so that step() completes a BA window and a BA-skipped one in
one call.

(1) Protocol: after every push, the windows each Backend.step() returned,
    the count of completed windows and the times of the estimates still in
    flight are those of the JAX system, and after flush() so are the window
    decisions, the packet grid and the per-packet omega (test_torch_slice.py's
    tolerances). On the dense stream the trajectories also agree within its
    knot tolerance. On the sparse one they do not: the windows half in the
    thinned span leave knots unconstrained, and where the two solvers stop
    on that flat landscape differs by degrees (ROADMAP.md, Queue 3).
(2) The pipelined port equals, bit for bit, the same port flushed and
    finalized after every push: knots, IG, update_times, the ang-vel log.
(3) Waits: the front-end waits no time in the loop; every wait of the
    back-end is a fused fetch (at most one per step), the first estimate's
    (the integrator's anchor, fetched as the JAX back-end fetches it) or a
    synchronous re-solve (crop escape, bootstrap).
(4) device_loop: two launches of one program in flight fetch their own
    numbers.
"""

import sys

import numpy as np
import pytest
import torch

from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu_torch.ops import device_loop
from cmax_slam_tpu_torch.utils.evaluate import rotation_rms_deg

from test_e2e import smooth_rot_fn
from test_torch_slice import (FX, FY, H, KNOT_DEG, W, _assert_omega_close, _knot_deg,
                              _systems)

torch.set_num_threads(1)

# name: (duration s, events, the span thinned to one event in 40 or None)
STREAMS = {"dense": (0.5, 50_000, None), "sparse": (0.8, 80_000, (0.25, 0.55))}
CHUNKS = (3000, 8000, 1500, 6000)  # cycled


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request):
    duration, n_events, sparse = STREAMS[request.param]
    rot_fn, _ = smooth_rot_fn(duration)
    ev = synthetic.rotating_camera_events(
        np.random.default_rng(3), n_events, duration, np.zeros(3), FX, FY, W / 2, H / 2,
        W, H, n_points=250, rot_fn=rot_fn)
    keep = np.ones(len(ev.ts), bool)
    if sparse is not None:
        thin = (ev.ts >= sparse[0]) & (ev.ts < sparse[1])
        keep = ~thin | (np.cumsum(thin) % 40 == 0)
    edges, i, k = [], 0, 0
    n = int(keep.sum())
    while i < n:
        j = min(i + CHUNKS[k % len(CHUNKS)], n)
        edges.append((i, j))
        i, k = j, k + 1
    arrays = tuple(a[keep] for a in (ev.xs, ev.ys, ev.ts, ev.pols))
    return request.param, arrays, edges


def _spy_steps(slam, log):
    """Record the window indices each backend.step() returns into log[-1]."""
    step = slam.backend.step

    def spied():
        out = step()
        log[-1].append([r.index for r in out])
        return out

    slam.backend.step = spied


def _drive(slam, stream, after_push=None):
    """Push the stream chunk by chunk; per push: (the windows of each step,
    windows completed, times of the estimates in flight)."""
    _, arrays, edges = stream
    steps, record = [], []
    _spy_steps(slam, steps)
    for a, b in edges:
        steps.append([])
        ests = slam.push_events(*(x[a:b] for x in arrays))
        if after_push is not None:
            after_push(slam, ests)
        record.append((steps[-1], len(slam.backend.results),
                       [e.t for e in slam.frontend.estimates if e.packed is not None]))
    return record


class _Waits:
    """Every call of device_loop.fetch_all that waits (a result not fetched
    before), with the names of the functions on the stack and the number of
    step() calls begun before it."""

    def __init__(self):
        self.calls, self.steps = [], 0

    def __enter__(self):
        self._fetch_all = fetch_all = device_loop.fetch_all

        def spied(results):
            if not all(r.fetched for r in results):
                names, f = set(), sys._getframe(1)
                while f is not None:
                    names.add(f.f_code.co_name)
                    f = f.f_back
                self.calls.append((names, self.steps))
            return fetch_all(results)

        device_loop.fetch_all = spied
        return self

    def __exit__(self, *exc):
        device_loop.fetch_all = self._fetch_all


@pytest.fixture(scope="module")
def runs(stream):
    j, t = _systems()
    record_j = _drive(j, stream)
    with _Waits() as waits:
        step = t.backend.step

        def counted():
            waits.steps += 1
            return step()

        t.backend.step = counted
        record_t = _drive(t, stream)
    counters = dict(t.metrics.counters)
    _, synced = _systems()

    def join(slam, ests):
        slam.flush()
        slam.frontend.finalize_batch(ests)

    _drive(synced, stream, join)
    j.flush()
    t.flush()
    synced.flush()
    return dict(name=stream[0], j=j, t=t, synced=synced, record_j=record_j,
                record_t=record_t, waits=waits, counters=counters)


def test_protocol_matches_jax(runs):
    rec_t, rec_j = runs["record_t"], runs["record_j"]
    assert len(rec_t) == len(rec_j) >= 8
    for k, ((steps_t, n_t, fly_t), (steps_j, n_j, fly_j)) in enumerate(zip(rec_t, rec_j)):
        assert steps_t == steps_j, (k, steps_t, steps_j)
        assert n_t == n_j, k
        assert len(fly_t) == len(fly_j) and np.allclose(fly_t, fly_j, atol=1e-9), k
    assert any(fly for _, _, fly in rec_t), "estimates in flight after a push"
    j, t = runs["j"], runs["t"]
    res_t, res_j = t.window_results(), j.window_results()
    assert [(r.index, r.ran_ba) for r in res_t] == [(r.index, r.ran_ba) for r in res_j]
    assert sum(r.ran_ba for r in res_t) >= 3
    if runs["name"] == "sparse":  # a BA window and a skipped one complete in one step
        assert not all(r.ran_ba for r in res_t)
        assert any(len(s) == 2 for steps, _, _ in rec_t for s in steps)
    assert [r.index for r in res_t] == list(range(len(res_t)))
    returned = [i for steps, _, _ in rec_t for s in steps for i in s]
    assert returned == [r.index for r in res_t][:len(returned)]  # each window once, in order
    assert len(t.backend.bootstrap_results) == len(j.backend.bootstrap_results) > 0
    # after flush(): test_torch_slice.py's tolerances
    _assert_omega_close(t.ang_vel_log, j.ang_vel_log)
    np.testing.assert_allclose([tt for tt, _ in t.trajectory_log],
                               [tt for tt, _ in j.trajectory_log], atol=1e-9)
    k_t, k_j = t.backend.traj.knots, j.backend.traj.knots
    assert k_t.shape == k_j.shape
    if runs["name"] == "sparse":  # its knots: test_half_empty_windows_knots_match_jax
        return
    assert _knot_deg(k_t, k_j).max() < KNOT_DEG
    tr_t, tr_j = t.backend.traj, j.backend.traj
    grid = np.linspace(tr_t.t_beg + 1e-6, tr_t.max_time() - 1e-6, 40)
    gap, _ = rotation_rms_deg(grid, tr_j.evaluate(grid), tr_t.evaluate(grid), "first")
    assert gap < KNOT_DEG


@pytest.mark.slow
@pytest.mark.parametrize("stream", ["sparse"], indirect=True)
@pytest.mark.xfail(strict=True, reason=(
    "known miss (ROADMAP Queue 3): the windows half in the thinned span leave knots "
    "unconstrained; from JAX's checkpoint before each window the port takes more line "
    "searches to a lower cost (11 against 6 in window 1, parting at the keep-test tie "
    "traced in test_half_empty_window1_parts_at_the_keep_test_tie) and the knots part "
    "by degrees (7.6 deg at the thinned span's first knot, KNOT_DEG 0.1)"))
def test_half_empty_windows_knots_match_jax(runs):
    """The sparse stream's knots against JAX's, at test_torch_slice.py's knot
    tolerance: the assertion test_protocol_matches_jax makes on the dense
    stream."""
    k_t, k_j = runs["t"].backend.traj.knots, runs["j"].backend.traj.knots
    assert k_t.shape == k_j.shape
    assert _knot_deg(k_t, k_j).max() < KNOT_DEG, np.round(_knot_deg(k_t, k_j), 4)


@pytest.mark.slow
@pytest.mark.parametrize("stream", ["sparse"], indirect=True)
def test_half_empty_window1_parts_at_the_keep_test_tie(stream, monkeypatch, tmp_path):
    """The trace of the marked miss above (ROADMAP Queue 3): window 1 of the
    sparse stream, from JAX's checkpoint before it and on JAX's front-end
    estimates, solved by both packages decision by decision
    (tests/test_torch_oracle_parity.py's tracer). Both take the same
    decisions on costs equal to float32 rounding until the first secant
    step of line search 3 re-evaluates the bracket's winning point with its
    gradient: JAX's value there is 1-2 ulps above its forward-only value of
    the same point, so JAX does not keep the point and the port does. The
    two solves then run 6 and 11 line searches."""
    from types import SimpleNamespace

    from cmax_slam_tpu_torch.config import ijrr_config
    from test_torch_oracle_parity import (assert_parts_at_the_keep_test_tie,
                                          trace_window_from_jax_state)

    _, arrays, _ = stream
    ev = SimpleNamespace(**dict(zip(("xs", "ys", "ts", "pols"), arrays)))
    traced = trace_window_from_jax_state(
        monkeypatch, lambda: _systems()[0], lambda: _systems()[1], ev, 1,
        ijrr_config(num_events_per_packet=4000).backend.optim, tmp_path)
    assert_parts_at_the_keep_test_tie(*traced)


def test_pipelined_equals_flushed_after_every_push(runs):
    t, s = runs["t"], runs["synced"]
    for a, b in ((t.backend.traj.knots, s.backend.traj.knots),
                 (t.ang_vel_log, s.ang_vel_log)):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(t.backend.IG, s.backend.IG)
    assert torch.equal(t.backend.update_times, s.backend.update_times)
    assert [(r.index, r.ran_ba, r.initial_cost, r.final_cost, r.iters)
            for r in t.window_results()] == \
        [(r.index, r.ran_ba, r.initial_cost, r.final_cost, r.iters)
         for r in s.window_results()]
    assert t.backend.IG.any()


def test_waits_in_the_loop(runs):
    c, waits = runs["counters"], runs["waits"]
    assert c.get("frontend.host_reads", 0) == 0
    assert c["frontend.launches"] > 0 and c["backend.host_reads"] == len(waits.calls)
    kinds = {"fused": [], "first estimate": [], "re-solve": []}
    for names, step in waits.calls:
        if "_fused_fetch" in names:
            kinds["fused"].append(step)
        elif "push_ang_vel" in names:
            kinds["first estimate"].append(step)
        elif "_finish_solve" in names:  # the escape and the bootstrap (refine) re-solves
            kinds["re-solve"].append(step)
        else:
            raise AssertionError(f"a wait outside the protocol: {sorted(names)}")
    fused = kinds["fused"]
    assert len(fused) == len(set(fused)), "more than one fused fetch in a step"
    assert len(fused) <= waits.steps
    ba_in_loop = sum(r.ran_ba for r in runs["t"].backend.results[:runs["record_t"][-1][1]])
    assert len(fused) >= ba_in_loop > 0
    assert len(kinds["first estimate"]) == 1
    boot = sum(r.ran_ba for r in runs["t"].backend.bootstrap_results)
    assert len(kinds["re-solve"]) == c.get("backend.crop_escapes", 0) + boot and boot > 0
    assert c["backend.host_reads"] == len(fused) + 1 + len(kinds["re-solve"])


def test_launches_in_flight_fetch_their_own_numbers():
    n = torch.zeros(1)

    def build(b):
        b.seg(lambda: n.add_(1.0))
        b.seg(lambda: prog.out.copy_(n))

    prog = device_loop.Program(build, 1, "cpu", name="test_in_flight")
    first, second = prog.run(), prog.run()
    assert not first.fetched and not second.fetched
    assert [v.tolist() for v in device_loop.fetch_all([second, first])] == [[2.0], [1.0]]
    assert first.fetched and second.fetched
    assert first.fetch().tolist() == [1.0] and prog.out.tolist() == [2.0]
