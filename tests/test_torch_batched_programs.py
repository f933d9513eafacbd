"""The lane-batched solves as device programs (parallel/sharding.LaneSolver,
from the module-level pool), on the CPU, where a program runs eagerly with
its gates read on the host: against the host-gated lane CG they replace
(optim.cg_init / make_cg_body / cg_run_rounds / cg_finalize, the eager
reference), bit for bit; with no value read on the host inside a round; and
from the pool, one program per device and lane shape.

(a) track_batched_compacted (each round one LaneSolver launch) equals, bit
    for bit, the same tracker written with the host-gated rounds
    (batched._run_round) and a host read of every lane's status per round,
    on tests/test_torch_batched.py's stream; so does track_batched (one
    launch per chunk) against cg_init + cg_run_rounds + cg_finalize. Against
    JAX both are held by tests/test_torch_batched.py, which now runs them.
(b) A round's program reads nothing on the host: with the gates off
    (device_loop.Eager(gate=False)) a Tensor's bool, item and float raise
    inside it.
(c) One program serves every round count of a bucket (the count is a
    device buffer): rounds of 1, then 3 line searches on a loaded state
    equal cg_run_rounds' 1 then 3.
(d) A second call builds no program: the calls lease the same entry; the
    shards of a device list lease one entry each.
"""

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch.ops import device_loop, optim, program_pool, warp_local
from cmax_slam_tpu_torch.parallel import batched, sharding

from test_torch_batched import CAM, CFG, FX, FY, H, LUT, MAX_LS, W
from test_torch_device_loop import _no_host_reads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    from cmax_slam_tpu_torch.io import synthetic

    rng = np.random.default_rng(9)
    ev = synthetic.rotating_camera_events(rng, 40000, 0.36, np.array([0.8, -1.1, 1.7]), FX, FY,
                                          W / 2, H / 2, W, H, n_points=220)
    return batched.cut_packets(ev.xs, ev.ys, ev.ts, LUT, CAM, CFG, device="cpu")


def _compacted_host_gated(batch, sweeps=2, round_schedule=(4, 4, 8, 8, 16), min_bucket=8,
                          cold_decimate=4):
    """track_batched_compacted with its rounds on the host-gated lane CG and
    the lanes' status read from the state each round: the eager reference."""
    opt, sigma, measure = CFG.optim, CFG.warp.blur_sigma, CFG.contrast_measure
    Pn = batch.bearings.shape[0]
    st = None
    for sweep in range(sweeps):
        if sweep > 0:
            omega0, k = torch.cat([st.x[:1], st.x[:-1]]), 1
        else:
            omega0 = torch.zeros((Pn, 3))
            k = 1 if sweep == sweeps - 1 else cold_decimate
        data = [t[:, ::k].contiguous() for t in (batch.bearings, batch.dts, batch.weights)]
        st = batched._init_states(*data, omega0, CAM, sigma, measure, opt)
        active, rounds = np.arange(Pn), 0
        while True:
            status, it = st.status.numpy(), st.it.numpy()
            active = active[(status[active] == optim.RUNNING) & (it[active] < MAX_LS)]
            n = len(active)
            if n == 0:
                break
            idx = torch.as_tensor(np.resize(active, batched._quantize_bucket(n, min_bucket)))
            round_iters = min(round_schedule[min(rounds, len(round_schedule) - 1)], MAX_LS)
            out = batched._run_round(*(t.index_select(0, idx) for t in data),
                                     optim.CGState(*(t.index_select(0, idx) for t in st)),
                                     CAM, sigma, measure, opt, round_iters)
            act = torch.as_tensor(active)
            st = optim.CGState(*(t.index_copy(0, act, o[:n]) for t, o in zip(st, out)))
            rounds += 1
    return st.x.numpy(), st.f.numpy(), st.it.numpy()


def test_compacted_rounds_equal_the_host_gated_rounds(batch):
    _, om, f, it = batched.track_batched_compacted(batch, CAM, CFG, sweeps=2)
    ref = _compacted_host_gated(batch)
    for got, want in zip((om, f, it), ref):
        np.testing.assert_array_equal(got, want)
    assert it.max() <= MAX_LS and np.all(it > 0)


def test_lockstep_chunks_equal_the_host_gated_solve(batch):
    _, om, f, it = batched.track_batched(batch, CAM, CFG, sweeps=1)
    opt = CFG.optim
    outs = []
    for lo in range(0, batch.bearings.shape[0], 16):
        b, d, w = (t[lo:lo + 16] for t in (batch.bearings, batch.dts, batch.weights))
        with torch.no_grad():
            fn = sharding.lane_objective(b, d, w, CAM, CFG.warp.blur_sigma, CFG.contrast_measure)
            st = optim.cg_init(warp_local.value_and_grad(fn), torch.zeros((len(b), 3)),
                               opt.initial_step)
            st = optim.cg_run_rounds(sharding.cg_body(fn, opt), st, MAX_LS, MAX_LS)
            res = optim.cg_finalize(st, MAX_LS)
        outs.append((res.x, res.fun, res.iters))
    for got, k in zip((om, f, it), range(3)):
        np.testing.assert_array_equal(got, torch.cat([o[k] for o in outs]).numpy())


def _round_solver(batch, P=8):
    owner = program_pool.Owner()
    prog = sharding.lane_solver(owner, CAM, CFG.warp.blur_sigma, CFG.contrast_measure,
                                CFG.optim, "cpu", P, batch.dts.shape[1], rounds=True)
    data = [t[:P] for t in (batch.bearings, batch.dts, batch.weights)]
    st = batched._init_states(*data, torch.zeros((P, 3)), CAM, CFG.warp.blur_sigma,
                              CFG.contrast_measure, CFG.optim)
    prog.load(data)
    for buf, t in zip(prog.cg.s, st):
        buf.copy_(t)
    return owner, prog, data, st


def test_a_round_reads_nothing_on_the_host(batch):
    _owner, prog, _, _ = _round_solver(batch)
    prog.round_iters.fill_(4)
    with _no_host_reads():
        prog.program.build_fn(device_loop.Eager(gate=False))
    assert int(prog.cg.s.it.min()) == 1  # the ungated loop body ran once
    assert prog.program.out.shape == (16,)


def test_one_program_serves_every_round_count(batch):
    _owner, prog, data, st = _round_solver(batch)
    fn = sharding.lane_objective(*data, CAM, CFG.warp.blur_sigma, CFG.contrast_measure)
    body = sharding.cg_body(fn, CFG.optim)
    for iters in (1, 3):
        prog.round_iters.fill_(iters)
        vals = prog.program.run().fetch()
        with torch.no_grad():
            st = optim.cg_run_rounds(body, st, iters, MAX_LS)
        for a, b in zip(prog.cg.s, st):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(vals, np.concatenate([st.status.numpy(), st.it.numpy()]))


def test_a_second_call_builds_no_program(batch, monkeypatch):
    key = ("lanes", torch.device("cpu"), CAM, float(CFG.warp.blur_sigma),
           int(CFG.contrast_measure), CFG.optim)
    batched.track_batched_compacted(batch, CAM, CFG, sweeps=2)
    entries = list(program_pool.ENTRIES[key])
    first = entries[0]  # a call leases the first free entry
    programs = dict(first.programs)
    assert programs and all(e.free for e in entries)
    batched.track_batched_compacted(batch, CAM, CFG, sweeps=2)
    assert program_pool.ENTRIES[key] == entries
    assert first.programs.keys() == programs.keys()
    assert all(first.programs[k] is p for k, p in programs.items())
    # the shards of a device list run concurrently: one entry each
    leases = []
    lease = program_pool.lease

    def spy(k, owner, reset=None):
        entry = lease(k, owner, reset)
        leases.append((id(owner), entry))
        return entry

    monkeypatch.setattr(program_pool, "lease", spy)
    batched.track_batched_compacted(batch, CAM, CFG, sweeps=2, devices=["cpu", "cpu"])
    by_owner = {}
    for owner, entry in leases:
        by_owner.setdefault(owner, set()).add(id(entry))
    assert len(by_owner) == 2 and all(len(v) == 1 for v in by_owner.values())
    assert len(set.union(*by_owner.values())) == 2
