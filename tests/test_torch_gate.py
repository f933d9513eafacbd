"""The device loop's gates (ops/device_loop.py: Gate, gate, limit, as_gate),
on the CPU, where every program runs eagerly with its gates read on the
host (Gate.holds, the plain version of csrc/loop.cu's predicate).

(a) Gates of 1, 24 and 2016 lanes with the live lanes first, in the middle,
    last, all and none: a register per lane counted down under a WHILE
    gated on the lanes' mask and a counter under a limit (folded into the
    gate), an IF on every third iteration. The eager program gives the
    values, iterations and per-node executions that the old form gives (every
    gate reduced into an int32 flag, ``int(any(mask & (counter < limit)))``),
    and the same values as the JAX package's form of the loop
    (``lax.while_loop`` with ``lax.cond``) on the same numpy inputs, exactly.
(b) The predicate's reduction as csrc/loop.cu maps it onto threads (one warp
    up to 32 lanes, else one block of up to 1024 threads, each lane read by
    thread lane % threads), emulated in numpy, equals ``mask.any()``.
(c) A gate the predicate cannot read raises, in the eager interpreter as at
    assembly on the card: no conversion, no fallback.
(d) Every ``repeat``/``when`` of ops/optim.LaneCG (each ladder, ``solve``
    and ``rounds``), of the front-end's packet program (with and without the
    coarse stage) and of the lane-batched LaneSolver passes a gate the
    predicate can read: a bool, contiguous, 1-D mask, int32 (1,) counters,
    and static buffers (the same storage at every interpretation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmax_slam_tpu_torch.config import OptimOptions, ijrr_config, replace
from cmax_slam_tpu_torch.frontend import _PacketSolver
from cmax_slam_tpu_torch.ops import device_loop, optim, warp_local
from cmax_slam_tpu_torch.parallel.sharding import LaneSolver

torch.set_num_threads(1)

LANES = (1, 24, 2016)
PATTERNS = ("first", "middle", "last", "all", "none")
LIMIT = 7


def _starts(L, pattern):
    lanes = np.arange(L)
    live = {"first": lanes < 3, "middle": lanes == L // 2, "last": lanes == L - 1,
            "all": lanes >= 0, "none": lanes < 0}[pattern]
    return np.where(live, 3 + lanes % 7, 0).astype(np.float32)


class _Counting(device_loop.Eager):
    """Eager with host gates that counts each conditional's predicate
    executions as the graph's counters do: a WHILE's entry test and one
    test per iteration, an IF's test, in the order met."""

    def __init__(self, holds):
        super().__init__()
        self.holds, self.preds = holds, []

    def when(self, gate_t, body):
        self.preds.append(1)
        if self.holds(gate_t):
            body()

    def repeat(self, gate_t, body, trips=None):
        slot = len(self.preds)
        self.preds.append(1)
        while self.holds(gate_t):
            body()
            self.preds[slot] += 1


def _old_flag(g):
    """The old form: the gate reduced into an int32 (1,) flag, read != 0."""
    g = device_loop.as_gate(g)
    mask = g.mask.bool()
    if g.counter is not None:
        mask = mask & (g.counter < g.limit)
    return bool(int(mask.any().to(torch.int32).reshape(1)[0]) != 0)


def _program(L, pattern):
    start = torch.tensor(_starts(L, pattern))
    reg, hits = torch.zeros(L), torch.zeros(1)
    it = torch.zeros(1, dtype=torch.int32)
    mask, third = device_loop.gate("cpu", L), device_loop.gate("cpu")
    gate = device_loop.Gate(mask, it, device_loop.limit(LIMIT, "cpu"))
    out = torch.zeros(L + 2)

    def init():
        reg.copy_(start)
        hits.zero_()
        it.zero_()
        torch.gt(reg, 0, out=mask)

    def step():
        reg.sub_(mask.float())
        it.add_(1)
        torch.gt(reg, 0, out=mask)
        torch.eq(torch.remainder(it, 3), 0, out=third)

    def build(b):
        b.seg(init)

        def body():
            b.seg(step)
            b.when(third, lambda: b.seg(lambda: hits.add_(1.0)))

        b.repeat(gate, body)
        b.seg(lambda: out.copy_(torch.cat([reg, hits, it.float()])))

    return build, out


def _jax_loop(start):
    def cond(c):
        reg, _, it = c
        return jnp.any(reg > 0) & (it < LIMIT)

    def body(c):
        reg, hits, it = c
        reg = reg - (reg > 0).astype(jnp.float32)
        it = it + 1
        hits = jax.lax.cond(it % 3 == 0, lambda h: h + 1.0, lambda h: h, hits)
        return reg, hits, it

    reg, hits, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(start), jnp.float32(0.0), jnp.int32(0)))
    return np.concatenate([np.asarray(reg), [float(hits), float(it)]]).astype(np.float32)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("L", LANES)
def test_gate_lanes_give_the_int32_flag_results_and_executions(L, pattern):
    build, out = _program(L, pattern)
    new = _Counting(lambda g: device_loop.as_gate(g).holds())
    build(new)
    got = out.clone()
    old = _Counting(_old_flag)
    build(old)
    assert torch.equal(got, out)
    assert new.preds == old.preds
    iters = int(got[-1])
    assert new.preds[0] == iters + 1 and sum(new.preds) == 1 + 2 * iters
    assert iters == min(int(_starts(L, pattern).max()), LIMIT)
    # the plain run through Program (the CPU's path) and JAX's loop
    device_loop.Program(build, L + 2, "cpu", name="gate_test").run()
    assert torch.equal(out, got)
    np.testing.assert_array_equal(got.numpy(), _jax_loop(_starts(L, pattern)))


def _pred_threads(L):
    """csrc/loop.cu add_pred's block: one warp up to 32 lanes, else a warp
    per 32 lanes up to 1024 threads."""
    return 32 if L <= 32 else min(1024, -(-L // 32) * 32)


@pytest.mark.parametrize("L", [1, 24, 32, 33, 1000, 2016, 5000])
def test_predicate_reduction_emulated_is_any(L):
    rng = np.random.default_rng(L)
    T = _pred_threads(L)
    for trial in range(40):
        mask = np.zeros(L, bool)
        if trial:
            mask[rng.integers(0, L, size=rng.integers(1, 3))] = True
        per_thread = [mask[t::T].any() for t in range(T)]  # thread t reads lanes t, t + T, ...
        assert any(per_thread) == bool(mask.any())
        assert all(len(mask[t::T]) <= -(-L // T) for t in range(T))
    assert T % 32 == 0 and T <= 1024


def _bad_gates():
    m = torch.zeros(4, dtype=torch.bool)
    c = torch.zeros(1, dtype=torch.int32)
    return {
        "int32 mask": device_loop.Gate(torch.zeros(1, dtype=torch.int32)),
        "float mask": device_loop.Gate(torch.zeros(3)),
        "2-D mask": device_loop.Gate(torch.zeros((2, 2), dtype=torch.bool)),
        "strided mask": device_loop.Gate(torch.zeros(8, dtype=torch.bool)[::2]),
        "empty mask": device_loop.Gate(torch.zeros(0, dtype=torch.bool)),
        "counter without limit": device_loop.Gate(m, c),
        "int64 counter": device_loop.Gate(m, torch.zeros(1, dtype=torch.int64), c),
        "counter of two values": device_loop.Gate(m, torch.zeros(2, dtype=torch.int32), c),
        "limit on another device": device_loop.Gate(m, c, torch.zeros(1, dtype=torch.int32,
                                                                     device="meta")),
        "a number": 1,
    }


@pytest.mark.parametrize("name", list(_bad_gates()))
def test_a_gate_the_predicate_cannot_read_raises(name):
    bad = _bad_gates()[name]
    with pytest.raises((TypeError, ValueError)):
        device_loop.as_gate(bad)
    ran = []
    for interp in (device_loop.Eager(), device_loop.Eager(gate=False)):
        with pytest.raises((TypeError, ValueError)):
            interp.repeat(bad, lambda: ran.append(1), trips=1)
        with pytest.raises((TypeError, ValueError)):
            interp.when(bad, lambda: ran.append(1))
    assert not ran


class _Recorder(device_loop.Eager):
    """Runs a program eagerly with its gates read on the host and records
    every gate it meets."""

    def __init__(self):
        super().__init__()
        self.gates = []

    def when(self, gate_t, body):
        self.gates.append(device_loop.as_gate(gate_t))
        super().when(gate_t, body)

    def repeat(self, gate_t, body, trips=None):
        self.gates.append(device_loop.as_gate(gate_t))
        super().repeat(gate_t, body, trips)


def _storage(g):
    return tuple(None if t is None else t.data_ptr() for t in g)


def _assert_readable_and_static(build, reset=lambda: None):
    """Interprets ``build`` twice from the same state (``reset`` before
    each): the same gates on the same storage, each readable."""
    first, second = _Recorder(), _Recorder()
    reset()
    build(first)
    reset()
    build(second)
    assert first.gates, "no gate met"
    assert [_storage(g) for g in first.gates] == [_storage(g) for g in second.gates]
    for g in first.gates:
        assert g.mask.dtype == torch.bool and g.mask.dim() == 1 and g.mask.is_contiguous()
        for t in (g.counter, g.limit):
            assert t is None or (t.dtype == torch.int32 and t.shape == (1,))
    return first.gates


def _bowl():
    rng = np.random.default_rng(2)
    c = torch.tensor(rng.uniform(-1, 1, (3, 6)).astype(np.float32))

    def f(x):
        cc = c if x.dim() == 2 else c[:, None]
        return ((x - cc) ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1)

    return f


@pytest.mark.parametrize("mode", ["solve", "rounds"])
@pytest.mark.parametrize("ladder", ["sequential", "vector", "grid"])
def test_lane_cg_gates_are_readable_and_static(ladder, mode):
    f = _bowl()
    cg = optim.LaneCG(warp_local.value_and_grad(f), f, 3, 6, "cpu", ladder=ladder,
                      max_iters=4)
    x0 = torch.zeros(3, 6)
    num_iters = torch.full((1,), 2, dtype=torch.int32)

    def build(b):
        if mode == "solve":
            cg.solve(b, x0)
        else:
            cg.rounds(b, num_iters)

    gates = _assert_readable_and_static(build, lambda: cg.start(x0))
    # the CG loop reads the lanes' keep mask; the line search's loops the
    # active lanes with their step counters, folded into the predicate
    assert gates[0].mask is cg.keep
    assert (gates[0].counter is cg.n) == (mode == "rounds")
    inner = [g for g in gates if g.mask is cg.active]
    assert inner and all(g.counter in (cg.k, cg.j) for g in inner)
    assert int(cg.s.it.min()) >= 1


@pytest.mark.parametrize("coarse", [False, True])
def test_packet_program_gates_are_readable_and_static(coarse):
    W, H, F = 60, 45, 45.0
    cam = warp_local.CameraParams(F, F, W / 2, H / 2, W, H)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    lut = torch.tensor(np.stack([((xs - W / 2) / F).ravel(), ((ys - H / 2) / F).ravel(),
                                 np.ones(W * H)], axis=-1).astype(np.float32))
    cfg = replace(ijrr_config(num_events_per_packet=500).frontend, coarse_to_fine=coarse)
    S = 500
    solver = _PacketSolver(cfg, cam, {"lut": lut, "ring": None}, S, "cpu", 3)
    rng = np.random.default_rng(5)
    host = np.zeros((2, 3, S), np.int32)
    host[0] = rng.integers(0, W * H, (3, S))
    host[1] = np.sort(rng.uniform(0, 0.01, (3, S)), axis=1).astype(np.float32).view(np.int32)
    lanes = np.array([[0, S, 0.005, 1, 0], [S, S, 0.005, 0, 0], [2 * S, S, 0.005, 1, 0]])
    solver.lanes_in[:3].copy_(torch.from_numpy(lanes))
    solver.count_in.fill_(3)
    solver.host_in.copy_(torch.from_numpy(host.reshape(2, -1)))
    gates = _assert_readable_and_static(solver.program.build_fn)
    assert gates[0].mask is solver.go and any(g.mask is solver.live for g in gates)
    assert all(g.mask.numel() == 1 for g in gates)


def test_lane_solver_gates_are_readable_and_static():
    cam = warp_local.CameraParams(45.0, 45.0, 30.0, 22.5, 60, 45)
    opt = OptimOptions(max_line_searches=3)
    for rounds in (False, True):
        prog = LaneSolver(24, 200, cam, 1.0, 0, opt, "cpu", rounds)
        rng = np.random.default_rng(7)
        prog.bearings.copy_(torch.tensor(rng.normal(size=(24, 200, 3)).astype(np.float32)))
        prog.bearings[..., 2] = 1.0
        prog.weights.fill_(1.0)
        prog.round_iters.fill_(2)
        gates = _assert_readable_and_static(prog.program.build_fn,
                                            lambda: prog.cg.start(prog.x0))
        assert gates[0].mask.numel() == 24 and gates[0].mask is prog.cg.keep
