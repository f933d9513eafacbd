"""What a device-loop iteration costs on a CUDA card, for one tree of the
repository (this one, or an unpacked checkout of another commit): the
graph's WHILE loop timed over a few bodies, and the nodes of a captured CG
iteration.

    python3 tools/loop_latency.py [--tree DIR] [--iterations 1000]

imports ``cmax_slam_tpu_torch`` from DIR (default: this checkout) and
prints one JSON line: for each body, the time of one loop iteration (CUDA
events around whole program launches, divided by the iterations) and the
body's nodes. The bodies, each in the tree's cheapest form of its gate:

- ``empty``: a counter's increment and the gate "counter < limit" (the
  least a loop that ends can do);
- ``one_kernel``: the same and one elementwise kernel;
- ``one_kernel_two_segments``: ``one_kernel`` with the elementwise kernel in
  a segment of its own (one more child-graph node, the same kernels);
- ``check``: chip_smoke's loop check body (a float register counted down,
  its gate, and an IF node on every third value that runs one kernel);
- ``empty_unfolded``: ``empty`` with its gate written as LaneCG's gates
  were before they were folded into the predicate, ``mask & (counter <
  limit)`` into a bool buffer (two kernels).

The tree must have ``device_loop.Gate`` and ``Program.items``.

chip_smoke.py imports ``iteration_nodes`` to count the nodes of one CG
iteration of a captured program (the innermost WHILE loop that holds
another) from the statement tree the program keeps (``Program.items``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _count(device_loop, prog, items) -> dict:
    """Nodes of a statement list: each segment's child node and its own
    nodes; each conditional's predicate, the conditional node and, for a
    WHILE, the in-body predicate; each body once."""
    out = {"nodes": 0, "kernel_nodes": 0, "gates": 0}
    for item in items:
        if item[0] == "seg":
            n, k = device_loop.graph_nodes(prog._graphs[item[1]])
            out["nodes"] += 1 + n
            out["kernel_nodes"] += k
        else:
            is_while, inner = item[1], item[4]
            sub = _count(device_loop, prog, inner)
            out["nodes"] += 2 + is_while + sub["nodes"]
            out["kernel_nodes"] += 1 + is_while + sub["kernel_nodes"]
            out["gates"] += 1 + sub["gates"]
    return out


def _has_while(items) -> bool:
    return any(it[0] == "cond" and (it[1] or _has_while(it[4])) for it in items)


def _cg_loop(items):
    """The innermost WHILE statement whose body holds another WHILE."""
    for it in items:
        if it[0] != "cond":
            continue
        deeper = _cg_loop(it[4])
        if deeper is not None:
            return deeper
        if it[1] and _has_while(it[4]):
            return it
    return None


def iteration_nodes(device_loop, prog) -> dict | None:
    """Nodes, kernel nodes and gates of one CG iteration of a captured
    program (its CG loop's body, each inner loop's body once, plus the CG
    loop's own in-body predicate); None if it has no CG loop."""
    loop = _cg_loop(prog.items)
    if loop is None:
        return None
    out = _count(device_loop, prog, loop[4])
    out["nodes"] += 1
    out["kernel_nodes"] += 1
    out["gates"] += 1
    return out


def _cases(device_loop, n_it: int) -> dict:
    """{body: (init, gate, body(b), check(out))} in the tree's form."""
    import torch

    dev = torch.device("cuda")
    n = torch.zeros(1, dtype=torch.int32, device=dev)
    x, reg, hits = (torch.zeros(1, device=dev) for _ in range(3))
    lim = torch.full((1,), n_it, dtype=torch.int32, device=dev)
    start = torch.tensor([float(n_it)], device=dev)
    ones = torch.ones(1, dtype=torch.bool, device=dev)
    counted = device_loop.Gate(ones, n, lim)  # the predicate reads n < lim
    go, third, loose = (device_loop.gate(dev) for _ in range(3))

    def gate_n():
        pass

    def gate_reg():
        torch.gt(reg, 0, out=go)

    def gate_third():
        torch.eq(torch.remainder(reg, 3.0), 0, out=third)

    def reset():
        n.zero_()
        reg.copy_(start)
        hits.zero_()

    def advance():
        n.add_(1)
        gate_n()

    def one():
        x.add_(1.0)
        advance()

    def step():
        reg.sub_(1.0)
        gate_third()
        gate_reg()

    def check_body(b):
        b.seg(step)
        b.when(third, lambda: b.seg(lambda: hits.add_(1.0)))

    def counted_ok(out):
        return int(out[0]) == n_it

    def check_ok(out):
        return float(out[1]) == 0.0 and float(out[2]) == -(-n_it // 3)  # 0, 3, ..., < n_it

    def begin(gate_fn):
        def init():
            reset()
            gate_fn()
        return init

    def two_segments(b):
        b.seg(lambda: x.add_(1.0))
        b.seg(advance)

    cases = {"empty": (begin(gate_n), counted, lambda b: b.seg(advance), counted_ok),
             "one_kernel": (begin(gate_n), counted, lambda b: b.seg(one), counted_ok),
             "one_kernel_two_segments": (begin(gate_n), counted, two_segments, counted_ok),
             "check": (begin(gate_reg), go, check_body, check_ok)}
    def gate_loose():
        torch.logical_and(ones, torch.lt(n, lim), out=loose)

    def advance_loose():
        n.add_(1)
        gate_loose()

    cases["empty_unfolded"] = (begin(gate_loose), loose, lambda b: b.seg(advance_loose),
                               counted_ok)
    return cases, (n, reg, hits)


def bodies(device_loop, n_it: int = 1000, reps: int = 5) -> dict:
    """The bodies of the module docstring as programs on the card: per body
    the time of one iteration (us) and its nodes per iteration (the body,
    each segment's child node and nodes, and the in-body predicate)."""
    import torch

    cases, (n, reg, hits) = _cases(device_loop, n_it)
    out = {}
    for name, (init, gate, body, ok) in cases.items():
        def build(b, init=init, gate=gate, body=body):
            b.seg(init)
            b.repeat(gate, lambda: body(b))
            b.seg(lambda: prog.out.copy_(torch.cat([n.float(), reg, hits])))

        prog = device_loop.Program(build, 3, "cuda", name=f"loop_latency_{name}")
        got = prog.run().fetch()
        if not ok(got):
            raise AssertionError(f"loop body {name}: wrong result {got.tolist()}")
        for _ in range(2):
            prog.run().fetch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            prog.run()
        end.record()
        torch.cuda.synchronize()
        graph_us = start.elapsed_time(end) / reps / n_it * 1e3
        if name == "check":  # the host gate: the same body, its gates read on the host
            start.record()
            prog.build_fn(device_loop.Eager())
            end.record()
            torch.cuda.synchronize()
            host = start.elapsed_time(end) / n_it * 1e3
        loop = next(it for it in prog.items if it[0] == "cond")
        nodes = _count(device_loop, prog, loop[4])
        out[name] = {"us_per_iteration": graph_us,
                     "nodes": nodes["nodes"] + 1, "kernel_nodes": nodes["kernel_nodes"] + 1}
        if name == "check":
            out[name]["host_gate_us_per_iteration"] = host
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iterations", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("loop_latency.py needs a CUDA card", file=sys.stderr)
        return 2
    from cmax_slam_tpu_torch.ops import device_loop

    device_loop.build()
    print(json.dumps(bodies(device_loop, args.iterations)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
