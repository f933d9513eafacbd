"""Runs one cell of the benchmark (BENCHMARK.json, portbench/) untraced by
the harness, with the port's own trace (cmax_slam_tpu_torch.utils.metrics
.TRACE) armed before the system is built and recording over the window, and
prints the cell's line with each program's device seconds split into its
outermost loop nodes (``metrics.loop_split``: the first CG solve ``cg``, a
restarted solve ``restart/cg``, the rest) and the readers of
portbench/pb/program_trace.py.

    python3 tools/trace_cell.py --workload ecrot-cubic.replay --seed 7 --seconds 34 \
        [--out _work/trace_cell.json]

Needs a CUDA card. The harness's files are used as they are: its window's
start and end and its run record are wrapped in this process only.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA card", file=sys.stderr)
        return 3
    from cmax_slam_tpu_torch.utils.metrics import TRACE, loop_split
    from pb import harness, program_trace

    begin, end, record = harness.Tracer.begin, harness.Tracer.end, harness.record

    def traced_begin(self):
        begin(self)
        TRACE.start()

    def traced_end(self):
        TRACE.stop()
        end(self)

    def traced_record(**kw):
        rec = record(**kw)
        rec["program_trace"] = TRACE.records()
        return rec

    harness.Tracer.begin, harness.Tracer.end = traced_begin, traced_end
    harness.record = traced_record
    TRACE.enable()
    keep = {}
    line = harness.run(args.workload, args.seed, args.seconds, False, "cuda", root=ROOT,
                       keep=keep)
    rec = keep["rec"]
    out = {"workload": args.workload, "seed": args.seed, "correct": line["correct"],
           "metrics": {k: m["value"] for k, m in line["metrics"].items()},
           "loop_split_s": loop_split(rec["program_trace"]),
           "readers": {name: fn(rec) for name, fn in program_trace.READERS.items()},
           "device": torch.cuda.get_device_name(0)}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
