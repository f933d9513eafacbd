"""The readings that a cell's limits are set from: for each seed, one run of
the program (its compared numbers), and on the seeds named for it the
control (the plain reference in bfloat16, pb/control.py) on the same stream
and packets; then, on their own seeds, runs of the program with each named
fault (pb/control.FAULTS); all in one process.

    python3 portbench/control.py --workload ijrr.replay --seconds 4 --seeds 11,12,13 \
        [--control-seeds 11,12] [--faults frontend_frozen --fault-seeds 21,22] \
        [--out out/control_ijrr.json]

Prints one JSON line per run and, last, the program's largest reading of
each number, the control's smallest, and each fault's smallest; with --out
it rewrites that file after every run. The benchmark's own runs never run
the control or a fault."""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _seeds(text):
    return [int(s) for s in text.split(",")] if text else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default=None,
                    help="comma-separated; the seeds the control runs on (default: all)")
    ap.add_argument("--faults", default="", help="comma-separated names of pb/control.FAULTS")
    ap.add_argument("--fault-seeds", default="", help="comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from pb import control, harness

    seeds = _seeds(args.seeds)
    ctrl_seeds = set(seeds if args.control_seeds is None else _seeds(args.control_seeds))
    runs = [(s, None) for s in seeds] + [(s, f) for f in args.faults.split(",") if f
                                         for s in _seeds(args.fault_seeds)]
    rows, faults = [], {}

    def save():
        out = {"workload": args.workload, "seconds": args.seconds, "rows": rows,
               "summary": control.summary(rows) if rows else {},
               "faults": {name: control.summary_of(r) for name, r in faults.items()}}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        return out

    for seed, fault in runs:
        keep = {}
        t0 = time.perf_counter()
        line = harness.run(args.workload, seed, args.seconds, False, "cuda", root=ROOT,
                           keep=keep, overrides=control.FAULTS[fault] if fault else None)
        t1 = time.perf_counter()
        row = {"seed": seed, "fault": fault, "correct": line["correct"],
               "program": keep["rec"]["readings"],
               "omega_errs": control.omega_errs(keep["rec"]),
               "metrics": {k: m["value"] for k, m in line["metrics"].items()},
               "run_s": t1 - t0}
        if fault is None and seed in ctrl_seeds:
            row["control"] = control.readings(keep["spec"], keep["rec"], "cuda")
            row["control_s"] = time.perf_counter() - t1
        (faults.setdefault(fault, []) if fault else rows).append(row)
        print(json.dumps(row), flush=True)
        del keep
        save()
    out = save()
    print(json.dumps({"summary": out["summary"], "faults": out["faults"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
