"""Runs one cell several times, each run a process of its own (run.py), and
summarizes the spread of each metric.

    python3 portbench/sets.py --workload ijrr.replay --seeds 1,2,3 --seconds 15 \
        [--trace 0] [--out out/sets_ijrr.json]

Per metric: the values, the median, the quartiles (statistics.quantiles,
n=4) and their distance as a share of the median. Prints one line per run
and the summary last."""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def spread(values: list) -> dict:
    med = statistics.median(values)
    out = {"values": values, "median": med}
    if len(values) >= 2:
        q1, _, q3 = statistics.quantiles(values, n=4)
        out.update(q1=q1, q3=q3, spread=(q3 - q1) / abs(med) if med else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(BENCH_DIR / "run.py"), "--workload", args.workload,
               "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            line = None
        run = {"seed": int(seed), "rc": proc.returncode, "wall_s": wall, "line": line}
        if line is None or proc.returncode != 0:
            run["stderr_tail"] = proc.stderr[-4000:]
        runs.append(run)
        print(json.dumps(run), flush=True)
    good = [r["line"] for r in runs if r["line"] is not None]
    names = sorted({k for line in good for k in line["metrics"]})
    summary = {"workload": args.workload, "seconds": args.seconds, "trace": args.trace,
               "correct": [line["correct"] for line in good],
               "metrics": {k: spread([line["metrics"][k]["value"] for line in good
                                      if k in line["metrics"]]) for k in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
