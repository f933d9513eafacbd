"""Runs one cell of the port's benchmark and prints its result's line.

    python3 portbench/run.py --workload ijrr.replay --seed 7 --seconds 15 --trace 0

from the root of a checkout. With --trace 0 the line's metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (a traced
window). The last line of standard output is one JSON object; the numbers
the comparison with the plain reference read, each beside its limit, are
the last lines of standard error and the line's last key, "checks".
Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every cache of a build or a kernel stays inside the checkout, at a fixed path.
CACHE = ROOT / "_portbench_cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # One process with one compute thread on the host: with torch's and the
    # BLAS libraries' thread pools on every core, runs read 3-4% slower on
    # the card's shared host.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    from pb import cell, harness

    bench = cell.benchmark(ROOT)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       t_start=T_START, root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules the benchmark may not load were loaded: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps(line))
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
