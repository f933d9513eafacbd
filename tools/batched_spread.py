"""Run-to-run spread of batched tracking (chip_smoke.py phase 6) on a CUDA
card, under one or more values of the K1 planner's P_MAX_BANDS.

    python3 tools/batched_spread.py [--runs 20] [--max-bands 4 10]

Runs ``chip_smoke.run_batched`` ``--runs`` times in one process, taking the
``--max-bands`` values in turn, and prints per run the value, the rate, the
median and worst lane error against the ground truth and the K1 launches
per variant (the lines phase 6 prints).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--max-bands", type=int, nargs="+", default=[cuda_iwe.P_MAX_BANDS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}", flush=True)
    for i in range(args.runs):
        cuda_iwe.P_MAX_BANDS = args.max_bands[i % len(args.max_bands)]
        print(f"run {i} P_MAX_BANDS={cuda_iwe.P_MAX_BANDS}", flush=True)
        _, checks = chip_smoke.run_batched()
        if not all(checks.values()):
            print(f"run {i}: phase 6 checks failed: {checks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
