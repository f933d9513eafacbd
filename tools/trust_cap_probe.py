"""The trust cap's spread on the card: phase 4 of chip_smoke.py (the stock
ijrr preset on 2.0 s of its stream) run several times, each run's
per-window largest knot corrections printed with its first window's and
its median, then chip_smoke's trust run at caps that are fractions of the
first stock run's first-window correction, several times each, with the
windows and bootstrap re-solves it rejected. One JSON line per run on
stdout; the whole record in chiprun_out/trust_cap_probe.json.

    python tools/trust_cap_probe.py [--stock 2] [--fractions 0.5:3,0.6:4,0.9:3]

Needs one CUDA card; run from the root of a checkout."""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stock", type=int, default=2, help="stock runs of phase 4")
    ap.add_argument("--fractions", default="0.5:3,0.6:4,0.9:3",
                    help="fraction:runs pairs of the trust run's cap")
    args = ap.parse_args()
    out, t0 = {"stock": [], "trust": []}, time.time()
    for rep in range(args.stock):
        _, checks, _, _, slam, graphs = chip_smoke.run_system(
            "cuda", label=f"stock{rep}", audit=True, shapes={})
        c = graphs["corrections"]
        online = [x["deg"] for x in c if x["pass"] == "online"]
        row = {"checks_passed": all(checks.values()), "first_deg": online[0],
               "median_deg": float(np.median(online)),
               "corrections": [(x["index"], x["pass"], round(x["deg"], 5)) for x in c]}
        out["stock"].append(row)
        print("STOCK", json.dumps(row), flush=True)
        del slam
    first = out["stock"][0]["first_deg"]
    for pair in args.fractions.split(","):
        frac, reps = float(pair.split(":")[0]), int(pair.split(":")[1])
        for _ in range(reps):
            _, checks, stats = chip_smoke.run_option("trust", cap_deg=frac * first,
                                                     phase4_pred=0)
            row = {"fraction": frac, "cap_deg": frac * first, "windows": stats["windows"],
                   "rejected_online": stats["rejected_online"],
                   "rejected_bootstrap": stats["rejected_bootstrap"],
                   "checks_failed": [k for k, v in checks.items() if not v],
                   "corrections": [(x["index"], x["pass"], x["rejected"], round(x["deg"], 5))
                                   for x in stats["corrections"]]}
            out["trust"].append(row)
            print("TRUST", json.dumps(row), flush=True)
    print(f"seconds {time.time() - t0:.1f}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "trust_cap_probe.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
