"""Time every K1 (vote_fwd) variant and launch shape on a CUDA card, to set
the planner's thresholds in cmax_slam_tpu_torch/ops/cuda_iwe.py.

    python3 tools/tune_vote_fwd.py [--out _work/tune_vote_fwd.json]

The planner reads two thresholds: P_MIN_IMAGES (images per launch from
which P beats G) and P_MAX_BANDS (bands per image beyond which it does
not). At chip_smoke.py's phase-3 shapes, plus narrower lane buckets and
wide launches of larger images around those crossovers, it launches G and P
in 1 to 6 bands (at least as many as the shared memory needs), each against
the plain vote on the same inputs (max abs error), and times each by device
time (chip_smoke's device_ms over 50 raw launches into a preallocated
image, zero fill included for G; CUDA-events time beside it in the JSON).
Prints one line per shape with the planner's pick and the fastest launch,
and writes every number to the JSON file.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe, scatter  # noqa: E402

EXTRA = (
    # Narrower lane buckets at the front-end size (phase 6's later rounds).
    ("b16", 16, 10_000, 180, 240, (16, 16)),
    ("b24", 24, 10_000, 180, 240, (24, 24)),
    ("b32", 32, 10_000, 180, 240, (32, 32)),
    ("b48", 48, 10_000, 180, 240, (48, 48)),
    ("b64", 64, 10_000, 180, 240, (64, 64)),
    ("b96", 96, 10_000, 180, 240, (96, 96)),
    ("b128", 128, 10_000, 180, 240, (128, 128)),
    # Wide launches of larger images around P_MAX_BANDS: the back-end crop
    # (3 bands at the tallest), the ijrr panorama (10) and a 1024x2048 one (37).
    ("crop24", 24, 1 << 18, 384, 384, (24, 24)),
    ("pano24", 24, 1 << 18, 512, 1024, (24, 24)),
    ("pano1k24", 24, 1 << 18, 1024, 2048, (24, 24)),
)


def plans(b, n, H, W, sms, optin):
    """(label, VotePlan) for every launch shape tried at this shape: G, and
    P in 1 to 6 bands, at least as many as the shared memory needs."""
    out = [("G", cuda_iwe.plan_vote_fwd(b, n, H, W, sms, optin, variant="G"))]
    tall = cuda_iwe.band_rows(H, W, optin)
    if tall is None:
        return out
    for min_bands in range(tall[1], max(tall[1], 6) + 1):
        rows, bands = cuda_iwe.band_rows(H, W, optin, min_bands)
        out.append((f"P{bands}", cuda_iwe.VotePlan("P", rows, bands, 4 * rows * W)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("_work", "tune_vote_fwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    sms, optin = cuda_iwe.device_attrs(torch.device("cuda", 0))
    print(f"{sms} SMs, {optin} B shared memory per block (opt-in)", flush=True)
    rng = np.random.default_rng(0)
    results = {"card": card, "sms": sms, "smem_optin": optin, "shapes": {}}
    shapes = [s[:5] + (s[6],) for s in chip_smoke.SHAPES] + list(EXTRA)
    for tag, b, n, H, W, rows in shapes:
        px, py, wt = chip_smoke._events(rng, n, H, W, rows, "cuda")
        r0 = min(rows)
        ref = scatter.bilinear_accumulate(*(chip_smoke._lead(t, r0) for t in (px, py, wt)),
                                          H, W).reshape(b, H, W)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        img = torch.empty((b, H, W), device="cuda")
        bd = chip_smoke.bound("fwd", b, n, H, W, rows)
        picked = cuda_iwe.plan_vote_fwd(b, n, H, W, sms, optin)
        cands = plans(b, n, H, W, sms, optin)
        if all(plan != picked for _, plan in cands):
            cands.append(("planner", picked))
        mine = next(label for label, plan in cands if plan == picked)
        timed = {}
        for label, plan in cands:
            def launch(plan=plan):
                if plan.variant != "P":
                    img.zero_()
                cuda_iwe.launch_fwd(plan, px, py, wt, img, b, H, W)

            launch()
            torch.cuda.synchronize()
            err = float((img - ref).abs().max())
            ms, events_ms = chip_smoke.device_ms(launch)
            timed[label] = {"plan": plan._asdict(), "device_ms": ms, "events_ms": events_ms,
                            "max_abs_err": err, "ok": err <= tol}
        best = min(timed, key=lambda k: timed[k]["device_ms"])
        print(f"{tag:9s} B={b} N={n} {H}x{W}: bound {bd['bound_ms'] * 1e3:.2f} us; planner "
              f"{mine} {timed[mine]['device_ms'] * 1e3:.2f} us; "
              f"best {best} {timed[best]['device_ms'] * 1e3:.2f} us; "
              + ", ".join(f"{k} {v['device_ms'] * 1e3:.2f}{'' if v['ok'] else ' WRONG'}"
                          for k, v in timed.items()), flush=True)
        results["shapes"][tag] = {"b": b, "n": n, "H": H, "W": W, "rows": rows, **bd,
                                  "planner": mine, "timed": timed}
        del img, ref
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    bad = [(t, k) for t, s in results["shapes"].items() for k, v in s["timed"].items()
           if not v["ok"]]
    if bad:
        print(f"launch shapes that disagree with the plain vote: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
