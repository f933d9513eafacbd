"""Time K2 (vote_bwd) on a CUDA card at the launch shapes that set its two
constants in cmax_slam_tpu_torch/ops/cuda_iwe.py.

    python3 tools/tune_vote_bwd.py [--out _work/tune_vote_bwd.json]

S_MIN_IMAGES is the number of images per launch from which S (one block
per staged image) beats G (a thread per event); G_BWD_THREADS is G's block
size, compiled in. At chip_smoke.py's K2 shapes and at lane buckets of
front-end images around S_MIN_IMAGES, the tool launches G built with blocks
of 32 to 256 threads (one library each) and S where the image stages
whole, all in "paths" mode (no dw, as the paths call K2). It holds each
against the plain version's autograd (max abs error) and times each by
device time (chip_smoke's device_ms over 50 raw launches into
preallocated gradients; CUDA-events time beside it in the JSON). It prints
one line per shape with the planner's pick and the fastest launch, and
writes every number to the JSON file.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe  # noqa: E402

SHAPES = [s[:5] + (s[6],) for s in chip_smoke.SHAPES if "bwd" in s[5]] + [
    # Narrower lane buckets at the front-end size (phase 6's later rounds),
    # around S_MIN_IMAGES.
    ("b16", 16, 10_000, 180, 240, (16, 16)),
    ("b32", 32, 10_000, 180, 240, (32, 32)),
    ("b48", 48, 10_000, 180, 240, (48, 48)),
    ("b64", 64, 10_000, 180, 240, (64, 64)),
    ("b96", 96, 10_000, 180, 240, (96, 96)),
]
G_BLOCKS = (32, 64, 128, 256)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("_work", "tune_vote_bwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    sms, optin = cuda_iwe.device_attrs(torch.device("cuda", 0))
    print(f"{sms} SMs, {optin} B shared memory per block (opt-in)", flush=True)
    chosen = cuda_iwe.G_BWD_THREADS
    for threads in G_BLOCKS:  # build every G library before timing any
        cuda_iwe.G_BWD_THREADS = threads
        cuda_iwe.build()
    rng = np.random.default_rng(0)
    results = {"card": card, "sms": sms, "smem_optin": optin, "shapes": {}}
    for tag, b, n, H, W, rows in SHAPES:
        px, py, wt = chip_smoke._events(rng, n, H, W, rows, "cuda")
        g = torch.tensor(rng.normal(size=(b, H, W)).astype(np.float32), device="cuda")
        _, _, ref = chip_smoke._plain_grads(px, py, wt, g, H, W, min(rows))
        tol = 1e-5 * b * max(1.0, float(g.abs().max()))
        dpx, dpy = (torch.empty((b, n), device="cuda") for _ in range(2))
        bd = chip_smoke.bound("bwd", b, n, H, W, rows, "paths")
        picked = cuda_iwe.plan_vote_bwd(b, n, H, W, sms, optin).variant
        cands = [(f"G/{t}", "G", t) for t in G_BLOCKS]
        if cuda_iwe.stages_whole(H, W, optin):
            cands.append(("S", "S", chosen))
        timed = {}
        for label, variant, threads in cands:
            cuda_iwe.G_BWD_THREADS = threads
            plan = cuda_iwe.plan_vote_bwd(b, n, H, W, sms, optin, variant=variant)

            def launch(plan=plan):
                cuda_iwe.launch_bwd(plan, px, py, wt, g, dpx, dpy, None, b)

            launch()
            torch.cuda.synchronize()
            err = max(float((cuda_iwe.sum_rows(d, t.shape[0]) - r).abs().max())
                      for d, t, r in zip((dpx, dpy), (px, py), ref))
            ms, events_ms = chip_smoke.device_ms(launch)
            timed[label] = {"device_ms": ms, "events_ms": events_ms, "max_abs_err": err,
                            "ok": err <= tol}
        cuda_iwe.G_BWD_THREADS = chosen
        mine = picked if picked == "S" else f"G/{chosen}"
        best = min(timed, key=lambda k: timed[k]["device_ms"])
        print(f"{tag:9s} B={b} N={n} {H}x{W}: bound {bd['bound_ms'] * 1e3:.2f} us; planner "
              f"{mine} {timed[mine]['device_ms'] * 1e3:.2f} us; "
              f"best {best} {timed[best]['device_ms'] * 1e3:.2f} us; "
              + ", ".join(f"{k} {v['device_ms'] * 1e3:.2f}{'' if v['ok'] else ' WRONG'}"
                          for k, v in timed.items()), flush=True)
        results["shapes"][tag] = {"b": b, "n": n, "H": H, "W": W, "rows": rows, **bd,
                                  "planner": mine, "timed": timed}
        del px, py, wt, g, ref, dpx, dpy
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    bad = [(t, k) for t, s in results["shapes"].items() for k, v in s["timed"].items()
           if not v["ok"]]
    if bad:
        print(f"launch shapes that disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
