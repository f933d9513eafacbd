"""Time K3 (vote_jvp) designs on a CUDA card: the two constants compiled
into csrc/iwe.cu (cuda_iwe.JVP_ITEMS, events a thread, and
cuda_iwe.JVP_TANGENTS, tangent images a chunk).

    python3 tools/tune_vote_jvp.py [--out _work/tune_vote_jvp.json]

Builds one library per design of DESIGNS (-DIWE_JVP_ITEMS,
-DIWE_JVP_TANGENTS), one nvcc each, all started together. The inputs:
chip_smoke.py's JVP_SHAPES (uniform draws with dropped events) and the
derivative images of a phase-4 window (K3's own operands, from a stock
2 s system run, the window chip_smoke's derivative-images phase takes).
At each it holds every design against the plain version (within 1e-5 of
the largest pixel, the dropped events alone voting exact zeros) and times
each with the zero fill of its output by device time (chip_smoke's
device_ms), in turns: the designs in order, then in reverse. It prints one
line per input and writes every number to the JSON file.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe, nvcc, scatter, warp_pano  # noqa: E402

# (events a thread, tangent images a chunk)
DESIGNS = ((4, 4), (4, 3), (4, 5), (4, 2), (2, 4), (2, 2), (8, 2), (8, 4))


def _use(design) -> None:
    cuda_iwe.JVP_ITEMS, cuda_iwe.JVP_TANGENTS = design


def window_operands() -> tuple:
    """K3's operands (px, py, w, tpx, tpy, H, W) at the derivative images
    of a phase-4 window, and its dropped events."""
    seen, vote_jvp = [], cuda_iwe.vote_jvp

    def spy(*args):
        seen.append(args)
        return vote_jvp(*args)

    slam = chip_smoke.run_system(label="tune")[4]
    cuda_iwe.vote_jvp = spy
    try:
        warp_pano.derivative_images(*chip_smoke.derivative_window(slam))
    finally:
        cuda_iwe.vote_jvp = vote_jvp
    px, py, wt, tpx, tpy, H, W, _ = seen[0]
    dropped = ~(scatter.inbounds_mask(px[0], py[0], H, W) & (wt[0] != 0))
    return (px, py, wt, tpx, tpy, H, W), dropped


def time_designs(tag, ops, dropped) -> dict:
    px, py, wt, tpx, tpy, H, W = ops
    T, n = tpx.shape
    ref = scatter.bilinear_accumulate_jvp(px[0], py[0], wt[0], tpx, tpy, H, W)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    img = torch.empty((T, H, W), device="cuda")
    dead = [t[:, dropped].contiguous() for t in (px, py, wt, tpx, tpy)]
    out = {"tol": tol, "bound": chip_smoke.bound("jvp", T, n, H, W, (1, 1)),
           "piles": chip_smoke.pile_stats(px, py, wt, H, W), "designs": {}}
    for d in DESIGNS:
        _use(d)
        img.zero_()
        cuda_iwe.launch_jvp(px, py, wt, tpx, tpy, img, T, H, W)
        none = torch.zeros((T, H, W), device="cuda")
        cuda_iwe.launch_jvp(*dead, none, T, H, W)
        torch.cuda.synchronize()
        err = float((img - ref).abs().max())
        if not (err <= tol and not bool(none.any())):
            raise AssertionError(f"{tag} design {d}: max err {err} (tol {tol}), dropped events "
                                 f"voted {bool(none.any())}")
        out["designs"][f"{d[0]}/{d[1]}"] = {"max_abs_err": err, "device_ms": []}
    for d in DESIGNS + DESIGNS[::-1]:
        _use(d)

        def call():
            img.zero_()
            cuda_iwe.launch_jvp(px, py, wt, tpx, tpy, img, T, H, W)

        out["designs"][f"{d[0]}/{d[1]}"]["device_ms"].append(chip_smoke.device_ms(call)[0])
    out["fill_ms"] = chip_smoke.device_ms(img.zero_)[0]
    print(f"{tag} T={T} N={n} {H}x{W}, bound {out['bound']['bound_ms'] * 1e3:.2f} us, fill "
          f"{out['fill_ms'] * 1e3:.2f} us; with the fill, us in turns: " + "; ".join(
              f"{d} {'/'.join(f'{t * 1e3:.2f}' for t in r['device_ms'])}"
              for d, r in out["designs"].items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("_work", "tune_vote_jvp.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    chosen = (cuda_iwe.JVP_ITEMS, cuda_iwe.JVP_TANGENTS)
    jobs = []
    for d in DESIGNS:
        _use(d)
        jobs.append(cuda_iwe.build_job())
    nvcc.compile_all(jobs)
    _use(chosen)
    results = {"card": card, "chosen": f"{chosen[0]}/{chosen[1]}", "inputs": {}}
    rng = np.random.default_rng(0)
    for tag, T, n, H, W in chip_smoke.JVP_SHAPES:
        px, py, wt = chip_smoke._events(rng, n, H, W, (1, 1), "cuda")
        tpx, tpy = (torch.tensor(rng.normal(size=(T, n)).astype(np.float32), device="cuda")
                    for _ in range(2))
        tpx[:, n // 5:n // 5 + 3] = float("nan")  # the NaN coordinates' tangents, as chip_smoke
        results["inputs"][tag] = time_designs(tag, (px, py, wt, tpx, tpy, H, W),
                                              chip_smoke._dropped(n))
    _use(chosen)
    ops, dropped = window_operands()
    results["inputs"]["real"] = time_designs("real", ops, dropped)
    _use(chosen)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
