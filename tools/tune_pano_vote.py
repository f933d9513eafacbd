"""Time K4 (pano_vote_fwd) and K5 (pano_vote_bwd) on a CUDA card at
chip_smoke.py's PANO_SHAPES, over the events per block that set
FWD_EVENTS and BWD_EVENTS in cmax_slam_tpu_torch/ops/cuda_pano_vote.py.

    python3 tools/tune_pano_vote.py [--out _work/tune_pano_vote.json]

First prints what ptxas reports for each kernel of csrc/pano_vote.cu
(registers, spills, shared memory; nvcc -Xptxas -v with the library's
flags). Then at each shape it launches K4 with 256 and 512 events per
block and K5 with 192, 256 and 288, holds each against the plain version
(the image within 1e-5 of its largest pixel, dL/ddelta within rtol 2e-3,
atol 2e-6 of its scale, two K5 launches torch.equal) and times each by
device time (chip_smoke's device_ms: torch.profiler over 50 raw launches,
K4 with the zero fill of its images, K5's two kernels), in turns: the
launch shapes in order, then in reverse. Then each once more through a
build with -DPANO_PROFILE, in which a thread of each block writes the
time at each of its marks (MARKS): printed per mark as the median and
largest time from the block's start over the blocks, with the launch's
span and the spread of the blocks' starts, beside each kernel's own mean
device time (K4 and its fill, K5's two kernels). Prints one line per
shape and writes every number to the JSON file.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote, nvcc, warp_pano  # noqa: E402

FWD = (256, 512)       # K4's events per block timed
BWD = (192, 256, 288)  # K5's


def ptxas_report(out_dir: str) -> str:
    """nvcc's -Xptxas -v report for csrc/pano_vote.cu, built beside the
    library into ``out_dir``."""
    so = os.path.join(out_dir, "pano_vote_ptxas.so")
    proc = subprocess.run([nvcc.find_nvcc(), *cuda_pano_vote.nvcc_flags(), "-Xptxas", "-v",
                           "-o", so, str(cuda_pano_vote.SOURCE)],
                          capture_output=True, text=True, check=True)
    return proc.stderr


def profile_library():
    """The kernels built with -DPANO_PROFILE (phase times per block, see
    csrc/pano_vote.cu), loaded with the library's argument types."""
    import ctypes

    flags = (*cuda_pano_vote.nvcc_flags(), "-DPANO_PROFILE")
    path = nvcc.library_path(cuda_pano_vote.SOURCE, flags, "libpano_vote_profile")
    nvcc.compile_all([(cuda_pano_vote.SOURCE, flags, path)])
    lib, ref = ctypes.CDLL(str(path)), cuda_pano_vote.build()
    for name in ("iwe_pano_vote_fwd", "iwe_pano_vote_bwd", "iwe_pano_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    lib.iwe_pano_set_profile.argtypes = [ctypes.c_void_p]
    return lib


SLOTS = 8  # kProfSlots in csrc/pano_vote.cu
MARKS = {"K4": {1: "rotations", 2: "thread 0 projected", 3: "votes in the table",
                4: "table flushed"},
         "K5": {1: "rotations", 2: "thread 0's event chained", 3: "thread 0's dL/dR stored",
                4: "dual factors", 5: "dual tangents", 6: "all joined", 7: "partial written"}}


def phases(fn, lib, blocks: int, kernel: str) -> dict:
    """One call of ``fn`` through the profile build: for each mark of
    MARKS[kernel], the median and largest time from the block's start over
    the blocks (clock64 cycles and globaltimer us), the launch's span from
    the first block's start to the last mark and the spread of the blocks'
    starts (globaltimer, us)."""
    buf = torch.zeros((blocks, 2 * SLOTS), dtype=torch.int64, device="cuda")
    saved = cuda_pano_vote._loaded["lib"]
    cuda_pano_vote._loaded["lib"] = lib
    try:
        lib.iwe_pano_set_profile(buf.data_ptr())
        fn()
        torch.cuda.synchronize()
        lib.iwe_pano_set_profile(None)
    finally:
        cuda_pano_vote._loaded["lib"] = saved
    a = buf.cpu().numpy().astype(np.float64)
    ns, clk = a[:, :SLOTS], a[:, SLOTS:]
    last = max(MARKS[kernel])
    seen = ns[:, last] > 0
    out = {"blocks": blocks, "span_us": float((ns[seen, last].max() - ns[:, 0].min()) / 1e3),
           "start_spread_us": float((ns[:, 0].max() - ns[:, 0].min()) / 1e3)}
    for i, name in MARKS[kernel].items():
        ok = (ns[:, i] > 0) & (ns[:, 0] > 0)
        if ok.any():
            c, t = clk[ok, i] - clk[ok, 0], (ns[ok, i] - ns[ok, 0]) / 1e3
            out[name] = {"cycles": [float(np.median(c)), float(c.max())],
                         "us": [float(np.median(t)), float(t.max())]}
    return out


def kernel_split(fn, reps: int = 50) -> dict:
    """Mean device time (us) of each kernel ``fn`` launches, over ``reps``
    calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def launch_shapes(ebs: int):
    """[(kernel, events per block)] timed at a shape with batches of ebs
    events."""
    cap = cuda_pano_vote.events_cap(ebs)
    return ([("K4", e) for e in sorted({min(e, cap) for e in FWD})]
            + [("K5", e) for e in sorted({min(e, cap) for e in BWD})])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("_work", "tune_pano_vote.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    report = ptxas_report(os.path.dirname(os.path.abspath(args.out)))
    print(report, flush=True)
    nvcc.compile_all([cuda_iwe.build_job(), cuda_pano_vote.build_job()])
    prof_lib = profile_library()
    dev = torch.device("cuda", 0)
    sms = cuda_iwe.device_attrs(dev)[0]
    floor_ms = float(np.mean([chip_smoke.device_ms(lambda: cuda_iwe.launch_noop(dev))[0]
                              for _ in range(2)]))
    rng = np.random.default_rng(0)
    results = {"card": card, "ptxas": report, "floor_ms": floor_ms, "shapes": {}}
    ok = True
    for tag, order, M, span, n_events, image in chip_smoke.PANO_SHAPES:
        win, pano, basis, origin, hw = chip_smoke.pano_case(order, span, n_events, image)
        K, B, N = win.knots.shape[0], win.batch_times.shape[0], win.weights.shape[0]
        ebs = N // B
        live = int((win.weights != 0).sum())
        delta = torch.tensor(rng.normal(size=(M, K, 3)) * 2e-3, dtype=torch.float32,
                             device="cuda")
        args_ = (win, pano, order, hw, origin, basis)
        ref = warp_pano.pano_vote_plain(delta, *args_)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        g = torch.tensor(rng.normal(size=(M, *hw)), dtype=torch.float32, device="cuda")
        d = delta.clone().requires_grad_(True)
        g_ref = torch.autograd.grad(warp_pano.pano_vote_plain(d, *args_), d, g)[0]
        g_tol = 2e-3 * float(g_ref.abs().max()) + 2e-6
        ops = cuda_pano_vote.prepare(delta, win, basis, pano, order, origin)
        fns, checks, blocks = {}, {}, {}
        for kernel, per_block in launch_shapes(ebs):
            key = f"{kernel} {per_block}"
            if kernel == "K4":
                img = torch.zeros((M, *hw), device="cuda")
                cuda_pano_vote.launch_fwd(ops, img, *hw, per_block)
                err = float((img - ref).abs().max())
                checks[key] = {"err": err, "ok": err <= tol}

                def fn(img=img, per_block=per_block):
                    img.zero_()
                    cuda_pano_vote.launch_fwd(ops, img, *hw, per_block)
            else:
                part = cuda_pano_vote.bwd_scratch(ops, per_block)
                dd = [torch.empty_like(ops.delta) for _ in range(2)]
                for x in dd:
                    cuda_pano_vote.launch_bwd(ops, g, part, x, per_block)
                err = float((dd[0] - g_ref).abs().max())
                same = bool(torch.equal(*dd))
                checks[key] = {"err": err, "equal": same, "ok": err <= g_tol and same}

                def fn(part=part, x=dd[0], per_block=per_block):
                    cuda_pano_vote.launch_bwd(ops, g, part, x, per_block)
            fns[key] = fn
            blocks[key] = M * -(-N // per_block)
        torch.cuda.synchronize()
        times = {key: [] for key in fns}
        for key in [*fns, *reversed(fns)]:
            times[key].append(chip_smoke.device_ms(fns[key])[0])
        bounds = {k: chip_smoke.pano_bound(k, M, N, live, B, K, order, *hw)["bound_ms"]
                  for k in ("pano_fwd", "pano_bwd")}
        rows = {key: checks[key] | {"device_ms": float(np.mean(t)), "turns": t}
                for key, t in times.items()}
        for key, n_blocks in blocks.items():
            rows[key]["phases"] = phases(fns[key], prof_lib, n_blocks, key.split()[0])
            rows[key]["kernels_us"] = kernel_split(fns[key])
        results["shapes"][tag] = {"batches": B, "ebs": ebs, "M": M, "K": K, "bound_ms": bounds,
                                  "tol": tol, "g_tol": g_tol, "launches": rows,
                                  "plan": {"K4": cuda_pano_vote.fwd_events(ebs, M * N, sms),
                                           "K5": cuda_pano_vote.bwd_events(ebs)}}
        ok &= all(r["ok"] for r in rows.values())
        for key in blocks:
            print(f"  {tag} {key}: kernels (us) {json.dumps(rows[key]['kernels_us'])}; "
                  f"{json.dumps(rows[key]['phases'])}", flush=True)
        print(f"{tag}: bound K4 {bounds['pano_fwd'] * 1e3:.2f} us, K5 "
              f"{bounds['pano_bwd'] * 1e3:.2f} us; floor {floor_ms * 1e3:.2f} us; "
              + "; ".join(f"{key} {r['device_ms'] * 1e3:.2f} us (err {r['err']:.2e}"
                          f"{'' if r['ok'] else ' FAILED'})" for key, r in rows.items()),
              flush=True)
        del ops, fns
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
