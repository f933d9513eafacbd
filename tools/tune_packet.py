"""Time K6 (packet_objective, cmax_slam_tpu_torch/csrc/packet.cu) on a CUDA
card at chip_smoke.py's PACKET_SHAPES, phase by phase.

    python3 tools/tune_packet.py [--out _work/tune_packet.json] [--only packet,padding]

First prints what ptxas reports for each form of the kernel (registers,
spills; nvcc -Xptxas -v with the library's flags). Then at each shape it
launches both forms ("vg", "f") of the library's build, timed by device time
(chip_smoke's device_ms: torch.profiler over 50 raw launches), and of a
build with -DPACKET_PROFILE, in which the first thread of each block of
the first cluster stamps %globaltimer at the end of each phase (MARKS):
printed per phase as the largest time over the blocks from the previous
stamp, in us, the median of 20 launches. Writes every number to the JSON
file.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_packet, nvcc  # noqa: E402

# The stamps of csrc/packet.cu's STAMP(i), each the end of a phase.
MARKS = ("start", "zero", "vote", "pass_w", "cluster_sync", "halos", "pass_h", "sums+value",
         "dL/dI", "pass_w^T+sync", "halos+pass_h^T", "gather", "gradient")


def ptxas_report() -> str:
    """nvcc's -Xptxas -v report for csrc/packet.cu with the library's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([nvcc.find_nvcc(), *cuda_packet.nvcc_flags(), "-Xptxas", "-v",
                               "-o", os.path.join(tmp, "packet_ptxas.so"),
                               str(cuda_packet.SOURCE)], capture_output=True, text=True,
                              check=True)
    return proc.stderr


def profile_library():
    """K6 built with -DPACKET_PROFILE, loaded with the library's argument
    types and its stamps' reader."""
    flags = (*cuda_packet.nvcc_flags(), "-DPACKET_PROFILE")
    path = nvcc.library_path(cuda_packet.SOURCE, flags, "libpacket_profile")
    nvcc.compile_all([(cuda_packet.SOURCE, flags, path)])
    lib, ref = ctypes.CDLL(str(path)), cuda_packet.build()
    for name in ("packet_allow_smem", "packet_objective", "packet_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    lib.packet_profile_read.argtypes = [ctypes.c_void_p]
    lib.packet_profile_read.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="_work/tune_packet.json")
    ap.add_argument("--only", default=None, help="comma-separated PACKET_SHAPES tags")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    card = chip_smoke.card_line()
    print(card, flush=True)
    print(ptxas_report(), flush=True)
    prof = profile_library()
    dev = torch.device("cuda")
    smem = cuda_iwe.device_attrs(dev)[1]
    cuda_packet.allow_smem(dev)
    with torch.cuda.device(dev):
        assert prof.packet_allow_smem(smem) == 0
    only = None if args.only is None else set(args.only.split(","))
    out = {"card": card, "marks": MARKS, "shapes": {}}
    for tag, b, n, measure, kind, camera in chip_smoke.PACKET_SHAPES:
        if only is not None and tag not in only:
            continue
        packet, cam, omega, u = chip_smoke._stream_packet(n, kind, camera)
        plan = cuda_packet.plan_packet_vg(b, n, cam.height, cam.width, 1.0, measure, smem)
        tables, margins = cuda_packet.band_tables(cam.height, cam.width, 1.0, str(dev))
        ops = tuple(t.float().contiguous() for t in packet)
        x = torch.as_tensor(omega[None] + 0.05 * np.arange(b)[:, None] * u[None],
                            dtype=torch.float32, device=dev)
        value = torch.empty(b, device=dev)
        grad = torch.empty((b, 3), device=dev)
        entry = {"b": b, "n": n, "hw": [cam.height, cam.width], "plan": plan._asdict()}
        for form, g in (("vg", grad), ("f", None)):
            def run():
                cuda_packet.launch(plan, measure, ops, x, cam, tables, margins, value, g)

            dev_ms, ev_ms = chip_smoke.device_ms(run)
            cuda_packet._loaded["lib"], saved = prof, cuda_packet._loaded["lib"]
            stamps = []
            try:
                for _ in range(20):
                    run()
                    torch.cuda.synchronize()
                    buf = np.zeros((8, 16), np.uint64)
                    assert prof.packet_profile_read(buf.ctypes.data) == 0
                    stamps.append(buf.astype(np.int64))
            finally:
                cuda_packet._loaded["lib"] = saved
            st = np.median(np.stack(stamps), axis=0)  # (blocks, marks) ns
            last = 12 if form == "vg" else 7
            phases = {MARKS[i]: float((st[:, i] - st[:, i - 1]).max()) / 1e3
                      for i in range(1, last + 1)}
            span = float((st[:, last].max() - st[:, 0].min()) / 1e3)
            entry[form] = {"device_us": dev_ms * 1e3, "events_us": ev_ms * 1e3,
                           "span_us": span, "phases_us": phases,
                           "start_spread_us": float((st[:, 0].max() - st[:, 0].min()) / 1e3)}
            print(f"{tag} {form}: device {dev_ms * 1e3:.2f} us (events {ev_ms * 1e3:.2f}); "
                  f"first cluster's span {span:.2f} us (starts spread "
                  f"{entry[form]['start_spread_us']:.2f}); phases "
                  + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()), flush=True)
        out["shapes"][tag] = entry
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
