"""Where the time goes in chip_smoke's ecrot runs, on a CUDA card.

    python3 tools/profile_ecrot.py [--shed] [--out _work/profile_ecrot.json]

Builds the libraries as chip_smoke.py does, then runs chip_smoke.run_ecrot
three times in one process on the whole 1.2 s stream: the stock
ecrot_real_config(), or with --shed ecrot_mount_config() with the
reference's live-mode shedding. The first run (a fresh configuration:
programs built and captured; in a fresh process also the card's context and
PyTorch's lazy imports, as a CLI run pays them) and the second (the pooled
programs, nothing captured) run under cProfile: the host functions by
cumulative time. The third, warm too, runs under torch.profiler. Device time
of the programs' graphs comes from run_ecrot's CUDA events around each
launch: the profiler records only part of the kernels inside graphs launched
through csrc/loop.cu, so its kernel list is mostly the device work outside
them (uploads, window assembly, eager kernels). Prints the card's name and
power limit, and writes the numbers as JSON to --out.
"""

import cProfile
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.io import native  # noqa: E402
from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote, device_loop, nvcc  # noqa: E402


def _arg(name: str, default):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def _host_profile(label: str, shed: bool):
    """One run_ecrot under cProfile: (its stats, the port's functions by
    cumulative host seconds)."""
    host = cProfile.Profile()
    host.enable()
    run = chip_smoke.run_ecrot(label=label, shed=shed)
    host.disable()
    rows = []
    for (path, line, fn), (_, ncalls, _, cum, _) in pstats.Stats(host).stats.items():
        if path.startswith(chip_smoke.REPO) and "chip_smoke" not in path:
            rows.append({"function": f"{os.path.relpath(path, chip_smoke.REPO)}:{line} {fn}",
                         "calls": ncalls, "cumulative_s": cum})
    rows.sort(key=lambda r: -r["cumulative_s"])
    return run[2], rows


def main() -> None:
    shed = "--shed" in sys.argv
    out_path = _arg("--out", os.path.join("_work", "profile_ecrot.json"))
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    if not native.available():
        native.build()
    nvcc.compile_all([cuda_iwe.build_job(), device_loop.build_job(), cuda_pano_vote.build_job()])
    cuda_iwe.build()
    device_loop.build()
    cuda_pano_vote.build()
    chip_smoke.make_ecrot_stream(chip_smoke.ECROT_DURATION, chip_smoke.ECROT_RATE)  # cached

    first_stats, rows = _host_profile("first", shed)
    warm_host_stats, warm_rows = _host_profile("warm_host", shed)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        warm = chip_smoke.run_ecrot(label="warm", shed=shed)
        wall = time.perf_counter() - t0
    kernels = [{"kernel": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total]
    kernels.sort(key=lambda k: -k["device_ms"])
    device_ms = sum(k["device_ms"] for k in kernels)
    out = {"card": card, "shed": shed,
           "first": {"wall_s": first_stats["wall_s"], "captures": first_stats["captures"],
                     "timers": first_stats["timers"],
                     "device_ms_by_program": first_stats["device_ms_by_program"],
                     "host_by_cumulative_s": rows[:40]},
           "warm_host": {"wall_s": warm_host_stats["wall_s"],
                         "timers": warm_host_stats["timers"],
                         "host_by_cumulative_s": warm_rows[:40]},
           "warm": {"wall_s": warm[2]["wall_s"], "profiled_block_s": wall,
                    "captures": warm[2]["captures"],
                    "device_ms_by_program": warm[2]["device_ms_by_program"],
                    "profiler_device_ms": device_ms, "profiler_kernels": kernels[:40]}}
    print(f"first run: wall {first_stats['wall_s']:.3f} s, captures "
          f"{json.dumps(first_stats['captures'])}; host functions by cumulative s:")
    for r in rows[:25]:
        print(f"  {r['cumulative_s']:8.3f} s {r['calls']:7d}  {r['function']}")
    print(f"second run (warm) under cProfile: wall {warm_host_stats['wall_s']:.3f} s, timers "
          f"{json.dumps(warm_host_stats['timers'])}; host functions by cumulative s:")
    for r in warm_rows[:25]:
        print(f"  {r['cumulative_s']:8.3f} s {r['calls']:7d}  {r['function']}")
    programs = warm[2]["device_ms_by_program"]
    print(f"warm run under torch.profiler: wall {warm[2]['wall_s']:.3f} s; the programs' "
          f"graphs {json.dumps(programs)} (CUDA events); the profiler's kernels "
          f"{device_ms:.1f} ms, by device ms:")
    for k in kernels[:25]:
        print(f"  {k['device_ms']:9.3f} ms {k['calls']:6d}  {k['kernel'][:90]}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(f"card: {card}; JSON in {out_path}")


if __name__ == "__main__":
    main()
