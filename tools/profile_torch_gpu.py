"""Profile the PyTorch port's main path on a CUDA card with torch.profiler.

    python3 tools/profile_torch_gpu.py

Replays chip_smoke.py's stream on the stock ijrr preset: 0.5 s of stream as
warm-up, 0.4 s timed without the profiler, then the next 0.4 s under the
profiler. Prints the unprofiled wall time, the device time of the profiled
window (kernels only), their ratio as the device busy share, and the top ops
by device and by host time.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.config import ijrr_config  # noqa: E402
from cmax_slam_tpu_torch.system import CMaxSLAM  # noqa: E402

CHUNK = 39_000  # 0.1 s of stream


def main() -> None:
    ev, _, calib = chip_smoke.make_stream(2.0)
    slam = CMaxSLAM(calib, ijrr_config(), device="cuda")

    def push(lo, hi):
        for i in range(lo, hi, CHUNK):
            slam.push_events(ev.xs[i:i + CHUNK], ev.ys[i:i + CHUNK], ev.ts[i:i + CHUNK],
                             ev.pols[i:i + CHUNK])
        torch.cuda.synchronize()

    push(0, 5 * CHUNK)
    t0 = time.perf_counter()
    push(5 * CHUNK, 9 * CHUNK)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        push(9 * CHUNK, 13 * CHUNK)
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"unprofiled wall {wall_ms:.1f} ms per 0.4 s of stream; device time of the "
          f"next 0.4 s {dev_ms:.1f} ms; busy share {dev_ms / wall_ms:.3f}")
    print(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))
    print(json.dumps({k: round(v.total, 3) for k, v in slam.metrics.timers.items()}))


if __name__ == "__main__":
    main()
