"""Compare two ways for a device program's launch to hand its ``out`` to the
host without a wait, on the card, on chip_smoke's phase 4 (stock preset,
2.0 s of stream):

- "pinned" (ops/device_loop.py as it stands): after the graph launch, a
  ``non_blocking`` copy of ``out`` and the counters into a pinned host slot
  of that launch, behind a CUDA event; a fetch waits on the events;
- "device": after the graph launch, a clone of ``out`` and the counters on
  the card; a fetch concatenates every launch's clone and copies them to the
  host at once.

    python3 tools/readback_modes.py [--turns 2]

One process: a warm-up run, then the modes in turns (pinned, device,
device, pinned, ...). Each run builds a new system (so it captures its
graphs again); prints per run the wall, the wall without the capture
seconds, and the ``backend.fetch`` and ``frontend.solve`` timers, then the
medians per mode as one JSON line.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cmax_slam_tpu_torch.ops import device_loop  # noqa: E402


class DeviceResult(device_loop.Result):
    """A launch's ``out`` and counters cloned on the card."""

    __slots__ = ("_dest",)

    def __init__(self, prog, dest):
        super().__init__(prog)
        self._dest = dest

    def _wait(self) -> None:
        if self._dest is not None:  # not taken by _device_fetch_all's copy
            self._take(self._dest.cpu().numpy())

    def _take(self, host) -> None:
        n = self._prog.out.numel()
        self._values = host[:n].copy()
        self._prog._count(host[n:])
        self._dest = None


def _device_readback(self, stream):
    return DeviceResult(self, self._readback.clone())


def _device_fetch_all(results):
    """One copy to the host for every clone not fetched yet."""
    pending = [r for r in results if not r.fetched]
    clones = [r for r in pending if isinstance(r, DeviceResult)]
    if clones:
        host = torch.cat([r._dest for r in clones]).cpu().numpy()
        at = 0
        for r in clones:
            size = r._dest.numel()
            r._take(host[at:at + size])
            at += size
    return _pinned_fetch_all(results)


_pinned_readback = device_loop.Program._enqueue_readback
_pinned_fetch_all = device_loop.fetch_all
MODES = {"pinned": (_pinned_readback, _pinned_fetch_all),
         "device": (_device_readback, _device_fetch_all)}


def run(mode: str) -> dict:
    device_loop.Program._enqueue_readback, device_loop.fetch_all = MODES[mode]
    try:
        _, checks, _, wall, slam, graphs = chip_smoke.run_system(label=f"readback {mode}")
    finally:
        device_loop.Program._enqueue_readback, device_loop.fetch_all = MODES["pinned"]
    timers = slam.metrics.timers
    out = {"mode": mode, "wall_s": wall, "captures_s": graphs["captures"]["s"],
           "wall_without_captures_s": wall - graphs["captures"]["s"],
           "backend_fetch_s": timers["backend.fetch"].total,
           "frontend_solve_s": timers["frontend.solve"].total,
           "failed_checks": [k for k, ok in checks.items() if not ok]}
    print("RUN " + json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/readback_modes.py needs a CUDA card")
    print(chip_smoke.card_line(), flush=True)
    run("pinned")  # warm-up: the library set-up and the kernels' builds
    runs = []
    for _ in range(args.turns):
        runs += [run(m) for m in ("pinned", "device", "device", "pinned")]
    summary = {m: {key: statistics.median(r[key] for r in runs if r["mode"] == m)
                   for key in ("wall_s", "wall_without_captures_s", "backend_fetch_s",
                               "frontend_solve_s")} for m in MODES}
    print(json.dumps({"card": chip_smoke.card_line(), "median": summary}))


if __name__ == "__main__":
    main()
