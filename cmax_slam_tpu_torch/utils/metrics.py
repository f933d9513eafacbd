"""Timing, counters and throughput; host-only copy of cmax_slam_tpu/utils/metrics.py.

The reference only has VLOG counters for function/gradient evaluations
(src/frontend/local_focus_funcs.cpp:80, local_optim_contrast_gsl.cpp:222-223);
SURVEY.md section 5 calls for proper step timing + events/sec metrics in the
rebuild — this module provides them.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

logger = logging.getLogger("cmax_slam_tpu_torch")


def configure_logging(verbosity: int = 0) -> None:
    """glog-style verbosity (the reference runs with --v N, src/node.cpp:11):
    0 = warnings, 1 = info (packets/windows), 2+ = debug (solver detail)."""
    level = (
        logging.WARNING if verbosity <= 0
        else logging.INFO if verbosity == 1
        else logging.DEBUG
    )
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname).1s %(message)s",
                          datefmt="%H:%M:%S")
    )
    logger.handlers[:] = [handler]
    logger.setLevel(level)


@dataclass
class TimerStat:
    count: int = 0
    total: float = 0.0
    minimum: float = float("inf")
    maximum: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.minimum = min(self.minimum, dt)
        self.maximum = max(self.maximum, dt)

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class Metrics:
    """Lightweight process-local metrics registry."""

    def __init__(self):
        self.timers: Dict[str, TimerStat] = defaultdict(TimerStat)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].add(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def throughput(self, counter: str, timer: str) -> float:
        """counter units per second of timer time (e.g. events/sec)."""
        t = self.timers[timer].total
        return self.counters[counter] / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "timers": {
                k: {"count": v.count, "total_s": v.total, "mean_s": v.mean}
                for k, v in self.timers.items()
            },
            "counters": dict(self.counters),
        }

    def log_summary(self) -> None:
        logger.info("metrics: %s", json.dumps(self.summary(), indent=2))
