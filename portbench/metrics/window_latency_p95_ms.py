"""The 95th percentile, over every back-end window whose last event was
pushed inside the window, of the time from the issue of that push to the
first poll (after a push returns, or after the final flush) that found the
window's result."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
