"""The table of peaks and the work of each objective, computed from shapes
alone, so that the count stays the same whatever kernels implement it.

Work counts each input read once and each output written once, and the
floating-point operations the mathematics needs; a share of the roofline is
the least time these allow (the larger of bytes over the memory's rate and
operations over the float32 rate) over the time measured.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM part: 3.35 TB/s of HBM3 and 67 TFLOP/s
# of float32 outside the tensor cores, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}

# Operations a value and gradient need: per event, the first-order warp and
# projection (about 30) and four bilinear votes (about 16), twice that for
# the gradient; per image pixel, a separable 9-tap blur each way (36) and
# the contrast's sums (4), both ways.
PACKET_FLOPS_PER_EVENT = 3 * 46
PIXEL_FLOPS = 2 * 40
# Per window event of the back-end: the spline's rotation at its batch is
# shared by the batch; the rotation of the bearing and the equirectangular
# projection (about 60 with the arc tangent and arc sine) and the votes.
WINDOW_FLOPS_PER_EVENT = 3 * 76


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def packet_objective_work(n: int, height: int, width: int) -> dict:
    """One value and gradient of the front-end packet objective on n events
    of a height x width sensor: per event its pixel index, time and weight
    (12 bytes) and the bearing of its pixel (12 bytes, at most one per
    pixel); out the value and the 3-vector gradient (16 bytes)."""
    pixels = height * width
    nbytes = 12 * n + 12 * min(n, pixels) + 16
    flops = PACKET_FLOPS_PER_EVENT * n + PIXEL_FLOPS * pixels
    return {"bytes": nbytes, "flops": flops}


def window_objective_work(n: int, knots: int, crop_h: int, crop_w: int,
                          cam_pixels: int) -> dict:
    """One value and gradient of the back-end crop objective on n live
    window events: per event its pixel index, time and weight (12 bytes)
    and its pixel's bearing (12, at most one per camera pixel); the knots
    (16 bytes each); the image-side operands, the map's crop and its mask
    (8 bytes a crop pixel); out the value and the 3-per-knot gradient."""
    crop = crop_h * crop_w
    nbytes = 12 * n + 12 * min(n, cam_pixels) + 16 * knots + 8 * crop + 4 * (1 + 3 * knots)
    flops = WINDOW_FLOPS_PER_EVENT * n + PIXEL_FLOPS * crop
    return {"bytes": nbytes, "flops": flops}


def bound_s(work: dict, peak: dict) -> float:
    """The least time the chip could take for ``work``."""
    return max(work["bytes"] / peak["bytes_per_s"], work["flops"] / peak["fp32_flops"])


def share_pct(work: dict, peak: dict | None, seconds: float | None) -> float | None:
    """The bound over the measured time, in percent; None where nothing was
    measured or the card has no row in the table."""
    if peak is None or not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(work, peak) / seconds


def capture_and_time(vg, x, reps: int = 200) -> float:
    """Seconds per evaluation of ``vg(x)`` captured alone into a CUDA graph and
    replayed ``reps`` times between CUDA events (chip_smoke.py's
    split_objectives takes an objective so)."""
    import torch
    from cmax_slam_tpu_torch.ops import cuda_iwe

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        vg(x)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), cuda_iwe.recording([]):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            vg(x)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    del graph
    return ms / 1e3
