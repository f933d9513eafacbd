"""Multi-device FULL-SYSTEM replay: one SLAM system per time segment, stitched
on the overlaps; counterpart of cmax_slam_tpu/parallel/replay.py.

The reference is strictly sequential — one ROS node, one stream
(src/cmax_slam.cpp; SURVEY.md section 2.3). Offline, a long recording can be
cut into N time segments, each replayed by a complete independent system
(front-end + back-end + global map) on its own device, and the per-segment
trajectories stitched into one:

- each segment gets ``overlap`` seconds of lead-in whose estimates are
  discarded: the front-end converges from cold in a few packets and the
  back-end is anchored by its own window protocol, so segment interiors
  match the sequential system away from the boundary;
- rotation-only SLAM has a global SO(3) gauge per segment; on the overlap
  both trajectories observe the same motion, so the relative gauge
  A = argmin_R sum_t ||R_a(t) - R R_b(t)||_F (rotation Procrustes over the
  overlap samples) aligns segment b onto a, and chaining the alignments
  gives one trajectory;
- devices never communicate during the replay; only tens of quaternions
  cross, on the host, for the stitch.

The port's solves sync the host once per objective evaluation, so one thread
feeding the segments in turn would run them one after another. Each segment
is fed from its own host thread instead (the GIL is released inside the
torch ops and device syncs). Segments are independent, so the result does
not depend on the interleaving.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import lie
from ..calib import CameraCalibration
from ..config import SystemConfig
from ..system import CMaxSLAM
from ..utils.device import resolve_devices
from ..utils.evaluate import align_global, quat_to_rotmats
from ..utils.metrics import logger


@dataclass
class Segment:
    index: int
    device: torch.device
    t_lo: float          # feed start (includes lead-in)
    t_hi: float          # feed end
    t_keep_lo: float     # stitched output span [t_keep_lo, t_keep_hi)
    t_keep_hi: float
    slam: CMaxSLAM = None
    ev_lo: int = 0
    ev_hi: int = 0


def _procrustes_quat(q_a: np.ndarray, q_b: np.ndarray) -> np.ndarray:
    """Rotation A (3x3) minimizing sum ||R(q_a_i) - A R(q_b_i)||_F."""
    return align_global(quat_to_rotmats(q_a), quat_to_rotmats(q_b))


def _each_segment(segs: List[Segment], fn) -> None:
    """fn(seg) for every segment, one host thread each; errors re-raise."""
    with ThreadPoolExecutor(len(segs)) as ex:
        list(ex.map(fn, segs))


def replay_multichip(
    xs: np.ndarray,
    ys: np.ndarray,
    ts: np.ndarray,
    ps: np.ndarray,
    calib: CameraCalibration,
    cfg: SystemConfig,
    n_segments: int,
    overlap: float = 0.4,
    chunk_events: int = 50_000,
    *,
    devices,
    sample_dt: float = 0.01,
    refine_passes: int = 0,
):
    """Replay a full recording as ``n_segments`` independent SLAM systems,
    segment i on ``devices[i]``, and stitch the trajectories.

    ``devices`` is required; repeats are allowed (``["cuda:0", "cuda:0"]``
    runs two segments on one card). ``refine_passes > 0`` runs that many
    offline refinement sweeps (CMaxSLAM.refine) per segment before
    stitching, all segments concurrently.

    Returns (times, quats, segments): the stitched trajectory sampled every
    ``sample_dt`` seconds (gauge of segment 0) and the per-segment systems
    for inspection (maps, logs, window results).
    """
    devices = resolve_devices(devices)
    if n_segments > len(devices):
        raise ValueError(
            f"{n_segments} segments need {n_segments} devices, have {len(devices)}")
    t0, t1 = float(ts[0]), float(ts[-1])
    span = (t1 - t0) / n_segments
    if span <= 2 * overlap and n_segments > 1:
        raise ValueError("segments shorter than twice the overlap")

    segs: List[Segment] = []
    for i in range(n_segments):
        keep_lo = t0 + i * span
        keep_hi = t0 + (i + 1) * span
        lo = keep_lo - (overlap if i > 0 else 0.0)
        hi = min(keep_hi + overlap, t1)  # tail overlap feeds the alignment
        seg = Segment(index=i, device=devices[i], t_lo=lo, t_hi=hi,
                      t_keep_lo=keep_lo, t_keep_hi=keep_hi,
                      ev_lo=int(np.searchsorted(ts, lo, side="left")),
                      ev_hi=int(np.searchsorted(ts, hi, side="right")))
        seg.slam = CMaxSLAM(calib, cfg, device=seg.device)
        segs.append(seg)

    def feed(seg: Segment) -> None:
        for a in range(seg.ev_lo, seg.ev_hi, chunk_events):
            b = min(a + chunk_events, seg.ev_hi)
            seg.slam.push_events(xs[a:b], ys[a:b], ts[a:b], ps[a:b])
        seg.slam.close()

    _each_segment(segs, feed)
    if refine_passes > 0:
        refine_segments(segs, xs, ys, ts, ps, refine_passes)
    return stitch_segments(segs, sample_dt) + (segs,)


def refine_segments(segs: List[Segment], xs, ys, ts, ps, passes: int = 1) -> None:
    """Run offline refinement sweeps on every segment concurrently, one host
    thread per segment."""

    def refine(seg: Segment) -> None:
        sl = slice(seg.ev_lo, seg.ev_hi)
        seg.slam.refine((xs[sl], ys[sl], ts[sl], ps[sl]), passes=passes)

    _each_segment(segs, refine)


def stitch_segments(segs: List[Segment], sample_dt: float = 0.01):
    """Gauge-align consecutive segment trajectories on their overlaps and
    concatenate the kept spans. Returns (times, quats)."""
    A = np.eye(3)  # cumulative alignment onto segment 0's gauge
    all_t: List[np.ndarray] = []
    all_q: List[np.ndarray] = []
    prev = None
    for seg in segs:
        seg.slam.flush()  # idempotent; guards direct stitch_segments callers
    for seg in segs:
        traj = seg.slam.backend.traj
        lo = max(seg.t_keep_lo, traj.t_beg + 1e-6)
        hi = min(seg.t_keep_hi, traj.max_time() - 1e-6)
        if prev is not None:
            # Overlap where BOTH trajectories are defined.
            ptraj = prev.slam.backend.traj
            o_lo = max(traj.t_beg + 1e-6, seg.t_lo)
            o_hi = min(ptraj.max_time() - 1e-6, prev.t_hi)
            if o_hi <= o_lo:
                raise RuntimeError(
                    f"segments {prev.index}/{seg.index} have no usable "
                    f"overlap ({o_lo:.3f} >= {o_hi:.3f})")
            n = max(int((o_hi - o_lo) / sample_dt), 4)
            t_ov = np.linspace(o_lo, o_hi, n)
            # prev is already in the global gauge via A; the local alignment
            # maps curr onto prev, then A maps onto the global gauge.
            A = A @ _procrustes_quat(ptraj.evaluate(t_ov), traj.evaluate(t_ov))
            logger.info("[replay] stitched segment %d -> %d over [%.3f, %.3f] "
                        "(%d samples)", prev.index, seg.index, o_lo, o_hi, n)
        times = np.arange(lo, hi, sample_dt)
        if len(times):
            R = quat_to_rotmats(traj.evaluate(times))
            q_al = lie.from_matrix(torch.as_tensor(A[None] @ R, dtype=torch.float64))
            all_t.append(times)
            all_q.append(q_al.numpy())
        prev = seg
    return np.concatenate(all_t), np.concatenate(all_q)
