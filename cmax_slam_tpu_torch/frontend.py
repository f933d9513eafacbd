"""Front-end: sliding-window angular-velocity estimation by CMax; counterpart
of cmax_slam_tpu/frontend.py.

Rebuild of AngVelEstimator (src/frontend/ang_vel_estimator.cpp). A
vectorized host-side packetizer over an EventStore cuts packets; each
packet's contrast maximization (warp -> vote -> blur -> variance, FR-CG with
the configured ladder) runs on the front-end's device, warm-started from the
previous packet's solution.

Packet semantics mirror the reference (ang_vel_estimator.cpp:68-135):
- output timestamps on a rigid grid t_k = t_first + dt_ang_vel/2 + k*dt;
- a packet is centered on the first event crossing the subset cursor:
  absolute indices [i+1-half, i+1+half) where half = num_events_per_packet/2;
- the warp reference time is the grid time t_k, not the event midpoint;
- a packet spanning more than 10*dt_ang_vel of wall time (or with fewer
  than 2 events) yields omega = 0 and resets the warm start;
- omega is warm-started from the previous packet.

Scheduling: the JAX package can solve a stride's packets in one device
program (``batch_sweeps``) and gather them from a device-resident event ring
(``device_store``); both are documented there to give the per-packet path's
solver inputs and warm-start chain. The port runs the sequential per-packet
chain for any value of either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import FrontendConfig
from .io import native
from .io.events import EventStore
from .ops import optim, warp_local
from .utils.device import resolve_device
from .utils.metrics import Metrics, logger


@dataclass
class AngVelEstimate:
    """One packet's angular-velocity estimate."""

    t: float
    omega: np.ndarray  # (3,) rad/s
    cost: float
    iters: int
    num_events: int
    span: Tuple[int, int] = (0, 0)  # absolute event-store indices [beg, end)


class Frontend:
    def __init__(
        self,
        cam: warp_local.CameraParams,
        lut: np.ndarray,
        cfg: FrontendConfig,
        *,
        device,
        store: Optional[EventStore] = None,
        metrics: Optional[Metrics] = None,
    ):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lut = torch.as_tensor(np.asarray(lut, np.float32), device=self.device)
        self.store = store if store is not None else EventStore()
        self.metrics = metrics if metrics is not None else Metrics()

        self.half = cfg.num_events_per_packet // 2
        # Pad to a multiple of the event batch size (batch-midpoint dts).
        bs = cfg.warp.event_batch_size
        self.packet_size = ((2 * self.half + bs - 1) // bs) * bs

        self._initialized = False
        self._t0: float = 0.0  # stream epoch: all device times are t - _t0
        self._cursor: float = 0.0  # time_get_subset_
        self._t_packet: float = 0.0  # time_packet_
        self._next_check_abs = 0  # next absolute event index to scan for triggers
        self._pending: List[Tuple[int, int]] = []  # subset (beg, end) abs indices
        self._omega = torch.zeros(3, dtype=torch.float32)  # warm start (ang_vel_), host
        self.estimates: List[AngVelEstimate] = []

    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """Packetizer state with the keys of the JAX package's
        Frontend.checkpoint: grid phase, trigger-scan cursor, pending packet
        spans and the warm-start omega."""
        return {
            "fe_initialized": self._initialized,
            "fe_t0": self._t0,
            "fe_cursor": self._cursor,
            "fe_t_packet": self._t_packet,
            "fe_next_check_abs": self._next_check_abs,
            "fe_pending": np.asarray(self._pending, np.int64).reshape(-1, 2),
            "fe_omega": self.omega,
        }

    def restore(self, d) -> None:
        """Inverse of checkpoint()."""
        self._initialized = bool(d["fe_initialized"])
        self._t0 = float(d["fe_t0"])
        self._cursor = float(d["fe_cursor"])
        self._t_packet = float(d["fe_t_packet"])
        self._next_check_abs = int(d["fe_next_check_abs"])
        self._pending = [(int(a), int(b)) for a, b in np.asarray(d["fe_pending"]).reshape(-1, 2)]
        self.omega = np.asarray(d["fe_omega"], np.float64)

    @property
    def omega(self) -> np.ndarray:
        """Current warm-start angular velocity."""
        return self._omega.numpy().astype(np.float64)

    @omega.setter
    def omega(self, value) -> None:
        self._omega = torch.as_tensor(np.asarray(value, np.float32))

    # ------------------------------------------------------------------
    def push_events(self, xs, ys, ts, ps) -> List[AngVelEstimate]:
        """Ingest a chunk of events (stream order); returns new estimates
        (the per-event pushEvent loop, ang_vel_estimator.cpp:68-135)."""
        ts = np.asarray(ts, np.float64)
        if len(ts) == 0:
            return []
        if not self._initialized:
            self._t0 = float(ts[0])
            self._t_packet = float(ts[0]) + 0.5 * self.cfg.dt_ang_vel
            self._cursor = self._t_packet
            self._initialized = True
        self.store.append(xs, ys, ts, ps)
        self._scan_triggers()
        out = []
        while self._pending and self.store.total > self._pending[0][1]:
            out.append(self._process_packet(*self._pending.pop(0)))
        return out

    def finalize_batch(self, ests: List[AngVelEstimate]) -> List:
        """Materialize in-flight estimates. Every port estimate is final when
        it is returned (its solve reads f and g on the host), so there is
        nothing to fetch; kept so that callers written for the JAX front-end,
        which finalizes lazily, run unchanged."""
        return []

    def _scan_triggers(self) -> None:
        """Find subset-cursor crossings among newly stored events."""
        store = self.store
        rel_next = max(self._next_check_abs - store.base, 0)
        trig, self._cursor, rel_next = native.scan_triggers(
            store._ts, self._cursor, rel_next, self.cfg.dt_ang_vel)
        self._next_check_abs = store.base + rel_next
        for idx_rel in trig:
            count = store.base + int(idx_rel) + 1
            self._pending.append((max(count - self.half, 0), count + self.half))

    def min_needed_abs_index(self) -> int:
        """Oldest absolute event index the front-end may still read: pending
        packet starts and the reach-back of the next (unformed) packet. The
        back-end clamps its prefix retirement to this (deleteOldEvents'
        min(idx_backend, ev_beg_idx_), ang_vel_estimator.cpp:149-152)."""
        candidates = [max(self.store.total - self.half, 0)]
        if self._pending:
            candidates.append(self._pending[0][0])
        return min(candidates)

    def _packet(self, xs, ys, ts, t_ref: float) -> warp_local.EventPacket:
        """Pad one packet to the static size and gather its bearings."""
        n = len(ts)
        S = self.packet_size
        idx = np.zeros(S, np.int64)
        idx[:n] = ys.astype(np.int64) * self.cam.width + xs
        ts_rel = np.zeros(S, np.float32)
        ts_rel[:n] = (ts - self._t0).astype(np.float32)
        valid = np.zeros(S, bool)
        valid[:n] = True
        dev = self.device
        valid_t = torch.as_tensor(valid, device=dev)
        return warp_local.EventPacket(
            bearings=self.lut[torch.as_tensor(idx, device=dev)],
            dts=warp_local.batch_midpoint_dts(
                torch.as_tensor(ts_rel, device=dev), valid_t,
                self.cfg.warp.event_batch_size, t_ref),
            weights=valid_t.to(torch.float32),
        )

    def _process_packet(self, beg: int, end: int) -> AngVelEstimate:
        cfg = self.cfg
        xs, ys, ts, _ = self.store.slice_abs(beg, end)
        n = len(ts)
        t_packet = self._t_packet
        self._t_packet += cfg.dt_ang_vel  # slideWindow (ang_vel_estimator.cpp:175-182)

        timespan = float(ts[-1] - ts[0]) if n else 0.0
        if timespan > 10.0 * cfg.dt_ang_vel or n < 2:
            # Degenerate packet guard (ang_vel_estimator.cpp:108-114)
            self._omega = torch.zeros(3, dtype=torch.float32)
            est = AngVelEstimate(t=t_packet, omega=np.zeros(3), cost=0.0, iters=0,
                                 num_events=n, span=(beg, end))
            self.estimates.append(est)
            return est

        o = cfg.optim

        def minimize(packet, sigma, x0, max_ls):
            f, vg = warp_local.make_local_objective(packet, self.cam, sigma,
                                                    cfg.contrast_measure)
            return optim.minimize_fr_cg(
                vg, x0.to(self.device), f_fn=f,
                max_line_searches=max_ls, initial_step=o.initial_step,
                line_search_tol=o.line_search_tol, grad_tol=o.grad_tol,
                fun_tol=o.fun_tol, max_fevals_per_linesearch=o.max_fevals_per_linesearch,
                stagnation_patience=o.stagnation_patience,
                secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
                cg_variant=o.cg_variant,
            )

        with self.metrics.timer("frontend.solve"), torch.no_grad():
            packet = self._packet(xs, ys, ts, float(np.float32(t_packet - self._t0)))
            x0, iters_coarse = self._omega, 0
            if cfg.coarse_to_fine:
                # Coarse stage on a 3x-blurred IWE with half the budget, then
                # the fine solve from its optimum (the JAX package's
                # _build_packet_solver); iterations of both are reported.
                coarse = minimize(packet, max(cfg.warp.blur_sigma, 1.0) * 3.0, x0,
                                  o.max_line_searches // 2)
                x0, iters_coarse = coarse.x, coarse.iters
            res = minimize(packet, cfg.warp.blur_sigma, x0, o.max_line_searches)
        self._omega = res.x
        self.metrics.count("frontend.events", n)
        est = AngVelEstimate(t=t_packet, omega=res.x.numpy().astype(np.float64),
                             cost=res.fun, iters=res.iters + iters_coarse, num_events=n,
                             span=(beg, end))
        self.estimates.append(est)
        logger.debug("[front-end] packet t=%.4f n=%d iters=%d", t_packet, n, res.iters)
        return est

    # ------------------------------------------------------------------
    def render_iwe_pair(self, beg: int, end: int, omega) -> Optional[np.ndarray]:
        """Zero-motion vs motion-compensated IWE side-by-side, normalized and
        inverted (publishEventImage, ang_vel_estimator.cpp:203-233). Both
        images come from one batched vote (K1 on the card) and one copy to
        the host. None when the packet has already been retired."""
        from .utils.image import normalize_minmax

        xs, ys, ts, _ = self.store.slice_abs(beg, end)
        if len(ts) == 0:
            return None
        packet = self._packet(xs, ys, ts, float(np.float32(0.5 * (ts[0] + ts[-1]) - self._t0)))
        omegas = torch.zeros((2, 3), dtype=torch.float32, device=self.device)
        omegas[1] = torch.as_tensor(np.asarray(omega, np.float32), device=self.device)
        with torch.no_grad():
            imgs = warp_local.local_iwe(omegas, packet, self.cam, 0.0).cpu().numpy()
        stacked = np.concatenate([imgs[0], imgs[1]], axis=1)
        return 255.0 - normalize_minmax(stacked) * 255.0
