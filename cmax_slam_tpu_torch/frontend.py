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

Scheduling:
- every solve is a device program (ops/device_loop.py, the JAX package's
  _build_packet_solver and _build_stride_solver): the packets of one launch
  are solved one after another on the device, each warm-started from the
  one before, with the coarse and fine CG loops, their line searches and
  the warm-start chain inside one CUDA graph. A launch reads nothing on the
  host: the warm start stays on the device from launch to launch, and each
  estimate holds its launch's handle (``AngVelEstimate.packed``) until it is
  finalized, one wait for many launches (``finalize_batch``,
  ``frontend.host_reads``). On the CPU the same program runs eagerly.
- ``batch_sweeps`` > 0: when at least 2 packets are ready at one push (a
  stride), all of them go to one launch, padded to the JAX package's lane
  buckets: a live lane is solved, a degenerate lane returns zeros and
  resets the warm start to zero, a padding lane passes it through
  (cmax_slam_tpu/frontend.py:274-291). Otherwise each packet is a launch of
  its own. Both give the same estimates, bit for bit on the CPU.
- ``device_store``: each event is uploaded once into a device ring
  (io/devring.py) and packets are gathered from it on the device; a packet
  the ring has lapped, or any packet while the ring is out of step with the
  store, is gathered from the host store instead (one upload of the
  launch's events). Both give bit-identical solver inputs.
- the programs come from the module-level pool (ops/program_pool.py, the
  JAX package's lru_cache'd builders): a front-end leases the entry of its
  camera, LUT, packet size, ring capacity and solver options when it is
  built, with the device ring that entry's programs read; a later front-end
  of the same key, once this one is collected, captures nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import FrontendConfig
from .io import native
from .io.devring import DeviceEventRing, _next_pow2
from .io.events import EventStore
from .ops import device_loop, optim, program_pool, warp_local
from .utils.device import resolve_device, stage, to_device, upload
from .utils.metrics import TRACE, Metrics, logger


@dataclass
class AngVelEstimate:
    """One packet's angular-velocity estimate.

    In flight while ``packed`` is not None: the solve may still run on the
    device, ``packed`` is (its launch's device_loop.Result, lane) and
    ``omega``/``cost``/``iters`` hold placeholders (zeros). With
    ``Frontend.auto_finalize`` (a front-end on its own) push_events returns
    finalized estimates; in the system loop they finalize when the back-end
    integrates them. Call ``Frontend.finalize_batch(ests)`` before reading
    the fields of estimates you hold on to (the JAX package's contract)."""

    t: float
    omega: np.ndarray  # (3,) rad/s
    cost: float
    iters: int
    num_events: int
    span: Tuple[int, int] = (0, 0)  # absolute event-store indices [beg, end)
    packed: object = None


class Frontend:
    def __init__(
        self,
        cam: warp_local.CameraParams,
        lut: np.ndarray,
        cfg: FrontendConfig,
        *,
        device=None,
        store: Optional[EventStore] = None,
        metrics: Optional[Metrics] = None,
    ):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        lut = np.asarray(lut, np.float32)
        self.lut = to_device(lut, self.device)
        self.store = store if store is not None else EventStore()
        self.metrics = metrics if metrics is not None else Metrics()

        self.half = cfg.num_events_per_packet // 2
        # Pad to a multiple of the event batch size (batch-midpoint dts).
        bs = cfg.warp.event_batch_size
        self.packet_size = ((2 * self.half + bs - 1) // bs) * bs
        self._lanes = torch.arange(self.packet_size, device=self.device)

        # The ring covers >= 16 packets of reach-back (at least 2^21 events,
        # 16 MiB), rounded up to a power of two. It belongs to the pool
        # entry whose programs read it, and is emptied for each new owner.
        cap = (_next_pow2(cfg.device_store_capacity or max(16 * self.packet_size, 1 << 21))
               if cfg.device_store else 0)
        key = ("frontend", program_pool.device_key(self.device), cam, program_pool.digest(lut),
               self.packet_size, cap, bs, cfg.warp.blur_sigma, cfg.contrast_measure,
               cfg.coarse_to_fine, cfg.optim)
        self._entry = program_pool.lease(key, self, reset=_empty_ring)
        state = self._entry.state
        if not state:
            state["lut"] = self.lut
            state["ring"] = (self._entry.build(
                lambda: DeviceEventRing(cap, cam.width, device=self.device)) if cap else None)
        self._ring: Optional[DeviceEventRing] = state["ring"]

        self._initialized = False
        # Finalize estimates as push_events returns them; the system loop
        # turns this off and lets the back-end finalize them in its fetch.
        self.auto_finalize = True
        self._t0: float = 0.0  # stream epoch: all device times are t - _t0
        self._cursor: float = 0.0  # time_get_subset_
        self._t_packet: float = 0.0  # time_packet_
        self._next_check_abs = 0  # next absolute event index to scan for triggers
        self._pending: List[Tuple[int, int]] = []  # subset (beg, end) abs indices
        # Warm start (ang_vel_): on the device between launches. _carry is
        # the latest launch's handle, whose out[-3:] is that value; None
        # after a reset (a degenerate packet, the setter), when _omega_host
        # holds it.
        self._omega_dev = torch.zeros(3, dtype=torch.float32, device=self.device)
        self._omega_host = np.zeros(3, np.float32)
        self._carry: Optional[device_loop.Result] = None
        self.estimates: List[AngVelEstimate] = []
        self._launch_count = 0  # launches made: the trace's launch numbers

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
        if self._ring is not None:
            # The ring is never serialized: rebuild it from the restored
            # store's resident window.
            self._ring.resync(self.store, self._t0)

    @property
    def omega(self) -> np.ndarray:
        """Current warm-start angular velocity. Finalizes the estimates in
        flight first; the warm start comes with them (the latest launch's
        carry), in the same wait."""
        pend = [e for e in self.estimates if e.packed is not None]
        extra = (self._carry,) if self._carry is not None else ()
        vals = self.finalize_batch(pend, extra_handles=extra)
        if vals:
            return vals[0][-3:].astype(np.float64)
        return self._omega_host.astype(np.float64)

    @omega.setter
    def omega(self, value) -> None:
        self._omega_host = np.asarray(value, np.float32).reshape(3)
        self._omega_dev = to_device(self._omega_host.copy(), self.device)
        self._carry = None

    def _reset_warm_start(self) -> None:
        """A degenerate packet's reset (ang_vel_estimator.cpp:108-114), on
        the device."""
        self._omega_dev.zero_()
        self._omega_host = np.zeros(3, np.float32)
        self._carry = None

    # ------------------------------------------------------------------
    def push_events(self, xs, ys, ts, ps) -> List[AngVelEstimate]:
        """Ingest a chunk of events (stream order); returns new estimates
        (the per-event pushEvent loop, ang_vel_estimator.cpp:68-135).

        Traced (utils.metrics.TRACE), a ``frontend.push`` span whose
        children are the store's append, the ring's, the trigger scan, each
        packet's cut, each launch's marshalling (``frontend.marshal``) and
        launch (``frontend.launch``, around the ``frontend.solve`` timer),
        both with the launch's number."""
        ts = np.asarray(ts, np.float64)
        if len(ts) == 0:
            return []
        with TRACE.span("frontend.push"):
            if not self._initialized:
                self._t0 = float(ts[0])
                self._t_packet = float(ts[0]) + 0.5 * self.cfg.dt_ang_vel
                self._cursor = self._t_packet
                self._initialized = True
            with TRACE.span("frontend.store_append"):
                self.store.append(xs, ys, ts, ps)
            if self._ring is not None:
                with TRACE.span("frontend.ring_append"):
                    self._ring.append(xs, ys, (ts - self._t0).astype(np.float32))
            with TRACE.span("frontend.scan"):
                self._scan_triggers()
                ready = []
                while self._pending and self.store.total > self._pending[0][1]:
                    ready.append(self._pending.pop(0))
            if len(ready) >= 2 and self.cfg.batch_sweeps > 0:
                out = self._process_stride(ready)
            else:
                out = [self._process_packet(beg, end) for beg, end in ready]
            if self.auto_finalize:
                with TRACE.span("frontend.finalize"):
                    self.finalize_batch(out)
            return out

    def finalize_batch(self, ests: List[AngVelEstimate], extra_handles: tuple = (), *,
                       counter: Optional[str] = "frontend.host_reads") -> List[np.ndarray]:
        """Finalize the estimates in flight among ``ests`` with one wait for
        every launch they come from and every device_loop.Result in
        ``extra_handles`` (the back-end's window result rides the same
        wait); returns the extras' values on the host. The wait, if there is
        one, is counted under ``counter`` (None: the caller counts it)."""
        pend = [e for e in ests if e.packed is not None]
        launches = list({id(e.packed[0]): e.packed[0] for e in pend}.values())
        handles = launches + list(extra_handles)
        if not handles:
            return []
        if counter is not None and not all(h.fetched for h in handles):
            self.metrics.count(counter)
        vals = device_loop.fetch_all(handles)
        rows = {id(h): v for h, v in zip(launches, vals)}
        for e in pend:
            launch, lane = e.packed
            row = rows[id(launch)][5 * lane:5 * lane + 5]
            e.omega = row[:3].astype(np.float64)
            e.cost = float(row[3])
            e.iters = int(row[4])
            e.packed = None
        return vals[len(launches):]

    def close(self) -> None:
        """Kept for API symmetry with Backend.close(): the front-end holds no
        background resources (estimates finalize on the caller's thread)."""

    def _scan_triggers(self) -> None:
        """Find subset-cursor crossings among newly stored events (the C++
        scan of io/native.py, reading the store's times in place)."""
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

    def _assemble(self, idx, ts, n, t_ref) -> warp_local.EventPacket:
        """A packet from the (S,) int32 LUT indices and float32 times of its
        events, its first ``n`` lanes valid (``assemble``)."""
        return assemble(self.lut, self._lanes, idx, ts, n, t_ref, self.cfg.warp.event_batch_size)

    def _host_events(self, xs, ys, ts) -> np.ndarray:
        """(2, S) int32: LUT indices and the bits of the float32 epoch-relative
        times, zero-padded: the values the device ring holds."""
        n = len(ts)
        ev = np.zeros((2, self.packet_size), np.int32)
        ev[0, :n] = ys.astype(np.int32) * self.cam.width + xs.astype(np.int32)
        ev[1, :n] = (ts - self._t0).astype(np.float32).view(np.int32)
        return ev

    def _packet(self, xs, ys, ts, t_ref: float) -> warp_local.EventPacket:
        """One packet gathered from the host store, padded to the static size."""
        ev = to_device(self._host_events(xs, ys, ts), self.device)
        return self._assemble(ev[0], ev[1].view(torch.float32), len(ts), t_ref)

    def _ring_packet(self, beg: int, n: int, t_ref: float) -> warp_local.EventPacket:
        """Packet [beg, beg + n) gathered from the device ring: the values and
        dtypes ``_packet`` gives."""
        ring = self._ring
        idx, ts = ring.buffers
        pos = (self._lanes + beg) & (ring.capacity - 1)
        return self._assemble(idx[pos], ts[pos], n, t_ref)

    def _from_ring(self, beg: int) -> bool:
        """Whether the packet starting at absolute index ``beg`` is gathered
        from the ring: it holds every stored event (in step with the store)
        and has not lapped ``beg``."""
        ring = self._ring
        return ring is not None and ring.hi == self.store.total and ring.resident(beg)

    def _next_packet(self, beg: int, end: int):
        """Grid time and degenerate guard of the next packet [beg, end)
        (slideWindow and ang_vel_estimator.cpp:108-114). Returns (estimate
        with zeros, degenerate)."""
        _, _, ts, _ = self.store.slice_abs(beg, end)
        n = len(ts)
        t_packet = self._t_packet
        self._t_packet += self.cfg.dt_ang_vel
        timespan = float(ts[-1] - ts[0]) if n else 0.0
        est = AngVelEstimate(t=t_packet, omega=np.zeros(3), cost=0.0, iters=0, num_events=n,
                             span=(beg, end))
        self.estimates.append(est)
        return est, timespan > 10.0 * self.cfg.dt_ang_vel or n < 2

    def _process_packet(self, beg: int, end: int) -> AngVelEstimate:
        with TRACE.span("frontend.cut"):
            est, degenerate = self._next_packet(beg, end)
        if degenerate:
            self._reset_warm_start()
            return est
        self._launch([est], [1.0])
        logger.debug("[front-end] packet t=%.4f n=%d dispatched", est.t, est.num_events)
        return est

    def _process_stride(self, ready) -> List[AngVelEstimate]:
        """Every ready packet in one launch (the JAX package's
        _process_packets_batched): lanes padded to _lane_bucket; a
        degenerate lane gives zeros and resets the warm start on the device."""
        ests, flags = [], []
        with TRACE.span("frontend.cut"):
            for beg, end in ready:
                est, degenerate = self._next_packet(beg, end)
                ests.append(est)
                flags.append(0.0 if degenerate else 1.0)
        if not any(flags):  # every packet degenerate: no solve, the warm start resets
            self._reset_warm_start()
            return ests
        pad = self._lane_bucket(len(ready)) - len(ready)
        self._launch(ests + [None] * pad, flags + [-1.0] * pad)
        logger.debug("[front-end] stride of %d packets dispatched", len(ready))
        return ests

    @staticmethod
    def _lane_bucket(n: int) -> int:
        """The JAX package's lane buckets (Frontend._lane_bucket)."""
        for b in (2, 4, 6, 8, 10, 12, 16):
            if n <= b:
                return b
        return ((n + 7) // 8) * 8

    def _launch(self, ests, flags) -> None:
        """Dispatch one launch's lanes (flag 1 live, 0 degenerate, -1
        padding) to the device; each live estimate keeps (the launch's
        handle, its lane) in ``packed``, and the warm start for the next
        launch stays on the device. Each live packet is gathered from the
        ring when it is resident there, else from this launch's upload of
        its events."""
        L, S = len(flags), self.packet_size
        self._launch_count += 1
        with TRACE.span("frontend.marshal", launch=self._launch_count):
            lanes = np.zeros((L, 5), np.float64)  # [position, n, t_ref, flag, from ring]
            host = None
            for i, (e, fl) in enumerate(zip(ests, flags)):
                lanes[i, 3] = fl
                if fl <= 0:
                    continue
                beg, end = e.span
                lanes[i, 1] = e.num_events
                lanes[i, 2] = np.float32(e.t - self._t0)
                if self._from_ring(beg):
                    lanes[i, 0] = beg & (self._ring.capacity - 1)
                    lanes[i, 4] = 1.0
                    self.metrics.count("frontend.ring_packets")
                else:
                    if host is None:
                        host = np.zeros((2, L, S), np.int32)
                    lanes[i, 0] = i * S
                    xs, ys, ts, _ = self.store.slice_abs(beg, end)
                    host[:, i] = self._host_events(xs, ys, ts)
                self.metrics.count("frontend.events", e.num_events)
            solver = self._solver(L)
        with TRACE.span("frontend.launch", launch=self._launch_count), \
                self.metrics.timer("frontend.solve"), torch.no_grad():
            handle = solver.solve(lanes, self._omega_dev, host)
            self._omega_dev.copy_(solver.carry[0])
        self._carry = handle
        self.metrics.count("frontend.launches")
        if L > 1:
            self.metrics.count("frontend.stride_launches")
        for i, (e, fl) in enumerate(zip(ests, flags)):
            if fl > 0:
                e.packed = (handle, i)

    def _solver(self, lanes: int) -> "_PacketSolver":
        """The narrowest program of the leased entry with room for ``lanes``
        lanes (16 at first; a wider launch builds a wider one, and the entry
        keeps both)."""
        room = [c for c in self._entry.programs if c >= lanes]
        cap = min(room) if room else max(16, lanes)
        return self._entry.program(cap, lambda: self._count_routes(_PacketSolver(
            self.cfg, self.cam, self._entry.state, self.packet_size, self.device, cap)))

    def _count_routes(self, solver: "_PacketSolver") -> "_PacketSolver":
        """Counts a new program's objectives by route
        (``frontend.objective_fused``, ``frontend.objective_chain``)."""
        for route in solver.routes:
            self.metrics.count(f"frontend.objective_{route}")
        return solver

    # ------------------------------------------------------------------
    def render_iwe_pair(self, beg: int, end: int, omega) -> Optional[np.ndarray]:
        """Zero-motion vs motion-compensated IWE side-by-side, normalized and
        inverted (publishEventImage, ang_vel_estimator.cpp:203-233). Both
        images come from one batched vote (K1 on the card) and one copy to
        the host (a wait, counted). None when the packet has already been
        retired."""
        from .utils.image import normalize_minmax

        xs, ys, ts, _ = self.store.slice_abs(beg, end)
        if len(ts) == 0:
            return None
        packet = self._packet(xs, ys, ts, float(np.float32(0.5 * (ts[0] + ts[-1]) - self._t0)))
        omegas = torch.zeros((2, 3), dtype=torch.float32, device=self.device)
        omegas[1] = to_device(np.asarray(omega, np.float32), self.device)
        with torch.no_grad(), TRACE.span("frontend.read_iwe", wait=True):
            imgs = warp_local.local_iwe(omegas, packet, self.cam, 0.0).cpu().numpy()
        self.metrics.count("frontend.host_reads")
        stacked = np.concatenate([imgs[0], imgs[1]], axis=1)
        return 255.0 - normalize_minmax(stacked) * 255.0


def assemble(lut, lanes, idx, ts, n, t_ref, batch_size: int) -> warp_local.EventPacket:
    """A packet from the (S,) int32 LUT indices and float32 times of its
    events, its first ``n`` lanes valid (``lanes`` is arange(S)). ``n`` and
    ``t_ref`` may be device scalars."""
    valid = lanes < n
    return warp_local.EventPacket(
        bearings=lut[torch.where(valid, idx, 0)],
        dts=warp_local.batch_midpoint_dts(torch.where(valid, ts, 0.0), valid, batch_size, t_ref),
        weights=valid.to(torch.float32),
    )


def _empty_ring(entry) -> None:
    """A pool entry's reset for its next owner: the ring emptied."""
    ring = entry.state["ring"]
    if ring is not None:
        ring.reset()


class _PacketSolver:
    """The packets of one launch as one device program: the counterpart of
    the JAX package's _build_stride_solver(_ring) (and, with one lane, of
    _build_packet_solver(_ring)). Lanes run one after another under a device
    loop: each gathers its packet from the ring or from the launch's host
    upload, is solved (coarse and fine CG, each a device loop) when live, and
    hands its warm start on; dead lanes skip the solve under a conditional
    node. The lane count is read from the launch's inputs, so one program
    serves every launch of up to ``capacity`` lanes. It reads only its own
    buffers and its pool entry's ``state``: the LUT and the ring."""

    def __init__(self, cfg: FrontendConfig, cam: warp_local.CameraParams, state: dict, S: int,
                 dev, capacity: int):
        o = cfg.optim
        self.capacity = capacity
        lut, ring = state["lut"], state["ring"]

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # per lane: [position, n, t_ref, flag, from ring]
        self.lanes_in = buf(capacity, 5, dtype=torch.float64)
        self.count_in = buf(1, dtype=torch.int64)
        self.omega_in = buf(1, 3)
        self.host_in = buf(2, capacity * S, dtype=torch.int32)
        self.li = buf(1, dtype=torch.int64)
        self.flag = buf(1)
        self.packet = warp_local.EventPacket(buf(S, 3), buf(S), buf(S))
        self.carry = buf(1, 3)
        self.rows = buf(capacity, 5)
        # gates: another lane to solve (li < count_in), this lane live (flag > 0)
        self.go, self.live = device_loop.gate(dev), device_loop.gate(dev)
        lanes = torch.arange(S, device=dev)

        self.routes = []  # each objective's route, "fused" (K6) or "chain"

        def objective(sigma):
            route = warp_local.objective_route(self.packet, cam, sigma, cfg.contrast_measure)
            self.routes.append(route)
            return warp_local.make_local_objective(self.packet, cam, sigma,
                                                   cfg.contrast_measure, route=route)

        kw = dict(initial_step=o.initial_step, line_search_tol=o.line_search_tol,
                  grad_tol=o.grad_tol, fun_tol=o.fun_tol,
                  max_fevals_per_linesearch=o.max_fevals_per_linesearch,
                  stagnation_patience=o.stagnation_patience,
                  secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
                  cg_variant=o.cg_variant)
        self.coarse = None
        if cfg.coarse_to_fine:
            # Coarse stage on a 3x-blurred IWE with half the budget, then the
            # fine solve from its optimum (_build_packet_solver).
            f, vg = objective(max(cfg.warp.blur_sigma, 1.0) * 3.0)
            self.coarse = optim.LaneCG(vg, f, 1, 3, dev, max_iters=o.max_line_searches // 2,
                                       name="coarse", **kw)
        f, vg = objective(cfg.warp.blur_sigma)
        self.fine = optim.LaneCG(vg, f, 1, 3, dev, max_iters=o.max_line_searches, name="fine",
                                 **kw)

        def start():
            self.li.zero_()
            self.carry.copy_(self.omega_in)
            self.rows.zero_()
            torch.lt(self.li, self.count_in, out=self.go)

        def load():
            lane = self.lanes_in.index_select(0, self.li)[0]
            pos0, n, t_ref = lane[0].long(), lane[1].long(), lane[2].float()
            from_ring = lane[4] > 0
            pos = lanes + torch.where(from_ring, 0, pos0)
            idx, ts = self.host_in[0][pos], self.host_in[1].view(torch.float32)[pos]
            if ring is not None:
                ridx, rts = ring.buffers
                rpos = (lanes + torch.where(from_ring, pos0, 0)) & (ring.capacity - 1)
                idx = torch.where(from_ring, ridx[rpos], idx)
                ts = torch.where(from_ring, rts[rpos], ts)
            packet = assemble(lut, lanes, idx, ts, n, t_ref, cfg.warp.event_batch_size)
            for b, v in zip(self.packet, packet):
                b.copy_(v)
            self.flag.copy_(lane[3:4])
            torch.gt(self.flag, 0, out=self.live)

        def store():
            cg, live = self.fine, self.flag > 0
            iters = cg.s.it + (self.coarse.s.it if self.coarse is not None else 0)
            row = torch.cat([cg.s.x[0], cg.s.f, iters.float()])
            self.rows.index_copy_(0, self.li, torch.where(live, row, 0.0)[None])
            keep = torch.where(self.flag < 0, self.carry, torch.zeros_like(self.carry))
            self.carry.copy_(torch.where(live, cg.s.x, keep))
            self.li.add_(1)
            torch.lt(self.li, self.count_in, out=self.go)

        def finish():
            self.out.copy_(torch.cat([self.rows.reshape(-1), self.carry[0]]))

        def solve_lane(b):
            x0 = self.carry
            if self.coarse is not None:
                self.coarse.solve(b, x0)
                x0 = self.coarse.s.x
            self.fine.solve(b, x0)

        def build(b):
            b.seg(start)

            def lane():
                b.seg(load)
                b.when(self.live, lambda: solve_lane(b), name="live")
                b.seg(store)

            b.repeat(self.go, lane, name="lanes")
            b.seg(finish)

        self.program = device_loop.Program(build, capacity * 5 + 3, dev, name="frontend")
        self.out = self.program.out

    def solve(self, lanes: np.ndarray, omega0: torch.Tensor,
              host: Optional[np.ndarray]) -> device_loop.Result:
        """Launch one solve: ``lanes`` (L, 5) [position, n, t_ref, flag, from
        ring], the warm start (a (3,) device tensor) and, if any lane is
        gathered from the host, the (2, L, S) events; the uploads are staged
        (utils.device.to_device). Returns the launch's handle: lane i's
        [omega, cost, iters] at ``out[5i:5i+5]``, the next warm start at
        ``out[-3:]`` (and in ``carry`` until the next launch)."""
        L = len(lanes)
        dev = self.lanes_in.device
        lanes_h = stage(lanes, dev)
        host_h = None if host is None else stage(host.reshape(2, -1), dev)
        with TRACE.span("frontend.upload", device=True):
            self.lanes_in[:L].copy_(upload(lanes_h, dev))
            self.count_in.fill_(L)
            self.omega_in.copy_(omega0.reshape(1, 3))
            if host_h is not None:
                self.host_in[:, :host_h.shape[1]].copy_(upload(host_h, dev))
        return self.program.run()
