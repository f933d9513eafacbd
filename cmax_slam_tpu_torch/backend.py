"""Back-end: sliding-window rotational bundle adjustment by global CMax;
counterpart of cmax_slam_tpu/backend.py.

Rebuild of PoseGraphOptimizer (src/backend/pose_graph_optimizer.cpp) as a
host-side state machine over the shared EventStore. Window protocol
(pose_graph_optimizer.cpp:244-354):

- windows of ``time_window_size`` slide by ``sliding_window_stride``;
- front-end angular velocities are trapezoid-integrated into absolute poses
  (post-multiplicative exp updates, :191-222);
- new control poses are fitted to those poses over the fresh ang-vel span
  and appended (dropping the first ``degree`` knots that overlap, :254-278);
- knots before the window, and the first knot(s) of the very first window,
  are frozen (:261-264, 283-288);
- each window's BA minimizes -contrast of the panoramic IWE over the free
  knot increments (FR-CG, sequential ladder), by default on a crop around
  the window's footprint (exact; a full-pano re-solve if the optimum
  escapes the crop);
- events with ts < t_win_beg + stride vote into IL_old and are absorbed into
  the global map IG after the solve, saturated per pixel by an update-count
  map grown from dilated FOV footprints every 0.05 s (:303-337).

The maps (``IG``, ``update_times``) stay resident on the back-end's device.
Each window's solve is one device program (ops/device_loop.py, the JAX
package's _build_crop_solver and _build_window_solver): the per-window
constants are computed on the device and copied into the program's static
buffers, then one graph launch runs the CG solve with its bounded restarts,
the old/new split, the optimum's bounding box and the map epilogue into
one packed array (knots, f0, fun, iters, alpha, bbox). On the CPU the same
program runs eagerly.

A window completes one step late, as in the JAX package: ``step()``
dispatches the window's program and returns, and the next ``step()`` (or
``flush()``) fetches its packed result together with every front-end
estimate in flight that the next window integrates, in one wait
(``_fused_fetch``, ``backend.host_reads``), then writes the knots back and
promotes the maps (``_complete_pending``). The host prepares the next stride
while the device solves the window. The crop-escape re-solve, the bootstrap
re-solve and ``refine_pass`` stay synchronous, as in the JAX package.

The window programs come from the module-level pool (ops/program_pool.py,
the JAX package's lru_cache'd _build_crop_solver and _build_window_solver):
a back-end leases the entry of its panorama, spline order, options and LUT
when it is built, and a later back-end of the same key, once this one is
collected, captures nothing. A program reads only its own buffers: the maps
are copied into them at each launch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import spline
from .calib import EquirectCamera
from .config import IMAGE_GRADIENT_MAGNITUDE_CONTRAST, BackendConfig
from .io.events import EventStore
from .ops import device_loop, optim, program_pool, warp_pano
from .ops.blur import opencv_ksize
from .ops.scatter import bilinear_accumulate_two
from .ops.warp_pano import PanoWindow
from .utils.device import resolve_device, to_device
from .utils.metrics import TRACE, Metrics, logger


@dataclass
class WindowResult:
    index: int
    t_beg: float
    t_end: float
    num_events: int
    ran_ba: bool
    initial_cost: float
    final_cost: float
    iters: int
    # True when the BA correction was rejected by the max_ba_correction_rad
    # trust region (the front-end knots were kept, the map not updated).
    rejected: bool = False
    # The solve's largest knot correction (rad): the angle between a knot
    # the window started from and the same knot solved, at most over the
    # window's knots, the angle max_ba_correction_rad is held to. 0 without BA.
    correction_rad: float = 0.0


class Backend:
    # Crop-dimension ladder, the JAX package's values: a bounded set of crop
    # shapes, and the same shapes on both systems for the parity tests.
    _CROP_LADDER = (128, 256, 384, 512, 640, 768, 1024, 1280, 1536,
                    2048, 2560, 3072, 4096)

    def __init__(
        self,
        cam_width: int,
        cam_height: int,
        lut: np.ndarray,
        cfg: BackendConfig,
        store: EventStore,
        *,
        device=None,
        frontend_sample_rate: int = 1,
        metrics: Optional[Metrics] = None,
    ):
        self.cfg = cfg
        self.store = store
        self.metrics = metrics if metrics is not None else Metrics()
        self.device = resolve_device(device)
        self.lut = np.asarray(lut, np.float32)
        self.lut_dev = to_device(self.lut, self.device)
        self.cam_width = cam_width
        self.cam_height = cam_height

        m = cfg.pano_map
        self.pano = EquirectCamera(width=m.pano_width, height=m.pano_height)
        self.order = 4 if cfg.trajectory.spline_degree == 3 else 2
        self.degree = self.order - 1

        # Global map state (event_pano_warper.cpp:21-28), device-resident.
        self.IG = torch.zeros((m.pano_height, m.pano_width), dtype=torch.float32,
                              device=self.device)
        self.update_times = torch.zeros((m.pano_height, m.pano_width), dtype=torch.int32,
                                        device=self.device)

        sw = cfg.sliding_window
        self.win_size = sw.time_window_size
        self.win_stride = sw.sliding_window_stride
        self.cp_stride = int(round(sw.sliding_window_stride / cfg.trajectory.dt_knots))
        self.count_window = 0
        self.initialized = False
        self.first_window = True
        self.idx_cp_opt_beg = 0

        # minimum events per window to run BA (pose_graph_optimizer.cpp:65-67)
        self.min_events_per_win = int(
            sw.time_window_size * m.backend_min_ev_rate
            / (cfg.warp.event_sample_rate * frontend_sample_rate)
        )

        # ang-vel inbox from the front-end (frontend_ang_vel_ map)
        self._av_times: List[float] = []
        self._av_vals: List = []
        self._av_prev: Optional[Tuple[float, np.ndarray]] = None

        self.traj: Optional[spline.Trajectory] = None
        self.pose_latest: Optional[Tuple[float, np.ndarray]] = None
        self.results: List[WindowResult] = []
        self.trajectory_log: List[Tuple[float, np.ndarray]] = []
        # Clamp on prefix retirement: absolute index the front-end still
        # needs (deleteOldEvents' min(), ang_vel_estimator.cpp:149-152).
        self.retain_from_fn = None

        self._ba_restarts = (
            cfg.ba_solve_restarts if cfg.ba_solve_restarts is not None
            else (1 if self.order == 4 else 0)
        )
        # window-knot count: round(win/dt) + degree
        self.K_win = int(round(self.win_size / cfg.trajectory.dt_knots)) + self.degree
        self._crop_shapes: set = set()  # (Hc, Wc) already used (sticky shapes)
        self._prior_lam = 0.0  # raised only during refine sweeps
        self._bootstrap_pending = cfg.bootstrap_resolve_window
        self.bootstrap_results: List[WindowResult] = []
        # The pool entry whose programs solve this back-end's windows
        # (programs keyed by window shape; see _solver).
        key = ("backend", program_pool.device_key(self.device), self.pano, self.order,
               cfg.trajectory.dt_knots, cfg.warp.blur_sigma, cfg.contrast_measure, cfg.optim,
               m.max_update_times, program_pool.digest(self.lut), cfg.max_ba_correction_rad,
               self._ba_restarts)
        self._entry = program_pool.lease(key, self)
        self._entry.state.setdefault("lut", self.lut_dev)
        # The window whose solve is in flight (see step() and flush()).
        self._pending_win: Optional[dict] = None
        # Finalizes front-end estimates in flight (Frontend.finalize_batch),
        # set by the system: one wait per window for them and the window.
        self.finalize_fn = None

    # ------------------------------------------------------------------
    # Front-end interface (pushAngVel, pose_graph_optimizer.cpp:73-110)
    # ------------------------------------------------------------------
    def push_ang_vel(self, t: float, omega) -> None:
        """Accepts a (3,) array or a frontend.AngVelEstimate, which may be
        in flight: only its time is needed now, its value is fetched (with
        the others of its window, through finalize_fn) when a window
        integrates it."""
        if not self.initialized:
            self.t_win_beg = t
            self.t_win_end = t + self.win_size
            self.t_av_beg = self.t_win_beg
            self.t_av_end = self.t_win_end
            self.traj = spline.Trajectory(self.t_win_beg, self.cfg.trajectory.dt_knots,
                                          self.order)
            self._av_prev = (t, self._av_value(omega))
            theta = math.radians(self.cfg.pano_map.y_angle_deg)
            q0 = np.array([math.cos(theta / 2.0), 0.0, math.sin(theta / 2.0), 0.0])
            self.pose_latest = (t, q0)  # rotation about +Y
            self.initialized = True
        self._av_times.append(float(t))
        self._av_vals.append(omega)

    def _av_value(self, omega) -> np.ndarray:
        """One inbox entry's value (an estimate in flight is fetched first)."""
        if getattr(omega, "packed", None) is not None and self.finalize_fn is not None:
            self._fetch([omega])
        if hasattr(omega, "omega"):
            return np.asarray(omega.omega, np.float64)
        return np.asarray(omega, np.float64)

    def _fetch(self, ests, handles=()) -> List[np.ndarray]:
        """One wait for the estimates in flight among ``ests`` (through
        finalize_fn) and the window results ``handles``, counted as
        ``backend.host_reads``. Returns the handles' values on the host."""
        pend = [e for e in ests if getattr(e, "packed", None) is not None]
        if (any(not e.packed[0].fetched for e in pend)
                or any(not h.fetched for h in handles)):
            self.metrics.count("backend.host_reads")
        if pend:
            return self.finalize_fn(pend, extra_handles=tuple(handles), counter=None)
        return device_loop.fetch_all(handles)

    def ready(self) -> bool:
        """isReadyFrontendPoses (pose_graph_optimizer.cpp:112-129)."""
        return (
            self.initialized
            and len(self._av_times) > 0
            and self._av_times[-1] > self.t_win_end
            and self.store.total > 0
            and self.store.latest_time() >= self.t_win_end
        )

    def step(self) -> List[WindowResult]:
        """One Run-loop iteration (pose_graph_optimizer.cpp:356-376): fetch
        and complete the window in flight (its program ran while the host
        streamed the last stride), then dispatch this window's. Returns
        every window completed in this call, in order: usually the one
        before, and this one too when it runs no BA.

        Traced (utils.metrics.TRACE), a ``backend.step`` span with the index
        of the window it dispatches; its children are the fetch and its
        wait, the finish of the window in flight (``backend.finish``, with
        that window's index), the event and ang-vel subsets, integration
        and fit, and the dispatch (``backend.solve``). Each completed window
        leaves a ``backend.result`` mark."""
        if not self.ready():
            return []
        with TRACE.span("backend.step", window=self.count_window):
            self._fused_fetch()
            done = self._complete_pending()
            if (self._bootstrap_pending is not None
                    and self.count_window >= self._bootstrap_pending):
                with TRACE.span("backend.bootstrap"):
                    self._run_bootstrap_resolve()
            with TRACE.span("backend.event_subset"):
                ev = self._get_event_subset(self.t_win_beg, self.t_win_end)
            with TRACE.span("backend.ang_vel_subset"):
                av = self._get_ang_vel_subset(self.t_av_beg, self.t_av_end)
            res = self._process_time_window(ev, av)
            self._slide_window()
            return [r for r in (done, res) if r is not None]

    def run(self) -> List[WindowResult]:
        """Step while a window is ready, then flush; returns every window
        completed, each once."""
        out = []
        while self.ready():
            out.extend(self.step())
        tail = self.flush()
        if tail is not None:
            out.append(tail)
        return out

    def flush(self) -> Optional[WindowResult]:
        """Complete the window in flight, if any, and return it. Call before
        reading results, the trajectory or the maps mid-stream (the system's
        accessors flush on their own)."""
        with TRACE.span("backend.flush"):
            return self._complete_pending()

    def close(self) -> Optional[WindowResult]:
        """Retire the instance: flush (the back-end holds no threads)."""
        return self.flush()

    def _fused_fetch(self) -> None:
        """One wait for the window in flight and for every front-end
        estimate in flight that the next window integrates, those in
        (t_av_beg, t_av_end)."""
        p = self._pending_win
        handles = [p["handle"]] if p is not None else []
        pend = []
        if self.finalize_fn is not None:
            times = np.asarray(self._av_times)
            lo = int(np.searchsorted(times, self.t_av_beg, side="right"))
            hi = int(np.searchsorted(times, self.t_av_end, side="left"))
            pend = [v for v in self._av_vals[lo:hi] if getattr(v, "packed", None) is not None]
        if not handles and not pend:
            return
        with self.metrics.timer("backend.fetch"):
            extras = self._fetch(pend, handles)
        if p is not None:
            p["fetched"] = extras[0]

    def _complete_pending(self) -> Optional[WindowResult]:
        """Finish the window in flight: the escape check (+ full-panorama
        re-solve), the trust-radius rejection, the knot write-back and the
        map promotion (_finish_solve), then its bookkeeping."""
        p = self._pending_win
        if p is None:
            return None
        self._pending_win = None
        with TRACE.span("backend.finish", window=p["index"]):
            with self.metrics.timer("backend.fetch"):
                initial, final, iters, rejected, correction = self._finish_solve(p)
            # The window's line searches, the first solve's and the
            # restarts', from its packed result (no read of their own).
            first = p["first_iters"]
            self.metrics.count("backend.cg_iters", first)
            self.metrics.count("backend.restart_cg_iters", iters - first)
            return self._finish_window(p, initial, final, iters, rejected, correction)

    # ------------------------------------------------------------------
    def _get_event_subset(self, t_beg: float, t_end: float):
        """Window slice of the shared store + prefix retirement
        (getEventSubset, pose_graph_optimizer.cpp:131-165)."""
        a = self.store.searchsorted_time(t_beg, side="left")
        b = self.store.searchsorted_time(t_end - 1e-6, side="right")
        xs, ys, ts, ps = self.store.slice_abs(a, b)
        out = (xs.copy(), ys.copy(), ts.copy(), ps.copy())
        if self._bootstrap_pending is not None:
            return out  # keep the tracked span for the bootstrap re-solve
        drop_to = a
        if self.retain_from_fn is not None:
            drop_to = min(drop_to, self.retain_from_fn())
        self.store.drop_before(drop_to)
        return out

    def _get_ang_vel_subset(self, t_beg: float, t_end: float):
        """getAngVelSubset (pose_graph_optimizer.cpp:167-189): consume
        ang-vels in (t_beg, t_end); erase everything up to t_end. Estimates
        still in flight (none after _fused_fetch) are fetched in one wait."""
        times = np.asarray(self._av_times)
        lo = int(np.searchsorted(times, t_beg, side="right"))
        hi = int(np.searchsorted(times, t_end, side="left"))
        if self.finalize_fn is not None:
            self._fetch(self._av_vals[lo:hi])
        sub = [(self._av_times[i], self._av_value(self._av_vals[i])) for i in range(lo, hi)]
        self._av_times = self._av_times[hi:]
        self._av_vals = self._av_vals[hi:]
        return sub

    def _integrate_ang_vel(self, av_subset):
        """Trapezoidal integration into absolute poses with post-multiplied
        exponentials (integrateAngVel, pose_graph_optimizer.cpp:191-222)."""
        t_curr, q_curr = self.pose_latest
        t_prev, w_prev = self._av_prev
        times, quats = [], []
        for t, w in av_subset:
            if t <= t_prev and not self.first_window:
                continue  # out-of-order guard (:199-202)
            drotv = (t - t_curr) * 0.5 * (w_prev + w)
            q_curr = spline._np_quat_mul(q_curr, spline._np_quat_exp(drotv))
            t_curr = t
            times.append(t)
            quats.append(q_curr)
            t_prev, w_prev = t, w
        self._av_prev = (t_prev, w_prev)
        return np.asarray(times), (np.stack(quats) if quats else np.zeros((0, 4)))

    # ------------------------------------------------------------------
    def _process_time_window(self, ev, av_subset) -> WindowResult:
        """processTimeWindow (pose_graph_optimizer.cpp:244-323)."""
        cfg = self.cfg
        with TRACE.span("backend.integrate"):
            pose_times, pose_quats = self._integrate_ang_vel(av_subset)

            if len(pose_times) >= 2:
                num_cps = (int(round((self.t_av_end - self.t_av_beg) / cfg.trajectory.dt_knots))
                           + self.degree)
                if len(pose_times) >= num_cps:
                    new_cps = spline.fit_ctrl_poses(pose_times, pose_quats, self.t_av_beg,
                                                    cfg.trajectory.dt_knots, num_cps, self.order)
                else:
                    new_cps = np.tile(self.pose_latest[1], (num_cps, 1))  # hold the last pose
                if self.first_window:
                    nfz = cfg.first_window_frozen_knots
                    self.idx_cp_opt_beg = self.degree if nfz is None else int(nfz)
                    self.first_window = False
                else:
                    new_cps = new_cps[self.degree:]
                self.traj.push_ctrl_poses(new_cps)

        idx_cp_traj_beg = self.count_window * self.cp_stride
        self.idx_cp_opt_beg = max(idx_cp_traj_beg, self.idx_cp_opt_beg)
        num_fixed = self.idx_cp_opt_beg - idx_cp_traj_beg

        xs, ys, ts, _ = ev
        n_raw = len(ts)
        ran_ba = n_raw > self.min_events_per_win and self.traj.size > idx_cp_traj_beg
        meta = dict(index=self.count_window, t_beg=self.t_win_beg, t_end=self.t_win_end,
                    num_events=n_raw, ran_ba=ran_ba, t_eval=self.t_win_end - 1e-6,
                    t_last=float(ts[-1]) if n_raw else None)
        if not ran_ba:
            return self._finish_window(meta, 0.0, 0.0, 0)
        # Dispatch only: the next step() (or flush()) fetches and completes it.
        with self.metrics.timer("backend.solve"):
            p = self._dispatch_window_solve(xs, ys, ts, idx_cp_traj_beg, num_fixed)
        p.update(meta)
        self._pending_win = p
        self.metrics.count("backend.events", n_raw)
        return None

    def _finish_window(self, meta, initial_cost, final_cost, iters,
                       rejected: bool = False, correction: float = 0.0) -> WindowResult:
        """Pose-latest update + result bookkeeping (pose_graph_optimizer.cpp:316-323)."""
        t_eval = meta["t_eval"]
        if self.traj.size >= self.order:
            q = self.traj.evaluate(min(t_eval, self.traj.max_time() - 1e-9))[0]
            self.pose_latest = (t_eval, q)
            self.trajectory_log.append((t_eval, q))
        res = WindowResult(index=meta["index"], t_beg=meta["t_beg"], t_end=meta["t_end"],
                           num_events=meta["num_events"], ran_ba=meta["ran_ba"],
                           initial_cost=initial_cost, final_cost=final_cost, iters=iters,
                           rejected=rejected, correction_rad=correction)
        self.results.append(res)
        TRACE.mark("backend.result", window=res.index, t_end=res.t_end,
                   t_event=meta.get("t_last"))
        logger.info("[back-end] window %d [%.3f, %.3f) n=%d ba=%s cost=%.5f iters=%d",
                    res.index, res.t_beg, res.t_end, res.num_events, res.ran_ba,
                    final_cost, iters)
        return res

    # ------------------------------------------------------------------
    def _run_bootstrap_resolve(self) -> None:
        """One-time online bootstrap re-solve (config.bootstrap_resolve_window):
        re-run the sliding-window BA over every completed window against the
        map accumulated so far, then retire the held prefix and resume."""
        self._bootstrap_pending = None
        t0 = self.traj.t_beg
        t_stop = self.t_win_end - self.win_stride  # last completed window end
        a = self.store.searchsorted_time(t0, side="left")
        b = self.store.searchsorted_time(t_stop - 1e-6, side="right")
        xs, ys, ts, _ = self.store.slice_abs(a, b)
        self.bootstrap_results = self.refine_pass(
            (xs.copy(), ys.copy(), ts.copy()), t_stop=t_stop, prior_lam=0.0)
        # The early trajectory_log entries predate the re-solve.
        self.trajectory_log = [
            (t, self.traj.evaluate(t)[0]) if t <= t_stop else (t, q)
            for (t, q) in self.trajectory_log
        ]
        drop_to = self.store.searchsorted_time(self.t_win_beg, side="left")
        if self.retain_from_fn is not None:
            drop_to = min(drop_to, self.retain_from_fn())
        self.store.drop_before(drop_to)
        logger.info("[back-end] bootstrap re-solve: %d windows over [%.3f, %.3f)",
                    len(self.bootstrap_results), t0, t_stop)

    def refine_pass(self, source, t_stop: Optional[float] = None,
                    prior_lam: Optional[float] = None) -> List[WindowResult]:
        """One more sliding-window BA sweep over an already-tracked stream,
        from the current trajectory and global map (Backend.refine_pass of
        the JAX package). ``source`` is a tuple ``(xs, ys, ts[, ps])`` or an
        iterable of such chunks; ``t_stop`` re-solves only windows ending at
        or before it; ``prior_lam`` defaults to cfg.refine_prior_lambda.
        Returns the refined per-window results. Each window is solved and
        completed before the next (synchronous, as in the JAX package)."""
        if self.traj is None or self.traj.size < self.order:
            raise ValueError("refine_pass needs a tracked trajectory; "
                             "run the stream through the system first")
        self.flush()
        saved = (self.t_win_beg, self.t_win_end, self.t_av_beg, self.t_av_end,
                 self.count_window, self.idx_cp_opt_beg, self.first_window, self._prior_lam)
        self._prior_lam = float(self.cfg.refine_prior_lambda if prior_lam is None
                                else prior_lam)
        chunks = iter([source]) if isinstance(source, tuple) else iter(source)

        # No gauge freeze in refine: the map anchors every window absolutely.
        t0 = self.traj.t_beg
        t_traj_end = self.traj.max_time()
        results: List[WindowResult] = []
        bufs = [np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float64)]
        drained = False
        try:
            self.count_window = 0
            self.t_win_beg, self.t_win_end = t0, t0 + self.win_size
            while self.t_win_beg < t_traj_end - 1e-9 and (
                t_stop is None or self.t_win_end <= t_stop + 1e-9
            ):
                while not drained and (len(bufs[2]) == 0 or bufs[2][-1] < self.t_win_end):
                    ch = next(chunks, None)
                    if ch is None:
                        drained = True
                        break
                    bufs[0] = np.concatenate([bufs[0], np.asarray(ch[0], np.int32)])
                    bufs[1] = np.concatenate([bufs[1], np.asarray(ch[1], np.int32)])
                    bufs[2] = np.concatenate([bufs[2], np.asarray(ch[2], np.float64)])
                ts_b = bufs[2]
                if drained and (len(ts_b) == 0 or ts_b[-1] < self.t_win_beg):
                    break
                # Clamp the window to the spline domain; skip a tail window
                # whose usable span is mostly missing.
                t_hi = min(self.t_win_end, t_traj_end)
                if t_hi - self.t_win_beg < 0.7 * self.win_size:
                    break
                a = int(np.searchsorted(ts_b, self.t_win_beg, side="left"))
                b = int(np.searchsorted(ts_b, t_hi - 1e-6, side="right"))
                idx_beg = self.count_window * self.cp_stride
                n_raw = b - a
                ran_ba = n_raw > self.min_events_per_win and self.traj.size > idx_beg
                initial = final = correction = 0.0
                iters, rejected = 0, False
                if ran_ba:
                    with self.metrics.timer("backend.refine"):
                        p = self._dispatch_window_solve(bufs[0][a:b], bufs[1][a:b],
                                                        ts_b[a:b], idx_beg, 0)
                        p["index"] = self.count_window
                        initial, final, iters, rejected, correction = self._finish_solve(p)
                results.append(WindowResult(
                    index=self.count_window, t_beg=self.t_win_beg, t_end=self.t_win_end,
                    num_events=n_raw, ran_ba=ran_ba, initial_cost=initial,
                    final_cost=final, iters=iters, rejected=rejected,
                    correction_rad=correction))
                logger.info("[back-end] refine window %d [%.3f, %.3f) n=%d ba=%s "
                            "cost=%.5f iters=%d", self.count_window, self.t_win_beg,
                            self.t_win_end, n_raw, ran_ba, final, iters)
                keep = int(np.searchsorted(ts_b, self.t_win_beg + self.win_stride,
                                           side="left"))
                if keep > 0:
                    bufs = [x[keep:] for x in bufs]
                self.count_window += 1
                self.t_win_beg += self.win_stride
                self.t_win_end += self.win_stride
        finally:
            (self.t_win_beg, self.t_win_end, self.t_av_beg, self.t_av_end,
             self.count_window, self.idx_cp_opt_beg, self.first_window,
             self._prior_lam) = saved
        self.metrics.count("backend.refine_windows", len(results))
        return results

    # ------------------------------------------------------------------
    def _window_arrays(self, xs, ys, ts, idx_cp_traj_beg):
        """A window's events padded to a bucketed size, host side."""
        cfg = self.cfg
        bs = cfg.warp.event_batch_size
        rate = cfg.warp.event_sample_rate
        n = len(ts)

        # Bucket: pad to bs * {1, 1.5} * 2^k (the JAX package's shapes).
        need = min(n, cfg.max_events_per_window)
        size = bs
        while size < need:
            if size * 3 // 2 >= need and (size // bs) % 2 == 0:
                size = size * 3 // 2
                break
            size *= 2
        size = min(size, ((cfg.max_events_per_window + bs - 1) // bs) * bs)
        n_use = min(n, size)
        if n_use < n:
            self.metrics.count("backend.events_dropped", n - n_use)
            logger.warning(
                "[back-end] window %d: %d of %d events dropped by max_events_per_window=%d",
                self.count_window, n - n_use, n, cfg.max_events_per_window)

        xs_p = np.zeros(size, np.int64)
        ys_p = np.zeros(size, np.int64)
        ts_p = np.zeros(size, np.float64)
        valid = np.zeros(size, bool)
        xs_p[:n_use] = xs[:n_use]
        ys_p[:n_use] = ys[:n_use]
        ts_p[:n_use] = ts[:n_use]
        valid[:n_use] = True

        # Batch midpoint times on the raw stream (event_pano_warper.cpp:238-243)
        B = size // bs
        tsb = ts_p.reshape(B, bs)
        vb = valid.reshape(B, bs)
        t_first = np.where(vb.any(1), np.where(vb, tsb, np.inf).min(1), 0.0)
        t_last = np.where(vb.any(1), np.where(vb, tsb, -np.inf).max(1), 0.0)
        batch_mid = t_first + 0.5 * (t_last - t_first)

        # In-batch decimation (event_pano_warper.cpp:262).
        if rate > 1:
            valid &= (np.arange(size) % bs) % rate == 0

        # Old/new split against the next window start (:296-311).
        is_old = ts_p < self.t_win_beg + self.win_stride

        t_knot0 = self.traj.knot_time(idx_cp_traj_beg)
        batch_rel = (batch_mid - t_knot0).astype(np.float32)
        return dict(xs=xs_p, ys=ys_p, valid=valid, is_old=is_old & valid,
                    batch_rel=batch_rel)

    def _crop_halo(self) -> int:
        """h = blur radius (+1 for Sobel stencils), the crop-exactness halo."""
        sigma = self.cfg.warp.blur_sigma
        r = (opencv_ksize(sigma) // 2) if sigma > 0 else 0
        s = 1 if self.cfg.contrast_measure == IMAGE_GRADIENT_MAGNITUDE_CONTRAST else 0
        return r + s

    def _host_bbox(self, np_xs, np_ys, np_batch_rel, np_valid, knots_sub):
        """Zero-increment warp bounding box in numpy (crop planning),
        subsampled for big windows: the pad margin dwarfs the subsampling
        error, and the escape check uses the exact bbox of the optimum."""
        B = len(np_batch_rel)
        E = len(np_xs) // B
        bstride = max(1, B // 2048)
        q = spline.evaluate_np(knots_sub, np_batch_rel[::bstride], 0.0,
                               self.cfg.trajectory.dt_knots, self.order)
        R = spline._np_quat_rotmat_batch(q)  # (Bs, 3, 3)
        estride = max(1, E // 16)
        sub2 = np.s_[::bstride, ::estride]
        xs = np_xs.reshape(B, E)[sub2]
        ys = np_ys.reshape(B, E)[sub2]
        valid = np_valid.reshape(B, E)[sub2]
        if not valid.any():
            return None
        b = np.moveaxis(self.lut[ys * self.cam_width + xs], -1, 0)  # (3, Bs, Es)
        x = R[:, 0, 0, None] * b[0] + R[:, 0, 1, None] * b[1] + R[:, 0, 2, None] * b[2]
        y = R[:, 1, 0, None] * b[0] + R[:, 1, 1, None] * b[1] + R[:, 1, 2, None] * b[2]
        z = R[:, 2, 0, None] * b[0] + R[:, 2, 1, None] * b[1] + R[:, 2, 2, None] * b[2]
        rho = np.sqrt(x * x + y * y + z * z)
        px = self.pano.cx + np.arctan2(x, z) * self.pano.fx
        py = self.pano.cy + np.arcsin(np.clip(y / rho, -1.0, 1.0)) * self.pano.fy
        return (float(px[valid].min()), float(px[valid].max()),
                float(py[valid].min()), float(py[valid].max()))

    def _plan_crop(self, arrays, knots_sub):
        """Host-side crop geometry for one window; None -> use the full pano.
        Returns (Hc, Wc, ints, h) with ints = [y0, x0, vy0, vy1, vx0, vx1]."""
        bbox = self._host_bbox(arrays["xs"], arrays["ys"], arrays["batch_rel"],
                               arrays["valid"], knots_sub)
        if bbox is None or not np.all(np.isfinite(bbox)):
            return None
        pxm, pxM, pym, pyM = bbox
        H, W = self.pano.height, self.pano.width
        h = self._crop_halo()
        # Margin the optimizer may move warped events (+2 for the 2x2
        # bilinear footprint), then the 2h exactness halo.
        m = max(32.0, self.cfg.crop_margin_rad * self.pano.fx)
        pad = m + 2 * h + 2

        def bucket(need: float, dim: int) -> int:
            for b in self._CROP_LADDER:
                if b >= need:
                    return min(b, dim)
            return dim

        need_w = (pxM - pxm) + 2 * pad
        need_h = (pyM - pym) + 2 * pad
        # Sticky shapes: reuse a crop shape already in use that covers this
        # window (identical to the JAX package's choice).
        best = None
        for (hc, wc) in self._crop_shapes:
            if hc >= need_h and wc >= need_w and hc * wc < 0.7 * H * W:
                if best is None or hc * wc < best[0] * best[1]:
                    best = (hc, wc)
        if best is not None:
            Hc, Wc = best
        else:
            Wc = bucket(need_w, W)
            Hc = bucket(need_h, H)
            if Hc * Wc >= 0.7 * H * W:
                return None
            self._crop_shapes.add((Hc, Wc))
        x0 = min(max(int(round(0.5 * (pxm + pxM) - Wc / 2)), 0), W - Wc)
        y0 = min(max(int(round(0.5 * (pym + pyM) - Hc / 2)), 0), H - Hc)
        vx0 = h if x0 > 0 else 0
        vx1 = Wc - (h if x0 + Wc < W else 0)
        vy0 = h if y0 > 0 else 0
        vy1 = Hc - (h if y0 + Hc < H else 0)
        return Hc, Wc, np.array([y0, x0, vy0, vy1, vx0, vx1], np.int64), h

    @staticmethod
    def _crop_escaped(bbox_opt, ints, Hc: int, Wc: int, h: int) -> bool:
        """True if the optimum's warped events came too close to a non-border
        crop edge for the crop objective to have been exact there."""
        box = np.asarray(bbox_opt, np.float64)
        if not np.all(np.isfinite(box)):
            return True
        pxm, pxM, pym, pyM = (float(v) for v in box)
        y0, x0, vy0, vy1, vx0, vx1 = (int(v) for v in ints)
        ok = True
        if vx0 > 0:
            ok &= pxm - 2 >= x0 + vx0 + h
        if vx1 < Wc:
            ok &= pxM + 2 <= x0 + vx1 - h
        if vy0 > 0:
            ok &= pym - 2 >= y0 + vy0 + h
        if vy1 < Hc:
            ok &= pyM + 2 <= y0 + vy1 - h
        return not ok

    # ------------------------------------------------------------------
    def _window(self, arrays, knots, free) -> PanoWindow:
        """Device-side window assembly: LUT bearing gather (component-major).
        The uploads are staged (utils.device.to_device): the window in flight
        and the front-end's launches queued behind it are not waited for."""
        dev = self.device
        valid = to_device(arrays["valid"], dev)
        idx = to_device(
            np.where(arrays["valid"], arrays["ys"] * self.cam_width + arrays["xs"], 0), dev)
        return PanoWindow(
            bearings=self.lut_dev[idx].T.contiguous(),
            batch_times=to_device(arrays["batch_rel"], dev),
            weights=valid.to(torch.float32),
            is_old=to_device(arrays["is_old"], dev),
            knots=to_device(knots, dev, torch.float32),
            free_mask=to_device(free, dev),
            t0=0.0,
            dt_knots=float(np.float32(self.cfg.trajectory.dt_knots)),
            ig_prime=self.IG,
            alpha=torch.zeros((), dtype=torch.float32, device=dev),
        )

    def _solver(self, win: PanoWindow, fov_rel, crop_hw) -> "_WindowSolver":
        """The leased entry's program for this window's shapes: events,
        batches, knots, crop (None: the full panorama), FOV-grid length and
        the prior weight of refine sweeps."""
        key = (win.weights.shape[0], win.batch_times.shape[0], win.knots.shape[0], crop_hw,
               len(fov_rel), self._prior_lam)
        return self._entry.program(key, lambda: _WindowSolver(
            self.cfg, self.pano, self.order, self._ba_restarts, self._prior_lam,
            self._entry.state["lut"], win, len(fov_rel), crop_hw))

    def _run_solver(self, win: PanoWindow, fov_rel, crop_hw=None, consts=None):
        """Load a window into its program and launch it. Returns (the
        launch's handle, the solver, whose ig_out/upd_out hold the new maps
        once the launch has completed)."""
        with TRACE.span("backend.launch"):
            solver = self._solver(win, fov_rel, crop_hw)
            with torch.no_grad():
                handle = solver.solve(win, fov_rel, consts, self.IG, self.update_times)
        return handle, solver

    @staticmethod
    def _unpack(packed: np.ndarray, K: int):
        """(knots_new (K, 4), stats [f0, fun, iters, alpha, bbox, the first
        solve's iters]) of a window's packed result; iters counts every
        solve's line searches, restarts included."""
        return packed[:4 * K].reshape(K, 4), packed[4 * K:].tolist()

    @torch.no_grad()
    def _solve_full(self, win: PanoWindow, fov_rel):
        """Full-panorama window solve, launched. Returns (handle, solver)."""
        K = win.knots.shape[0]
        with TRACE.span("backend.full_alpha"):
            zeros = torch.zeros((K, 3), device=self.device)
            il0, _ = warp_pano.pano_objective_image(zeros, win, self.pano, self.order,
                                                    self.cfg.warp.blur_sigma)
            alpha = warp_pano.compute_alpha(il0, win.ig_prime)
        return self._run_solver(win, fov_rel, consts=dict(alpha=alpha))

    @torch.no_grad()
    def _solve_crop(self, win: PanoWindow, fov_rel, plan):
        """FOV-crop window solve, launched. Returns (handle, solver)."""
        Hc, Wc, ints, _ = plan
        cfg = self.cfg
        with TRACE.span("backend.crop_constants"):
            ints_t = to_device(ints, self.device)
            win, _, _, a_crop, mask, out_s1, out_s2 = warp_pano.crop_window_constants(
                win, self.pano, self.order, cfg.warp.blur_sigma, cfg.contrast_measure, (Hc, Wc),
                ints_t)
        consts = dict(alpha=win.alpha, crop=ints_t, a_crop=a_crop, mask=mask, out_s1=out_s1,
                      out_s2=out_s2)
        return self._run_solver(win, fov_rel, (Hc, Wc), consts)

    def _dispatch_window_solve(self, xs, ys, ts, idx_cp_traj_beg, num_fixed):
        """Marshal the window and launch its solve (crop first where
        planned); nothing is read on the host. Returns the completion record
        for _finish_solve."""
        with TRACE.span("backend.window_arrays"):
            arrays = self._window_arrays(xs, ys, ts, idx_cp_traj_beg)
        K = self.K_win
        sub = self.traj.knots[idx_cp_traj_beg:][:K]
        n_real = len(sub)
        if K > n_real:  # pad the window sub-trajectory to K knots
            sub = np.concatenate([sub, np.tile(sub[-1], (K - n_real, 1))], axis=0)
        free = np.zeros(K, np.float32)
        free[num_fixed:n_real] = 1.0
        fov_rel = self._fov_times_rel(self.traj.knot_time(idx_cp_traj_beg), n_real)
        with TRACE.span("backend.window"):
            win = self._window(arrays, sub.astype(np.float32), free)
        with TRACE.span("backend.plan_crop"):
            plan = self._plan_crop(arrays, sub) if self.cfg.crop_solver else None
        if plan is not None:
            handle, solver = self._solve_crop(win, fov_rel, plan)
        else:
            handle, solver = self._solve_full(win, fov_rel)
        return dict(handle=handle, solver=solver, plan=plan, win=win, fov_rel=fov_rel, K=K,
                    n_real=n_real, idx_cp_traj_beg=idx_cp_traj_beg, index=self.count_window,
                    knots_sub=sub)

    def _finish_solve(self, p) -> Tuple[float, float, int, bool, float]:
        """Escape check (+ full-pano re-solve), the max_ba_correction_rad
        rejection, knot write-back (incrementalUpdate,
        global_optim_contrast_gsl.cpp:130) and map promotion. Reads the
        packed result _fused_fetch fetched, else fetches it (a synchronous
        solve). Returns (initial, final, iters, rejected, the largest knot
        correction in rad)."""
        packed = p.get("fetched")
        if packed is None:
            packed = self._fetch([], (p["handle"],))[0]
        knots_new, stats = self._unpack(packed, p["K"])
        solver = p["solver"]
        if p["plan"] is not None:
            Hc, Wc, ints, h = p["plan"]
            if self._crop_escaped(stats[4:8], ints, Hc, Wc, h):
                logger.info("[back-end] window %d: optimum escaped the %dx%d crop; "
                            "re-solving on the full panorama", p["index"], Hc, Wc)
                self.metrics.count("backend.crop_escapes", 1)
                with TRACE.span("backend.escape"):
                    handle, solver = self._solve_full(p["win"], p["fov_rel"])
                    knots_new, stats = self._unpack(self._fetch([], (handle,))[0], p["K"])
            else:
                self.metrics.count("backend.crop_windows", 1)
        p["first_iters"] = int(stats[8])
        idx, n_real = p["idx_cp_traj_beg"], p["n_real"]
        q1 = knots_new.astype(np.float64)[:n_real]
        q0 = p["knots_sub"][:n_real].astype(np.float64)
        dots = np.abs(np.sum(q0 * q1, axis=1))
        max_ang = float(2.0 * np.arccos(np.clip(dots, -1.0, 1.0)).max())
        cap = self.cfg.max_ba_correction_rad
        if cap is not None:
            # Degenerate-landscape guard (pairs with the in-solve trust stop):
            # a correction that moved any knot past the cap is a wandering
            # solve on a weakly textured window. Keep the front-end knots and
            # do not absorb this window's votes into the map.
            if max_ang > cap:
                logger.warning(
                    "[back-end] window %d: BA correction %.2f deg exceeds "
                    "max_ba_correction_rad (%.2f deg); rejected, keeping the "
                    "front-end trajectory", p["index"], math.degrees(max_ang),
                    math.degrees(cap))
                self.metrics.count("backend.ba_rejected", 1)
                return float(stats[0]), float(stats[1]), int(stats[2]), True, max_ang
        self.traj.knots[idx: idx + n_real] = q1
        # In place, before the next window's dispatch: the window programs
        # read the maps at these addresses.
        self.IG.copy_(solver.ig_out)
        self.update_times.copy_(solver.upd_out)
        return float(stats[0]), float(stats[1]), int(stats[2]), False, max_ang

    def _fov_times_rel(self, t_knot0: float, n_real: int, dt_check: float = 0.05) -> np.ndarray:
        """setUpdateTimesIG's dt_check grid across the consumed stride
        (pose_graph_optimizer.cpp:325-337), clamped to the evaluable span and
        shifted to the window sub-spline clock."""
        count = max(1, int(math.ceil(self.win_stride / dt_check - 1e-9)))
        times = self.t_win_beg + dt_check * np.arange(count)
        t_max = min(
            self.traj.max_time() - 1e-9,
            t_knot0 + (n_real - self.order + 1) * self.cfg.trajectory.dt_knots - 1e-9,
        )
        return (np.minimum(times, t_max) - t_knot0).astype(np.float32)

    def _slide_window(self):
        """slideWindow (pose_graph_optimizer.cpp:339-354)."""
        self.t_win_beg += self.win_stride
        self.t_av_beg = self.t_win_end
        self.t_win_end += self.win_stride
        self.t_av_end = self.t_win_end
        self.count_window += 1

    # ------------------------------------------------------------------
    def render_map(self) -> np.ndarray:
        """Pano display image (publishEventImage,
        pose_graph_optimizer.cpp:378-413): the window in flight completed,
        one copy of IG to the host (a wait, counted), then the display
        transform and the sensor-FOV outline in host numpy."""
        from .utils.image import render_pano

        self.flush()
        with TRACE.span("backend.read_map", wait=True):
            ig = self.IG.cpu().numpy()
        img = render_pano(ig, gamma=self.cfg.gamma, invert=True)
        self.metrics.count("backend.host_reads")
        if self.cfg.draw_fov and self.traj is not None and self.traj.size >= self.order:
            img = np.stack([img] * 3, axis=-1)
            t_plot = min(self.t_win_end - 1e-6, self.traj.max_time() - 1e-9)
            q = self.traj.evaluate(t_plot)[0]
            # Sensor-FOV *outline*: project only the border pixels' bearings
            # (drawSensorFOV, event_pano_warper.cpp:56-79).
            W, H = self.cam_width, self.cam_height
            border = np.concatenate([
                np.arange(W),                       # y = 0
                (H - 1) * W + np.arange(W),         # y = H-1
                np.arange(H) * W,                   # x = 0
                np.arange(H) * W + (W - 1),         # x = W-1
            ])
            rays = self.lut[border] @ spline._np_quat_rotmat_batch(q).T
            rho = np.linalg.norm(rays, axis=-1)
            px = self.pano.cx + np.arctan2(rays[:, 0], rays[:, 2]) * self.pano.fx
            py = self.pano.cy + np.arcsin(np.clip(rays[:, 1] / rho, -1, 1)) * self.pano.fy
            ix = np.clip(np.round(px).astype(int), 0, self.pano.width - 1)
            iy = np.clip(np.round(py).astype(int), 0, self.pano.height - 1)
            img[iy, ix] = np.array([255, 0, 0], np.uint8)
        return img

    # ------------------------------------------------------------------
    def restore(self, d) -> None:
        """Inverse of checkpoint(): resume a run mid-stream. Reads the keys
        the JAX package's Backend.checkpoint writes."""
        knots = np.asarray(d["knots"])
        if len(knots):
            self.traj = spline.Trajectory(float(d["traj_t_beg"]),
                                          self.cfg.trajectory.dt_knots, self.order)
            self.traj.push_ctrl_poses(knots)
        self.IG.copy_(to_device(np.asarray(d["IG"], np.float32), self.device))
        self.update_times.copy_(to_device(np.asarray(d["update_times"], np.int32), self.device))
        self.count_window = int(d["count_window"])
        self.t_win_beg = float(d["t_win_beg"])
        self.t_win_end = float(d["t_win_end"])
        self._pending_win = None
        self.t_av_beg = float(d["t_av_beg"])
        self.t_av_end = float(d["t_av_end"])
        self.initialized = bool(d["be_initialized"])
        if self.initialized and self.traj is None:
            # Initialized but no window completed: recreate the empty trajectory.
            self.traj = spline.Trajectory(float(d["traj_t_beg"]),
                                          self.cfg.trajectory.dt_knots, self.order)
        self.first_window = bool(d["first_window"])
        self.idx_cp_opt_beg = int(d["idx_cp_opt_beg"])
        pl = np.asarray(d["pose_latest"], np.float64)
        self.pose_latest = (float(pl[0]), pl[1:5]) if len(pl) else None
        ap = np.asarray(d["av_prev"], np.float64)
        self._av_prev = (float(ap[0]), ap[1:4]) if len(ap) else None
        self._av_times = [float(t) for t in np.asarray(d["av_inbox_t"])]
        self._av_vals = [w for w in np.asarray(d["av_inbox_w"], np.float64)]
        bp = int(d["bootstrap_pending"])
        self._bootstrap_pending = None if bp < 0 else bp
        tl = np.asarray(d["trajectory_log"], np.float64).reshape(-1, 5)
        self.trajectory_log = [(float(r[0]), r[1:5]) for r in tl]

    def checkpoint(self) -> dict:
        """Serializable back-end state, with the keys of the JAX package's
        Backend.checkpoint: knots, maps, window cursors, integrator anchors,
        the ang-vel inbox and the refined-pose log. Completes the window in
        flight first; the inbox's estimates in flight are fetched in one
        wait."""
        self.flush()
        if self.finalize_fn is not None:
            self._fetch(self._av_vals)
        if self._av_vals:
            av_w = np.stack([self._av_value(v) for v in self._av_vals])
        else:
            av_w = np.zeros((0, 3))
        tl = (np.array([[t, *q] for t, q in self.trajectory_log])
              if self.trajectory_log else np.zeros((0, 5)))
        with TRACE.span("backend.read_map", wait=True):
            ig, upd = self.IG.cpu().numpy(), self.update_times.cpu().numpy()
        self.metrics.count("backend.host_reads", 2)
        return {
            "knots": self.traj.knots if self.traj else np.zeros((0, 4)),
            "traj_t_beg": self.traj.t_beg if self.traj else 0.0,
            "IG": ig,
            "update_times": upd,
            "count_window": self.count_window,
            "t_win_beg": getattr(self, "t_win_beg", 0.0),
            "t_win_end": getattr(self, "t_win_end", 0.0),
            "t_av_beg": getattr(self, "t_av_beg", 0.0),
            "t_av_end": getattr(self, "t_av_end", 0.0),
            "be_initialized": self.initialized,
            "first_window": self.first_window,
            "idx_cp_opt_beg": self.idx_cp_opt_beg,
            "pose_latest": (np.array([self.pose_latest[0], *self.pose_latest[1]])
                            if self.pose_latest is not None else np.zeros(0)),
            "av_prev": (np.array([self._av_prev[0], *self._av_prev[1]])
                        if self._av_prev is not None else np.zeros(0)),
            "av_inbox_t": np.asarray(self._av_times, np.float64),
            "av_inbox_w": av_w,
            "bootstrap_pending": (-1 if self._bootstrap_pending is None
                                  else int(self._bootstrap_pending)),
            "trajectory_log": tl,
        }


def map_epilogue(ig, upd, il_old, knots_new, fov_rel, win: PanoWindow, order: int, lut,
                 pano: EquirectCamera, max_updates: int):
    """IG absorption with per-pixel saturation (updateIG,
    pose_graph_optimizer.cpp:303) and FOV update-count growth at the
    dt_check grid (setUpdateTimesIG, :325-337): (IG, update_times) new."""
    ig_new = warp_pano.accumulate_global_map(ig, il_old, upd, max_updates)
    q_fov = spline.evaluate(knots_new, fov_rel, win.t0, win.dt_knots, order)
    return ig_new, upd + warp_pano.fov_mask(q_fov, lut, pano, radius=3)


class _WindowSolver:
    """One window's solve as one device program: the counterpart of the JAX
    package's _build_crop_solver (``crop_hw`` set) and _build_window_solver
    (the full panorama). Static buffers hold the window's events, knots,
    constants and the maps it starts from; the program runs the CG solve
    from zero increments inside the max_ba_correction_rad trust radius, its
    bounded restarts from the optimum (config.ba_solve_restarts), then the
    old/new split, the optimum's bounding box (crop) and the map epilogue,
    and packs knots and stats into ``out``; the new maps stay in
    ``ig_out``/``upd_out``. It reads nothing outside its buffers and the
    pool entry's LUT, so any back-end of its pool key may launch it."""

    def __init__(self, cfg: BackendConfig, pano: EquirectCamera, order: int, restarts: int,
                 lam: float, lut, win: PanoWindow, n_fov: int, crop_hw):
        o, dev = cfg.optim, lut.device
        N, K = win.weights.shape[0], win.knots.shape[0]
        B = win.batch_times.shape[0]
        H, W = pano.height, pano.width
        sigma, measure = cfg.warp.blur_sigma, cfg.contrast_measure
        self.order = order

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.ig_in, self.upd_in = buf(H, W), buf(H, W, dtype=torch.int32)
        self.win = PanoWindow(bearings=buf(3, N), batch_times=buf(B), weights=buf(N),
                              is_old=buf(N, dtype=torch.bool), knots=buf(K, 4),
                              free_mask=buf(K), t0=win.t0, dt_knots=win.dt_knots,
                              ig_prime=self.ig_in, alpha=buf())
        self.fov = buf(n_fov)
        # The spline basis of the window's batches (spline.segment_basis),
        # computed per window at load: the objective reads it.
        self.basis = (buf(B, dtype=torch.int32), buf(B, order))
        self.ig_out, self.upd_out = torch.zeros_like(self.ig_in), torch.zeros_like(self.upd_in)
        self.crop = None
        if crop_hw is not None:
            Hc, Wc = crop_hw
            self.crop = buf(6, dtype=torch.int64)
            self.origin = buf(2)  # the crop origin (x0, y0) as floats
            self.a_crop, self.mask = buf(Hc, Wc), buf(Hc, Wc)
            self.out_s1, self.out_s2 = buf(), buf()
            x0f, y0f = self.origin[0], self.origin[1]  # views: read at every run
            f, vg = warp_pano.make_crop_objective(self.win, pano, order, sigma, measure,
                                                  crop_hw, None, None, self.a_crop, self.mask,
                                                  self.out_s1, self.out_s2, origin=self.origin,
                                                  basis=self.basis)
        else:
            f, vg = warp_pano.make_pano_objective(self.win, pano, order, sigma, measure,
                                                  basis=self.basis)
        if lam:  # quadratic prior toward the incoming knots (refine sweeps)
            f0, vg0 = f, vg

            def f(x):
                return f0(x) + 0.5 * lam * torch.sum(x * x, dim=-1)

            def vg(x):
                v, g = vg0(x)
                return v + 0.5 * lam * torch.sum(x * x, dim=-1), g + lam * x

        self.cg = cg = optim.LaneCG(
            vg, f, 1, 3 * K, dev, max_iters=o.max_line_searches, initial_step=o.initial_step,
            line_search_tol=o.line_search_tol, grad_tol=o.grad_tol, fun_tol=o.fun_tol,
            max_fevals_per_linesearch=o.max_fevals_per_linesearch,
            stagnation_patience=o.stagnation_patience,
            secant_refine_evals=o.secant_refine_evals, ladder=o.ladder,
            cg_variant=o.cg_variant, trust_radius=cfg.max_ba_correction_rad)
        self.x0 = buf(1, 3 * K)
        self.iters, self.f0, self.first_iters = buf(1), buf(1), buf(1)

        def first():
            self.f0.copy_(cg.s.f0)
            self.first_iters.copy_(cg.s.it)
            self.iters.zero_()

        def restart():
            self.iters.add_(cg.s.it)

        def epilogue():
            win = self.win
            drotv = cg.s.x[0].reshape(K, 3)
            knots_new = spline.apply_masked_increments(win.knots, drotv, win.free_mask)
            px, py = warp_pano.warp_to_pano(drotv, win, pano, order, self.basis)
            if self.crop is None:
                il_old, _ = bilinear_accumulate_two(px, py, win.weights, ~win.is_old, H, W)
                bbox = torch.zeros(4, device=dev)
            else:
                # Old/new split at the optimum on the crop, placed into the
                # full pano, and the optimum's bounding box for the escape check.
                ilo_c, _ = bilinear_accumulate_two(px - x0f, py - y0f, win.weights,
                                                   ~win.is_old, *crop_hw)
                rows = self.crop[0] + torch.arange(crop_hw[0], device=dev)
                cols = self.crop[1] + torch.arange(crop_hw[1], device=dev)
                il_old = torch.zeros((H, W), device=dev)
                il_old[rows[:, None], cols[None, :]] = ilo_c
                bbox = warp_pano.bbox_of(px, py, win.weights)
            ig_new, upd_new = map_epilogue(self.ig_in, self.upd_in, il_old, knots_new, self.fov,
                                           win, order, lut, pano,
                                           cfg.pano_map.max_update_times)
            self.ig_out.copy_(ig_new)
            self.upd_out.copy_(upd_new)
            stats = torch.cat([self.f0, cg.s.f, (self.iters + cg.s.it).float(),
                               win.alpha.reshape(1), bbox, self.first_iters])
            self.out.copy_(torch.cat([knots_new.reshape(-1), stats]))

        def build(b):
            cg.solve(b, self.x0)
            b.seg(first)
            for _ in range(restarts):
                # Bounded re-seeded restarts: a fresh full-scale bracket from
                # the optimum (the JAX package's _build_crop_solver), its
                # loop nodes named apart from the first solve's.
                b.seg(restart)
                cg.solve(b, cg.s.x, name="restart/cg")
            b.seg(epilogue)

        name = "backend.crop" if crop_hw is not None else "backend.full"
        self.program = device_loop.Program(build, 4 * K + 9, dev, name=name)
        self.out = self.program.out

    def solve(self, win: PanoWindow, fov_rel, consts, ig, upd) -> device_loop.Result:
        """Load the window (``load``) and launch; returns the launch's
        handle."""
        with TRACE.span("backend.load"):
            self.load(win, fov_rel, consts, ig, upd)
        return self.program.run()

    def load(self, win: PanoWindow, fov_rel, consts, ig, upd) -> None:
        """Copy the window, its spline basis, its constants and the maps
        (IG, update_times) into the buffers."""
        for name in ("bearings", "batch_times", "weights", "is_old", "knots", "free_mask"):
            getattr(self.win, name).copy_(getattr(win, name))
        for buf, value in zip(self.basis, spline.segment_basis(
                self.win.batch_times, self.win.t0, self.win.dt_knots, self.win.knots.shape[0],
                self.order)):
            buf.copy_(value)
        self.ig_in.copy_(ig)
        self.upd_in.copy_(upd)
        self.win.alpha.copy_(consts["alpha"])
        self.fov.copy_(to_device(fov_rel, self.fov.device))
        if self.crop is not None:
            for name in ("crop", "a_crop", "mask", "out_s1", "out_s2"):
                getattr(self, name).copy_(consts[name])
            self.origin.copy_(consts["crop"][:2].flip(0))  # (x0, y0)
