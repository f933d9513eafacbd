"""System orchestration; counterpart of cmax_slam_tpu/system.py.

Rebuild of CMaxSLAM (src/cmax_slam.cpp:14-161) without ROS: construction
precomputes the bearing LUT from the calibration and wires the front-end and
back-end over one shared EventStore. Pushing events advances the front-end;
every new angular-velocity estimate feeds the back-end, which dispatches each
window as soon as it is complete. As in the JAX package the loop runs ahead
of the device: the front-end's estimates stay in flight until the back-end
integrates them, and each window's solve completes at the next window (one
wait for both, Backend._fused_fetch); flush() joins the window in flight,
and the accessors below join what they read.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from .backend import Backend, WindowResult
from .calib import CameraCalibration, bearing_lut
from .config import SystemConfig
from .frontend import AngVelEstimate, Frontend
from .io.events import EventStore
from .ops.warp_local import CameraParams
from .utils.device import resolve_device
from .utils.metrics import TRACE, Metrics


class CMaxSLAM:
    def __init__(self, calib: CameraCalibration, cfg: Optional[SystemConfig] = None, *,
                 device=None, backend_device=None, run_backend: bool = True):
        """``device``: where the front-end's packet solves run ('cpu' or
        'cuda'; default the card), and 'cuda' without a usable card raises.
        ``backend_device``: where the back-end's maps, LUT and window solves
        live (default: ``device``); a second card maps the reference's
        back-end thread (src/cmax_slam.cpp:92) onto its own chip. The two
        stages exchange only host floats (angular velocities)."""
        self.device = resolve_device(device)
        self.backend_device = (self.device if backend_device is None
                               else resolve_device(backend_device))
        self.cfg = cfg if cfg is not None else SystemConfig()
        self.calib = calib
        self.metrics = Metrics()

        lut = bearing_lut(calib)
        K = calib.K
        cam = CameraParams(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                           cy=float(K[1, 2]), width=calib.width, height=calib.height)
        self.store = EventStore()
        self.frontend = Frontend(cam, lut, self.cfg.frontend, device=self.device,
                                 store=self.store, metrics=self.metrics)
        self.backend = None
        if run_backend:
            self.backend = Backend(
                calib.width, calib.height, lut, self.cfg.backend, self.store,
                device=self.backend_device,
                frontend_sample_rate=self.cfg.frontend_event_sample_rate,
                metrics=self.metrics,
            )
            self.backend.retain_from_fn = self.frontend.min_needed_abs_index
            # Estimates finalize when the back-end integrates them, in the
            # window's one wait, not at every push.
            self.frontend.auto_finalize = False
            self.backend.finalize_fn = self.frontend.finalize_batch
        self._decim_phase = 0
        # Raw (pre-decimation) events consumed; checkpointed so a resumed
        # replay knows how far into the recording to skip.
        self._raw_count = 0

    # ------------------------------------------------------------------
    def push_events(self, xs, ys, ts, ps) -> List[AngVelEstimate]:
        """Feed a chunk of raw sensor events (eventsCallback,
        src/cmax_slam.cpp:147-161): decimate by frontend_event_sample_rate,
        advance the front-end, hand fresh ang-vels to the back-end and step
        every window that became complete.

        With a back-end the returned estimates may still be in flight (see
        AngVelEstimate): call ``frontend.finalize_batch(ests)``, or read
        ``ang_vel_log``, before reading their fields.

        Traced (utils.metrics.TRACE), a ``system.push`` span holding the
        time of the chunk's last event."""
        last = float(ts[-1]) if TRACE.recording and len(ts) else None
        with TRACE.span("system.push", t_event=last):
            rate = self.cfg.frontend_event_sample_rate
            self._raw_count += len(ts)
            if rate > 1:
                # phase-continuous every-rate-th selection across chunks
                n = len(ts)
                sel = (np.arange(n) + self._decim_phase) % rate == 0
                self._decim_phase = (self._decim_phase + n) % rate
                xs, ys, ts, ps = xs[sel], ys[sel], ts[sel], ps[sel]

            estimates = self.frontend.push_events(xs, ys, ts, ps)
            if self.backend is not None:
                for est in estimates:
                    self.backend.push_ang_vel(est.t, est)
                while self.backend.ready():
                    self.backend.step()
            return estimates

    def run(self, chunks: Iterable) -> None:
        """Drive the full pipeline from an iterator of event chunks."""
        for xs, ys, ts, ps in chunks:
            self.push_events(xs, ys, ts, ps)

    def flush(self) -> None:
        """Join the back-end's window in flight (the analog of waiting for
        the reference's worker thread to drain, src/cmax_slam.cpp:92)."""
        if self.backend is not None:
            with TRACE.span("system.flush"):
                self.backend.flush()

    # ------------------------------------------------------------------
    @property
    def ang_vel_log(self) -> np.ndarray:
        """All front-end estimates as (T, 4) array [t, wx, wy, wz] (rad/s);
        those in flight are finalized first, in one wait."""
        es = self.frontend.estimates
        if not es:
            return np.zeros((0, 4))
        self.frontend.finalize_batch(es)
        return np.array([[e.t, *e.omega] for e in es])

    @property
    def trajectory_log(self):
        """Back-end refined absolute poses as [(t, quat_wxyz)] (flushes)."""
        if self.backend is None:
            return []
        self.backend.flush()
        return self.backend.trajectory_log

    def window_results(self) -> List[WindowResult]:
        """Every completed window's result (flushes)."""
        if self.backend is None:
            return []
        self.backend.flush()
        return self.backend.results

    def refine(self, source, passes: int = 1) -> List[WindowResult]:
        """Offline polish: re-run the sliding-window bundle adjustment over
        the whole stream ``passes`` times, starting from the online
        trajectory and global map (Backend.refine_pass; removes the
        map-bootstrap transient the online pass bakes into the early knots).

        ``source`` is the SAME raw event stream the online pass consumed:
        a tuple of arrays ``(xs, ys, ts[, ps])``, an iterable of such
        chunks (single pass only), or a zero-arg callable returning a fresh
        chunk iterator (re-readable; required for ``passes > 1``).
        Decimation by ``frontend_event_sample_rate`` is re-applied
        identically, so callers always pass raw sensor events."""
        if self.backend is None:
            raise ValueError("refine requires a back-end")
        if passes > 1 and not (callable(source) or isinstance(source, tuple)):
            raise ValueError("passes > 1 needs a re-readable source: pass "
                             "arrays or a callable returning a fresh iterator")
        results: List[WindowResult] = []
        for _ in range(passes):
            if callable(source):
                chunks = source()
            elif isinstance(source, tuple):
                chunks = iter([source])
            else:
                chunks = iter(source)
            results = self.backend.refine_pass(self._decimated(chunks))
        return results

    def _decimated(self, chunks):
        """Re-apply push_events' phase-continuous decimation to raw chunks
        (the back-end consumed the decimated store during the online pass)."""
        rate = self.cfg.frontend_event_sample_rate
        phase = 0
        for ch in chunks:
            xs, ys, ts = ch[0], ch[1], ch[2]
            if rate > 1:
                n = len(ts)
                sel = (np.arange(n) + phase) % rate == 0
                phase = (phase + n) % rate
                xs, ys, ts = xs[sel], ys[sel], ts[sel]
            yield (xs, ys, ts)

    def close(self) -> None:
        """Flush both stages (the port holds no background threads, so this
        is all there is to release); the system stays usable afterwards."""
        self.flush()
        self.frontend.close()
        if self.backend is not None:
            self.backend.close()

    @property
    def raw_count(self) -> int:
        """Raw (pre-decimation) events consumed so far."""
        return self._raw_count

    def save_checkpoint(self, path: str) -> None:
        """Serialize the full system state with the keys of the JAX
        package's CMaxSLAM.save_checkpoint, so either system can resume the
        other's checkpoint: trajectory knots, global map, window cursors,
        integrator anchors, the ang-vel inbox, the front-end packetizer phase,
        the resident EventStore window and the raw stream position. Joins
        the work in flight first."""
        self.flush()
        state = {}
        if self.backend is not None:
            state.update(self.backend.checkpoint())
        state.update(self.frontend.checkpoint())
        st = self.store
        state.update(
            store_base=st.base, store_xs=st._xs, store_ys=st._ys,
            store_ts=st._ts, store_ps=st._ps, store_t_last=st._t_last,
            raw_count=self._raw_count, decim_phase=self._decim_phase,
        )
        state["ang_vel_log"] = self.ang_vel_log
        state["frontend_omega"] = self.frontend.omega
        np.savez_compressed(path, **state)

    def load_checkpoint(self, path: str) -> None:
        """Restore the full system state from a checkpoint written by either
        system (see save_checkpoint). Construct with the same config and
        calibration, load, then resume pushing the raw events after
        ``raw_count``."""
        with np.load(path) as d:
            st = self.store
            st._xs = np.asarray(d["store_xs"], np.int32)
            st._ys = np.asarray(d["store_ys"], np.int32)
            st._ts = np.asarray(d["store_ts"], np.float64)
            st._ps = np.asarray(d["store_ps"], np.int8)
            st.base = int(d["store_base"])
            st._t_last = float(d["store_t_last"])
            self.frontend.restore(d)
            self._raw_count = int(d["raw_count"])
            self._decim_phase = int(d["decim_phase"])
            if self.backend is not None:
                self.backend.restore(d)
