"""Configuration dataclasses and presets; host-only copy of cmax_slam_tpu/config.py.

The field set, defaults and presets are those of the JAX package, so a config
built for one system configures the other identically (checkpoints and the
parity tests rely on that). Configs are plain frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# Contrast measures (reference: include/frontend/local_focus_funcs.h:7-11)
VARIANCE_CONTRAST = 0
MEAN_SQUARE_CONTRAST = 1
IMAGE_GRADIENT_MAGNITUDE_CONTRAST = 2


@dataclass(frozen=True)
class WarpOptions:
    """Reference: OptionsWarp (include/utils/parameters.h:17-28)."""

    blur_sigma: float = 1.0
    event_batch_size: int = 100
    event_sample_rate: int = 1
    # Matmul precision knob of the JAX package's TPU matrix-unit votes. The
    # port votes with exact f32 atomics and blurs with f32 matmuls, so the
    # value is carried for config compatibility and ignored.
    precision: str = "default"


@dataclass(frozen=True)
class SlidingWindowOptions:
    """Reference: OptionSlidingwindow (include/utils/parameters.h:38-45)."""

    time_window_size: float = 0.2
    sliding_window_stride: float = 0.1


@dataclass(frozen=True)
class TrajectoryOptions:
    """Reference: OptionTraj (include/utils/parameters.h:48-55)."""

    dt_knots: float = 0.1
    spline_degree: int = 1  # 1=Linear, 3=Cubic


@dataclass(frozen=True)
class PanoMapOptions:
    """Reference: OptionPanoMap (include/utils/parameters.h:59-73)."""

    pano_height: int = 1024
    pano_width: int = 2048
    y_angle_deg: float = 0.0
    max_update_times: int = 10
    backend_min_ev_rate: int = 10


@dataclass(frozen=True)
class OptimOptions:
    """Optimizer budget; reference hard-codes these
    (src/frontend/local_optim_contrast_gsl.cpp:108-122,
    src/backend/global_optim_contrast_gsl.cpp:41-53)."""

    max_line_searches: int = 50
    initial_step: float = 0.1
    line_search_tol: float = 0.05  # directional-derivative reduction factor
    grad_tol: float = 1e-3  # front-end; back-end uses 1e-4
    fun_tol: float = 1e-4
    # Bracket budget per line search: 16 spans step scales 2^-4..2^4.
    max_fevals_per_linesearch: int = 16
    # Consecutive stalls required to STOP; earlier stalls restart the solve
    # with steepest descent. 1 = exact GSL semantics, the default everywhere.
    stagnation_patience: int = 1
    # Secant-refinement budget per line search (phase 2 of every ladder).
    secant_refine_evals: int = 4
    # Line-search bracket: "sequential" probes rungs one at a time;
    # "vector" evaluates every rung in one batched objective call; "grid"
    # replays the sequential choice over a batched grid of rungs.
    ladder: str = "sequential"
    # Conjugate-direction formula: "fr" = Fletcher-Reeves (GSL
    # conjugate_fr, the reference's method); "pr" = Polak-Ribiere+.
    cg_variant: str = "fr"


@dataclass(frozen=True)
class FrontendConfig:
    """Reference: AngVelEstParams (include/utils/parameters.h:76-86)."""

    contrast_measure: int = VARIANCE_CONTRAST
    num_events_per_packet: int = 30000
    dt_ang_vel: float = 0.02
    warp: WarpOptions = field(default_factory=WarpOptions)
    # Vector ladder by default: the packet objective is small, so all rungs
    # of a line search go to the device in one batched evaluation.
    optim: OptimOptions = field(
        default_factory=lambda: OptimOptions(ladder="vector"))
    show_iwe: bool = False
    # Coarse-to-fine CMax (no reference counterpart): solve on a 3x-blurred
    # IWE first, then refine at blur_sigma. Off by default.
    coarse_to_fine: bool = False
    # Stride batching of the JAX package (the packets ready at one push in
    # one device program, with the per-packet path's numerics). Accepted
    # and without effect: the port solves every packet on the per-packet
    # chain, whose solves read f and g on the host.
    batch_sweeps: int = 2
    # Device-resident event ring (io/devring.py): each event is uploaded
    # once and packets are gathered on the device; 0 = auto capacity (>= 16
    # packets, at least 2^21 events). Scheduling only: the solver's inputs
    # are bit-identical to those gathered from the host store.
    device_store: bool = True
    device_store_capacity: int = 0


@dataclass(frozen=True)
class BackendConfig:
    """Reference: PoseGraphParams (include/utils/parameters.h:89-102)."""

    contrast_measure: int = VARIANCE_CONTRAST
    sliding_window: SlidingWindowOptions = field(default_factory=SlidingWindowOptions)
    warp: WarpOptions = field(default_factory=WarpOptions)
    trajectory: TrajectoryOptions = field(default_factory=TrajectoryOptions)
    pano_map: PanoMapOptions = field(default_factory=PanoMapOptions)
    # initial_step stays at the front-end's 0.1 and stagnation_patience at 1
    # (see cmax_slam_tpu/config.py for the accuracy reasons).
    optim: OptimOptions = field(
        default_factory=lambda: OptimOptions(
            grad_tol=1e-4, line_search_tol=0.1
        )
    )
    show_iwe: bool = False
    draw_fov: bool = False
    gamma: float = 0.75
    # Cap on the padded per-window event subset.
    max_events_per_window: int = 1 << 18
    # FOV-crop solver: evaluate each window's objective on a crop around the
    # warped-event footprint (exact; ops/warp_pano.make_crop_objective). The
    # margin bounds how far the optimizer may move knots before the escape
    # check triggers a full-pano re-solve of that window.
    crop_solver: bool = True
    crop_margin_rad: float = 0.1
    # Knots frozen in the very first window; None = reference semantics
    # (degree knots, pose_graph_optimizer.cpp:261-264).
    first_window_frozen_knots: int | None = 1
    # Bounded BA solve restarts per window; None = auto (1 for the cubic
    # back-end, 0 for linear).
    ba_solve_restarts: int | None = None
    # Opt-in trust region on the per-window BA correction (radians): the
    # solve stops at it and a window whose correction exceeds it is
    # rejected (front-end knots kept, map not updated).
    max_ba_correction_rad: float | None = None
    # Quadratic prior weight toward the incoming knots, applied only during
    # offline refine sweeps (Backend.refine_pass).
    refine_prior_lambda: float = 0.0
    # One-time online bootstrap re-solve: when the back-end reaches this
    # window index, re-run the sliding-window BA once over the tracked span
    # against the map accumulated so far, then resume streaming. None turns
    # it off (the reference's never-revisit protocol).
    bootstrap_resolve_window: int | None = 4


@dataclass(frozen=True)
class SystemConfig:
    """Top-level config, analog of the launch-file parameter block
    (reference launch/ijrr.launch)."""

    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    frontend_event_sample_rate: int = 1


def ijrr_config(num_events_per_packet: int = 10000) -> SystemConfig:
    """Per-dataset preset mirroring the reference's launch/ijrr.launch."""
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=num_events_per_packet,
            dt_ang_vel=0.01,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=512, pano_width=1024, max_update_times=200,
                backend_min_ev_rate=10000,
            ),
            gamma=0.75,
            draw_fov=True,
        ),
    )


def ecrot_synth_config() -> SystemConfig:
    """Preset mirroring the reference's launch/ecrot_synth.launch."""
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=70000,
            dt_ang_vel=0.005,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=512, pano_width=1024, max_update_times=200,
                backend_min_ev_rate=10000,
            ),
        ),
    )


def ecrot_real_config(y_angle_deg: float = 0.0) -> SystemConfig:
    """Preset mirroring the reference's launch/ecrot_handheld.launch (use
    y_angle_deg=-90 for ecrot_mount.launch — the only difference): 200k-event
    packets, non-overlapping 0.2s windows, 2048-high panorama."""
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=200000,
            dt_ang_vel=0.01,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.2),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=2048, pano_width=4096, max_update_times=200,
                backend_min_ev_rate=10000, y_angle_deg=y_angle_deg,
            ),
            max_events_per_window=1 << 20,
        ),
    )


def ecrot_mount_config() -> SystemConfig:
    """Preset mirroring the reference's launch/ecrot_mount.launch."""
    return ecrot_real_config(y_angle_deg=-90.0)


def live_davis_config() -> SystemConfig:
    """Preset mirroring the reference's launch/live_davis.launch (load-shedding)."""
    return SystemConfig(
        frontend=FrontendConfig(
            num_events_per_packet=5000,
            dt_ang_vel=0.04,
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=1),
        ),
        backend=BackendConfig(
            sliding_window=SlidingWindowOptions(0.2, 0.1),
            warp=WarpOptions(blur_sigma=1.0, event_batch_size=100, event_sample_rate=5),
            trajectory=TrajectoryOptions(dt_knots=0.05, spline_degree=1),
            pano_map=PanoMapOptions(
                pano_height=512, pano_width=1024, max_update_times=200,
                backend_min_ev_rate=10,
            ),
            # Live mode keeps the reference's never-revisit protocol.
            bootstrap_resolve_window=None,
        ),
        frontend_event_sample_rate=10,
    )


def replace(cfg, **kwargs):
    """dataclasses.replace that tolerates nested dotted keys ('warp.blur_sigma').

    Dotted keys sharing a prefix ('pano_map.pano_height' and
    'pano_map.pano_width') are grouped and applied in ONE sub-replace, so
    they compose instead of the later one clobbering the earlier.
    """
    flat = {}
    nested: dict = {}
    for key, val in kwargs.items():
        if "." in key:
            head, rest = key.split(".", 1)
            nested.setdefault(head, {})[rest] = val
        else:
            flat[key] = val
    for head, sub_kwargs in nested.items():
        if head in flat:
            raise ValueError(
                f"conflicting keys: '{head}' set both directly and via dotted keys")
        flat[head] = replace(getattr(cfg, head), **sub_kwargs)
    return dataclasses.replace(cfg, **flat)
