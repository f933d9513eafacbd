"""Synthetic DVS event generation; host-only copy of cmax_slam_tpu/io/synthetic.py.

The reference has no synthetic data path (validation is visual, on rosbags —
SURVEY.md section 4); we add one: a rotating camera observing a fixed set of
world landmarks emits an event whenever a landmark is sampled, at the pixel
where the landmark projects at that instant. Warping events with the true
motion collapses each landmark to a point, so contrast is (near-)maximal at
the ground truth — the property every CMax test relies on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class SyntheticEvents:
    xs: np.ndarray  # (N,) int32 pixel column
    ys: np.ndarray  # (N,) int32 pixel row
    ts: np.ndarray  # (N,) float64 seconds, sorted
    pols: np.ndarray  # (N,) int8 in {-1, +1}
    omega: Optional[np.ndarray]  # (3,) true angular velocity if constant
    rot_fn: Callable[[np.ndarray], np.ndarray]  # t -> (...,3,3) camera-to-world


def _exp_so3(v: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    if theta < 1e-12:
        return np.eye(3) + K
    return (
        np.eye(3)
        + np.sin(theta) / theta * K
        + (1 - np.cos(theta)) / theta**2 * (K @ K)
    )


def make_landmarks(rng: np.random.Generator, n_points: int, fov_deg: float = 120.0):
    """Unit-sphere landmarks inside a cone around +z."""
    half = np.deg2rad(fov_deg / 2)
    cos_min = np.cos(half)
    z = rng.uniform(cos_min, 1.0, n_points)
    phi = rng.uniform(0, 2 * np.pi, n_points)
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def rotating_camera_events(
    rng: np.random.Generator,
    n_events: int,
    duration: float,
    omega: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    n_points: int = 300,
    R0: Optional[np.ndarray] = None,
    rot_fn: Optional[Callable] = None,
    pixel_noise: float = 0.0,
    quantize: bool = True,
    margin: int = 3,
    landmarks: Optional[np.ndarray] = None,
) -> SyntheticEvents:
    """Generate events from a purely rotating camera.

    If ``rot_fn`` is given it overrides the constant-omega model; it must map
    an array of times to (N, 3, 3) camera-to-world rotation matrices.
    """
    omega = np.asarray(omega, dtype=np.float64)
    if R0 is None:
        R0 = np.eye(3)
    if rot_fn is None:
        def rot_fn(ts):
            return np.stack([R0 @ _exp_so3(omega * t) for t in np.atleast_1d(ts)])

    if landmarks is None:
        landmarks = make_landmarks(rng, n_points)

    # Oversample: some projections fall outside the sensor.
    xs_out, ys_out, ts_out = [], [], []
    need = n_events
    while need > 0:
        n_try = int(need * 2.0) + 1000
        t = np.sort(rng.uniform(0, duration, n_try))
        idx = rng.integers(0, len(landmarks), n_try)
        R = rot_fn(t)  # (n,3,3) camera-to-world
        b = np.einsum("nji,nj->ni", R, landmarks[idx])  # world -> camera: R^T P
        ok = b[:, 2] > 0.1
        u = fx * b[:, 0] / b[:, 2] + cx
        v = fy * b[:, 1] / b[:, 2] + cy
        if pixel_noise > 0:
            u = u + rng.normal(0, pixel_noise, n_try)
            v = v + rng.normal(0, pixel_noise, n_try)
        ok &= (u >= margin) & (u < width - margin) & (v >= margin) & (v < height - margin)
        xs_out.append(u[ok])
        ys_out.append(v[ok])
        ts_out.append(t[ok])
        need = n_events - sum(len(a) for a in xs_out)

    xs = np.concatenate(xs_out)[:n_events]
    ys = np.concatenate(ys_out)[:n_events]
    ts = np.concatenate(ts_out)[:n_events]
    order = np.argsort(ts, kind="stable")
    xs, ys, ts = xs[order], ys[order], ts[order]
    if quantize:
        xs = np.clip(np.round(xs), 0, width - 1)
        ys = np.clip(np.round(ys), 0, height - 1)
    pols = rng.choice(np.array([-1, 1], dtype=np.int8), n_events)
    return SyntheticEvents(
        xs=xs.astype(np.int32),
        ys=ys.astype(np.int32),
        ts=ts,
        pols=pols,
        omega=omega if rot_fn is None else omega,
        rot_fn=rot_fn,
    )


def identity_lut(width: int, height: int, fx: float, fy: float, cx: float, cy: float):
    """Bearing LUT for an ideal (distortion-free) pinhole camera."""
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    bx = (xs - cx) / fx
    by = (ys - cy) / fy
    b = np.stack([bx.ravel(), by.ravel(), np.ones(bx.size)], axis=-1)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    return b.astype(np.float32)
