"""Trajectory RMS after gauge alignment; host-only copy of
cmax_slam_tpu/utils/evaluate.py::rotation_rms_deg and its helpers."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import spline


def quat_to_rotmats(quats: np.ndarray) -> np.ndarray:
    return spline._np_quat_rotmat_batch(np.atleast_2d(np.asarray(quats, np.float64)))


def angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Geodesic angle between two rotations, degrees."""
    c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def align_first(R_ref: np.ndarray, R_est: np.ndarray) -> np.ndarray:
    """Left-align the estimate's gauge to the reference at the first sample."""
    return R_ref[0] @ R_est[0].T


def align_global(R_ref: np.ndarray, R_est: np.ndarray) -> np.ndarray:
    """Least-squares gauge alignment: argmin_R sum ||R_ref_i - R R_est_i||_F
    via SVD of sum(R_ref_i R_est_i^T) (rotation Procrustes)."""
    M = np.zeros((3, 3))
    for a, b in zip(R_ref, R_est):
        M += a @ b.T
    U, _, Vt = np.linalg.svd(M)
    S = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    return U @ S @ Vt


def rotation_rms_deg(
    times: np.ndarray,
    quats_ref: np.ndarray,
    quats_est: np.ndarray,
    alignment: str = "global",
) -> Tuple[float, np.ndarray]:
    """RMS rotational error (deg) after gauge alignment; returns (rms, errs)."""
    R_ref = quat_to_rotmats(quats_ref)
    R_est = quat_to_rotmats(quats_est)
    A = (align_global if alignment == "global" else align_first)(R_ref, R_est)
    errs = np.array([angle_deg(R_ref[i], A @ R_est[i]) for i in range(len(R_ref))])
    return float(np.sqrt(np.mean(errs**2))), errs
