"""Continuous-time SO(3) trajectory: cumulative uniform B-splines; counterpart
of cmax_slam_tpu/spline.py.

The host half (blending matrices, control-pose fitting, float64 evaluation
and the quaternion helpers) is a numpy copy of the JAX package's. The device
half evaluates the spline on torch tensors and is differentiable with
respect to the knots, so the BA gradient comes from autograd.

Knots are (K, 4) unit quaternions (w, x, y, z).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import lie
from .utils.device import to_device


# ---------------------------------------------------------------------------
# Blending matrices (basalt spline_common.h:70-100)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def blending_matrix(order: int, cumulative: bool = True) -> np.ndarray:
    """Uniform B-spline blending matrix M (order x order), optionally
    cumulative (Qin 1998). Basis weights = [1, u, u^2, ...] @ M."""
    n = order
    m = np.zeros((n, n), dtype=np.float64)  # m[basis j, power i]
    for i in range(n):
        for j in range(n):
            s_sum = 0.0
            for s in range(j, n):
                s_sum += (-1.0) ** (s - j) * math.comb(n, s - j) * (n - s - 1.0) ** (n - 1 - i)
            m[j, i] = math.comb(n - 1, n - 1 - i) * s_sum
    if cumulative:
        for i in range(n):
            for j in range(i + 1, n):
                m[i, :] += m[j, :]
    m /= math.factorial(n - 1)
    return np.ascontiguousarray(m.T)


# ---------------------------------------------------------------------------
# Device evaluation (torch)
# ---------------------------------------------------------------------------

def _segment_and_u(t: torch.Tensor, t0, dt, num_knots: int, order: int):
    """Segment index s and normalized position u for times t."""
    rel = (t - t0) / dt
    s = torch.floor(rel).to(torch.int64).clamp(0, num_knots - order)
    u = rel - s.to(rel.dtype)
    return s, u


@functools.lru_cache(maxsize=16)
def _blending_tensor(order: int, dtype, device: str) -> torch.Tensor:
    """The cumulative blending matrix resident on ``device``, uploaded once:
    code captured into a CUDA graph may not copy from the host."""
    return to_device(blending_matrix(order, cumulative=True), device, dtype)


def _coeffs(u: torch.Tensor, order: int, dtype) -> torch.Tensor:
    M = _blending_tensor(order, dtype, str(u.device))
    up = torch.stack([u**i for i in range(order)], dim=-1)
    return up @ M


def segment_basis(t: torch.Tensor, t0, dt, num_knots: int, order: int,
                  dtype=torch.float32):
    """Each time's spline segment (int32) and its (order,) blending
    coefficients, as ``evaluate_rotmats`` computes them from ``t``: they do
    not depend on the knots, so a window computes them once and its
    objective reads them (the back-end kernels K4 and K5 take them as
    operands)."""
    s, u = _segment_and_u(t, t0, dt, num_knots, order)
    return s.to(torch.int32), _coeffs(u, order, dtype)


def evaluate(knots: torch.Tensor, t: torch.Tensor, t0, dt, order: int) -> torch.Tensor:
    """Evaluate the cumulative SO(3) B-spline at times ``t`` -> (..., 4).

    R(t) = R_s * prod_{j=1..N-1} exp(coeff_j * log(R_{s+j-1}^{-1} R_{s+j}))
    (So3Spline::evaluate, so3_spline.h:218-274). ``t`` are relative seconds
    on the same clock as ``t0``."""
    num_knots = knots.shape[0]
    s, u = _segment_and_u(t, t0, dt, num_knots, order)
    coeff = _coeffs(u, order, knots.dtype)
    kq = knots[s[..., None] + torch.arange(order, device=knots.device)]
    res = kq[..., 0, :]
    for j in range(1, order):
        delta = lie.log(lie.mul(lie.inv(kq[..., j - 1, :]), kq[..., j, :]))
        res = lie.mul(res, lie.exp(coeff[..., j, None] * delta))
    return res


def evaluate_with_jacobian(knots: torch.Tensor, t: torch.Tensor, t0, dt, order: int):
    """Closed-form Jacobian d(R(t)) / d(left perturbation of each knot), the
    recursion of So3Spline::evaluate with J != nullptr (so3_spline.h:237-273);
    a test oracle, the paths differentiate ``evaluate`` by autograd. Returns
    (quaternion, start index, (..., order, 3, 3))."""
    num_knots = knots.shape[0]
    s, u = _segment_and_u(t, t0, dt, num_knots, order)
    coeff = _coeffs(u, order, knots.dtype)
    kq = knots[s[..., None] + torch.arange(order, device=knots.device)]
    res = kq[..., 0, :]
    J_helper = torch.eye(3, dtype=knots.dtype, device=knots.device).expand(*t.shape, 3, 3)
    Js = []
    for j in range(1, order):
        q0, q1 = kq[..., j - 1, :], kq[..., j, :]
        delta = lie.log(lie.mul(lie.inv(q0), q1))
        kdelta = coeff[..., j, None] * delta
        Ji = J_helper
        J_helper = coeff[..., j, None, None] * (
            lie.to_matrix(res) @ lie.left_jacobian(kdelta) @ lie.left_jacobian_inv(delta)
            @ lie.to_matrix(lie.inv(q0)))
        Js.append(Ji - J_helper)
        res = lie.mul(res, lie.exp(kdelta))
    Js.append(J_helper)
    return res, s, torch.stack(Js, dim=-3)


def _soa_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _soa_log(q):
    w, x, y, z = q
    sign = torch.where(w < 0, -1.0, 1.0).to(w.dtype)
    w, x, y, z = w * sign, x * sign, y * sign, z * sign
    n_sq = x * x + y * y + z * z
    small = n_sq < lie._EPS * lie._EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    w_c = torch.clamp(w, -1.0, 1.0)
    theta = 2.0 * torch.atan2(n, w_c)
    w_safe = torch.clamp(w_c, min=0.5)
    scale = torch.where(small, 2.0 / w_safe - 2.0 * n_sq / (3.0 * w_safe**3), theta / n)
    return x * scale, y * scale, z * scale


def _soa_exp(v):
    x, y, z = v
    theta_sq = x * x + y * y + z * z
    small = theta_sq < lie._EPS * lie._EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return w, x * sinc_half, y * sinc_half, z * sinc_half


def evaluate_rotmats(knots: torch.Tensor, t: torch.Tensor, t0, dt, order: int,
                     basis=None):
    """Spline rotation matrices at times ``t`` (B,) as a 3x3 nest of (..., B)
    component tensors R[i][j]: ``lie.to_matrix(evaluate(...))`` in
    component-wise arithmetic, the form the back-end warp consumes. ``knots``
    is (..., K, 4); leading dimensions (a batch of candidate trajectories)
    carry through to the components. ``basis``: ``segment_basis`` of ``t``,
    computed beforehand (else here)."""
    num_knots = knots.shape[-2]
    s, coeff = basis or segment_basis(t, t0, dt, num_knots, order, knots.dtype)  # (B,), (B, order)
    kq = knots[..., s[:, None] + torch.arange(order, device=knots.device), :]  # (..., B, order, 4)

    res = tuple(kq[..., 0, c] for c in range(4))
    for j in range(1, order):
        q0_inv = (kq[..., j - 1, 0], -kq[..., j - 1, 1], -kq[..., j - 1, 2],
                  -kq[..., j - 1, 3])
        q1 = tuple(kq[..., j, c] for c in range(4))
        dx, dy, dz = _soa_log(_soa_mul(q0_inv, q1))
        c = coeff[:, j]
        res = _soa_mul(res, _soa_exp((c * dx, c * dy, c * dz)))

    w, x, y, z = res
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def incremental_update(knots: torch.Tensor, drotv: torch.Tensor, idx_beg: int) -> torch.Tensor:
    """Left-perturb knots[idx_beg:] by exp(drotv): the BA update step."""
    updated = lie.mul(lie.exp(drotv), knots[idx_beg:])
    return torch.cat([knots[:idx_beg], updated], dim=0)


def apply_masked_increments(knots: torch.Tensor, drotv: torch.Tensor,
                            free_mask: torch.Tensor) -> torch.Tensor:
    """Differentiable left-perturbation with a per-knot free/frozen mask
    (frozen knots: pose_graph_optimizer.cpp:283-288)."""
    return lie.mul(lie.exp(drotv * free_mask[:, None]), knots)


# ---------------------------------------------------------------------------
# Host half (numpy, float64)
# ---------------------------------------------------------------------------

def fit_ctrl_poses(
    pose_times: np.ndarray,
    pose_quats: np.ndarray,
    t_beg: float,
    dt_knots: float,
    num_cps: int,
    order: int,
) -> np.ndarray:
    """Fit ``num_cps`` control poses to pose samples via a tangent-space
    least-squares solve (trajectory.cpp:112-192 / 357-464), using the
    non-cumulative basis like the reference."""
    if len(pose_times) < num_cps:
        raise ValueError("underdetermined control-pose fit")
    M = blending_matrix(order, cumulative=False)

    # 1. Lift: rotation increments relative to the first pose.
    q_off = pose_quats[0]
    q_off_inv = q_off * np.array([1.0, -1, -1, -1])
    d = np.zeros((len(pose_times), 3))
    for i, q in enumerate(pose_quats):
        d[i] = _np_quat_log(_np_quat_mul(q_off_inv, q))

    # 2. Solve N P = D in least squares.
    N = np.zeros((len(pose_times), num_cps))
    for row, t in enumerate(pose_times):
        t_i = int(np.floor((t - t_beg) / dt_knots))
        t_i = min(max(t_i, 0), num_cps - order)
        u = (t - (t_i * dt_knots + t_beg)) / dt_knots
        U = np.array([u**i for i in range(order)])
        N[row, t_i : t_i + order] = U @ M
    P, *_ = np.linalg.lstsq(N, d, rcond=None)

    # 3. Retract.
    out = np.zeros((num_cps, 4))
    for i in range(num_cps):
        out[i] = _np_quat_mul(q_off, _np_quat_exp(P[i]))
    return out


def evaluate_np(knots: np.ndarray, t, t0: float, dt: float, order: int) -> np.ndarray:
    """Pure-numpy float64 batch evaluation (same math as `evaluate`), for
    host bookkeeping: pose lookups, crop planning, checkpoint resume."""
    knots = np.asarray(knots, np.float64)
    t = np.atleast_1d(np.asarray(t, np.float64))
    M = blending_matrix(order, cumulative=True)
    rel = (t - t0) / dt
    s = np.clip(np.floor(rel).astype(np.int64), 0, len(knots) - order)
    u = rel - s
    up = np.stack([u**i for i in range(order)], axis=-1)
    coeff = up @ M  # (B, order)
    kq = knots[s[:, None] + np.arange(order)]  # (B, order, 4)
    res = kq[:, 0]
    for j in range(1, order):
        q0 = kq[:, j - 1] * np.array([1.0, -1, -1, -1])
        d = _np_quat_log_batch(_np_quat_mul_batch(q0, kq[:, j]))
        res = _np_quat_mul_batch(res, _np_quat_exp_batch(coeff[:, j, None] * d))
    return res


def _np_quat_mul_batch(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _np_quat_exp_batch(v):
    theta = np.linalg.norm(v, axis=-1, keepdims=True)
    small = theta < 1e-12
    safe = np.where(small, 1.0, theta)
    w = np.cos(theta / 2)
    s = np.where(small, 0.5, np.sin(safe / 2) / safe)
    return np.concatenate([w, s * v], axis=-1)


def _np_quat_log_batch(q):
    w = q[..., :1]
    xyz = q[..., 1:]
    sign = np.where(w < 0, -1.0, 1.0)
    w = w * sign
    xyz = xyz * sign
    n = np.linalg.norm(xyz, axis=-1, keepdims=True)
    small = n < 1e-12
    scale = np.where(
        small, 2.0 / np.maximum(w, 0.5),
        2.0 * np.arctan2(n, w) / np.where(small, 1.0, n),
    )
    return xyz * scale


def _np_quat_rotmat_batch(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def _np_quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _np_quat_exp(v):
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.array([1.0, *(0.5 * v)])
    return np.array([np.cos(theta / 2), *(np.sin(theta / 2) * v / theta)])


def _np_quat_log(q):
    w = q[0]
    xyz = np.asarray(q[1:])
    if w < 0:
        w, xyz = -w, -xyz
    n = np.linalg.norm(xyz)
    if n < 1e-12:
        return 2.0 * xyz / max(w, 0.5)
    return 2.0 * np.arctan2(n, w) * xyz / n


def interp_pose_mid(t1, q1, t2, q2):
    """SO(3) midpoint interpolation (Trajectory::interpPoseMid,
    trajectory.cpp:7-20), on the host."""
    dq = _np_quat_mul(q1 * np.array([1.0, -1, -1, -1]), q2)
    return 0.5 * (t1 + t2), _np_quat_mul(q1, _np_quat_exp(0.5 * _np_quat_log(dq)))


class Trajectory:
    """Host-side growing trajectory (cmax_slam::Trajectory,
    include/backend/trajectory.h:25-78). Holds knots as float64 numpy."""

    def __init__(self, t_beg: float, dt_knots: float, order: int):
        if order not in (2, 4):
            raise ValueError(f"spline order must be 2 or 4, got {order}")
        self.t_beg = float(t_beg)
        self.dt_knots = float(dt_knots)
        self.order = order
        self.knots = np.zeros((0, 4), dtype=np.float64)

    @property
    def size(self) -> int:
        return len(self.knots)

    @property
    def degree(self) -> int:
        return self.order - 1

    def knot_time(self, i: int) -> float:
        return self.t_beg + i * self.dt_knots

    def generate_ctrl_poses(self, pose_times: np.ndarray, pose_quats: np.ndarray,
                            t_beg: float, t_end: float) -> np.ndarray:
        """round(span / dt) + degree knots fitted to pose samples
        (LinearTrajectory::generateCtrlPoses, trajectory.cpp:210-219;
        CubicTrajectory, :480-489)."""
        num_cps = int(round((t_end - t_beg) / self.dt_knots)) + self.degree
        return fit_ctrl_poses(pose_times, pose_quats, t_beg, self.dt_knots, num_cps, self.order)

    def push_ctrl_poses(self, quats: np.ndarray) -> None:
        self.knots = np.concatenate([self.knots, np.atleast_2d(quats)], axis=0)

    def evaluate(self, t) -> np.ndarray:
        """Evaluate at scalar/array times (float64 host path)."""
        return evaluate_np(self.knots, t, self.t_beg, self.dt_knots, self.order)

    def incremental_update(self, drotv: np.ndarray, idx_beg: int) -> None:
        """Left-perturb knots[idx_beg:] by exp(drotv) in float64 on the host
        (trajectory.cpp:221-238)."""
        drotv = np.broadcast_to(np.asarray(drotv, np.float64),
                                (self.size - idx_beg, 3))
        tail = _np_quat_mul_batch(_np_quat_exp_batch(drotv), self.knots[idx_beg:])
        self.knots = np.concatenate([self.knots[:idx_beg], tail], axis=0)

    def max_time(self) -> float:
        return self.t_beg + (self.size - self.order + 1) * self.dt_knots
