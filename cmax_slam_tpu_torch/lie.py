"""SO(3) operations on unit quaternions in torch; counterpart of
cmax_slam_tpu/lie.py.

Quaternions are ``(..., 4)`` tensors in ``(w, x, y, z)`` order, rotation
vectors ``(..., 3)``. Every function broadcasts over leading axes and is
differentiable; the small-angle branches are guarded with ``torch.where`` on
safe operands so autograd stays NaN-free at the identity (the BA objective
is evaluated at zero increments every window).
"""

from __future__ import annotations

import torch

# Below this angle (radians) Taylor expansions replace trig ratios.
_EPS = 1e-6


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v``: hat(v) @ x == cross(v, x)
    (cross2Matrix, include/utils/image_geom_util.h:5-8)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def exp(rotvec: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector -> unit quaternion (w, x, y, z)."""
    theta_sq = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
    small = theta_sq < _EPS * _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, rotvec * sinc_half], dim=-1)


def log(q: torch.Tensor) -> torch.Tensor:
    """Logarithm map: unit quaternion -> rotation vector (angle in [0, pi])."""
    w = q[..., :1]
    xyz = q[..., 1:]
    # Force the positive hemisphere so the angle is the minimal one.
    sign = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    w = w * sign
    xyz = xyz * sign
    n_sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = n_sq < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    w_c = torch.clamp(w, -1.0, 1.0)
    theta = 2.0 * torch.atan2(n, w_c)
    # theta / sin(theta/2) ~ 2/w for tiny n
    w_safe = torch.clamp(w_c, min=0.5)
    scale = torch.where(
        small, 2.0 / w_safe - 2.0 * n_sq / (3.0 * w_safe**3), theta / n
    )
    return xyz * scale


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (compose rotations: first q2, then q1)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (conjugate)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def from_matrix(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> unit quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # Four candidate quaternions, each stable in a different region.
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)
    traces = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
         1 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(traces, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return normalize(q)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q without forming the matrix."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity quaternion (w, x, y, z)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def left_jacobian(rotvec: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3) (Sophus::leftJacobianSO3,
    basalt/utils/sophus_utils.hpp:333-371)."""
    theta_sq = torch.sum(rotvec * rotvec, dim=-1)[..., None, None]
    small = theta_sq < _EPS * _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    K = hat(rotvec)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe - torch.sin(safe)) / safe**3)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + a * K + b * (K @ K)


def left_jacobian_inv(rotvec: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3) (Sophus::leftJacobianInvSO3,
    basalt/utils/sophus_utils.hpp:373-411)."""
    theta_sq = torch.sum(rotvec * rotvec, dim=-1)[..., None, None]
    small = theta_sq < _EPS * _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    K = hat(rotvec)
    cot = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                      1.0 / (safe * safe) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye - 0.5 * K + cot * (K @ K)
