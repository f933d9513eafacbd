"""The plain reference of the back-end's window: the cumulative SO(3)
B-spline of order 2 (linear) and 4 (cubic) and the window objective the
bundle adjustment maximizes, computed from a window's raw events. Plain
PyTorch and NumPy, float64 by default (every function takes a ``dtype``, so
that a lower precision can be held to the same tolerances), written from
the reference's equations and importing nothing of the program: no kernel,
no objective, no spline of it. It runs on the CPU and on the card alike.

The spline (the reference's ``CubicTrajectory::evaluate``,
``src/backend/trajectory.cpp:329-355``, and ``LinearTrajectory::evaluate``,
``:86-110``, both basalt's So3Spline): knot i sits at ``t0 + i dt``; a time
t lies in segment s = floor((t - t0) / dt) at u = (t - t0) / dt - s, and

    R(t) = R_s * prod_{j=1}^{order-1} exp(B_j(u) log(R_{s+j-1}^-1 R_{s+j}))

with the cumulative basis B_j(u) = sum_i M[j, i] u^i (M4, ``:419-422``;
M2 the linear one, B_1(u) = u).

The window objective (EventWarper, ``src/backend/event_pano_warper.cpp``,
and global_focus_funcs): the knots are left-perturbed by exp(x_k) where
knot k is free; each batch of ``batch`` consecutive events (counted from the
window's first) is rotated by R at its batch's mid time, the midpoint of its
first and last event times (``:238-251``); each bearing b goes to the world
ray R b, projected on the equirectangular panorama (x = W/2 + atan2(x, z)
W / 2 pi, y = H/2 + asin(y / |r|) H / pi); bilinear votes of unit weight,
kept when 1 <= floor < size - 2 on both axes; the image is the Gaussian blur
(OpenCV's automatic kernel, reflect-101 borders) of IL + alpha IG', where IG'
is the global map and alpha = density(IL at x = 0) / density(IG'), 0 for an
empty map (``:134-165``), density(I) = sum I / sum (1 - exp(-I)); the
objective is minus the image's population variance.

Departures from the C++, each also the port's:
- a time outside the spline's domain takes the nearest segment (the C++
  asserts it is inside);
- alpha is a constant of the window, taken at zero increments;
- the vote's gradient is the floor-parametrized one (the floor a constant),
  the reference's one-sided derivative;
- the display gamma (``backend.gamma``) only renders the map and is not part
  of the objective.

Large windows are computed in blocks of events (``Window``): the image as a
sum of the blocks' votes, the gradient as the sum over blocks of the votes'
adjoint against dL/dIL, which is computed once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pb import reference

# The cumulative bases, rows by knot j, columns by the power of u.
BASIS = {
    2: np.array([[1.0, 0.0],
                 [0.0, 1.0]]),
    4: np.array([[6.0, 0.0, 0.0, 0.0],
                 [5.0, 3.0, -3.0, 1.0],
                 [1.0, 3.0, 3.0, -2.0],
                 [0.0, 0.0, 0.0, 1.0]]) / 6.0,
}


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """exp of a rotation vector; the series near 0 keeps it differentiable."""
    th2 = (v * v).sum(-1, keepdim=True)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    w = torch.where(small, 1 - th2 / 8, torch.cos(th / 2))
    s = torch.where(small, 0.5 - th2 / 48, torch.sin(th / 2) / th)
    return torch.cat([w, s * v], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion, on the short arc."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., :1], q[..., 1:]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    scale = torch.where(small, 2 / w.clamp(min=0.5), 2 * torch.atan2(n, w) / n)
    return v * scale


def quat_rotate(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q r q^-1 for rays r (..., 3)."""
    p = torch.cat([torch.zeros_like(r[..., :1]), r], dim=-1)
    return quat_mul(quat_mul(q, p), quat_conj(q))[..., 1:]


# ---------------------------------------------------------------------------
# The spline
# ---------------------------------------------------------------------------

def segment(t, t0: float, dt: float, num_knots: int, order: int, dtype=torch.float64):
    """(segment s (int64), cumulative basis (..., order)) of times ``t``."""
    t = torch.as_tensor(t, dtype=torch.float64)
    rel = (t - t0) / dt
    s = torch.floor(rel).to(torch.int64).clamp(0, num_knots - order)
    u = (rel - s.to(torch.float64)).to(dtype)
    M = torch.as_tensor(BASIS[order], dtype=dtype, device=u.device)
    powers = torch.stack([u ** i for i in range(order)], dim=-1)
    return s, powers @ M.T


def blend(knots: torch.Tensor, s: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """R_s * prod_j exp(B_j log(R_{s+j-1}^-1 R_{s+j})) for segments ``s`` and
    their basis ``coeff`` (..., order)."""
    order = coeff.shape[-1]
    kq = knots[s[..., None] + torch.arange(order, device=knots.device)]
    res = kq[..., 0, :]
    for j in range(1, order):
        d = quat_log(quat_mul(quat_conj(kq[..., j - 1, :]), kq[..., j, :]))
        res = quat_mul(res, quat_exp(coeff[..., j, None] * d))
    return res


def evaluate(knots: torch.Tensor, t, t0: float, dt: float, order: int) -> torch.Tensor:
    """The spline's quaternions at times ``t`` (the knots' dtype)."""
    s, coeff = segment(t, t0, dt, knots.shape[0], order, knots.dtype)
    return blend(knots, s.to(knots.device), coeff.to(knots.device))


def perturb(knots: torch.Tensor, x: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Knot k left-multiplied by exp(x_k) where it is free."""
    return quat_mul(quat_exp(x * free[:, None]), knots)


# ---------------------------------------------------------------------------
# The window objective
# ---------------------------------------------------------------------------

def batch_mid_times(ts: np.ndarray, batch: int) -> np.ndarray:
    """Each batch's mid time: the midpoint of its first and last event's."""
    ts = np.asarray(ts, np.float64)
    first = ts[::batch]
    last = ts[np.minimum(np.arange(batch - 1, len(ts) + batch - 1, batch), len(ts) - 1)]
    return first + 0.5 * (last - first)


def project(r: torch.Tensor, height: int, width: int):
    """Equirectangular pixel coordinates of rays (..., 3)."""
    x, y, z = r.unbind(-1)
    rho = torch.sqrt(x * x + y * y + z * z)
    px = width / 2 + torch.atan2(x, z) * (width / (2 * math.pi))
    py = height / 2 + torch.asin(torch.clamp(y / rho, -1, 1)) * (height / math.pi)
    return px, py


def density(image: torch.Tensor) -> torch.Tensor:
    return image.sum() / torch.clamp((1 - torch.exp(-image)).sum(), min=1e-12)


def variance(image: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(image - image.mean()))


class Window:
    """One back-end window from its raw events, in ``dtype`` on ``device``.

    bearings (N, 3) are the events' unit camera rays in stream order, ts (N,)
    their times; knots (K, 4) the window's control poses, knot 0 at
    ``t_knot0`` on the events' clock, spaced ``dt``; free (K,) 1 for a knot
    the window solves; ig_prime (H, W) the global map. ``block`` events are
    warped and voted at a time."""

    def __init__(self, bearings, ts, knots, free, t_knot0: float, dt: float, order: int,
                 batch: int, ig_prime, sigma: float, device="cpu", dtype=torch.float64,
                 block: int = 1 << 17):
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

        self.dtype, self.device, self.order, self.sigma = dtype, device, order, sigma
        self.b = put(bearings)
        self.knots, self.free = put(knots), put(free)
        self.ig = put(ig_prime)
        self.height, self.width = self.ig.shape
        self.n = self.b.shape[0]
        self.batch = batch
        mids = batch_mid_times(ts, batch) - t_knot0
        s, coeff = segment(mids, 0.0, dt, self.knots.shape[0], order, dtype)
        self.seg, self.coeff = s.to(device), coeff.to(device)
        self.block = max(batch, block // batch * batch)
        with torch.no_grad():
            il0 = self.votes(torch.zeros_like(self.knots[:, :3]))
            if torch.count_nonzero(self.ig) == 0:
                self.alpha = torch.zeros((), dtype=dtype, device=device)
            else:
                self.alpha = density(il0) / density(self.ig)

    def rotations(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The spline's quaternion of every event in [lo, hi) (its batch's)."""
        bl, bh = lo // self.batch, -(-hi // self.batch)
        res = blend(perturb(self.knots, x, self.free), self.seg[bl:bh], self.coeff[bl:bh])
        per_event = torch.arange(lo, hi, device=self.device) // self.batch - bl
        return res[per_event]

    def coords(self, x: torch.Tensor, lo: int, hi: int):
        r = quat_rotate(self.rotations(x, lo, hi), self.b[lo:hi])
        return project(r, self.height, self.width)

    def votes(self, x: torch.Tensor) -> torch.Tensor:
        """IL: every event's votes at increments x (K, 3), block by block."""
        il = torch.zeros((self.height, self.width), dtype=self.dtype, device=self.device)
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            il = il + reference.vote(*self.coords(x, lo, hi), self.height, self.width)
        return il

    def image(self, il: torch.Tensor) -> torch.Tensor:
        return reference.blur(il + self.alpha * self.ig, self.sigma)

    def value(self, x) -> float:
        with torch.no_grad():
            return float(-variance(self.image(self.votes(self._x(x)))))

    def value_grad(self, x) -> tuple:
        """(value, d value / dx (K, 3) as float64 numpy)."""
        x = self._x(x)
        with torch.no_grad():
            il = self.votes(x)
        il.requires_grad_(True)
        v = -variance(self.image(il))
        (g_il,) = torch.autograd.grad(v, il)
        return float(v.detach()), self.adjoint(x, g_il)

    def adjoint(self, x, g_il: torch.Tensor) -> np.ndarray:
        """d <IL(x), g_il> / dx (K, 3) as float64 numpy: the votes' adjoint
        against an (H, W) image, block by block."""
        x = self._x(x)
        g_il = g_il.to(self.dtype)
        grad = torch.zeros_like(x)
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            xb = x.detach().clone().requires_grad_(True)
            part = (reference.vote(*self.coords(xb, lo, hi), self.height, self.width) * g_il).sum()
            grad = grad + torch.autograd.grad(part, xb)[0]
        return grad.double().cpu().numpy()

    def _x(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x, np.float64))
        return x.to(device=self.device, dtype=self.dtype).reshape(-1, 3)
