"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
written from the published CMax-SLAM equations and the launch files'
settings, importing nothing of the program.

Three layers are judged:

- the front-end's answer for a packet, its angular velocity and the
  contrast it reports there: the angular velocity against the traffic's
  truth, which is exact and constant, as a share of the truth's norm
  (``omega_err``); and the packet's contrast (the population variance of
  the Gaussian-blurred image of its events warped to the packet's time by
  the first-order rotation, bilinear votes on the floored point kept when
  1 <= floor < size - 2) computed here in float64 from the packet's raw
  events at the program's angular velocity, against the contrast the
  program reports there (``cost_rel_err``);
- the back-end's refined trajectory: the RMS angle to the truth exp(omega t)
  after a global gauge alignment (``rms_deg``, the JAX package's
  ``rotation_rms_deg`` with ``align_global``, as chip_smoke.py's
  ``_rms_vs_truth`` reads it);
- the global panoramic map: the mass-weighted mean angle from each map pixel
  to the nearest landmark, in panorama pixels (``map_offset_px``), and the
  share of the mass farther than two pixels (``map_far_share``).

Every function takes a ``dtype`` so that the control (the same reference in
bfloat16) runs through the same code.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Front-end packets
# ---------------------------------------------------------------------------

def bearings(sensor, xs, ys, dtype, device) -> torch.Tensor:
    """Unit rays of pixels (x, y) of a centred pinhole without distortion."""
    x = (torch.as_tensor(xs, device=device, dtype=torch.float64) - sensor.cx) / sensor.fx
    y = (torch.as_tensor(ys, device=device, dtype=torch.float64) - sensor.cy) / sensor.fy
    b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return (b / torch.linalg.norm(b, dim=-1, keepdim=True)).to(dtype)


def batch_dts(ts: np.ndarray, t_ref: float, batch: int) -> np.ndarray:
    """Each event's warp interval: the midpoint of its batch of ``batch``
    consecutive events (counted from the packet's first), less t_ref."""
    n = len(ts)
    out = np.empty(n)
    for a in range(0, n, batch):
        tb = ts[a:a + batch]
        out[a:a + batch] = tb[0] + 0.5 * (tb[-1] - tb[0]) - t_ref
    return out


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's automatic kernel for float images: size round(8 sigma + 1)
    made odd, weights exp(-x^2 / 2 sigma^2) summing to 1."""
    k = int(round(sigma * 8 + 1)) | 1
    x = np.arange(k) - (k - 1) / 2
    w = np.exp(-x * x / (2 * sigma * sigma))
    return w / w.sum()


def _reflect101(n: int, half: int, device) -> torch.Tensor:
    i = torch.arange(-half, n + half, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian with reflect-101 borders over the last two axes."""
    taps = gaussian_taps(sigma)
    half = len(taps) // 2
    H, W = image.shape[-2:]
    p = image[..., _reflect101(H, half, image.device), :]
    out = sum(float(taps[t]) * p[..., t:t + H, :] for t in range(len(taps)))
    p = out[..., _reflect101(W, half, image.device)]
    return sum(float(taps[t]) * p[..., t:t + W] for t in range(len(taps)))


def vote(px: torch.Tensor, py: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear votes of unit weight; the floor is a constant of the
    gradient; a vote is kept when 1 <= floor < size - 2 on both axes."""
    x0, y0 = torch.floor(px).detach(), torch.floor(py).detach()
    keep = (x0 >= 1) & (x0 < width - 2) & (y0 >= 1) & (y0 < height - 2)
    px, py, x0, y0 = px[keep], py[keep], x0[keep], y0[keep]
    dx, dy = px - x0, py - y0
    base = y0.to(torch.int64) * width + x0.to(torch.int64)
    idx = torch.cat([base, base + 1, base + width, base + width + 1])
    val = torch.cat([(1 - dx) * (1 - dy), dx * (1 - dy), (1 - dx) * dy, dx * dy])
    img = torch.zeros(height * width, dtype=px.dtype, device=px.device)
    return img.index_put((idx,), val, accumulate=True).reshape(height, width)


def packet_contrast(b: torch.Tensor, dts: torch.Tensor, omega: torch.Tensor, sensor,
                    sigma: float) -> torch.Tensor:
    """Variance of the blurred image of the packet's events warped by omega."""
    d = dts[:, None] * omega[None, :]
    r = b + torch.linalg.cross(d, b, dim=-1)
    px = sensor.fx * r[:, 0] / r[:, 2] + sensor.cx
    py = sensor.fy * r[:, 1] / r[:, 2] + sensor.cy
    img = blur(vote(px, py, sensor.height, sensor.width), sigma)
    return torch.mean(torch.square(img - img.mean()))


class Packet:
    """One packet's events on the device in ``dtype``: its contrast and
    gradient at any omega, and a local maximizer."""

    def __init__(self, xs, ys, ts, t_ref: float, batch: int, sensor, sigma: float,
                 dtype=torch.float64, device="cuda"):
        self.sensor, self.sigma, self.dtype, self.device = sensor, sigma, dtype, device
        self.b = bearings(sensor, xs, ys, dtype, device)
        self.dts = torch.as_tensor(batch_dts(np.asarray(ts, np.float64), t_ref, batch),
                                   device=device).to(dtype)

    def value_grad(self, omega) -> tuple:
        w = torch.as_tensor(np.asarray(omega, np.float64), device=self.device).to(self.dtype)
        w.requires_grad_(True)
        c = packet_contrast(self.b, self.dts, w, self.sensor, self.sigma)
        (g,) = torch.autograd.grad(c, w)
        return float(c.detach()), g.double().cpu().numpy()

    def contrast(self, omega) -> float:
        with torch.no_grad():
            w = torch.as_tensor(np.asarray(omega, np.float64), device=self.device).to(self.dtype)
            return float(packet_contrast(self.b, self.dts, w, self.sensor, self.sigma))

    def maximize(self, omega0, iters: int = 100) -> np.ndarray:
        """BFGS on the contrast from omega0 (scipy, the gradient by autograd
        in this packet's dtype)."""
        from scipy.optimize import minimize

        c0 = max(abs(self.contrast(omega0)), 1e-30)

        def fun(w):
            c, g = self.value_grad(w)
            return -c / c0, -g / c0

        res = minimize(fun, np.asarray(omega0, np.float64), jac=True, method="BFGS",
                       options={"gtol": 1e-12, "maxiter": iters})
        return np.asarray(res.x, np.float64)


def cost_rel_err(ref: Packet, answer, contrast: float) -> float:
    """How far a contrast reported for the answer lies from the float64
    reference's contrast there, as a share of the latter."""
    c = ref.contrast(answer)
    return abs(contrast - c) / c if c > 0 else math.inf


def omega_err(answer, truth) -> float:
    """How far an angular velocity lies from the truth, as a share of the
    truth's norm."""
    truth = np.asarray(truth, np.float64)
    return float(np.linalg.norm(np.asarray(answer, np.float64) - truth) / np.linalg.norm(truth))


def packets(settings: dict, st, sensor, checked: list, device, dtype=torch.float64) -> list:
    """The reference's Packet of each of the program's checked packets (its
    span of the stream and its grid time), with the configuration's batch
    size and blur."""
    return [Packet(*st.slice(*pk["span"])[:3], pk["t"], settings["frontend.warp.event_batch_size"],
                   sensor, settings["frontend.warp.blur_sigma"], dtype, device)
            for pk in checked]


def packet_numbers(settings: dict, st, sensor, checked: list, device) -> dict:
    """The front-end's numbers over the checked packets: the largest error of
    the answer against the truth, and of the contrast the program reports
    for its answer (each infinite without a packet)."""
    refs = packets(settings, st, sensor, checked, device)
    return {"omega_err": max((omega_err(pk["omega"], st.omega) for pk in checked),
                             default=math.inf),
            "cost_rel_err": max((cost_rel_err(r, pk["omega"], pk["contrast"])
                                 for r, pk in zip(refs, checked)), default=math.inf)}


# ---------------------------------------------------------------------------
# Trajectory
# ---------------------------------------------------------------------------

def truth_quats(omega, times) -> np.ndarray:
    """Quaternions (w, x, y, z) of exp(omega t), float64."""
    omega = np.asarray(omega, np.float64)
    speed = np.linalg.norm(omega)
    half = 0.5 * speed * np.asarray(times, np.float64)
    return np.concatenate([np.cos(half)[:, None],
                           np.sin(half)[:, None] * (omega / speed)[None, :]], axis=1)


def quat_rotmats(q) -> np.ndarray:
    """Rotation matrices of quaternions (w, x, y, z), normalized first."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def align_global(R_ref: np.ndarray, R_est: np.ndarray) -> np.ndarray:
    """argmin_A sum ||R_ref_i - A R_est_i||_F by the SVD of sum R_ref_i R_est_i^T."""
    M = np.einsum("nij,nkj->ik", R_ref, R_est)
    U, _, Vt = np.linalg.svd(M)
    return U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt


def rms_deg(q_truth, q_est) -> tuple:
    """(RMS angle in degrees after the global gauge alignment, the
    alignment A with R_truth ~ A R_est)."""
    R_ref, R_est = quat_rotmats(q_truth), quat_rotmats(q_est)
    A = align_global(R_ref, R_est)
    c = (np.einsum("nij,nij->n", R_ref, A @ R_est) - 1.0) / 2.0
    err = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    return float(np.sqrt(np.mean(err ** 2))), A


def to_dtype(q: np.ndarray, dtype) -> np.ndarray:
    """``q`` rounded to ``dtype`` and back to float64 (the control's knots)."""
    return torch.as_tensor(q).to(dtype).double().numpy()


# ---------------------------------------------------------------------------
# Panoramic map
# ---------------------------------------------------------------------------

def pixel_rays(ix: torch.Tensor, iy: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """World rays of equirectangular panorama pixels (360 x 180 degrees,
    x = W/2 + atan2(x, z) W / 2 pi, y = H/2 + asin(y) H / pi)."""
    lon = (ix.double() - width / 2) * (2 * math.pi / width)
    lat = (iy.double() - height / 2) * (math.pi / height)
    return torch.stack([torch.cos(lat) * torch.sin(lon), torch.sin(lat),
                        torch.cos(lat) * torch.cos(lon)], dim=-1)


def map_numbers(image, landmarks: np.ndarray, device="cuda", far_px: float = 2.0,
                block: int = 1 << 16) -> dict:
    """For the pixels with mass (rays in the map's frame): the mass-weighted
    mean angle to the nearest landmark (``map_offset_px``) and the share of
    the mass farther than ``far_px`` from every landmark (``map_far_share``),
    angles in panorama pixels (2 pi / width). An empty map reads infinity
    and 1."""
    img = torch.as_tensor(np.asarray(image), device=device).double().abs()
    H, W = img.shape
    iy, ix = torch.nonzero(img > 0, as_tuple=True)
    if ix.numel() == 0:
        return {"map_offset_px": math.inf, "map_far_share": 1.0}
    mass = img[iy, ix]
    L = torch.as_tensor(np.asarray(landmarks, np.float64), device=device)
    L = L / torch.linalg.norm(L, dim=-1, keepdim=True)
    px = 2 * math.pi / W
    total = far = 0.0
    for a in range(0, ix.numel(), block):
        rays = pixel_rays(ix[a:a + block], iy[a:a + block], H, W)
        near = (rays @ L.T).amax(dim=1)
        chord = torch.sqrt(torch.clamp(2 - 2 * near, min=0))
        ang = 2 * torch.asin(torch.clamp(chord / 2, max=1.0)) / px
        m = mass[a:a + block]
        total += float((ang * m).sum())
        far += float(m[ang > far_px].sum())
    whole = float(mass.sum())
    return {"map_offset_px": total / whole, "map_far_share": far / whole}


def truth_map(xs, ys, ts, omega, sensor, height: int, width: int, dtype,
              device="cuda") -> torch.Tensor:
    """The panorama of events rotated by the truth exp(omega t) into the world
    and voted bilinearly, computed in ``dtype`` (the control's map in
    bfloat16; float64 reads what the pixel grid alone costs)."""
    b = bearings(sensor, xs, ys, dtype, device)
    axis = torch.as_tensor(np.asarray(omega) / np.linalg.norm(omega), device=device).to(dtype)
    ang = torch.as_tensor(np.asarray(ts, np.float64) * np.linalg.norm(omega),
                          device=device).to(dtype)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    kxb = torch.linalg.cross(axis.expand_as(b), b, dim=-1)
    kdb = (b * axis).sum(-1, keepdim=True)
    r = b * c + s * kxb + (1 - c) * kdb * axis
    px = width / 2 + torch.atan2(r[:, 0], r[:, 2]) * (width / (2 * math.pi))
    rho = torch.linalg.norm(r, dim=-1)
    py = height / 2 + torch.asin(torch.clamp(r[:, 1] / rho, -1, 1)) * (height / math.pi)
    return vote(px, py, height, width)
