"""The cell's event stream, made on the device from the seed.

A camera turns at a constant angular velocity omega among landmarks spread
over the whole sphere; each event is a landmark sampled at a uniform time
and projected, at that time, through a centred pinhole onto the sensor
(rounded to a pixel). This is cmax_slam_tpu_torch/io/synthetic.py's
``rotating_camera_events`` as chip_smoke.py's ``make_stream`` drives it
(landmarks on the sphere, a 3-pixel margin, bearings with z > 0.1), rewritten
in PyTorch so that it runs on the card with a ``torch.Generator`` there.

With a constant omega the view repeats with period T = 2 pi / |omega|, so one
period is generated and tiled in time: the event of global index g is event
g mod n of the period, at time ts[g mod n] + (g div n) T, and the truth stays
R(t) = exp(omega t) across the seams. Every seed gives the same events per
period and the same pushes over the same scene (the traffic's landmarks,
drawn from its own ``landmarks_seed``, as a recording's scene is fixed); it
moves the sample times, the landmark each event samples and the
polarities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

CHUNK_DRAWS = 1 << 23  # candidate events per device pass (about 1 GB of temporaries)


@dataclass(frozen=True)
class Sensor:
    """A centred pinhole without distortion."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_config(cls, sensor: dict) -> "Sensor":
        w, h = int(sensor["width"]), int(sensor["height"])
        return cls(w, h, float(sensor["fx"]), float(sensor["fy"]),
                   float(sensor.get("cx", w / 2)), float(sensor.get("cy", h / 2)))

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])


def axis_angle(omega) -> tuple:
    """(unit axis, |omega|) as float64 numpy."""
    omega = np.asarray(omega, np.float64)
    speed = float(np.linalg.norm(omega))
    return omega / speed, speed


def world_to_camera(k: torch.Tensor, angle: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """R(t)^T p for R = exp(angle [k]x), rows of ``points`` (n, 3) at the
    angles (n,): p cos a - sin a (k x p) + (1 - cos a) (k . p) k."""
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    kxp = torch.linalg.cross(k.expand_as(points), points, dim=-1)
    kdp = (points * k).sum(-1, keepdim=True)
    return points * c - s * kxp + (1 - c) * kdp * k


class Stream:
    """One period of events on the host (as the sensor driver would hand
    them over), tiled in time; ``landmarks`` and ``omega`` are the truth."""

    def __init__(self, xs, ys, ts, pols, period: float, landmarks: np.ndarray,
                 omega: np.ndarray):
        self.xs, self.ys, self.ts, self.pols = xs, ys, ts, pols
        self.n = len(ts)
        self.period = period
        self.landmarks = landmarks
        self.omega = omega

    def index(self, t: float) -> int:
        """Global index of the first event at or after time ``t``."""
        p = math.floor(t / self.period)
        j = int(np.searchsorted(self.ts, t - p * self.period, side="left"))
        return p * self.n + j

    def slice(self, g0: int, g1: int):
        """(xs, ys, ts, pols) of the global indices [g0, g1)."""
        parts = []
        g = g0
        while g < g1:
            p, j = divmod(g, self.n)
            k = min(self.n, j + g1 - g)
            parts.append((self.xs[j:k], self.ys[j:k], self.ts[j:k] + p * self.period,
                          self.pols[j:k]))
            g += k - j
        if len(parts) == 1:
            return parts[0]
        if not parts:
            return (self.xs[:0], self.ys[:0], self.ts[:0], self.pols[:0])
        return tuple(np.concatenate(a) for a in zip(*parts))

    def push_bounds(self, k: int, hz: float) -> tuple:
        """Global indices [g0, g1) of push k: the events of [k / hz, (k+1) / hz)."""
        return self.index(k / hz), self.index((k + 1) / hz)


def _landmarks(gen, n: int, device) -> torch.Tensor:
    z = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 2 - 1
    phi = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * (2 * math.pi)
    r = torch.sqrt(1 - z * z)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def make_stream(sensor: Sensor, traffic: dict, seed: int, device) -> Stream:
    """One period of ``traffic`` ("omega", "rate" events/s, "landmarks" drawn
    from "landmarks_seed", "margin") seen by ``sensor``, its events drawn on
    ``device`` from ``seed``."""
    device = torch.device(device)
    scene = torch.Generator(device=device)
    scene.manual_seed(int(traffic["landmarks_seed"]))
    land = _landmarks(scene, int(traffic["landmarks"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    axis, speed = axis_angle(traffic["omega"])
    period = 2 * math.pi / speed
    n = int(round(float(traffic["rate"]) * period))
    margin = float(traffic.get("margin", 3))
    k = torch.as_tensor(axis, device=device)
    kept_t, kept_u, kept_v, have, accept = [], [], [], 0, None
    while have < n:
        need = n - have
        draws = CHUNK_DRAWS if accept is None else min(
            CHUNK_DRAWS, int(need / max(accept, 1e-3) * 1.2) + 4096)
        t = torch.rand(draws, generator=gen, device=device, dtype=torch.float64) * period
        idx = torch.randint(0, land.shape[0], (draws,), generator=gen, device=device)
        b = world_to_camera(k, t * speed, land[idx])
        z = b[:, 2]
        u = sensor.fx * b[:, 0] / z + sensor.cx
        v = sensor.fy * b[:, 1] / z + sensor.cy
        ok = ((z > 0.1) & (u >= margin) & (u < sensor.width - margin)
              & (v >= margin) & (v < sensor.height - margin))
        kept_t.append(t[ok])
        kept_u.append(u[ok])
        kept_v.append(v[ok])
        got = int(ok.sum())
        accept = got / draws if accept is None else accept
        have += got
        del b, z, u, v, ok, idx, t
    t, u, v = (torch.cat(a) for a in (kept_t, kept_u, kept_v))
    # A uniform subset of exactly n keeps the density even up to the seam.
    pick = torch.randperm(t.shape[0], generator=gen, device=device)[:n]
    t, u, v = t[pick], u[pick], v[pick]
    order = torch.sort(t, stable=True).indices
    t, u, v = t[order], u[order], v[order]
    xs = torch.clamp(torch.round(u), 0, sensor.width - 1).to(torch.int32)
    ys = torch.clamp(torch.round(v), 0, sensor.height - 1).to(torch.int32)
    pols = (torch.randint(0, 2, (n,), generator=gen, device=device) * 2 - 1).to(torch.int8)
    host = [a.cpu().numpy() for a in (xs, ys, t, pols)]
    return Stream(host[0], host[1], host[2], host[3], period, land.cpu().numpy(),
                  np.asarray(traffic["omega"], np.float64))
