"""The port's renderings against the JAX package's at tests/test_render.py's
sizes: the front-end's zero-motion | motion-compensated IWE pair and the
back-end's panorama with its sensor-FOV outline.

Tolerances: the IWE pair is a float32 vote summed in another order on each
side, min-max normalized to [0, 255]; it agrees to 1e-2 on that scale. The
panorama is rendered from the same float32 map with the same float64 host
code, so the uint8 images are identical."""

import numpy as np
import pytest
import torch

from cmax_slam_tpu.backend import Backend as JBackend
from cmax_slam_tpu.config import (BackendConfig as JBackendConfig, FrontendConfig as
                                  JFrontendConfig, PanoMapOptions as JPano,
                                  WarpOptions as JWarp)
from cmax_slam_tpu.frontend import Frontend as JFrontend
from cmax_slam_tpu.io import synthetic
from cmax_slam_tpu.io.events import EventStore as JEventStore
from cmax_slam_tpu.ops.warp_local import CameraParams as JCameraParams
from cmax_slam_tpu_torch import spline
from cmax_slam_tpu_torch.backend import Backend
from cmax_slam_tpu_torch.config import (BackendConfig, FrontendConfig, PanoMapOptions,
                                        WarpOptions)
from cmax_slam_tpu_torch.frontend import Frontend
from cmax_slam_tpu_torch.io.events import EventStore
from cmax_slam_tpu_torch.ops import cuda_iwe
from cmax_slam_tpu_torch.ops.warp_local import CameraParams

torch.set_num_threads(1)

W, H = 120, 90
FX = FY = 90.0
LUT = synthetic.identity_lut(W, H, FX, FY, W / 2, H / 2)


@pytest.fixture(scope="module")
def frontends():
    rng = np.random.default_rng(42)
    ev = synthetic.rotating_camera_events(rng, 6000, 0.05, np.array([0.9, -1.2, 1.6]),
                                          FX, FY, W / 2, H / 2, W, H, n_points=150)
    kw = dict(num_events_per_packet=4000, dt_ang_vel=0.02)
    fe_j = JFrontend(JCameraParams(FX, FY, W / 2, H / 2, W, H), LUT,
                     JFrontendConfig(warp=JWarp(event_batch_size=100), **kw))
    fe_t = Frontend(CameraParams(FX, FY, W / 2, H / 2, W, H), LUT,
                    FrontendConfig(warp=WarpOptions(event_batch_size=100), **kw), device="cpu")
    for fe in (fe_j, fe_t):
        fe.push_events(ev.xs, ev.ys, ev.ts, ev.pols)
    fe_j.finalize_batch(fe_j.estimates)
    assert fe_t.estimates and fe_j.estimates
    return fe_j, fe_t


@pytest.mark.parametrize("span", [(0, 4000), (1000, 5000), (2500, 2600)])
def test_iwe_pair_matches_jax(frontends, span):
    fe_j, fe_t = frontends
    omega = np.asarray(fe_j.estimates[-1].omega, np.float64)
    ref = fe_j.render_iwe_pair(*span, omega)
    launches = dict(cuda_iwe.LAUNCHES)
    img = fe_t.render_iwe_pair(*span, omega)
    assert cuda_iwe.LAUNCHES == launches  # the CPU path never reaches the kernels
    assert isinstance(img, np.ndarray) and img.shape == ref.shape == (H, 2 * W)
    assert img.min() >= 0 and img.max() <= 255
    np.testing.assert_allclose(img, ref, atol=1e-2)
    # motion compensation sharpens: the compensated half has darker minima
    assert img[:, W:].min() <= img[:, :W].min()


def test_iwe_pair_without_stored_events_is_none(frontends):
    fe_j, fe_t = frontends
    end = fe_t.store.total + 10
    assert fe_t.render_iwe_pair(end, end + 100, np.zeros(3)) is None
    assert fe_j.render_iwe_pair(end, end + 100, np.zeros(3)) is None


@pytest.mark.parametrize("draw_fov", [True, False])
def test_render_map_matches_jax(draw_fov):
    rng = np.random.default_rng(4)
    pano = dict(pano_height=64, pano_width=128)
    be_j = JBackend(W, H, LUT, JBackendConfig(pano_map=JPano(**pano), draw_fov=draw_fov),
                    JEventStore())
    be_t = Backend(W, H, LUT, BackendConfig(pano_map=PanoMapOptions(**pano), draw_fov=draw_fov),
                   EventStore(), device="cpu")
    knots = np.stack([spline._np_quat_exp(np.array([0.1, 0.4, -0.2]) * i) for i in range(4)])
    ig = (np.abs(rng.normal(size=(64, 128))) ** 2).astype(np.float32)
    for be in (be_j, be_t):
        be.push_ang_vel(0.0, np.zeros(3))
        be.traj.push_ctrl_poses(knots)
    be_j.IG = ig
    be_t.IG = torch.as_tensor(ig)
    img, ref = be_t.render_map(), be_j.render_map()
    assert img.dtype == np.uint8 and img.shape == ref.shape
    assert img.shape == ((64, 128, 3) if draw_fov else (64, 128))
    np.testing.assert_array_equal(img, ref)
    if draw_fov:
        assert (img[..., 0] == 255).any() and (img[..., 1] == 0).any()
