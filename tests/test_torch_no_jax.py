"""The port stands alone: importing every module of cmax_slam_tpu_torch pulls
in neither jax nor the JAX package, and triggers no kernel build (the card's
machine has no JAX, and CPU collection must never need nvcc). Also: every
public constructor runs on the card unless asked for the CPU, and refuses a
CUDA device it cannot use."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cmax_slam_tpu_torch.calib import CameraCalibration
from cmax_slam_tpu_torch.config import ijrr_config
from cmax_slam_tpu_torch.system import CMaxSLAM

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    preloaded = "jax" in sys.modules
    # Any attempt to import JAX or the JAX package now raises ImportError, and
    # so does one of PyYAML or h5py (the card's machine has neither): the
    # modules that read those formats import them only when asked to.
    for name in ("jax", "jaxlib", "cmax_slam_tpu", "yaml", "h5py"):
        sys.modules[name] = None
    import cmax_slam_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(cmax_slam_tpu_torch.__path__,
                                                   "cmax_slam_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from cmax_slam_tpu_torch.ops import cuda_iwe, cuda_pano_vote
    build_dir = cuda_iwe.BUILD_DIR
    built = sorted(p.name for p in build_dir.glob("*")) if build_dir.exists() else []
    print(json.dumps({"preloaded": preloaded, "names": names,
                      "lib": bool(cuda_iwe._loaded or cuda_pano_vote._loaded),
                      "launches": cuda_iwe.LAUNCHES, "built": built}))
""")


def test_importing_every_module_needs_no_jax_and_builds_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    build_dir = os.path.join(REPO, "cmax_slam_tpu_torch", "_build")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"cmax_slam_tpu_torch." + m for m in (
        "backend", "calib", "config", "frontend", "lie", "spline", "system",
        "ops.scatter", "ops.cuda_iwe", "ops.blur", "ops.contrast", "ops.warp_local",
        "ops.optim", "ops.warp_pano", "ops.cuda_pano_vote", "ops.device_loop", "ops.program_pool", "io.events", "io.native", "io.synthetic", "io.devring",
        "utils.metrics", "utils.evaluate", "utils.device", "cli", "io.streams", "io.rosbag",
        "utils.image", "parallel", "parallel.sharding", "parallel.batched",
        "parallel.window_shard", "parallel.replay")}
    assert expected <= set(res["names"])
    assert not res["preloaded"]
    assert not res["lib"] and res["launches"] == {
        "fwd": 0, "fwd_P": 0, "fwd_G": 0, "bwd": 0, "bwd_S": 0, "bwd_G": 0, "jvp": 0,
        "jvp_G": 0, "pano_fwd": 0, "pano_fwd_o2": 0, "pano_fwd_o4": 0, "pano_bwd": 0,
        "pano_bwd_o2": 0, "pano_bwd_o4": 0}
    assert res["built"] == before


def test_device_is_explicit_and_checked():
    """The device defaults to the card: without one, the default and an
    explicit 'cuda' both raise; the CPU runs only when asked for."""
    K = np.array([[90.0, 0, 60], [0, 90.0, 45], [0, 0, 1]])
    calib = CameraCalibration(width=120, height=90, K=K)
    with pytest.raises(ValueError):
        CMaxSLAM(calib, ijrr_config(), device="meta")
    if not torch.cuda.is_available():
        for kw in ({}, dict(device=None), dict(device="cuda")):
            with pytest.raises(RuntimeError, match="cuda"):
                CMaxSLAM(calib, ijrr_config(), **kw)
    slam = CMaxSLAM(calib, ijrr_config(), device="cpu")
    assert slam.backend.IG.device.type == "cpu"
    assert slam.frontend.lut.device.type == "cpu"


def test_device_lists_are_explicit_and_checked():
    """The multi-device modes take a device list (the JAX package's mesh);
    repeats stand for several devices on one card, and a CUDA entry without
    a card raises instead of running on the CPU."""
    from cmax_slam_tpu_torch.parallel import batched
    from cmax_slam_tpu_torch.parallel.sharding import make_mesh
    from cmax_slam_tpu_torch.utils.device import resolve_devices

    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    for bad in (None, [], "cpu"):
        with pytest.raises(ValueError, match="non-empty list"):
            resolve_devices(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(2, "cuda:0")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_devices(["cpu", "cuda:0"])
        with pytest.raises(RuntimeError, match="cuda"):
            batched.cut_packets(np.zeros(4, np.int32), np.zeros(4, np.int32),
                                np.linspace(0, 0.1, 4), np.zeros((1, 3), np.float32),
                                None, ijrr_config().frontend, device="cuda")
