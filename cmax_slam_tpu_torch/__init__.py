"""CMax-SLAM in PyTorch with hand-written CUDA vote kernels: the port of
cmax_slam_tpu (JAX on a TPU) to one NVIDIA H100.

Module names mirror the JAX package's, so each counterpart is easy to find.
The package imports torch and never jax. Every public constructor takes an
explicit ``device``; votes on CUDA tensors run the kernels of csrc/iwe.cu
(built with nvcc at first use), votes on CPU tensors their plain PyTorch
versions. Entry point: ``system.CMaxSLAM(calib, cfg, device=...)``.
"""

__version__ = "0.1.0"
