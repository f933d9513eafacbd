"""The explicit device that every public constructor of the port takes."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Validate a caller's device. There is no default and no auto-detection:
    ``None`` raises, and a CUDA device without a usable card raises instead
    of silently running on the CPU."""
    if device is None:
        raise ValueError("device is required: pass 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
