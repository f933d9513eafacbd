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


def resolve_devices(devices) -> list:
    """Validate a device list (the port's stand-in for a JAX mesh: one host
    process drives every entry). Repeats are allowed: ``["cuda:0",
    "cuda:0"]`` runs a two-device path on one card."""
    if devices is None or isinstance(devices, (str, torch.device)) or len(devices) == 0:
        raise ValueError("devices must be a non-empty list, e.g. ['cuda:0', 'cuda:0']")
    out = [resolve_device(d) for d in devices]
    # 'cuda' means the current card: name it, so it compares equal to the
    # device of the tensors placed there.
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]
