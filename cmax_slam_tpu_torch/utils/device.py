"""The device every public constructor and entry point of the port takes:
the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Validate a caller's device. ``None`` means ``"cuda"``; a CUDA device
    without a usable card raises instead of silently running on the CPU,
    which runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
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


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``
    without a wait on the host. A blocking copy from pageable memory makes
    torch synchronize the stream, so it would wait for every solve queued
    before it; on a CUDA device the array goes through a pinned staging
    copy and a ``non_blocking`` upload instead. The staging buffer comes from
    PyTorch's caching host allocator, which records an event on the stream
    with the copy and reuses the buffer only once that event has completed.
    On the CPU the result may share memory with ``array``."""
    host = torch.as_tensor(array)
    if dtype is not None:
        host = host.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
