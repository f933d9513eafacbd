"""The device every public constructor and entry point of the port takes:
the card unless the caller asks for the CPU."""

from __future__ import annotations

import math

import numpy as np
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
    return upload(stage(array, device, dtype), device)


def stage(array, device, dtype=None) -> torch.Tensor:
    """The host half of ``to_device``: ``array`` as a tensor ready for the
    upload to ``device`` (a pinned copy for a CUDA device)."""
    host = torch.as_tensor(array)
    if dtype is not None:
        host = host.to(dtype)
    return host.pin_memory() if torch.device(device).type == "cuda" else host


def upload(staged: torch.Tensor, device) -> torch.Tensor:
    """The device half of ``to_device``: a tensor from ``stage`` on
    ``device`` (a ``non_blocking`` copy for a CUDA device)."""
    device = torch.device(device)
    return staged if device.type != "cuda" else staged.to(device, non_blocking=True)


class PackedUpload:
    """Host arrays of fixed shapes and dtypes that reach ``device`` in one
    copy: a host buffer and its device twin, each split into typed views
    (``views``: the device's, which a program reads) at 8-byte aligned
    offsets. ``write(**arrays)`` fills the host views, ``upload()`` queues
    the one copy. On a CUDA device the host buffer is pinned, the copy is
    ``non_blocking`` and an event is recorded behind it; ``write`` waits for
    that event before it touches the buffer again, as the caching host
    allocator behind ``to_device`` does. On the CPU the two buffers are one
    and ``upload`` does nothing. ``fields``: name -> (shape, torch dtype)."""

    def __init__(self, fields: dict, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        spans, at = {}, 0
        for name, (shape, dtype) in fields.items():
            n = math.prod(shape) * dtype.itemsize
            spans[name] = (at, n, tuple(shape), dtype)
            at += -(-n // 8) * 8
        self.host = torch.empty(max(at, 8), dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.empty_like(self.host, device=self.device) if cuda else self.host
        raw = self.host.numpy()
        self.views, self._host = {}, {}
        for name, (o, n, shape, dtype) in spans.items():
            self.views[name] = self.dev[o:o + n].view(dtype).view(shape)
            np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
            self._host[name] = raw[o:o + n].view(np_dtype).reshape(shape)
        self._event = None

    def write(self, **arrays) -> None:
        """Copy each named array into its host view (cast to the view's
        dtype); every field is written, or keeps the last window's values."""
        if self._event is not None:
            self._event.synchronize()  # the last copy from the buffer has completed
            self._event = None
        for name, value in arrays.items():
            np.copyto(self._host[name], value, casting="unsafe")

    def upload(self) -> None:
        """Queue the copy of the whole host buffer to the device."""
        if self.dev is self.host:
            return
        self.dev.copy_(self.host, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(self.device))
