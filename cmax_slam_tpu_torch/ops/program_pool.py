"""A module-level pool of device programs: the counterpart of the JAX
package's memoized solver builders (``functools.lru_cache`` on
cmax_slam_tpu/frontend.py's ``_build_packet_solver``, ``_build_stride_solver``
and their ring forms, backend.py's ``_build_window_solver`` and
``_build_crop_solver``), through which a second system in a process compiles
nothing.

A device program (ops/device_loop.py) is captured once, at its first run, and
its graphs bake in the addresses of the buffers it reads. So a program here
owns every buffer its captured code touches, and what an instance would
otherwise close over is either copied into those buffers at each launch (a
window's maps) or belongs to the pool entry and is leased with it (the
front-end's device ring, too large to copy per launch). An entry is keyed as
JAX keys its builders, plus the device and everything the captured code
closes over; its ``programs`` hold the shapes built under that key.

An entry serves one live owner at a time: the multi-device modes run several
systems, or several shards, on one card concurrently in host threads, and
two of them must not share buffers. A second live owner with the same key
gets a second entry. An entry is free again once its owner has been
collected (a system's ``close()`` leaves it usable, so only its end frees
the entry); the next owner to lease it gets its programs, with ``reset``
clearing whatever state the last owner left in it. Entries are never freed
otherwise, as ``lru_cache(maxsize=None)`` frees nothing. On the CPU the
programs run eagerly and the pool applies all the same.
"""

from __future__ import annotations

import gc
import hashlib
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from . import device_loop

ENTRIES: dict = {}  # key -> [Entry], in the order they were built
_lock = threading.Lock()


class Owner:
    """A lease holder for a caller with no instance of its own (one call of
    a batched solve, one shard of it)."""


class Entry:
    """The programs built under one key (``programs``: shape key -> program)
    and the device state they read (``state``), leased to one owner at a
    time. ``leases`` counts its leases."""

    def __init__(self, key):
        self.key = key
        self.programs: dict = {}
        self.state: dict = {}
        self.leases = 0
        self._owner: Optional[weakref.ref] = None

    def held_by(self, owner) -> bool:
        return self._owner is not None and self._owner() is owner

    @property
    def free(self) -> bool:
        return self._owner is None or self._owner() is None


def digest(array) -> str:
    """A key for an array's content (a bearing LUT)."""
    a = np.ascontiguousarray(np.asarray(array))
    return f"{a.dtype}{a.shape}:" + hashlib.sha1(a.tobytes()).hexdigest()


def device_key(device) -> torch.device:
    """A device as a key: "cuda" named by the card it means now, so that a
    program captured there serves "cuda" and "cuda:0" alike."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _first_free(entries):
    return next((e for e in entries if e.free), None)


def lease(key, owner, reset: Optional[Callable[[Entry], None]] = None) -> Entry:
    """The entry of ``key`` leased to ``owner``: the one it holds already,
    else a free one (``reset(entry)`` runs on it first), else a new one. An
    owner caught in a reference cycle is only collected by the garbage
    collector, so before building a new entry the collector runs once (not
    while another thread captures a graph)."""
    with _lock:
        entries = ENTRIES.setdefault(key, [])
        for e in entries:
            if e.held_by(owner):
                return e
        e = _first_free(entries)
        if e is None and entries:
            with device_loop._capture_lock:
                gc.collect()
            e = _first_free(entries)
        if e is None:
            e = Entry(key)
            entries.append(e)
        elif e.leases and reset is not None:
            reset(e)
        e.leases += 1
        e._owner = weakref.ref(owner)
        return e


def stats() -> dict:
    """Entries, those leased now, and the programs they hold."""
    with _lock:
        every = [e for entries in ENTRIES.values() for e in entries]
        return {"entries": len(every), "leased": sum(not e.free for e in every),
                "programs": sum(len(e.programs) for e in every)}
