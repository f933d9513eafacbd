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
clearing whatever state the last owner left in it. On the CPU the programs
run eagerly and the pool applies all the same.

Memory. Unlike JAX's compiled programs, an entry holds device memory: its
``state`` (a ring, a LUT) and each program's buffers and private graph pool.
Its state is made, each program is built (``Entry.program``) and captured at
its first run under ``Entry.build``, which counts the allocator's growth on
the entry's device into the entry (``stats()`` reports it with the state's
bytes). When one of them raises ``torch.cuda.OutOfMemoryError``, the pool
drops every free entry on that device, least recently leased first
(``relieve``: their programs and state go, and the allocator's cache is
emptied) and tries once more; a second failure raises. A leased entry is
never dropped. So a dead system's buffers go back to the device when
another needs them, as a dead JAX system's do, at the price of capturing
again if that configuration comes back; while memory suffices nothing is
dropped and a later system of a configuration already run captures nothing.
"""

from __future__ import annotations

import gc
import hashlib
import itertools
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from . import device_loop

ENTRIES: dict = {}  # key -> [Entry], in the order they were built
DROPPED: list = []  # (key, last lease stamp) of each entry dropped, in drop order
# Lock order: device_loop._capture_lock before _lock, never the other way.
_lock = threading.Lock()
_stamps = itertools.count(1)


class Owner:
    """A lease holder for a caller with no instance of its own (one call of
    a batched solve, one shard of it)."""


class Entry:
    """The programs built under one key (``programs``: shape key -> program)
    and the device state they read (``state``), leased to one owner at a
    time. ``leases`` counts its leases, ``last_lease`` stamps the latest;
    ``allocated`` and ``reserved`` sum the allocator's growth (bytes) across
    what was built under ``build``."""

    def __init__(self, key):
        self.key = key
        self.device = next((k for k in key if isinstance(k, torch.device)), None)
        self.programs: dict = {}
        self.state: dict = {}
        self.leases = 0
        self.last_lease = 0
        self.allocated = 0
        self.reserved = 0
        self._owner: Optional[weakref.ref] = None

    def held_by(self, owner) -> bool:
        return self._owner is not None and self._owner() is owner

    @property
    def free(self) -> bool:
        return self._owner is None or self._owner() is None

    def build(self, make: Callable):
        """``make()``, its allocator growth counted into this entry; after an
        out-of-memory error the free entries on this device are dropped
        (``relieve``) and ``make()`` runs once more."""
        for retry in (False, True):
            before = _memory(self.device)
            try:
                out = make()
            except Exception as e:  # only out-of-memory is retried
                if retry or not _out_of_memory(e):
                    raise
            else:
                break
            # Out of the handler: the failed attempt's tensors are released.
            relieve(self.device)
        after = _memory(self.device)
        self.allocated += after[0] - before[0]
        self.reserved += after[1] - before[1]
        return out

    def program(self, key, make: Callable):
        """``programs[key]``, built by ``make()`` under ``build`` if absent;
        the program's first capture runs under ``build`` too."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = self.build(make)
            prog.program.capture_guard = self.build
        return prog

    def state_bytes(self) -> int:
        return _tensor_bytes(self.state)


def _memory(device) -> tuple:
    """(allocated, reserved) bytes on a CUDA device; (0, 0) elsewhere."""
    if device is None or device.type != "cuda" or not torch.cuda.is_initialized():
        return 0, 0
    return torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)


def _out_of_memory(e: BaseException) -> bool:
    """Whether ``e`` is, or was raised while handling, an out-of-memory
    error (a capture that fails raises again as it ends)."""
    seen = set()
    while e is not None and id(e) not in seen:
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        seen.add(id(e))
        e = e.__cause__ or e.__context__
    return False


def _tensor_bytes(obj, seen=None) -> int:
    """Bytes of the distinct tensor storages reachable from ``obj`` through
    dicts, lists, tuples and object attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        ptr = (obj.device, obj.untyped_storage().data_ptr())
        if ptr in seen:
            return 0
        seen.add(ptr)
        return obj.untyped_storage().nbytes()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if hasattr(obj, "__dict__"):
        return _tensor_bytes(vars(obj), seen)
    return 0


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


def _take(key, owner, reset) -> Optional[Entry]:
    """Under _lock: the entry of ``key`` that ``owner`` holds, else a free
    one leased to it (``reset`` first), else None."""
    entries = ENTRIES.setdefault(key, [])
    e = next((e for e in entries if e.held_by(owner)), None)
    if e is not None:
        return e
    e = next((e for e in entries if e.free), None)
    if e is not None:
        if e.leases and reset is not None:
            reset(e)
        _lease_to(e, owner)
    return e


def _lease_to(e: Entry, owner) -> None:
    e.leases += 1
    e.last_lease = next(_stamps)
    e._owner = weakref.ref(owner)


def lease(key, owner, reset: Optional[Callable[[Entry], None]] = None) -> Entry:
    """The entry of ``key`` leased to ``owner``: the one it holds already,
    else a free one (``reset(entry)`` runs on it first), else a new one. An
    owner caught in a reference cycle is only collected by the garbage
    collector, so before building a new entry the collector runs once (not
    while another thread captures a graph)."""
    with _lock:
        e = _take(key, owner, reset)
        if e is not None:
            return e
        if not ENTRIES[key]:
            return _new(key, owner)
    with device_loop._capture_lock:
        gc.collect()
    with _lock:
        return _take(key, owner, reset) or _new(key, owner)


def _new(key, owner) -> Entry:
    e = Entry(key)
    ENTRIES.setdefault(key, []).append(e)
    _lease_to(e, owner)
    return e


def relieve(device) -> int:
    """Drop every free entry on ``device`` (every device for None), least
    recently leased first: out of the pool, its programs and state released;
    then collect and empty the allocator's cache. Returns how many went."""
    with device_loop._capture_lock:
        with _lock:
            free = sorted((e for entries in ENTRIES.values() for e in entries
                           if e.free and (device is None or e.device == device)),
                          key=lambda e: e.last_lease)
            for e in free:
                ENTRIES[e.key].remove(e)
                DROPPED.append((e.key, e.last_lease))
                e.programs.clear()
                e.state.clear()
            dropped = len(free)
            del free
        gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    return dropped


def stats(detail: bool = False) -> dict:
    """Entries, those leased now, the programs they hold, their bytes
    (``state_bytes``: the state's tensors; ``allocated_bytes`` and
    ``reserved_bytes``: the allocator's growth across their builds and first
    captures) and the entries dropped so far; with ``detail`` the same per
    entry (its kind, key[0])."""
    with _lock:
        every = [e for entries in ENTRIES.values() for e in entries]
        per = [{"kind": str(e.key[0]), "leased": not e.free, "programs": len(e.programs),
                "state_bytes": e.state_bytes(), "allocated_bytes": e.allocated,
                "reserved_bytes": e.reserved} for e in every]
        out = {"entries": len(every), "leased": sum(p["leased"] for p in per),
               "programs": sum(p["programs"] for p in per),
               **{k: sum(p[k] for p in per)
                  for k in ("state_bytes", "allocated_bytes", "reserved_bytes")},
               "dropped": len(DROPPED)}
        if detail:
            out["by_entry"] = per
        return out
