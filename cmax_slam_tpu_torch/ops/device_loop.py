"""Device-resident control flow for the port's solves: the counterpart of the
JAX package's ``lax.while_loop`` and ``lax.cond`` (cmax_slam_tpu/ops/optim.py,
cmax_slam_tpu/frontend.py:288), as CUDA graph conditional nodes.

A program is described once by a ``build(b)`` function over static buffers
(tensors whose storage lives as long as the program) with three statements:

- ``b.seg(fn)``: straight-line tensor code; ``fn()`` reads and writes the
  buffers in place and never reads a value on the host;
- ``b.when(gate, body, name=None)``: ``body()`` (more statements) runs only
  if the gate holds;
- ``b.repeat(gate, body, trips=None, name=None)``: ``body()`` runs while the
  gate holds; the body must change what the gate reads, and ``trips``, where
  given, is the most iterations the loop can run.

``name`` names the node in the program's statement tree and in the trace
(default ``while<slot>`` / ``if<slot>``).

A gate is a ``Gate(mask, counter=None, limit=None)`` (a bare mask stands for
``Gate(mask)``): it holds while any lane of ``mask`` is set and, where a
counter is given, ``counter[0] < limit[0]``. ``mask`` is a static bool (or
uint8), contiguous, 1-D buffer of L >= 1 lanes (1 for a packet solve, the
lanes of a stride or of a batched round), written in place by the segments
before the gate (``torch.lt(a, b, out=mask)``, a CG state's own lane mask);
``counter`` and ``limit`` are static int32 (1,) buffers (``limit()`` makes
a constant one). So the common ``active & (k < max_evals)`` costs no kernel
of its own: the predicate reads the lanes' mask and the counter itself. A
gate of any other form raises, in every interpreter, before anything runs.

``Program.run()`` launches it and returns a ``Result``, a handle on that
launch's ``out``; ``Result.fetch()`` (or ``fetch_all`` for many handles)
waits for it on the host. On the CPU every run interprets ``build`` with
``Eager``, whose gates are read on the host (``Gate.holds``, the plain
version of the predicate), as a host loop does, and returns a Result that is
already complete. On a CUDA device the first run captures every segment into
a CUDA graph of its own (torch.cuda.CUDAGraph(keep_graph=True), after one
warm-up run on a side stream, all graphs of the program in one private
memory pool of its own) and csrc/loop.cu joins them into one graph: a WHILE
node per ``repeat`` and an IF node per ``when``, each behind the loop
predicate kernel, which reduces the gate's mask and reads its counter on the
device in one launch. Every later run is one graph launch, then one copy of
``out`` and the counters into a pinned host slot of that launch's own,
behind a CUDA event: the host goes on at once, and several launches of one
program may be in flight, each fetching its own numbers (the program's
buffers hold only the last launch's). A step met again (the same bound
method: the bracket and secant steps, a restarted solve) reuses its capture
as another child node. A capture or launch that fails raises; nothing falls
back to the eager form.

Counts. The predicate adds one to its node's execution counter each time the
body runs; the counters travel to the host with ``out`` in the same copy.
When a Result is fetched, each kernel launch captured in a segment
(ops/cuda_iwe.py records them) is counted once per execution of that
segment, ``LAUNCHES["pred"]`` counts the predicate's executions, and
``RUNS`` the graph launches by program name.

Trace (utils/metrics.TRACE). A program built while the trace is armed
gives each loop predicate a pointer to an int64 pair of its WHILE node
beside the readback: at an entry that runs the loop the predicate stores
``%globaltimer``, at the predicate that ends it it adds the time since to
the node's total, and the totals reach the host in the readback copy, as
device seconds by node path (``Launch.loops``). Unarmed, the pointer is
null and the graph is the same. While recording with a CUDA anchor, each
launch records a CUDA event before and after it (``TRACE.launch``; a first
run's after its capture), a wait on the host is a ``device_loop.wait``
span, a capture a ``device_loop.capture`` span and each segment's warm-up
before its capture a ``device_loop.warmup`` device span on the capture's
stream.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.metrics import TRACE
from . import cuda_iwe, nvcc

LAUNCHES = {"pred": 0}
RUNS: dict = {}          # program name -> graph launches
CAPTURES = {"graphs": 0, "s": 0.0}
MAX_CONDS = 128          # conditional nodes per program (counter slots)

SOURCE = nvcc.CSRC / "loop.cu"
_lock = threading.Lock()
# One capture at a time (the multi-device modes' threads); reentrant, so
# that a capture's memory guard (Program.capture_guard) may collect.
_capture_lock = threading.RLock()
_lib = None


def build_job() -> tuple:
    """(source, flags, library) for nvcc.compile_all."""
    return SOURCE, nvcc.NVCC_FLAGS, nvcc.library_path(SOURCE, nvcc.NVCC_FLAGS, "libloop")


def build():
    """Compile csrc/loop.cu (once per source hash) and load it."""
    global _lib
    with _lock:
        if _lib is None:
            src, flags, so = build_job()
            nvcc.compile_all([(src, flags, so)])
            lib = ctypes.CDLL(str(so))
            p, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
            h = ctypes.c_ulonglong
            lib.loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            lib.loop_graph_create.argtypes = [pp]
            lib.loop_graph_destroy.argtypes = [p]
            lib.loop_add_child.argtypes = [p, p, p, pp]
            i = ctypes.c_int
            lib.loop_add_cond.argtypes = [p, p, i, p, i, p, p, p, p, pp, pp, ctypes.POINTER(h)]
            lib.loop_add_pred.argtypes = [p, p, h, p, i, p, p, p, p, pp]
            lib.loop_instantiate.argtypes = [p, pp]
            lib.loop_launch.argtypes = [p, p]
            lib.loop_exec_destroy.argtypes = [p]
            lib.loop_graph_nodes.argtypes = [p, ctypes.POINTER(ctypes.c_size_t),
                                             ctypes.POINTER(ctypes.c_size_t)]
            lib.loop_error_string.argtypes = [ctypes.c_int]
            lib.loop_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> tuple:
    """(nodes, kernel nodes) of a graph captured with keep_graph=True."""
    lib = build()
    total, kernels = ctypes.c_size_t(), ctypes.c_size_t()
    _check(lib, lib.loop_graph_nodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                     ctypes.byref(total), ctypes.byref(kernels)),
           "cudaGraphGetNodes")
    return total.value, kernels.value


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.loop_error_string(err).decode()}")


class Gate(NamedTuple):
    """A loop's or branch's condition (see the module docstring): any lane
    of ``mask`` set and, with a counter, ``counter[0] < limit[0]``."""

    mask: torch.Tensor
    counter: torch.Tensor | None = None
    limit: torch.Tensor | None = None

    def holds(self) -> bool:
        """The host gate: the predicate's plain version (reads the buffers)."""
        if not bool(self.mask.any()):
            return False
        return self.counter is None or int(self.counter[0]) < int(self.limit[0])


def gate(device, lanes: int = 1) -> torch.Tensor:
    """A gate's mask buffer: bool (lanes,), written in place by a segment."""
    return torch.zeros(lanes, dtype=torch.bool, device=device)


def limit(value: int, device) -> torch.Tensor:
    """A constant limit for a gate's counter: int32 (1,)."""
    return torch.full((1,), value, dtype=torch.int32, device=device)


def as_gate(g) -> Gate:
    """``g`` (a Gate or a bare mask) as a Gate the predicate can read;
    raises for anything else (no conversion: the graph reads the buffers
    themselves)."""
    g = g if isinstance(g, Gate) else Gate(g)
    m = g.mask
    if not isinstance(m, torch.Tensor) or m.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"a gate's mask must be a bool or uint8 tensor, not "
                        f"{getattr(m, 'dtype', type(m))}")
    if m.dim() != 1 or not 1 <= m.numel() < 1 << 31 or not m.is_contiguous():
        raise ValueError(f"a gate's mask must be 1-D, contiguous and non-empty "
                         f"(shape {tuple(m.shape)})")
    if (g.counter is None) != (g.limit is None):
        raise ValueError("a gate takes a counter and a limit together")
    for t in (g.counter, g.limit):
        if t is not None and (t.dtype != torch.int32 or t.shape != (1,)
                              or t.device != m.device):
            raise ValueError("a gate's counter and limit are int32 (1,) tensors beside "
                             "its mask")
    return g


class Eager:
    """Interprets a program as it goes. With ``gate`` the gates are read on
    the host (``Gate.holds``, the CPU's form); without it nothing is read there:
    every ``when`` body runs and every ``repeat`` body runs ``trips`` times
    (once where no bound is given); steps masked per lane then change
    nothing."""

    def __init__(self, gate: bool = True):
        self.gate = gate

    def seg(self, fn: Callable) -> None:
        fn()

    def when(self, gate_t, body: Callable, name: str | None = None) -> None:
        g = as_gate(gate_t)
        if not self.gate or g.holds():
            body()

    def repeat(self, gate_t, body: Callable, trips: int | None = None,
               name: str | None = None) -> None:
        g = as_gate(gate_t)
        if not self.gate:
            for _ in range(trips or 1):
                body()
            return
        while g.holds():
            body()


class _Capture:
    """Captures each segment into a graph of its own and records the tree of
    conditional nodes (see Program)."""

    def __init__(self, prog: "Program"):
        self.prog = prog
        self.items: List = []   # ("seg", index) | ("cond", is_while, gate, slot, items)
        self.slot = -1          # counter slot of the innermost conditional (-1: top level)

    def seg(self, fn: Callable) -> None:
        prog = self.prog
        idx = prog._seg_index.get(fn)
        if idx is None:  # a step met again (a bound method) reuses its capture
            idx = prog._seg_index[fn] = prog._capture_segment(fn)
        prog._occurrences.append((idx, self.slot))
        self.items.append(("seg", idx))

    def _cond(self, is_while: int, gate_t, body: Callable, name: str | None) -> None:
        prog = self.prog
        g = as_gate(gate_t)
        where = g.mask.device
        if where.type != prog.device.type or prog.device.index not in (None, where.index):
            raise ValueError(f"a gate on {where} in a program on {prog.device}")
        slot = len(prog._conds)
        if slot >= MAX_CONDS:
            raise RuntimeError(f"more than {MAX_CONDS} conditional nodes in one program")
        name = name or f"{'while' if is_while else 'if'}{slot}"
        prog._conds.append((is_while, self.slot))
        prog._cond_paths.append(name if self.slot < 0 else f"{prog._cond_paths[self.slot]}/{name}")
        outer, self.items, outer_slot, self.slot = self.items, [], self.slot, slot
        try:
            body()
        finally:
            inner, self.items, self.slot = self.items, outer, outer_slot
        self.items.append(("cond", is_while, g, slot, inner))

    def when(self, gate_t, body: Callable, name: str | None = None) -> None:
        self._cond(0, gate_t, body, name)

    def repeat(self, gate_t, body: Callable, trips: int | None = None,
               name: str | None = None) -> None:
        self._cond(1, gate_t, body, name)


class Program:
    """One device program (see the module docstring). ``build(b)`` describes
    it; ``out`` (float32, ``n_out`` values) is what the host reads after a
    run; ``name`` keys RUNS. Its graphs share a private memory pool that no
    other program uses, so dropping a program leaves no pool half released.
    Programs are kept and shared through ops/program_pool.py."""

    items: tuple | list = ()  # the statement tree assembled at capture (_Capture.items)

    def __init__(self, build_fn: Callable, n_out: int, device, *, name: str):
        self.build_fn = build_fn
        self.device = torch.device(device)
        self.name = name
        # out, the conditional nodes' counters and, built armed, their loop
        # clocks (int64 start and total per node, 8-byte aligned) share one
        # buffer: one copy to the host per run.
        cuda = self.device.type == "cuda"
        ncount = MAX_CONDS if cuda else 0
        self.clocked = cuda and TRACE.armed
        self._clock_at = (n_out + ncount + 1) // 2 * 2
        size = self._clock_at + 4 * MAX_CONDS if self.clocked else n_out + ncount
        self._readback = torch.zeros(size, dtype=torch.float32, device=self.device)
        self.out = self._readback[:n_out]
        self._counts = self._readback[n_out:n_out + ncount]
        self._clocks = (self._readback[self._clock_at:].view(torch.int64).view(MAX_CONDS, 2)
                        if self.clocked else None)
        self._slots: List[torch.Tensor] = []  # free pinned host slots of the readback
        self._pool = None
        self._exec = None
        self._graphs: List = []     # the captured segments' torch graphs (own the pool blocks)
        self._seg_index: dict = {}  # segment function -> its capture
        self._seg_launches: List[list] = []  # per capture: the kernel launches it holds
        self._occurrences: List[tuple] = []  # (capture, counter slot of its conditional)
        self._conds: List[tuple] = []  # (is_while, parent slot)
        self._cond_paths: List[str] = []  # the nodes' names, "outer/inner"
        self.capture_s = 0.0
        # Runs the first capture: ``capture_guard(capture)``; the program
        # pool sets it to account the capture's memory and retry it once
        # after an out-of-memory error (ops/program_pool.py).
        self.capture_guard: Callable | None = None

    # -- capture --------------------------------------------------------
    def _capture_segment(self, fn: Callable) -> int:
        side = self._side
        with torch.cuda.stream(side), TRACE.span("device_loop.warmup", device=True):
            fn()  # warm-up: lazy handles, workspaces and kernel attributes
        with TRACE.span("device_loop.wait", program=self.name, wait=True):
            side.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        rec: list = []
        with torch.cuda.stream(side), cuda_iwe.recording(rec):
            g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                g.capture_end()
        self._graphs.append(g)
        self._seg_launches.append(rec)
        return len(self._graphs) - 1

    def _assemble(self, lib, graph, items) -> ctypes.c_void_p:
        p = ctypes.c_void_p
        tail = p()
        for item in items:
            out = p()
            if item[0] == "seg":
                raw = p(self._graphs[item[1]].raw_cuda_graph())
                _check(lib, lib.loop_add_child(graph, tail, raw, ctypes.byref(out)),
                       "cudaGraphAddChildGraphNode")
            else:
                _, is_while, g, slot, inner = item
                body, handle = p(), ctypes.c_ulonglong()
                gp = (p(g.mask.data_ptr()), g.mask.numel(),
                      *(p(None if t is None else t.data_ptr()) for t in (g.counter, g.limit)))
                cp = p(self._counts[slot:].data_ptr())
                clock = p(self._clocks[slot].data_ptr() if self.clocked and is_while else None)
                _check(lib, lib.loop_add_cond(graph, tail, is_while, *gp, cp, clock,
                                              ctypes.byref(out), ctypes.byref(body),
                                              ctypes.byref(handle)),
                       "conditional node")
                btail = self._assemble(lib, body, inner)
                if is_while:
                    end = p()
                    _check(lib, lib.loop_add_pred(body, btail, handle, *gp, cp, clock,
                                                  ctypes.byref(end)),
                           "loop predicate node")
            tail = out
        return tail

    def _capture(self) -> None:
        lib = build()
        t0 = time.perf_counter()
        # A capture that failed (out of memory) is retried from scratch.
        self._graphs, self._seg_index, self._seg_launches = [], {}, []
        self._occurrences, self._conds, self._cond_paths = [], [], []
        self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(main)
        cap = _Capture(self)
        cap.seg(self._readback[self.out.numel():].zero_ if self.clocked else self._counts.zero_)
        self.build_fn(cap)
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        _check(lib, lib.loop_graph_create(ctypes.byref(graph)), "cudaGraphCreate")
        try:
            self._assemble(lib, graph, cap.items)
            _check(lib, lib.loop_instantiate(graph, ctypes.byref(exe)), "cudaGraphInstantiate")
            self.items = cap.items
        finally:
            lib.loop_graph_destroy(graph)
        self._exec = exe
        main.wait_stream(self._side)
        self.capture_s = time.perf_counter() - t0
        with _lock:
            CAPTURES["graphs"] += 1
            CAPTURES["s"] += self.capture_s

    def __del__(self):
        if self._exec is not None and _lib is not None:
            _lib.loop_exec_destroy(self._exec)

    # -- run --------------------------------------------------------------
    def run(self) -> "Result":
        """Launch the program; returns the handle on this launch's ``out``.
        Nothing is read on the host here."""
        if self.device.type != "cuda":
            self.build_fn(Eager())
            return Result(self, values=self._readback.numpy().copy())
        with torch.cuda.device(self.device):
            if self._exec is None:
                with _capture_lock, TRACE.span("device_loop.capture", program=self.name):
                    # No garbage collection inside a capture: a collected
                    # program frees its graphs there, which the capture
                    # forbids (cudaErrorStreamCaptureInvalidated).
                    enabled = gc.isenabled()
                    gc.collect()
                    gc.disable()
                    try:
                        if self.capture_guard is None:
                            self._capture()
                        else:
                            self.capture_guard(self._capture)
                    finally:
                        if enabled:
                            gc.enable()
            lib = build()
            stream = torch.cuda.current_stream(self.device)
            launch = TRACE.launch(self.name)
            if launch is not None:
                launch.events[0].record(stream)
            _check(lib, lib.loop_launch(self._exec, ctypes.c_void_p(stream.cuda_stream)),
                   "cudaGraphLaunch")
            result = self._enqueue_readback(stream)
            if launch is not None:
                launch.events[1].record(stream)
                result._launch = launch
            return result

    def _enqueue_readback(self, stream) -> "Result":
        """Queue the copy of ``out`` and the counters (and the loop clocks)
        into a pinned host slot (a free one of this program's, else a new
        one) and an event behind it; the slot returns to the pool when its
        Result is fetched."""
        slot = (self._slots.pop() if self._slots
                else torch.empty(self._readback.shape, dtype=torch.float32, pin_memory=True))
        slot.copy_(self._readback, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        return Result(self, slot=slot, event=event)

    def _loop_seconds(self, host: np.ndarray) -> dict:
        """Device seconds of each WHILE node of one launch, by node path,
        from the readback's clock totals (nanoseconds)."""
        totals = host[self._clock_at:].view(np.int64).reshape(MAX_CONDS, 2)[:, 1]
        out: dict = {}
        for slot, (is_while, _) in enumerate(self._conds):
            if is_while:
                path = self._cond_paths[slot]
                out[path] = out.get(path, 0.0) + float(totals[slot]) * 1e-9
        return out

    def _count(self, counts: np.ndarray) -> None:
        """Executed launches from the nodes' counters."""
        def execs(slot):
            return 1 if slot < 0 else int(round(counts[slot]))

        for idx, slot in self._occurrences:
            times = execs(slot)
            for kernel, variant, shape in self._seg_launches[idx]:
                if times:
                    cuda_iwe.count_launches(kernel, variant, shape, times, in_graph=True)
        preds = sum(execs(parent) + (execs(slot) if is_while else 0)
                    for slot, (is_while, parent) in enumerate(self._conds))
        with _lock:
            LAUNCHES["pred"] += preds
            RUNS[self.name] = RUNS.get(self.name, 0) + 1


class Result:
    """One launch's ``out``, in flight until fetched. ``fetched`` is False
    until the first fetch; the values are kept after it, so a Result shared
    by several readers (the lanes of one front-end launch) waits once."""

    __slots__ = ("_prog", "_slot", "_event", "_values", "_launch", "fetched")

    def __init__(self, prog: Program, *, slot=None, event=None, values=None):
        self._prog, self._slot, self._event = prog, slot, event
        self._values = values
        self._launch = None  # the trace's record of this launch (utils.metrics.Launch)
        self.fetched = False

    def _wait(self) -> None:
        """Block until the launch and its copy have completed, then count its
        kernel launches and give the slot back (no-op on the CPU)."""
        if self._event is None:
            return
        with TRACE.span("device_loop.wait", program=self._prog.name, wait=True):
            self._event.synchronize()
        host = self._slot.numpy()
        n = self._prog.out.numel()
        self._values = host[:n].copy()
        self._prog._count(host[n:])
        if self._launch is not None and self._prog.clocked:
            self._launch.loops = self._prog._loop_seconds(host)
        self._prog._slots.append(self._slot)
        self._slot = self._event = None

    def fetch(self) -> np.ndarray:
        """``out`` of this launch on the host (waits once, the first time)."""
        return fetch_all([self])[0]


def fetch_all(results: Sequence[Result]) -> List[np.ndarray]:
    """Every result's ``out`` on the host: one wait for all of them (each
    launch's event; those queued before the last have completed by then)."""
    for r in results:
        if not r.fetched:
            r._wait()
            r.fetched = True
    return [r._values[:r._prog.out.numel()] for r in results]
