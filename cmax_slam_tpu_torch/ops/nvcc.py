"""Builds the port's native sources into shared libraries with a plain C
interface, loaded with ctypes: the CUDA sources (csrc/*.cu) with nvcc, for
ops/cuda_iwe.py, ops/cuda_pano_vote.py and ops/device_loop.py, and the host
data plane (native/evstream.cpp) with the host C++ compiler, for io/native.py.

A library lives in ``_build/`` beside the package, named by a hash of its
source and flags (a caller that may change compiler puts it in the flags),
and is built at first use. ``compile_all`` starts one compiler process per
missing library, all at once, and waits for them: a caller that needs
several libraries pays for the slowest build, not the sum. Each build
writes a file of its own and renames it into place, so processes that build
the same library at once do not clash. A build that fails raises with the
compiler's output."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CSRC = BUILD_DIR.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(source: Path, flags: tuple, stem: str) -> Path:
    """Where the build of ``source`` with ``flags`` lives."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


def compile_all(jobs, compiler: str | None = None) -> None:
    """Build every (source, flags, path) whose library is missing with
    ``compiler`` (None: nvcc), one process each, all started together."""
    todo = [(src, flags, so) for src, flags, so in jobs if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    compiler = compiler or find_nvcc()
    procs, failed = [], []
    for src, flags, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            procs.append((so, tmp, subprocess.Popen(
                [compiler, *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        except OSError as e:
            failed.append(f"{compiler} could not start for {so.name}: {e}")
    for so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{compiler} failed ({proc.returncode}) for {so.name}:\n{out}\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
