"""Builds the port's CUDA sources (csrc/*.cu) with nvcc into shared libraries
with a plain C interface, loaded with ctypes by ops/cuda_iwe.py and
ops/device_loop.py.

A library lives in ``_build/`` beside the package, named by a hash of its
source and flags, and is built at first use. ``compile_all`` starts one nvcc
per missing library, all at once, and waits for them: a caller that needs
several libraries pays for the slowest build, not the sum. A build that fails
raises with nvcc's output."""

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


def compile_all(jobs) -> None:
    """Build every (source, flags, path) whose library is missing, one nvcc
    each, all started together."""
    todo = [(src, flags, so) for src, flags, so in jobs if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for src, flags, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((so, tmp, subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {so.name}:\n{out}\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
