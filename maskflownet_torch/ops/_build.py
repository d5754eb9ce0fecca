"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by one
``nvcc`` call for Hopper (``sm_90a``) into
``<repo>/build/maskflownet_torch/lib<name>-<hash>.so``, the hash taken over
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built at import: the first launch
builds, or a caller builds every source at once with :func:`build`. A failed
``nvcc`` raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "maskflownet_torch"
SOURCES = ("correlation", "affine", "deform")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": nvcc wall time, "log": nvcc's output (ptxas -v:
#: registers, shared memory, spills)} for the sources built by this process
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so, time.perf_counter()))
    errors = []
    for name, proc, tmp, so, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build((name,))[name]))
    return lib
