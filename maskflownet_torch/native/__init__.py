"""The port's host-side C++ runtime (``png_filters.cpp``), loaded with
ctypes: the counterpart of ``maskflownet_tpu/native/``'s unfilter, with
the same C interface. :func:`png_unfilter` is the PNG scanline unfilter of
every PNG that ``data/codecs.py`` reads (8-bit and 16-bit);
``codecs._unfilter`` is its plain numpy version, which only the tests
call. The JAX runtime's crop is not ported: the loader's numpy slices give
the same arrays (``data/loader.py``).

The library is compiled by ``g++ -O3 -shared -fPIC`` at first use into
``<repo>/build/maskflownet_torch/libpng_filters-<hash>.so``, the hash taken
over the source and the flags, written under a temporary name and moved
into place, so that concurrent builds never load a half-written file. A
failed build raises with ``g++``'s output: there is no fallback to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from maskflownet_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("png_filters.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: ``g++``'s wall time in seconds, once this process has built the library
build_seconds: float | None = None


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return build_dir / f"libpng_filters-{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless its library exists; return the library's
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    global build_seconds
    so = library_path(source, build_dir)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native "
                           "runtime (png_filters.cpp) cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """The library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        return _lib


def png_unfilter(body: np.ndarray, filters: np.ndarray, bpp: int) -> None:
    """Unfilter ``body`` (h, stride) uint8, C-contiguous and writable, in
    place, row y by its filter ``filters[y]``; ``bpp`` bytes a pixel (1 for
    bit depths below 8). Raises ``ValueError`` on a filter id above 4."""
    h, stride = body.shape
    if body.dtype != np.uint8 or not body.flags.c_contiguous or \
            not body.flags.writeable:
        raise ValueError("png_unfilter: body must be C-contiguous, "
                         "writable uint8")
    filters = np.ascontiguousarray(filters, np.uint8)
    if filters.shape != (h,):
        raise ValueError(f"png_unfilter: {filters.shape} filters for {h} "
                         f"rows")
    if load().png_unfilter(body.ctypes.data, h, stride, bpp,
                           filters.ctypes.data):
        raise ValueError(f"unknown PNG filter {int(filters[filters > 4][0])}")

