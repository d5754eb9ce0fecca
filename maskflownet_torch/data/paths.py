"""Dataset location registry: the port's copy of
``maskflownet_tpu/data/paths.py``, the same variables and defaults.

The reference hardcodes Windows paths at the top of each reader
(``main.py:16-18``, ``reader/sintel.py:9-10``, ``reader/kitti.py:11-25``,
``reader/hd1k.py:8-13``, ``reader/things3d.py:7``); here every location is an
environment variable with a sane default, overridable per call.
"""

from __future__ import annotations

import os


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def chairs_dir() -> str:
    return _env("MFN_CHAIRS_DIR", "/data/FlyingChairs_release/data")


def chairs_split_file() -> str:
    return _env("MFN_CHAIRS_SPLIT",
                "/data/FlyingChairs_release/FlyingChairs_train_val.txt")


def sintel_root() -> str:
    return _env("MFN_SINTEL_ROOT", "/data/Sintel")


def sintel_split_file() -> str:
    return _env("MFN_SINTEL_SPLIT",
                os.path.join(sintel_root(), "Sintel_train_val_maskflownet.txt"))


def kitti_root() -> str:
    return _env("MFN_KITTI_ROOT", "/data/KITTI")


def hd1k_root() -> str:
    return _env("MFN_HD1K_ROOT", "/data/HD1K")


def things3d_root() -> str:
    return _env("MFN_THINGS3D_ROOT", "/data/FlyingThings3D_subset")
