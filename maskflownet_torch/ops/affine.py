"""Bilinear resampling at absolute coordinates, and its CUDA kernel.

Counterpart of ``maskflownet_tpu/ops/pallas/affine.py::windowed_sample``
(kernel ``_kernel``), the sampler of device-side geometric augmentation:

  ``affine_sample(img, sy, sx)[n, c, y, x]``
      = the bilinear sample of ``img[n, c]`` at ``(sy[n, y, x], sx[n, y, x])``

with corners outside the image contributing zero (``ops/warp.py``'s
``backwarp_coords``), f32 weights and sums, and an f32 result.

A CPU tensor takes ``affine_sample_plain``; a CUDA tensor runs the
hand-written kernel of ``csrc/affine.cu`` or raises. There is no fallback
from the kernel to the plain version. Unlike the TPU kernel, neither side
takes a source-window bound: the CUDA kernel reads its corners from global
memory wherever they lie.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskflownet_torch.ops import _build
from maskflownet_torch.ops.warp import backwarp_coords

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def affine_sample_plain(img: torch.Tensor, sy: torch.Tensor,
                        sx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``backwarp_coords`` of the image in f32."""
    return backwarp_coords(img.float(), sy, sx)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("affine")
    lib.mfn_affine_sample.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mfn_affine_sample.restype = ctypes.c_int
    lib.mfn_affine_error_string.argtypes = [ctypes.c_int]
    lib.mfn_affine_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                  ) -> None:
    if img.dim() != 4 or 0 in img.shape:
        raise ValueError(f"affine_sample: img must be non-empty NCHW, got "
                         f"{tuple(img.shape)}")
    want = (img.shape[0],) + tuple(sy.shape[1:])
    if sy.dim() != 3 or tuple(sy.shape) != want or sx.shape != sy.shape:
        raise ValueError(f"affine_sample: sy/sx must both be (N, Ho, Wo) "
                         f"with N = {img.shape[0]}, got {tuple(sy.shape)} "
                         f"and {tuple(sx.shape)}")


def _launch(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
            ) -> torch.Tensor:
    ts = (img, sy, sx)
    if any(t.device != img.device for t in ts):
        raise ValueError(f"affine_sample: inputs must lie on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if img.dtype not in _DTYPE_CODES or sy.dtype != torch.float32 or \
            sx.dtype != torch.float32:
        raise TypeError(f"affine_sample: img must be f32 or bf16 and sy/sx "
                        f"f32, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("affine_sample: inputs must be contiguous")
    n, c, h, w = img.shape
    ho, wo = sy.shape[1:]
    if n > 65535 or h * w >= 2 ** 31 or ho * wo >= 2 ** 31:
        raise ValueError(f"affine_sample: shape {tuple(img.shape)} -> "
                         f"{(ho, wo)} too large")
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().mfn_affine_sample(
            img.data_ptr(), sy.data_ptr(), sx.data_ptr(), out.data_ptr(), n,
            c, h, w, ho, wo, _DTYPE_CODES[img.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"affine_sample: launch failed: "
                           f"{_lib().mfn_affine_error_string(err).decode()}")
    affine_sample.launches += 1
    return out


def affine_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                  ) -> torch.Tensor:
    """Sample ``img`` (N,C,H,W) at absolute coordinates ``sy``/``sx``
    (N,Ho,Wo); returns (N,C,Ho,Wo) f32, zero outside the image.

    On a CUDA tensor it launches the kernel on the current stream (img f32
    or bf16, sy/sx f32, all contiguous) and counts the launch in
    ``affine_sample.launches``; it raises on any input the kernel does not
    take and if the launch reports an error. On a CPU tensor it returns
    ``affine_sample_plain``."""
    _check_shapes(img, sy, sx)
    if img.device.type == "cuda":
        return _launch(img, sy, sx)
    if img.device.type == "cpu":
        return affine_sample_plain(img, sy, sx)
    raise ValueError(f"affine_sample: no path for device {img.device}")


affine_sample.launches = 0
