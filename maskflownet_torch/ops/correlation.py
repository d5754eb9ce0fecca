"""FlowNet-C correlation cost volume (NCHW) and its CUDA kernel.

Counterpart of ``maskflownet_tpu/ops/correlation.py:27-100``:

  ``out[n, (dy+md)*(2md+1) + (dx+md), y, x]
      = act(mean_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx])``

for ``dy, dx in [-md, md]``, f2 zero outside the image, displacement
channels y-major, ``act`` LeakyReLU(``leaky``) or the identity.

``correlation`` picks the path by device: a CPU tensor takes
``correlation_plain``; a CUDA tensor takes the hand-written kernel
``csrc/correlation.cu`` through ``corr_fwd``, or raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from maskflownet_torch.ops import _build

MAX_MD = 4  # the kernel is instantiated for md = 1..4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, md: int,
                      leaky: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: the kernel's contract on any device (f32
    products and sums, the activation on the f32 value, one cast to the
    input dtype at the end)."""
    n, c, h, w = f1.shape
    d = 2 * md + 1
    a = f1.float()
    b = F.pad(f2.float(), (md, md, md, md))
    out = torch.stack([(a * b[:, :, dy:dy + h, dx:dx + w]).sum(1)
                       for dy in range(d) for dx in range(d)], 1) * (1.0 / c)
    if leaky is not None:
        out = F.leaky_relu(out, leaky)
    return out.to(f1.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("correlation")
    lib.mfn_corr_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.mfn_corr_fwd.restype = ctypes.c_int
    lib.mfn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def corr_fwd(f1: torch.Tensor, f2: torch.Tensor, md: int,
             leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA forward kernel on the current stream.

    f1/f2: contiguous NCHW CUDA tensors of one shape and dtype (f32, bf16
    or f16). Returns (N, (2md+1)^2, H, W) in that dtype. Raises on any input
    the kernel does not take, and if the launch reports an error."""
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"corr_fwd: f1/f2 must lie on one CUDA device, got "
                         f"{f1.device} and {f2.device}")
    if f1.dtype not in _DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError(f"corr_fwd: dtypes {f1.dtype}/{f2.dtype} not taken; "
                        "expected one of f32, bf16, f16 for both")
    if f1.dim() != 4 or f2.shape != f1.shape or 0 in f1.shape:
        raise ValueError(f"corr_fwd: expected two equal non-empty NCHW "
                         f"shapes, got {tuple(f1.shape)}, {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("corr_fwd: f1/f2 must be contiguous NCHW")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"corr_fwd: md={md} outside 1..{MAX_MD}")
    n, c, h, w = f1.shape
    if n > 65535 or c * h * w >= 2 ** 31:
        raise ValueError(f"corr_fwd: shape {tuple(f1.shape)} too large")
    d = 2 * md + 1
    out = torch.empty((n, d * d, h, w), dtype=f1.dtype, device=f1.device)
    lib = _lib()
    with torch.cuda.device(f1.device):
        err = lib.mfn_corr_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w, md,
            _DTYPE_CODES[f1.dtype], 0.0 if leaky is None else float(leaky),
            int(leaky is not None), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"corr_fwd: launch failed: "
                           f"{lib.mfn_cuda_error_string(err).decode()}")
    corr_fwd.launches += 1
    return out


corr_fwd.launches = 0


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int,
                leaky: float | None = None) -> torch.Tensor:
    """Cost volume with (2md+1)^2 channels; see the module docstring."""
    if f1.device.type == "cuda":
        return corr_fwd(f1, f2, md, leaky)
    # 'meta' is the parameter-shape pass of nn.collect_shapes
    if f1.device.type in ("cpu", "meta"):
        return correlation_plain(f1, f2, md, leaky)
    raise ValueError(f"correlation: no path for device {f1.device}")
