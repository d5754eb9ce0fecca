"""FlowNet-C correlation cost volume (NCHW), its gradient, and their CUDA
kernels.

Counterpart of ``maskflownet_tpu/ops/correlation.py:27-100`` and of the
``custom_vjp`` pair ``correlation_pallas`` / ``correlation_pallas_cmajor``
(``maskflownet_tpu/ops/pallas/correlation.py:274-410``):

  ``out[n, (dy+md)*(2md+1) + (dx+md), y, x]
      = act(mean_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx])``

for ``dy, dx in [-md, md]``, f2 zero outside the image, displacement
channels y-major, ``act`` LeakyReLU(``leaky``) or the identity.

``correlation`` goes through :class:`CorrelationFunction` on both devices.
A CPU tensor takes ``correlation_plain`` forward and
``correlation_bwd_plain`` backward; a CUDA tensor takes the hand-written
kernels of ``csrc/correlation.cu`` through ``corr_fwd``, ``corr_bwd_f1``
and ``corr_bwd_f2``, or raises. There is no fallback from a kernel to the
plain version. ``corr_fwd`` returns a tensor without a gradient, so it
refuses an input that asks for one while grad mode is on.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

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


def _plain_cotangent(g, out, leaky):
    """g' in f32: the cotangent rescaled by the LeakyReLU's derivative, read
    off the sign of the saved output (``out >= 0 ? g : leaky*g``)."""
    gp = g.float()
    return gp if leaky is None else torch.where(out >= 0, gp, leaky * gp)


def correlation_bwd_f1_plain(g: torch.Tensor, f2: torch.Tensor,
                             out: torch.Tensor | None, md: int,
                             leaky: float | None = None) -> torch.Tensor:
    """Plain version of ``corr_bwd_f1`` (same arguments): one shifted
    multiply-add per displacement, ``df1 += g'_t * f2(y+dy, x+dx)``, f32
    throughout, one cast at the end."""
    n, c, h, w = f2.shape
    d = 2 * md + 1
    gp = _plain_cotangent(g, out, leaky)
    b = F.pad(f2.float(), (md, md, md, md))
    df1 = torch.zeros((n, c, h, w), device=f2.device)
    for t in range(d * d):
        dy, dx = divmod(t, d)
        df1 += gp[:, t:t + 1] * b[:, :, dy:dy + h, dx:dx + w]
    return (df1 * (1.0 / c)).to(f2.dtype)


def correlation_bwd_f2_plain(g: torch.Tensor, f1: torch.Tensor,
                             out: torch.Tensor | None, md: int,
                             leaky: float | None = None) -> torch.Tensor:
    """Plain version of ``corr_bwd_f2`` (same arguments): one shifted
    multiply-add per displacement into a zero-padded accumulator,
    ``df2(y+dy, x+dx) += g'_t * f1``, f32 throughout, one cast at the
    end."""
    n, c, h, w = f1.shape
    d = 2 * md + 1
    gp = _plain_cotangent(g, out, leaky)
    a = f1.float()
    df2 = torch.zeros((n, c, h + 2 * md, w + 2 * md), device=f1.device)
    for t in range(d * d):
        dy, dx = divmod(t, d)
        df2[:, :, dy:dy + h, dx:dx + w] += gp[:, t:t + 1] * a
    return (df2[:, :, md:md + h, md:md + w] * (1.0 / c)).to(f1.dtype)


def correlation_bwd_plain(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                          out: torch.Tensor | None, md: int,
                          leaky: float | None = None):
    """Plain PyTorch gradient of ``correlation_plain``: ``(df1, df2)`` for
    the cotangent ``g`` of its output, in the dtype of f1/f2. With
    ``leaky``, ``out`` is the saved output whose sign gives the
    activation's derivative; without it, None."""
    return (correlation_bwd_f1_plain(g, f2, out, md, leaky),
            correlation_bwd_f2_plain(g, f1, out, md, leaky))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("correlation")
    lib.mfn_corr_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.mfn_corr_fwd.restype = ctypes.c_int
    for fn in (lib.mfn_corr_bwd_f1, lib.mfn_corr_bwd_f2):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.mfn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, feats, maps, md: int) -> None:
    """Raise unless the kernel takes these inputs: ``feats`` are the (N,C,H,W)
    feature maps, ``maps`` the (N,(2md+1)^2,H,W) cotangent/output maps."""
    ts = list(feats) + list(maps)
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in ts]} not taken; "
                        "expected one of f32, bf16, f16 for all")
    shape = feats[0].shape
    if feats[0].dim() != 4 or 0 in shape or any(
            t.shape != shape for t in feats):
        raise ValueError(f"{name}: expected equal non-empty NCHW feature "
                         f"shapes, got {[tuple(t.shape) for t in feats]}")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"{name}: md={md} outside 1..{MAX_MD}")
    n, c, h, w = shape
    dshape = (n, (2 * md + 1) ** 2, h, w)
    if any(tuple(t.shape) != dshape for t in maps):
        raise ValueError(f"{name}: expected {dshape} for the cost-volume "
                         f"maps, got {[tuple(t.shape) for t in maps]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous NCHW")
    if n > 65535 or c * h * w >= 2 ** 31 or dshape[1] * h * w >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(shape)} too large")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{_lib().mfn_cuda_error_string(err).decode()}")


def corr_fwd(f1: torch.Tensor, f2: torch.Tensor, md: int,
             leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA forward kernel on the current stream.

    f1/f2: contiguous NCHW CUDA tensors of one shape and dtype (f32, bf16
    or f16). Returns (N, (2md+1)^2, H, W) in that dtype, without a
    gradient: with grad mode on, an input that requires one raises (use
    ``correlation``). Raises on any input the kernel does not take, and if
    the launch reports an error."""
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError("corr_fwd: an input requires grad, and the "
                           "kernel's output would drop it; call "
                           "correlation(), whose backward runs the "
                           "gradient kernels")
    _check("corr_fwd", (f1, f2), (), md)
    n, c, h, w = f1.shape
    d = 2 * md + 1
    out = torch.empty((n, d * d, h, w), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        err = _lib().mfn_corr_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w, md,
            _DTYPE_CODES[f1.dtype], 0.0 if leaky is None else float(leaky),
            int(leaky is not None), torch.cuda.current_stream().cuda_stream)
    _raise_on("corr_fwd", err)
    corr_fwd.launches += 1
    return out


corr_fwd.launches = 0


def _bwd(name: str, fn_name: str, g, feat, out, md, leaky):
    if (out is None) != (leaky is None):
        raise ValueError(f"{name}: pass the saved output exactly when the "
                         "LeakyReLU is fused (leaky is not None)")
    _check(name, (feat,), (g,) if out is None else (g, out), md)
    n, c, h, w = feat.shape
    grad = torch.empty_like(feat)
    with torch.cuda.device(feat.device):
        err = getattr(_lib(), fn_name)(
            g.data_ptr(), None if out is None else out.data_ptr(),
            feat.data_ptr(), grad.data_ptr(), n, c, h, w, md,
            _DTYPE_CODES[feat.dtype], 0.0 if leaky is None else float(leaky),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    return grad


def corr_bwd_f1(g: torch.Tensor, f2: torch.Tensor, out: torch.Tensor | None,
                md: int, leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel for d cost / d f1 on the current stream.

    g (the cotangent) and out (the forward's saved output, None without
    ``leaky``): contiguous (N,(2md+1)^2,H,W); f2: contiguous (N,C,H,W); one
    CUDA device and dtype. Returns df1 (N,C,H,W) in that dtype."""
    df1 = _bwd("corr_bwd_f1", "mfn_corr_bwd_f1", g, f2, out, md, leaky)
    corr_bwd_f1.launches += 1
    return df1


corr_bwd_f1.launches = 0


def corr_bwd_f2(g: torch.Tensor, f1: torch.Tensor, out: torch.Tensor | None,
                md: int, leaky: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel for d cost / d f2; arguments as
    :func:`corr_bwd_f1`, with f1 in place of f2. Returns df2."""
    df2 = _bwd("corr_bwd_f2", "mfn_corr_bwd_f2", g, f1, out, md, leaky)
    corr_bwd_f2.launches += 1
    return df2


corr_bwd_f2.launches = 0


class CorrelationFunction(torch.autograd.Function):
    """The cost volume with its gradient (``correlation_pallas``'s
    ``custom_vjp``): saves ``(f1, f2, out if leaky else None)``; backward
    rescales the cotangent by the sign of the saved output and returns
    ``(df1, df2)`` in the input dtype. CUDA tensors run the kernels, CPU
    tensors the plain versions."""

    @staticmethod
    def forward(ctx, f1, f2, md, leaky):
        if f1.device.type == "cuda":
            out = corr_fwd(f1, f2, md, leaky)
        else:
            out = correlation_plain(f1, f2, md, leaky)
        ctx.md, ctx.leaky = md, leaky
        ctx.save_for_backward(f1, f2, None if leaky is None else out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2, out = ctx.saved_tensors
        md, leaky = ctx.md, ctx.leaky
        g = g.to(f1.dtype).contiguous()
        if f1.device.type != "cuda":
            df1, df2 = correlation_bwd_plain(g, f1, f2, out, md, leaky)
            return df1, df2, None, None
        df1 = (corr_bwd_f1(g, f2, out, md, leaky)
               if ctx.needs_input_grad[0] else None)
        df2 = (corr_bwd_f2(g, f1, out, md, leaky)
               if ctx.needs_input_grad[1] else None)
        return df1, df2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int,
                leaky: float | None = None) -> torch.Tensor:
    """Cost volume with (2md+1)^2 channels; see the module docstring."""
    if f1.device.type in ("cuda", "cpu"):
        return CorrelationFunction.apply(f1, f2, md, leaky)
    # 'meta' is the parameter-shape pass of nn.collect_shapes
    if f1.device.type == "meta":
        return correlation_plain(f1, f2, md, leaky)
    raise ValueError(f"correlation: no path for device {f1.device}")
