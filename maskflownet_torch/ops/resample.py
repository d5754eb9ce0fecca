"""Resampling (NCHW): the triangle-kernel upsample as an exact separable
lerp, the triangle-kernel downsample, and align-corners bilinear resize.

Counterpart of ``maskflownet_tpu/ops/resample.py:32-99``.
``upsample(img, f)`` is ``out[f*i + r] = ((f-r)*x[i] + r*x[i+1]) / f`` per
axis with the last row/column repeated (clamp at the bottom/right only);
``F.interpolate`` has no mode with that edge rule, so it is written out.
``downsample(img, f)`` is the anti-aliased triangle mean (kernel of size
f+1, stride f, padding f/2), renormalised by the same convolution of ones
so the border is not darkened. ``resize_bilinear`` is MXNet
``BilinearResize2D`` (align corners), which is
exactly ``F.interpolate(mode="bilinear", align_corners=True)``; the port's
tests hold the two against the JAX function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _upsample_axis(x: torch.Tensor, f: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    t = torch.arange(f, dtype=x.dtype, device=x.device) / f
    t = t.reshape((f,) + (1,) * (x.dim() - 1 - dim))
    out = x.unsqueeze(dim + 1) * (1 - t) + nxt.unsqueeze(dim + 1) * t
    return out.flatten(dim, dim + 1)


def upsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,H*factor,W*factor); values interpolated, not
    rescaled."""
    if factor == 1:
        return img
    return _upsample_axis(_upsample_axis(img, factor, 2), factor, 3)


def _triangle_kernel(f: int) -> torch.Tensor:
    w = f // 2
    k = (w + 1) - (w - torch.arange(2 * w + 1)).abs()
    return k.float() / (2 * w + 1)


def downsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,ceil(H/factor),ceil(W/factor)) triangle mean."""
    if factor == 1:
        return img
    c = img.shape[1]
    k1 = _triangle_kernel(factor).to(img.device, img.dtype)
    k = (k1[:, None] * k1[None, :]).expand(c, 1, -1, -1)
    args = dict(stride=factor, padding=factor // 2, groups=c)
    return (F.conv2d(img, k, **args)
            / F.conv2d(torch.ones_like(img), k, **args))


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Align-corners bilinear resize of (N,C,H,W) to (N,C,height,width)."""
    if tuple(img.shape[2:]) == (height, width):
        return img
    return F.interpolate(img, size=(height, width), mode="bilinear",
                         align_corners=True)
