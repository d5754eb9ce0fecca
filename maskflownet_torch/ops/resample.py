"""Resampling (NCHW): the triangle-kernel upsample as an exact separable
lerp, and align-corners bilinear resize.

Counterpart of ``maskflownet_tpu/ops/resample.py:32-51, 82-99``.
``upsample(img, f)`` is ``out[f*i + r] = ((f-r)*x[i] + r*x[i+1]) / f`` per
axis with the last row/column repeated (clamp at the bottom/right only);
``F.interpolate`` has no mode with that edge rule, so it is written out.
``resize_bilinear`` is MXNet ``BilinearResize2D`` (align corners), which is
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


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Align-corners bilinear resize of (N,C,H,W) to (N,C,height,width)."""
    if tuple(img.shape[2:]) == (height, width):
        return img
    return F.interpolate(img, size=(height, width), mode="bilinear",
                         align_corners=True)
