"""Flow-guided deformable 3x3 convolution (NCHW, OIHW weight).

Counterpart of ``maskflownet_tpu/ops/deform.py:74-116, 228-280``:

  ``out[n, o, y, x] = bias[o] + sum_{ky,kx in {-1,0,1}} sum_c
        w[o, c, ky+1, kx+1] * bilinear(x_in[n, c], y + dy + ky, x + dx + kx)``

a 3x3 conv whose window is shifted rigidly per output pixel by the flow
(dy, dx); out-of-image bilinear corners contribute zero.

Two exact formulations, as in the JAX package:

* ``warpconv`` (the main path; the JAX package's default on the TPU): all
  nine taps share one fractional offset, so the bilinear weights commute
  with the tap sum. One stock 3x3 conv over the input zero-padded by two
  gives the conv on the one-pixel-extended grid [-1, H] x [-1, W], and one
  bilinear gather of that, with zero padding, at ``p + 1 + flow`` is the
  result (the extended border reads the image through the outer taps,
  beyond it every tap is outside).
* ``gather``: the 4x4 integer window around ``floor(p + flow)`` gathered
  once (16 corners), nine bilinear taps, one contraction over 9*Cin. It
  is the plain check of ``warpconv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from maskflownet_torch import nn
from maskflownet_torch.ops.warp import _gather, backwarp_coords, base_grid


def _warpconv(x, flow, weight, bias):
    conv = F.conv2d(F.pad(x, (2, 2, 2, 2)), weight.to(x.dtype))
    sy, sx = base_grid(flow, offset=1.0)
    out = backwarp_coords(conv, sy, sx)
    return out if bias is None else out + bias.to(x.dtype)[:, None, None]


def _gather_deform(x, flow, weight, bias):
    n, cin, h, w = x.shape
    dtype = x.dtype
    sy, sx = base_grid(flow)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0).unsqueeze(1).to(dtype)
    fx = (sx - x0).unsqueeze(1).to(dtype)
    y0 = y0.long()
    x0 = x0.long()
    corners = {}
    for u in (-1, 0, 1, 2):
        for v in (-1, 0, 1, 2):
            yy = y0 + u
            xx = x0 + v
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            g = _gather(x, yy.clamp(0, h - 1), xx.clamp(0, w - 1))
            corners[(u, v)] = torch.where(valid.unsqueeze(1), g,
                                          g.new_zeros(()))
    taps = [(1 - fy) * (1 - fx) * corners[(ky, kx)]
            + (1 - fy) * fx * corners[(ky, kx + 1)]
            + fy * (1 - fx) * corners[(ky + 1, kx)]
            + fy * fx * corners[(ky + 1, kx + 1)]
            for ky in (-1, 0, 1) for kx in (-1, 0, 1)]
    stacked = torch.stack(taps, 1)                      # (N, 9, Cin, H, W)
    wk = weight.to(dtype).reshape(weight.shape[0], cin, 9)
    out = torch.einsum("nkchw,ock->nohw", stacked, wk)
    return out if bias is None else out + bias.to(dtype)[:, None, None]


_METHODS = {"warpconv": _warpconv, "gather": _gather_deform}


def flow_guided_deform_conv3x3(x: torch.Tensor, flow: torch.Tensor,
                               weight: torch.Tensor,
                               bias: torch.Tensor | None = None,
                               method: str = "warpconv") -> torch.Tensor:
    """x: (N,Cin,H,W); flow: (N,2,H,W) (dy, dx) pixels at this level;
    weight: (Cout,Cin,3,3); bias: (Cout,) or None. -> (N,Cout,H,W)."""
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(f"deform method {method!r}: expected one of "
                         f"{sorted(_METHODS)}") from None
    return fn(x, flow, weight, bias)


def deform_conv(ctx: nn.Ctx, name: str, x: torch.Tensor, flow: torch.Tensor,
                cout: int, *, use_bias: bool = True) -> torch.Tensor:
    """Parameterized wrapper (kernel 3, stride 1, pad 1, one group)."""
    wgt = ctx.param(f"{name}/w", (cout, x.shape[1], 3, 3), nn.msra_prelu())
    b = ctx.param(f"{name}/b", (cout,), nn.zeros_init) if use_bias else None
    return flow_guided_deform_conv3x3(x, flow, wgt, b)
