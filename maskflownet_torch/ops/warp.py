"""Bilinear backward warping (NCHW; flow channels are (dy, dx) pixels).

Counterpart of ``maskflownet_tpu/ops/warp.py:28-36, 133-208`` (its
``gather`` method): ``backwarp(img, flow)[n, c, y, x]`` samples
``img[n, c, y + flow[n,0,y,x], x + flow[n,1,y,x]]`` from its four corners;
out-of-image corners contribute zero, and ``clamp=True`` first clamps the
sample point to the image rectangle. ``affine_grid`` (``:211-229``) and
``normalized_to_pixels`` (the coordinate map of ``grid_sample_normalized``,
``:232-239``) give geometric augmentation its sampling coordinates; it
samples at them through ``ops/affine.py::affine_sample``.
"""

from __future__ import annotations

import torch


def _gather(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
            ) -> torch.Tensor:
    """img (N,C,H,W); iy/ix (N,Ho,Wo) in-bounds int64 -> (N,C,Ho,Wo)."""
    n, c, h, w = img.shape
    idx = (iy * w + ix).reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(img.reshape(n, c, h * w), 2, idx).reshape(
        (n, c) + tuple(iy.shape[1:]))


def backwarp_coords(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    *, clamp: bool = False) -> torch.Tensor:
    """Sample ``img`` (N,C,H,W) at float coords ``sy``/``sx`` (N,Ho,Wo)."""
    h, w = img.shape[2], img.shape[3]
    sy = sy.float()
    sx = sx.float()
    if clamp:
        sy = sy.clamp(0.0, h - 1.0)
        sx = sx.clamp(0.0, w - 1.0)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0).unsqueeze(1).to(img.dtype)
    wx = (sx - x0).unsqueeze(1).to(img.dtype)
    y0 = y0.long()
    x0 = x0.long()
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            v = _gather(img, yy.clamp(0, h - 1), xx.clamp(0, w - 1))
            if not clamp:
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                v = torch.where(valid.unsqueeze(1), v, v.new_zeros(()))
            contrib = v * ((wy if dy else 1 - wy) * (wx if dx else 1 - wx))
            out = contrib if out is None else out + contrib
    return out


def base_grid(flow: torch.Tensor, offset: float = 0.0):
    """Sample coordinates ``p + offset + flow`` for a (N,2,H,W) flow, f32."""
    h, w = flow.shape[2], flow.shape[3]
    gy = torch.arange(h, dtype=torch.float32, device=flow.device)
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)
    sy = gy[:, None] + offset + flow[:, 0].float()
    sx = gx[None, :] + offset + flow[:, 1].float()
    return sy, sx


def backwarp(img: torch.Tensor, flow: torch.Tensor, *, clamp: bool = False
             ) -> torch.Tensor:
    """Backward-warp ``img`` (N,C,H,W) by ``flow`` (N,2,H,W) (dy, dx)."""
    sy, sx = base_grid(flow)
    return backwarp_coords(img, sy, sx, clamp=clamp)


def affine_grid(theta: torch.Tensor, height: int, width: int):
    """Normalized affine sampling grid (``maskflownet_tpu/ops/warp.py:
    211-229``). ``theta``: (N, 6) rows ``[a, b, tx, c, d, ty]``; target
    coordinates ``x_t``, ``y_t`` run over [-1, 1] inclusive (align-corners).
    Returns ``gx = a*x_t + b*y_t + tx`` and ``gy = c*x_t + d*y_t + ty``,
    each (N, H, W) f32."""
    ys = torch.linspace(-1.0, 1.0, height, dtype=torch.float32,
                        device=theta.device)[:, None]
    xs = torch.linspace(-1.0, 1.0, width, dtype=torch.float32,
                        device=theta.device)[None, :]
    t = theta.float()[:, :, None, None]
    gx = t[:, 0] * xs + t[:, 1] * ys + t[:, 2]
    gy = t[:, 3] * xs + t[:, 4] * ys + t[:, 5]
    return gx, gy


def normalized_to_pixels(gx: torch.Tensor, gy: torch.Tensor, height: int,
                         width: int):
    """Absolute (sy, sx) of normalized [-1, 1] coordinates on an image of
    ``height`` x ``width`` (align-corners): ``sx = (gx + 1) * (W - 1) / 2``."""
    return (gy + 1.0) * ((height - 1) / 2.0), (gx + 1.0) * ((width - 1) / 2.0)

