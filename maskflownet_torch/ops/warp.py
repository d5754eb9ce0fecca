"""Bilinear backward warping (NCHW; flow channels are (dy, dx) pixels).

Counterpart of ``maskflownet_tpu/ops/warp.py:28-36, 133-208`` (its
``gather`` method): ``backwarp(img, flow)[n, c, y, x]`` samples
``img[n, c, y + flow[n,0,y,x], x + flow[n,1,y,x]]`` from its four corners;
out-of-image corners contribute zero, and ``clamp=True`` first clamps the
sample point to the image rectangle.
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
