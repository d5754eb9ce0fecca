"""MaskFlownet-S forward (NCHW), the port of
``maskflownet_tpu/models/maskflownet.py:36-64, 118-323``.

Conventions kept from the JAX package:
  * flow inside the network is full-resolution displacement / 20
    (``scale = 20 * flow_multiplier``); predictions are multiplied back;
  * flow channels are (dy, dx);
  * deformable-conv offsets are the upsampled flow in level pixels
    (``flow * scale / stride``), one offset for all nine taps;
  * level 2 has no ``pred_mask``: its gate is the upsampled level-3 mask;
  * ``strict_c2s_compat`` reproduces the reference's ``c2s`` quirk
    (image-1 features at indices 1 and 2) in the cascade sources;
  * parameter names are the JAX package's (``conv1a/w``, ``pred_flow6/b``,
    ...); shared pyramid weights are one entry used for both images.

The TPU-only reformulations of the JAX model (space-to-depth pyramids,
per-piece dense convs) are not part of the port: they compute the same
function for the TPU's lane tiling.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from maskflownet_torch import nn
from maskflownet_torch.ops.correlation import correlation
from maskflownet_torch.ops.deform import deform_conv
from maskflownet_torch.ops.resample import upsample
from maskflownet_torch.ops.warp import backwarp


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    flow_multiplier: float = 1.0
    deform_bias: bool = True
    upfeat_ch: tuple[int, ...] = (16, 16, 16, 16)
    strict_c2s_compat: bool = True

    @property
    def scale(self) -> float:
        return 20.0 * self.flow_multiplier


STRIDES = (64, 32, 16, 8, 4)  # levels 6..2
PYRAMID_CH = (16, 32, 64, 96, 128, 196)
DENSE_CH = (128, 128, 96, 64, 32)
MD = 4


def _pyramid(ctx: nn.Ctx, x: torch.Tensor,
             names: tuple[str, str, str] = ("a", "b", "c")
             ) -> list[torch.Tensor]:
    """Six levels of three convs, the first of each with stride 2."""
    feats = []
    for i, ch in enumerate(PYRAMID_CH, start=1):
        x = nn.conv(ctx, f"conv{i}{names[0]}", x, ch, stride=2)
        x = nn.conv(ctx, f"conv{i}{names[1]}", x, ch)
        x = nn.conv(ctx, f"conv{i}{names[2]}", x, ch)
        feats.append(x)
    return feats


def _pyramid_pair(ctx: nn.Ctx, xa: torch.Tensor, xb: torch.Tensor,
                  names: tuple[str, str, str] = ("a", "b", "c")):
    """The two shared-weight pyramids as one pass over the 2B batch."""
    b = xa.shape[0]
    feats = _pyramid(ctx, torch.cat([xa, xb], 0), names)
    return [f[:b] for f in feats], [f[b:] for f in feats]


def _dense_block(ctx: nn.Ctx, lvl: int, x: torch.Tensor) -> torch.Tensor:
    for j, ch in enumerate(DENSE_CH):
        x = torch.cat([nn.conv(ctx, f"conv{lvl}_{j}", x, ch), x], 1)
    return x


def _context_net(ctx: nn.Ctx, x: torch.Tensor) -> torch.Tensor:
    """Dilated context network: dilations 1, 2, 4, 8, 16, 1, then flow."""
    for i, (ch, dil) in enumerate(((128, 1), (128, 2), (128, 4), (96, 8),
                                   (64, 16), (32, 1)), start=1):
        x = nn.conv(ctx, f"dc_conv{i}", x, ch, dilation=dil)
    return nn.conv(ctx, "dc_conv7", x, 2, act=False)


def _pred_flow(ctx: nn.Ctx, lvl: int, x: torch.Tensor) -> torch.Tensor:
    return nn.conv(ctx, f"pred_flow{lvl}", x, 2, act=False).float()


def _pred_flow_mask(ctx: nn.Ctx, lvl: int, x: torch.Tensor):
    """Flow and mask heads as one 3-channel conv over the two stored
    parameters (``pred_flow{lvl}``, ``pred_mask{lvl}``)."""
    cin = x.shape[1]
    wf = ctx.param(f"pred_flow{lvl}/w", (2, cin, 3, 3), nn.msra_prelu())
    bf = ctx.param(f"pred_flow{lvl}/b", (2,), nn.zeros_init)
    wm = ctx.param(f"pred_mask{lvl}/w", (1, cin, 3, 3), nn.msra_prelu())
    bm = ctx.param(f"pred_mask{lvl}/b", (1,), nn.zeros_init)
    y = F.conv2d(x, torch.cat([wf, wm], 0), torch.cat([bf, bm]),
                 padding=1).float()
    return y[:, 0:2], y[:, 2:3]


def maskflownet_s(ctx: nn.Ctx, im1: torch.Tensor, im2: torch.Tensor,
                  cfg: ModelConfig = ModelConfig(), *,
                  cascade_sources: bool = True):
    """MaskFlownet-S forward on (B,3,H,W) images, H and W multiples of 64.

    Returns ``(predictions, occlusion_masks, srcs)``: predictions are
    [flow6 .. flow2] * scale (coarse to fine, (B,2,h,w) f32, (dy, dx)
    full-resolution pixels), occlusion_masks is [sigmoid(mask2)], and srcs
    holds the cascade inputs ``(c1s, c2s, flows, c30, c40)``, or is None
    when ``cascade_sources`` is False (inference does not read them).
    """
    dtype = ctx.dtype
    im1 = im1.to(dtype)
    im2 = im2.to(dtype)

    c1s, c2s = _pyramid_pair(ctx, im1, im2)

    # level 6; leaky=0.1 is the LeakyReLU after every cost volume, fused
    # into the kernel's epilogue
    x = _dense_block(ctx, 6, correlation(c1s[5], c2s[5], MD, leaky=0.1))
    flow, mask = _pred_flow_mask(ctx, 6, x)
    flows = [flow]

    for idx, lvl in enumerate((5, 4, 3, 2)):
        c1l, c2l = c1s[lvl - 1], c2s[lvl - 1]
        feat = nn.deconv(ctx, f"upfeat{lvl}", x, cfg.upfeat_ch[idx])
        fm = upsample(torch.cat([flow, mask], 1), 2)
        flow, mask = fm[:, 0:2], fm[:, 2:3]
        offsets = flow * (cfg.scale / STRIDES[idx + 1])
        warp = deform_conv(ctx, f"deform{lvl}", c2l, offsets, c2l.shape[1],
                           use_bias=cfg.deform_bias)
        warp = warp * torch.sigmoid(mask).to(dtype) + nn.conv(
            ctx, f"conv{lvl}f", feat, c2l.shape[1], act=False)
        corr = correlation(c1l, nn.leaky_relu(warp), MD, leaky=0.1)
        x = _dense_block(ctx, lvl, torch.cat([corr, c1l, feat,
                                              flow.to(dtype)], 1))
        if lvl > 2:
            df, mask = _pred_flow_mask(ctx, lvl, x)
            flow = flow + df
        else:
            flow = flow + _pred_flow(ctx, lvl, x)
        flows.append(flow)

    flow = flow + _context_net(ctx, x).float()
    flows[-1] = flow

    predictions = [f * cfg.scale for f in flows]
    occlusion_masks = [torch.sigmoid(mask)]
    if not cascade_sources:
        return predictions, occlusion_masks, None

    c21, c22, c23, c24, c25, c26 = c2s
    if cfg.strict_c2s_compat:
        c2s_out = [c21, c1s[1], c1s[2], c24, c25, c26]
    else:
        c2s_out = [c21, c22, c23, c24, c25, c26]
    mask0 = torch.sigmoid(upsample(mask, 4)) - 0.5
    flow0 = upsample(flow, 4) * cfg.scale
    c30 = torch.cat([im1, torch.zeros_like(mask0, dtype=dtype)], 1)
    c40 = torch.cat([backwarp(im2, flow0).to(dtype), mask0.to(dtype)], 1)
    return predictions, occlusion_masks, (c1s, c2s_out, flows, c30, c40)


@functools.cache
def _shapes(cfg: ModelConfig):
    return nn.collect_shapes(maskflownet_s, (1, 3, 64, 64), (1, 3, 64, 64),
                             cfg=cfg, cascade_sources=False)


def param_shapes(cfg: ModelConfig = ModelConfig()) -> dict[str, tuple]:
    """Name -> OIHW shape of every MaskFlownet_S parameter."""
    return {k: v[0] for k, v in _shapes(cfg).items()}


def init_params(seed: int, cfg: ModelConfig = ModelConfig()
                ) -> dict[str, torch.Tensor]:
    """Seeded MSRA-PReLU weights and zero biases at the published widths
    (f32, CPU)."""
    return nn.init(_shapes(cfg), seed)
