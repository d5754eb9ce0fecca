"""End-point-error losses and validation metrics (NCHW, f32).

Counterpart of ``maskflownet_tpu/losses.py:24-83``: ``EpeLoss``,
``EpeLossWithMask`` with the optional q-norm, ``MultiscaleEpe`` with the
'upsampling' and 'downsampling' label match, and the KITTI Fl-all outlier
rate. Shapes: pred/label (N, 2, H, W) in (dy, dx); mask (N, 1, H, W) in
[0, 1]. Every function returns a per-sample vector (N,); the train step
takes the mean.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from maskflownet_torch.ops.resample import downsample, upsample


def epe_loss(pred: torch.Tensor, label: torch.Tensor,
             eps: float = 0.0) -> torch.Tensor:
    """Mean end-point error per sample."""
    d = pred.float() - label.float()
    return torch.sqrt((d * d).sum(1) + eps).mean((1, 2))


def epe_loss_with_mask(pred: torch.Tensor, label: torch.Tensor,
                       mask: torch.Tensor, eps: float = 1e-8,
                       q: float | None = None) -> torch.Tensor:
    """Masked EPE per sample, normalised by the mask sum; with ``q`` the
    robust ``(sum_c |d_c| + eps) ** q`` in place of the L2 distance."""
    d = pred.float() - label.float()
    if q is not None:
        dist = (d.abs().sum(1) + eps) ** q
    else:
        dist = torch.sqrt((d * d).sum(1) + eps)
    m = mask.float()[:, 0]
    return (dist * m).sum((1, 2)) / m.sum((1, 2))


def multiscale_epe(flow: torch.Tensor, mask: torch.Tensor,
                   predictions: Sequence[torch.Tensor], *,
                   scales: Sequence[int] = (64, 32, 16, 8, 4),
                   weights: Sequence[float] = (0.005, 0.01, 0.02, 0.08, 0.32),
                   match: str = "upsampling", eps: float = 1e-8,
                   q: float | None = None) -> torch.Tensor:
    """Weighted multiscale EPE per sample. 'upsampling': each prediction is
    triangle-upsampled to the label's resolution; 'downsampling': label and
    mask are triangle-downsampled to each prediction's."""
    total = None
    for pred, w, s in zip(predictions, weights, scales):
        if match == "upsampling":
            term = epe_loss_with_mask(upsample(pred, s), flow, mask, eps, q)
        elif match == "downsampling":
            term = epe_loss_with_mask(pred, downsample(flow, s),
                                      downsample(mask, s), eps, q)
        else:
            raise NotImplementedError(match)
        term = term * w
        total = term if total is None else total + term
    return total


def kitti_outlier_rate(pred: torch.Tensor, label: torch.Tensor,
                       mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """KITTI Fl-all per sample: the share of valid pixels whose EPE is over
    3 px and over 5% of the label's magnitude."""
    pred, label = pred.float(), label.float()
    err = torch.sqrt(((pred - label) ** 2).sum(1))
    mag = torch.sqrt((label ** 2).sum(1))
    bad = (err > 3.0) & (err / (mag + eps) > 0.05)
    m = mask.float()[:, 0]
    return (bad * m).sum((1, 2)) / m.sum((1, 2))
