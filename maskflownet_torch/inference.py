"""MaskFlownet_S image-pair inference: the port of
``maskflownet_tpu/training/engine.py:66-75, 210-266, 306`` (``centralize``,
``Trainer._infer_fn``/``do_batch``, ``predict``) and
``maskflownet_tpu/tools/infer.py:39-53``.

``Predictor.do_batch`` takes NCHW images in [0, 1]: centralise the pair,
resize bilinearly to the next multiple of 64 (or ``resize``), run the
network, upsample the finest flow and the occlusion mask by 4, resize them
back with the flow values rescaled, and warp image 2 by the flow.
"""

from __future__ import annotations

import numpy as np
import torch

from maskflownet_torch import get_device, nn
from maskflownet_torch.models.maskflownet import ModelConfig, maskflownet_s
from maskflownet_torch.ops.resample import resize_bilinear, upsample
from maskflownet_torch.ops.warp import backwarp


def centralize(img1: torch.Tensor, img2: torch.Tensor):
    """Subtract the per-sample mean colour of the pair (mean in f32)."""
    mean = torch.cat([img1, img2], 2).float().mean(dim=(2, 3), keepdim=True)
    mean = mean.to(img1.dtype)
    return img1 - mean, img2 - mean


class Predictor:
    """Holds MaskFlownet_S parameters on a device and runs inference.

    ``params``: port parameters (OIHW), e.g. from ``models.init_params``,
    ``interop.params_from_jax`` or ``interop.load_npz``. ``dtype`` is the
    compute dtype of the network (flow accumulators stay f32); the
    parameters are held in it, cast once here rather than on every read."""

    def __init__(self, params: dict[str, torch.Tensor],
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 cfg: ModelConfig = ModelConfig()):
        self.device = get_device(device)
        self.dtype = dtype
        self.cfg = cfg
        self.params = {k: v.to(self.device, dtype) for k, v in params.items()}

    @torch.no_grad()
    def do_batch(self, img1, img2, resize: tuple[int, int] | None = None):
        """img1/img2: (B,3,H,W) float in [0, 1] (tensors or arrays).
        Returns f32 tensors on the device at input resolution: flow
        (B,2,H,W) in (dy, dx) pixels, occlusion (B,1,H,W), warped image 2
        (B,3,H,W)."""
        img1 = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        img2 = torch.as_tensor(img2, dtype=torch.float32, device=self.device)
        h, w = img1.shape[2:]
        if resize is None:
            wh, ww = h + (-h) % 64, w + (-w) % 64
        else:
            wh, ww = resize
        i1, i2 = centralize(img1, img2)
        i1 = resize_bilinear(i1, wh, ww)
        i2 = resize_bilinear(i2, wh, ww)
        preds, occs, _ = maskflownet_s(nn.apply_ctx(self.params, self.dtype),
                                       i1, i2, self.cfg,
                                       cascade_sources=False)
        flow = upsample(preds[-1], 4)
        occ = upsample(occs[0].float(), 4)
        if (wh, ww) != (h, w):
            scale = torch.tensor([h / wh, w / ww], device=self.device)
            flow = resize_bilinear(flow, h, w) * scale[:, None, None]
            occ = resize_bilinear(occ, h, w)
        warped = backwarp(img2, flow, clamp=True)
        return flow, occ, warped

    def predict(self, img1s, img2s, batch_size: int = 4, resize=None):
        """Yield (flow (H,W,2) (dy, dx), occ (H,W,1), warped (H,W,3)) numpy
        arrays per frame for lists of (H,W,3) uint8 RGB images; a short last
        batch is padded by repeating its last frame."""
        for j in range(0, len(img1s), batch_size):
            i1 = np.stack(img1s[j:j + batch_size]).astype(np.float32) / 255.0
            i2 = np.stack(img2s[j:j + batch_size]).astype(np.float32) / 255.0
            k = i1.shape[0]
            if k < batch_size:
                i1, i2 = [np.concatenate([a, np.repeat(a[-1:], batch_size - k,
                                                       0)]) for a in (i1, i2)]
            outs = self.do_batch(i1.transpose(0, 3, 1, 2),
                                 i2.transpose(0, 3, 1, 2), resize=resize)
            flow, occ, warped = [o.permute(0, 2, 3, 1).cpu().numpy()
                                 for o in outs]
            for t in range(k):
                yield flow[t], occ[t], warped[t]


def predict_image_pair_flow(predictor: Predictor, img1: np.ndarray,
                            img2: np.ndarray, resize=None):
    """img1/img2: (H,W,3) uint8 RGB -> (flow (H,W,2) (dy, dx), occ,
    warped) numpy arrays."""
    return next(predictor.predict([img1], [img2], batch_size=1,
                                  resize=resize))
