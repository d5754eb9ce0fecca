"""Host-side (numpy) bilinear resize used by the dataset readers: the
port's copy of ``maskflownet_tpu/data/resize.py``.

Align-corners sampling, consistent with the readers' flow rescale factor
``(new - 1) / (old - 1)`` (reference ``reader/kitti.py:69-71``) and with the
device-side ``ops.resample.resize_bilinear``.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear_np(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) float/uint array -> (height, width, C), float32."""
    h, w = img.shape[:2]
    out_dtype = np.float32
    img = img.astype(np.float32)
    if (h, w) == (height, width):
        return img
    ys = np.linspace(0.0, h - 1.0, height, dtype=np.float64)
    xs = np.linspace(0.0, w - 1.0, width, dtype=np.float64)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, max(h - 2, 0))
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, max(w - 2, 0))
    wy = (ys - y0).astype(np.float32)[:, None, None]
    wx = (xs - x0).astype(np.float32)[None, :, None]
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(out_dtype)
