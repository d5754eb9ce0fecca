"""Host-side geometric augmentation in numpy: the port's copy of
``maskflownet_tpu/augment/host_geometry.py``, and the training CLI's
default when there is no device cache (``--aug host``).

The JAX package made this the default for a TPU, on which per-pixel
gathers were slow; on the card the device path (``augment/geometry.py``
through the ``affine_sample`` kernel) has no such cost. This path stays
for the same CLI surface: it runs on the prefetch thread, overlapped with
the device's work, and ships target-shape uint8 crops to the card. The
JAX module warps through OpenCV where it can; the port's machines may lack
OpenCV, so this copy has only the JAX module's numpy warp (the same
bilinear sampling, replicate or zero border).

Parameter distributions and warp semantics mirror ``augment/geometry.py``:
same rotation/zoom/aspect/translation draws, scale clamp, force-translation
correction, relative img2 transform, joint [img1, mask, flow*mask] warp with
mask renormalization, and the exact induced flow-vector transform
F'(p) = T2^{-1}(T1(p) + F~(p)) - p. The draws come from a
``numpy.random.RandomState`` in the JAX module's order, so one state gives
both packages the same draws.

Color augmentation stays on the device, inside the train step, so that
cached (echoed) batches still get fresh chromatic draws on every reuse.
"""

from __future__ import annotations

import math

import numpy as np

from maskflownet_torch.augment.geometry import GeometryAugConfig

# the border of a warp: the sampling coordinates clamped to the image
# (img1's grid, clamp semantics) or zeros outside it
REPLICATE, ZERO = "replicate", "zero"


def _warp(src: np.ndarray, m: np.ndarray, t: np.ndarray, out_hw,
          border: str):
    """Bilinearly sample src (H,W,C) at pixel coords q = m @ p + t (xy
    order) -> (th, tw, C) float32."""
    th, tw = out_hw
    py, px = np.mgrid[0:th, 0:tw].astype(np.float32)
    sx = m[0, 0] * px + m[0, 1] * py + t[0]
    sy = m[1, 0] * px + m[1, 1] * py + t[1]
    h, w = src.shape[:2]
    if border == REPLICATE:
        sx = np.clip(sx, 0, w - 1)
        sy = np.clip(sy, 0, h - 1)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    out = np.zeros((th, tw, src.shape[2]), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))
            v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            v = np.where(valid[..., None], v, 0.0)
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            out += v * wgt
    return out


def host_geometry_augmentation(rng: np.random.RandomState,
                               img1: np.ndarray, img2: np.ndarray,
                               flow: np.ndarray, mask: np.ndarray | None,
                               cfg: GeometryAugConfig):
    """Single sample: img1/img2 (oh,ow,3) float32 [0,1] or uint8; flow
    (oh,ow,2) (dy,dx) f32; mask (oh,ow,1) in [0,1] or None. Returns float32
    (img1_a, img2_a, flow_a, mask_a) at cfg.target_shape.

    Mirrors augment/geometry.py::geometry_augmentation exactly (one sample,
    numpy RNG). See that module for the derivation and reference citations.
    """
    oh, ow = img1.shape[:2]
    th, tw = cfg.target_shape
    assert (oh, ow) == tuple(cfg.orig_shape), (img1.shape, cfg.orig_shape)
    deg = math.pi / 180.0

    rot = rng.uniform(cfg.angle_range[0] * deg, cfg.angle_range[1] * deg)
    aspect = (rng.uniform(*cfg.aspect_range)
              if cfg.aspect_range is not None else 1.0)
    scale = rng.uniform(*cfg.zoom_range)
    osy, osx = oh - 1.0, ow - 1.0
    tsy, tsx = th - 1.0, tw - 1.0
    ar = abs(rot)
    scale = min(scale,
                osx / (aspect * (tsy * math.sin(ar) + tsx * math.cos(ar))),
                osy / (tsy * math.cos(ar) + tsx * math.sin(ar)))

    unit_xx, unit_yx = tsx / osx, tsy / osx
    unit_xy, unit_yy = tsx / osy, tsy / osy
    pad_x = 1 - scale * unit_xx
    pad_y = 1 - scale * unit_yy
    tr = cfg.translation_range
    tx = rng.uniform(-1, 1) * pad_x + rng.uniform(-2 * tr, 2 * tr)
    ty = rng.uniform(-1, 1) * pad_y + rng.uniform(-2 * tr, 2 * tr)

    a1 = np.asarray([
        scale * aspect * math.cos(rot) * unit_xx,
        scale * aspect * (-math.sin(rot)) * unit_yx,
        tx,
        scale * math.sin(rot) * unit_xy,
        scale * math.cos(rot) * unit_yy,
        ty,
    ], np.float64)

    if cfg.relative_angle is not None:
        rrot = rng.uniform(cfg.angle_range[0] * deg * cfg.relative_angle,
                           cfg.angle_range[1] * deg * cfg.relative_angle)
        rscale = rng.uniform(*cfg.relative_scale)
    else:
        rrot, rscale = 0.0, 1.0
    arel = tsy / tsx
    rel = np.asarray([
        [rscale * math.cos(rrot), rscale * (-math.sin(rrot)) * arel, 0.0],
        [rscale * math.sin(rrot) / arel, rscale * math.cos(rrot), 0.0],
        [0.0, 0.0, 1.0]])
    a2 = (a1.reshape(2, 3) @ rel).reshape(6)

    if cfg.relative_translation is not None:
        rt = 2 * cfg.translation_range * cfg.relative_translation
        rel_t = rng.uniform(-rt, rt, size=2)
    else:
        rel_t = np.zeros(2)

    # force-translation correction from the affine's corner extremes
    def extremes(theta):
        gx_hi = abs(theta[0]) + abs(theta[1]) + theta[2]
        gx_lo = -abs(theta[0]) - abs(theta[1]) + theta[2]
        gy_hi = abs(theta[3]) + abs(theta[4]) + theta[5]
        gy_lo = -abs(theta[3]) - abs(theta[4]) + theta[5]
        return gx_lo, gx_hi, gy_lo, gy_hi

    gx_lo, gx_hi, gy_lo, gy_hi = extremes(a1)
    ftx = max(gx_hi - 1, 0) + min(gx_lo + 1, 0)
    fty = max(gy_hi - 1, 0) + min(gy_lo + 1, 0)

    cx_t, cy_t = tsx / 2.0, tsy / 2.0
    cx_o, cy_o = osx / 2.0, osy / 2.0

    def to_pixel(theta, add_rel):
        m = theta.reshape(2, 3)
        t_n = m[:, 2] - np.asarray([ftx, fty])
        if add_rel:
            t_n = t_n + rel_t
        m_px = (m[:, :2] * np.asarray([[cx_o], [cy_o]])
                ) @ np.asarray([[1.0 / cx_t, 0.0], [0.0, 1.0 / cy_t]])
        t_px = (t_n + 1.0) * np.asarray([cx_o, cy_o])
        t_full = t_px - m_px @ np.asarray([cx_t, cy_t])
        return m_px, t_full

    m1, t1 = to_pixel(a1, False)
    m2, t2 = to_pixel(a2, True)

    img1 = np.asarray(img1, np.float32)
    img2 = np.asarray(img2, np.float32)
    flow = np.asarray(flow, np.float32)
    if mask is None:
        mask_full = np.ones((oh, ow, 1), np.float32)
    else:
        mask_full = np.broadcast_to(
            np.asarray(mask, np.float32), (oh, ow, 1)).copy()

    # img1's grid is clipped to [-1,1] (clamp semantics) -> replicate border
    packed = np.concatenate([img1, mask_full, flow * mask_full], axis=-1)
    # warped 3 + 3 channels with the same map, as the JAX module does for
    # OpenCV's 4-channel cap
    p1 = _warp(packed[..., :3], m1, t1, (th, tw), REPLICATE)
    p2 = _warp(packed[..., 3:], m1, t1, (th, tw), REPLICATE)
    img1_a = p1
    mask_a = p2[..., 0:1]
    flow_s = p2[..., 1:3] / np.maximum(mask_a, 1e-8)
    img2_a = _warp(img2, m2, t2, (th, tw), ZERO)

    det = m2[0, 0] * m2[1, 1] - m2[0, 1] * m2[1, 0]
    inv2 = np.asarray([[m2[1, 1], -m2[0, 1]], [-m2[1, 0], m2[0, 0]]]) / det

    py, px = np.mgrid[0:th, 0:tw].astype(np.float32)
    f_x = flow_s[..., 1]
    f_y = flow_s[..., 0]
    qx = m1[0, 0] * px + m1[0, 1] * py + t1[0] + f_x
    qy = m1[1, 0] * px + m1[1, 1] * py + t1[1] + f_y
    nx = inv2[0, 0] * (qx - t2[0]) + inv2[0, 1] * (qy - t2[1])
    ny = inv2[1, 0] * (qx - t2[0]) + inv2[1, 1] * (qy - t2[1])
    flow_a = np.stack([ny - py, nx - px], axis=-1).astype(np.float32)

    return img1_a, img2_a, flow_a, mask_a


def batch_host_geometry(rng: np.random.RandomState, img1, img2, flow, mask,
                        cfg: GeometryAugConfig):
    """Batched wrapper over (B, oh, ow, ...) arrays; fresh params per sample."""
    outs = [host_geometry_augmentation(
        rng, img1[i], img2[i], flow[i],
        None if mask is None else mask[i], cfg)
        for i in range(img1.shape[0])]
    return tuple(np.stack([o[k] for o in outs]) for k in range(4))
