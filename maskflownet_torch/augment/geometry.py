"""Device-side geometric augmentation (batched random affines, NCHW).

Counterpart of ``maskflownet_tpu/augment/geometry.py:41-51, 206-404``
(``GeometryAugConfig``, ``geometry_augmentation``), split in two:

* :func:`draw_geometry` makes the random draws of ``:221-281`` from a
  ``torch.Generator``;
* :func:`geometry_augmentation` is the deterministic rest: the crop-fit
  clamp of the zoom, the force-translation correction, the joint sampling
  of ``[img1, mask, flow * mask]`` with the mask renormalisation, the
  sampling of img2 through the relative transform, and the induced
  transform of the flow vectors, ``F'(p) = T2^-1(T1 p + F~(p)) - p``.

``sampler`` picks how the two samplings run (the explicit counterpart of
``MFN_AUG_SAMPLER``; the port reads no environment variable):

* ``"affine"`` (the default, the JAX package's off-TPU gather path):
  ``ops.affine.affine_sample``, the hand-written CUDA kernel on a CUDA
  tensor, the plain version on a CPU tensor, in f32. The JAX package
  bounds the source window each output tile reads (``_pick_sampler``,
  ``:145-203``) only so that its TPU kernel can stage that window in
  VMEM; the CUDA kernel reads its corners from global memory and needs no
  bound.
* ``"twopass"`` (the JAX package's TPU default, ``:330-368``):
  ``ops.affine2pass.affine_sample_twopass``, the images in bf16 and the
  labels (mask, flow * mask) in ``label_dtype``, f16 unless f32 is asked
  for (the counterpart of ``MFN_AUG_LABEL_DTYPE``). Its sheared stencil is
  another function than the bilinear one: the TPU's augmented batches. A
  config whose rotations pass ``_TWOPASS_MAX_ANGLE_RAD``, where the JAX
  package's static two-pass bounds stop being sound, takes ``"affine"``,
  as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from maskflownet_torch.ops.affine import affine_sample
from maskflownet_torch.ops.affine2pass import affine_sample_twopass
from maskflownet_torch.ops.warp import affine_grid, normalized_to_pixels


@dataclasses.dataclass(frozen=True)
class GeometryAugConfig:
    angle_range: tuple[float, float] = (-17.0, 17.0)  # degrees
    zoom_range: tuple[float, float] = (1 / 1.5, 1 / 0.9)
    aspect_range: tuple[float, float] | None = (0.9, 1 / 0.9)
    translation_range: float = 0.1
    target_shape: tuple[int, int] = (320, 448)  # (H, W)
    orig_shape: tuple[int, int] = (384, 512)
    relative_angle: float | None = 0.25
    relative_scale: tuple[float, float] = (0.96, 1 / 0.96)
    relative_translation: float | None = 0.25


#: Largest total rotation (radians) for which the static two-pass bounds
#: are sound: cos stays >= cos(1.2) ~ 0.362, so the Y pass's scale d =
#: s*cos stays positive and the 1/cos factors bounded (``:81-84``)
_TWOPASS_MAX_ANGLE_RAD = 1.2
SAMPLERS = ("affine", "twopass")


def _twopass_total_angle(cfg: GeometryAugConfig) -> float:
    ang = max(abs(cfg.angle_range[0]), abs(cfg.angle_range[1]))
    if cfg.relative_angle is not None:
        ang *= (1.0 + cfg.relative_angle)
    return ang * math.pi / 180.0


def _twopass_fits(cfg: GeometryAugConfig) -> bool:
    """Whether ``cfg``'s rotations stay within ``_TWOPASS_MAX_ANGLE_RAD``,
    where the JAX package's ``_twopass_bounds`` (``:95-143``) returns
    bounds and its sampler runs two-pass."""
    return _twopass_total_angle(cfg) <= _TWOPASS_MAX_ANGLE_RAD


def _uniform(gen, lo, hi, shape, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def draw_geometry(gen: torch.Generator, b: int, cfg: GeometryAugConfig,
                  device) -> dict[str, torch.Tensor]:
    """The random draws of one batch of ``b``, all f32 on ``device``:
    ``rot`` (radians), ``aspect``, ``scale`` (before the crop-fit clamp),
    the translation uniforms ``tx_unit``/``ty_unit`` in [-1, 1] and
    ``tx_shift``/``ty_shift`` in +-2 ``translation_range``, ``rrot`` and
    ``rscale`` of the relative transform, each (b,), and ``rel_t`` (b, 2),
    the relative translation (x, y) in normalized units. Disabled ranges
    give the identity (ones, zeros)."""
    deg = math.pi / 180.0
    dev = torch.device(device)
    ones = torch.ones((b,), device=dev)
    tr = 2 * cfg.translation_range
    d = {"rot": _uniform(gen, cfg.angle_range[0] * deg,
                         cfg.angle_range[1] * deg, (b,), dev),
         "aspect": (ones if cfg.aspect_range is None else
                    _uniform(gen, *cfg.aspect_range, (b,), dev)),
         "scale": _uniform(gen, *cfg.zoom_range, (b,), dev),
         "tx_unit": _uniform(gen, -1.0, 1.0, (b,), dev),
         "tx_shift": _uniform(gen, -tr, tr, (b,), dev),
         "ty_unit": _uniform(gen, -1.0, 1.0, (b,), dev),
         "ty_shift": _uniform(gen, -tr, tr, (b,), dev)}
    if cfg.relative_angle is not None:
        ra = cfg.relative_angle * deg
        d["rrot"] = _uniform(gen, cfg.angle_range[0] * ra,
                             cfg.angle_range[1] * ra, (b,), dev)
        d["rscale"] = _uniform(gen, *cfg.relative_scale, (b,), dev)
    else:
        d["rrot"], d["rscale"] = torch.zeros_like(ones), ones
    if cfg.relative_translation is not None:
        rt = tr * cfg.relative_translation
        d["rel_t"] = _uniform(gen, -rt, rt, (b, 2), dev)
    else:
        d["rel_t"] = torch.zeros((b, 2), device=dev)
    return d


def _maps(d: dict[str, torch.Tensor], cfg: GeometryAugConfig):
    """From the draws: the normalized sampling grids of img1 (and labels)
    and of img2, ``(g1x, g1y, g2x, g2y)`` each (B, th, tw), and the pixel
    maps ``q = m p + t`` of both, ``(m1, t1, m2, t2)``, m (B, 2, 2) and t
    (B, 2) in (x, y) order (``geometry.py:231-327``)."""
    th, tw = cfg.target_shape
    oh, ow = cfg.orig_shape
    rot, aspect = d["rot"], d["aspect"]
    b = rot.shape[0]
    osy, osx = oh - 1.0, ow - 1.0
    tsy, tsx = th - 1.0, tw - 1.0
    ar = rot.abs()
    # clamp so that the rotated crop fits inside the source
    scale = torch.minimum(d["scale"], osx / (aspect * (
        tsy * torch.sin(ar) + tsx * torch.cos(ar))))
    scale = torch.minimum(scale, osy / (tsy * torch.cos(ar)
                                        + tsx * torch.sin(ar)))
    unit_xx, unit_yx = tsx / osx, tsy / osx
    unit_xy, unit_yy = tsx / osy, tsy / osy
    tx = d["tx_unit"] * (1 - scale * unit_xx) + d["tx_shift"]
    ty = d["ty_unit"] * (1 - scale * unit_yy) + d["ty_shift"]
    cos, sin = torch.cos(rot), torch.sin(rot)
    # normalized rows [a, b, tx, c, d, ty]
    a1 = torch.stack([scale * aspect * cos * unit_xx,
                      scale * aspect * (-sin) * unit_yx, tx,
                      scale * sin * unit_xy, scale * cos * unit_yy, ty], 1)
    # the relative transform of img2: a2 = a1 (2x3) @ rel (3x3)
    rrot, rscale = d["rrot"], d["rscale"]
    arel = tsy / tsx
    zero, one = torch.zeros_like(rrot), torch.ones_like(rrot)
    rel = torch.stack([
        rscale * torch.cos(rrot), rscale * (-torch.sin(rrot)) * arel, zero,
        rscale * torch.sin(rrot) / arel, rscale * torch.cos(rrot), zero,
        zero, zero, one], 1).reshape(b, 3, 3)
    a2 = torch.matmul(a1.reshape(b, 2, 3), rel).reshape(b, 6)
    rel_t = d["rel_t"]

    # grids, with the force-translation correction of img1's grid
    g1x, g1y = affine_grid(a1, th, tw)
    ftx = ((g1x.amax((1, 2)) - 1).clamp_min(0)
           + (g1x.amin((1, 2)) + 1).clamp_max(0))
    fty = ((g1y.amax((1, 2)) - 1).clamp_min(0)
           + (g1y.amin((1, 2)) + 1).clamp_max(0))
    g1x = (g1x - ftx[:, None, None]).clamp(-1, 1)
    g1y = (g1y - fty[:, None, None]).clamp(-1, 1)
    g2x, g2y = affine_grid(a2, th, tw)
    g2x = g2x - ftx[:, None, None] + rel_t[:, 0, None, None]
    g2y = g2y - fty[:, None, None] + rel_t[:, 1, None, None]

    # pixel-space maps q = m p + t of both grids, (x, y) order: rows
    # scaled by the source's centre, columns by 1 / the target's (Python
    # scalars: a tensor made from a list would wait for the device)
    ft = torch.stack([ftx, fty], 1)
    c_t, c_o = (tsx / 2.0, tsy / 2.0), (osx / 2.0, osy / 2.0)

    def to_pixel(theta, t_n):
        m = theta.reshape(b, 2, 3)
        rows = torch.stack([m[:, 0, :2] * c_o[0], m[:, 1, :2] * c_o[1]], 1)
        m_px = torch.stack([rows[:, :, 0] * (1.0 / c_t[0]),
                            rows[:, :, 1] * (1.0 / c_t[1])], 2)
        t_px = torch.stack([(t_n[:, 0] + 1.0) * c_o[0],
                            (t_n[:, 1] + 1.0) * c_o[1]], 1)
        return m_px, t_px - (m_px[:, :, 0] * c_t[0] + m_px[:, :, 1] * c_t[1])

    m1, t1 = to_pixel(a1, a1[:, 2::3] - ft)
    m2, t2 = to_pixel(a2, a2[:, 2::3] - ft + rel_t)
    return (g1x, g1y, g2x, g2y), (m1, t1, m2, t2)


def sample_grids(draws: dict[str, torch.Tensor], cfg: GeometryAugConfig):
    """The normalized source grids of the two samplings, ``((g1x, g1y),
    (g2x, g2y))``, each (B, th, tw) f32: img1 with the labels, then img2
    (``ops.warp.normalized_to_pixels`` gives their absolute
    coordinates)."""
    (g1x, g1y, g2x, g2y), _ = _maps(draws, cfg)
    return (g1x, g1y), (g2x, g2y)


def geometry_augmentation(img1: torch.Tensor, img2: torch.Tensor,
                          flow: torch.Tensor, mask: torch.Tensor,
                          draws: dict[str, torch.Tensor],
                          cfg: GeometryAugConfig, image_dtype=None,
                          sampler: str = "affine",
                          label_dtype: torch.dtype = torch.float16):
    """img1/img2: (B, 3, oh, ow); flow: (B, 2, oh, ow) (dy, dx) source
    pixels; mask: (B, 1, oh, ow) in [0, 1], or broadcastable to it;
    ``draws`` from :func:`draw_geometry`. Returns ``(img1, img2, flow,
    mask)`` at ``cfg.target_shape``: the images in ``image_dtype`` (f32 by
    default), flow (B, 2, th, tw) and mask (B, 1, th, tw) in f32.
    ``sampler``: ``"affine"`` or ``"twopass"``, whose labels are sampled
    in ``label_dtype`` (f16 or f32)."""
    b, _, oh, ow = img1.shape
    th, tw = cfg.target_shape
    if (oh, ow) != tuple(cfg.orig_shape):
        raise ValueError(f"geometry_augmentation: images are {(oh, ow)}, "
                         f"the config expects {tuple(cfg.orig_shape)}")
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: expected one of {SAMPLERS}")
    if label_dtype not in (torch.float16, torch.float32):
        raise ValueError(f"label_dtype {label_dtype}: f16 or f32")
    (g1x, g1y, g2x, g2y), (m1, t1, m2, t2) = _maps(draws, cfg)
    out_dt = image_dtype or torch.float32
    mask_b = mask.float().expand(b, 1, oh, ow)
    if sampler == "twopass" and _twopass_fits(cfg):
        # the images in bf16 through one call, the labels in label_dtype
        imgs_a = affine_sample_twopass(
            torch.cat([img1, img2], 0).to(torch.bfloat16),
            torch.cat([m1, m2], 0), torch.cat([t1, t2], 0), th, tw)
        img1_a = imgs_a[:b].to(out_dt)
        img2_a = imgs_a[b:].to(out_dt)
        lab = torch.cat([mask_b, flow.float() * mask_b], 1).to(label_dtype)
        packed = affine_sample_twopass(lab, m1, t1, th, tw).float()
        mask_a, flow_s = packed[:, 0:1], packed[:, 1:3]
    else:
        # joint sampling of img1 / mask / flow*mask, then img2
        packed = torch.cat([img1.float(), mask_b, flow.float() * mask_b], 1)
        packed = affine_sample(packed,
                               *normalized_to_pixels(g1x, g1y, oh, ow))
        img2_a = affine_sample(img2.contiguous(),
                               *normalized_to_pixels(g2x, g2y, oh, ow))
        img1_a = packed[:, 0:3].to(out_dt)
        img2_a = img2_a.to(out_dt)
        mask_a, flow_s = packed[:, 3:4], packed[:, 4:6]
    flow_s = flow_s / mask_a.clamp_min(1e-8)                  # (dy, dx)

    # the induced flow-vector transform: F'(p) = T2^-1 (T1 p + F~) - p
    det = m2[:, 0, 0] * m2[:, 1, 1] - m2[:, 0, 1] * m2[:, 1, 0]
    inv2 = torch.stack([torch.stack([m2[:, 1, 1], -m2[:, 0, 1]], 1),
                        torch.stack([-m2[:, 1, 0], m2[:, 0, 0]], 1)],
                       1) / det[:, None, None]
    py = torch.arange(th, dtype=torch.float32, device=img1.device)[:, None]
    px = torch.arange(tw, dtype=torch.float32, device=img1.device)[None, :]

    def per(v):
        return v[:, None, None]

    qx = per(m1[:, 0, 0]) * px + per(m1[:, 0, 1]) * py + per(t1[:, 0]) \
        + flow_s[:, 1] - per(t2[:, 0])
    qy = per(m1[:, 1, 0]) * px + per(m1[:, 1, 1]) * py + per(t1[:, 1]) \
        + flow_s[:, 0] - per(t2[:, 1])
    new_x = per(inv2[:, 0, 0]) * qx + per(inv2[:, 0, 1]) * qy
    new_y = per(inv2[:, 1, 0]) * qx + per(inv2[:, 1, 1]) * qy
    flow_a = torch.stack([new_y - py, new_x - px], 1)          # (dy, dx)
    return img1_a, img2_a, flow_a, mask_a
