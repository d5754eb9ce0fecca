"""Synthetic learnable-flow pairs: textured image pairs with exact
ground-truth flow. The port's copy of ``maskflownet_tpu/data/synthetic.py``:
the same ``RandomState`` gives the same arrays.

Real datasets (FlyingChairs/Sintel/...) are not part of the repository, so
the tests and ``chip_smoke.py`` write dataset trees from these pairs: the
flow label is exact by construction and dense texture makes the
correspondence learnable.

Construction (per pair):
  * a rich multi-scale texture ``base`` with margins,
  * a random affine ``T`` (rotation/scale/aspect/translation about the
    image center),
  * ``img1`` = center crop of ``base``,
  * ``img2(q) = base(T^-1(q))`` -- so ``img1(p) = img2(T(p))`` exactly
    (up to bilinear resampling), matching the framework's label
    convention ``img1(p) ~ img2(p + F(p))`` with ``F(p) = T(p) - p``
    in (dy, dx) order,
  * ``valid`` marks pixels whose correspondence lands inside img2.

Flow magnitude is controlled by the affine ranges; defaults give |F| up to
~0.08 * min(H, W) at the borders, comparable to FlyingChairs statistics.
"""

from __future__ import annotations

import numpy as np


def make_texture(rng: np.random.RandomState, h: int, w: int,
                 octaves: int = 10) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1]: sinusoid mixture across octaves plus
    broadband noise -- dense gradients everywhere, no flat regions."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for o in range(octaves):
            freq = 2.0 ** (o % 5) / 64.0
            ky, kx = rng.uniform(-freq, freq, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(0.2, 1.0) / (1 + o % 5) * np.sin(
                2 * np.pi * (ky * yy + kx * xx) + ph)
        img[..., c] = acc
    img += 0.15 * rng.randn(h, w, 1).astype(np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-6)


def _bilinear(base: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Sample base (H, W, C) at float coords (ys, xs) (clipped to edges)."""
    h, w = base.shape[:2]
    ys = np.clip(ys, 0, h - 1.001)
    xs = np.clip(xs, 0, w - 1.001)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    ay = (ys - y0)[..., None]
    ax = (xs - x0)[..., None]
    return ((1 - ay) * (1 - ax) * base[y0, x0]
            + (1 - ay) * ax * base[y0, x0 + 1]
            + ay * (1 - ax) * base[y0 + 1, x0]
            + ay * ax * base[y0 + 1, x0 + 1])


def make_affine_pair(rng: np.random.RandomState, h: int, w: int, *,
                     max_rot: float = 0.12, max_log_scale: float = 0.08,
                     max_trans: float = 0.04):
    """-> (img1, img2, flow, valid): float32 images [0,1], flow (dy, dx),
    valid uint8 {0, 255}. ``max_trans`` is a fraction of min(h, w)."""
    margin = int(0.3 * min(h, w))
    base = make_texture(rng, h + 2 * margin, w + 2 * margin)

    rot = rng.uniform(-max_rot, max_rot)
    sy = np.exp(rng.uniform(-max_log_scale, max_log_scale))
    sx = np.exp(rng.uniform(-max_log_scale, max_log_scale))
    t = rng.uniform(-max_trans, max_trans, 2) * min(h, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    # A maps img1-centered coords -> img2-centered coords (rows, cols)
    A = np.array([[sy * np.cos(rot), -sy * np.sin(rot)],
                  [sx * np.sin(rot), sx * np.cos(rot)]], np.float32)

    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    dy = py - cy
    dx = px - cx
    ty = A[0, 0] * dy + A[0, 1] * dx + cy + t[0]
    tx = A[1, 0] * dy + A[1, 1] * dx + cx + t[1]
    flow = np.stack([ty - py, tx - px], axis=-1).astype(np.float32)

    img1 = base[margin:margin + h, margin:margin + w]
    # img2(q) = base(T^-1(q) + margin)
    Ainv = np.linalg.inv(A)
    sy_ = Ainv[0, 0] * (py - cy - t[0]) + Ainv[0, 1] * (px - cx - t[1]) + cy
    sx_ = Ainv[1, 0] * (py - cy - t[0]) + Ainv[1, 1] * (px - cx - t[1]) + cx
    img2 = _bilinear(base, sy_ + margin, sx_ + margin).astype(np.float32)

    valid = ((ty >= 0) & (ty <= h - 1) & (tx >= 0) & (tx <= w - 1))
    valid = (valid * 255).astype(np.uint8)[..., None]
    return img1.astype(np.float32), img2, flow, valid


def make_dataset(rng: np.random.RandomState, n: int, h: int, w: int,
                 **kwargs):
    """n pairs as parallel lists (img1 u8, img2 u8, flow f32, valid u8) --
    the ``data.loader.Dataset`` column format."""
    img1s, img2s, flows, valids = [], [], [], []
    for _ in range(n):
        i1, i2, fl, va = make_affine_pair(rng, h, w, **kwargs)
        img1s.append((i1 * 255 + 0.5).astype(np.uint8))
        img2s.append((i2 * 255 + 0.5).astype(np.uint8))
        flows.append(fl)
        valids.append(va)
    return img1s, img2s, flows, valids


# ---------------------------------------------------------------------------
# Occluded pairs: foreground objects with independent motion
# ---------------------------------------------------------------------------

def make_occluded_pair(rng: np.random.RandomState, h: int, w: int, *,
                       max_rot: float = 0.08, max_log_scale: float = 0.05,
                       max_trans: float = 0.03, n_objects: int = 2,
                       obj_trans: float = 0.18, obj_rot: float = 0.3,
                       obj_log_scale: float = 0.08):
    """Textured pair with independently-moving foreground objects => real
    occlusion, in the FlyingChairs spirit (the reference's training data is
    exactly renderings of movable objects over moving backgrounds).

    -> (img1, img2, flow, valid, occ):
      * ``flow`` is the full ground-truth flow, *including* occluded pixels
        (their motion is well-defined even though the correspondence is
        invisible in img2 -- the Sintel/Chairs labeling convention). The
        occlusion mask is deliberately NOT fed to the loss: the paper's
        claim is that the gate *learns* occlusion without supervision
        (reference ``MaskFlownet.py:230-233``; paper §3).
      * ``valid`` (u8 {0,255}) marks pixels whose target lands in-frame
        (same convention as :func:`make_affine_pair`).
      * ``occ`` (u8 {0,255}, 255 = occluded) marks in-frame pixels whose
        target point is covered by a *different*, higher-z surface in img2
        -- the evaluation target for an occlusion AUC.

    Objects are rotated ellipses with their own texture, rigid motion
    (rotation up to ``obj_rot`` rad, scale, translation up to
    ``obj_trans * min(h, w)`` px -- large displacements), painted in
    z-order (later = on top) in both frames.
    """
    margin = int(0.35 * min(h, w))
    base = make_texture(rng, h + 2 * margin, w + 2 * margin)

    # ---- background affine (same construction as make_affine_pair)
    rot = rng.uniform(-max_rot, max_rot)
    sy = np.exp(rng.uniform(-max_log_scale, max_log_scale))
    sx = np.exp(rng.uniform(-max_log_scale, max_log_scale))
    t = rng.uniform(-max_trans, max_trans, 2) * min(h, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    A = np.array([[sy * np.cos(rot), -sy * np.sin(rot)],
                  [sx * np.sin(rot), sx * np.cos(rot)]], np.float32)
    Ainv = np.linalg.inv(A)

    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = py - cy, px - cx
    bg_ty = A[0, 0] * dy + A[0, 1] * dx + cy + t[0]
    bg_tx = A[1, 0] * dy + A[1, 1] * dx + cx + t[1]

    img1 = base[margin:margin + h, margin:margin + w].copy()
    sy_ = Ainv[0, 0] * (py - cy - t[0]) + Ainv[0, 1] * (px - cx - t[1]) + cy
    sx_ = Ainv[1, 0] * (py - cy - t[0]) + Ainv[1, 1] * (px - cx - t[1]) + cx
    img2 = _bilinear(base, sy_ + margin, sx_ + margin).astype(np.float32)

    flow_ty, flow_tx = bg_ty.copy(), bg_tx.copy()   # target coords per pixel
    zmap1 = np.zeros((h, w), np.int32)              # 0 = background
    region2s = [None]                               # per z, img2 coverage

    for z in range(1, n_objects + 1):
        # ellipse in img1
        oc = rng.uniform(0.25, 0.75, 2) * [h, w]
        rad = rng.uniform(0.10, 0.22, 2) * min(h, w)
        ang = rng.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)

        def ellipse(yy, xx):
            u = (ca * (yy - oc[0]) + sa * (xx - oc[1])) / rad[0]
            v = (-sa * (yy - oc[0]) + ca * (xx - oc[1])) / rad[1]
            return u * u + v * v <= 1.0

        # rigid object motion about its center
        orot = rng.uniform(-obj_rot, obj_rot)
        osc = np.exp(rng.uniform(-obj_log_scale, obj_log_scale))
        ot = rng.uniform(-obj_trans, obj_trans, 2) * min(h, w)
        oca, osa = osc * np.cos(orot), osc * np.sin(orot)
        M = np.array([[oca, -osa], [osa, oca]], np.float32)
        Minv = np.linalg.inv(M)

        region1 = ellipse(py, px)
        o_ty = M[0, 0] * (py - oc[0]) + M[0, 1] * (px - oc[1]) + oc[0] + ot[0]
        o_tx = M[1, 0] * (py - oc[0]) + M[1, 1] * (px - oc[1]) + oc[1] + ot[1]

        # object texture painted into img1
        otex = make_texture(rng, h + 2 * margin, w + 2 * margin, octaves=8)
        img1[region1] = otex[margin:margin + h, margin:margin + w][region1]
        flow_ty[region1] = o_ty[region1]
        flow_tx[region1] = o_tx[region1]
        zmap1[region1] = z

        # img2 coverage: q with Minv(q) inside the img1 ellipse
        q_sy = Minv[0, 0] * (py - oc[0] - ot[0]) \
            + Minv[0, 1] * (px - oc[1] - ot[1]) + oc[0]
        q_sx = Minv[1, 0] * (py - oc[0] - ot[0]) \
            + Minv[1, 1] * (px - oc[1] - ot[1]) + oc[1]
        region2 = ellipse(q_sy, q_sx)
        img2[region2] = _bilinear(otex, q_sy + margin,
                                  q_sx + margin)[region2]
        region2s.append(region2)

    flow = np.stack([flow_ty - py, flow_tx - px], axis=-1).astype(np.float32)
    valid = ((flow_ty >= 0) & (flow_ty <= h - 1)
             & (flow_tx >= 0) & (flow_tx <= w - 1))

    # occlusion: the target point is covered by a strictly-higher surface
    iy = np.clip(np.rint(flow_ty), 0, h - 1).astype(np.int32)
    ix = np.clip(np.rint(flow_tx), 0, w - 1).astype(np.int32)
    occ = np.zeros((h, w), bool)
    for z in range(1, n_objects + 1):
        covered = region2s[z][iy, ix]
        occ |= covered & (zmap1 < z)
    occ &= valid

    return (img1.astype(np.float32), img2.astype(np.float32), flow,
            (valid * 255).astype(np.uint8)[..., None],
            (occ * 255).astype(np.uint8)[..., None])


def make_occluded_dataset(rng: np.random.RandomState, n: int, h: int, w: int,
                          **kwargs):
    """n occluded pairs as parallel lists (img1 u8, img2 u8, flow f32,
    valid u8, occ u8)."""
    cols = ([], [], [], [], [])
    for _ in range(n):
        i1, i2, fl, va, oc = make_occluded_pair(rng, h, w, **kwargs)
        cols[0].append((i1 * 255 + 0.5).astype(np.uint8))
        cols[1].append((i2 * 255 + 0.5).astype(np.uint8))
        cols[2].append(fl)
        cols[3].append(va)
        cols[4].append(oc)
    return cols
