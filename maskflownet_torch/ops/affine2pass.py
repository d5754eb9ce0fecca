"""Two-pass (Catmull-Smith) affine resampling, NCHW: the port of
``maskflownet_tpu/ops/affine2pass.py::affine_sample_twopass``
(``:140-177``), the TPU's default sampler of geometric augmentation.

An affine map q = M p + t with M = [[a, b], [c, d]] (x row first) is
resampled as two 1-D passes,

    X pass:  t1(x, v) = in(U(x, v), v),  U = (det/d) x + (b/d) (v - ty) + tx
    Y pass: out(x, y) = t1(x, V(x, y)),  V = c x + d y + ty

so that U(x, V(x, y)) = a x + b y + tx. Each pass is one linear
interpolation along one axis with zeros outside the source. The stencil
is the sheared 4-point lattice (along the map's rows, then across them),
not the axis-aligned one of the one-pass bilinear sampler
(``ops/affine.py``): a different function, which agrees with it on
lattice points and under translations.

The JAX function forms each pass out of slab gathers, power-of-two rolls
and a hat-weight product, which exist only for the TPU's gather
descriptors; here each pass is a plain 1-D gather and lerp, which computes
the JAX function's arithmetic: the position ``scale * x + off`` is split
as the JAX function splits it (``floor(off)``, ``floor(scale * x)`` and
the rest) and weighted by the same hat ``max(0, 1 - |s - k|)``, in f32,
applied in the input's dtype. The JAX function takes static bounds on the
pass scales and shears (``augment/geometry.py``'s ``_twopass_bounds``
there), sizes its slabs by them and clips sample positions past them;
inside them it computes this function, which needs no bound. Plain
PyTorch on both devices: no kernel of its own, gradients from autograd.
"""

from __future__ import annotations

import torch


def _resample_last(img: torch.Tensor, scale: torch.Tensor, off: torch.Tensor,
                   out_len: int) -> torch.Tensor:
    """``out[n, c, r, x]`` = ``img[n, c, r, :]`` linearly interpolated at
    ``scale[n] * x + off[n, r]``, zero outside [0, L - 1]: img (N, C, R,
    L), scale (N,), off (N, R) -> (N, C, R, out_len) in img's dtype."""
    n, c, r, length = img.shape
    base = torch.floor(off)                                    # (N, R)
    frac = (off - base)[:, :, None]
    xs = torch.arange(out_len, dtype=torch.float32, device=img.device)
    u = scale[:, None] * xs[None, :]                           # (N, O)
    j0 = torch.floor(u)
    s = (u - j0)[:, None, :] + frac                            # (N, R, O)
    k0 = torch.floor(s)                                        # 0 or 1
    first = base[:, :, None] + j0[:, None, :] + k0
    out = None
    for k in (k0, k0 + 1.0):
        pos = first + (k - k0)
        valid = (pos >= 0) & (pos <= length - 1)
        idx = pos.clamp(0, length - 1).long()
        v = torch.gather(img, 3, idx[:, None].expand(n, c, r, out_len))
        v = torch.where(valid[:, None], v, v.new_zeros(()))
        w = (1.0 - (s - k).abs()).clamp_min(0.0).to(img.dtype)[:, None]
        out = w * v if out is None else out + w * v
    return out


def affine_sample_twopass(img: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                          ho: int, wo: int) -> torch.Tensor:
    """Sample ``img`` (N, C, H, W) at q = m @ p + t for the output pixels
    p = (x, y) of an (ho, wo) grid, zero outside: (N, C, ho, wo) in img's
    dtype. ``m`` (N, 2, 2), x row first; ``t`` (N, 2), (x, y). Both pass
    scales, det(m) / m[1, 1] and m[1, 1], must be positive (rotations of
    less than 90 degrees with positive scales)."""
    h = img.shape[2]
    m = m.float()
    t = t.float()
    a, b = m[:, 0, 0], m[:, 0, 1]
    cc, d = m[:, 1, 0], m[:, 1, 1]
    tx, ty = t[:, 0], t[:, 1]
    det = a * d - b * cc
    # X pass over the H source rows: scale det/d, offset (b/d) v + ...
    v = torch.arange(h, dtype=torch.float32, device=img.device)
    off_x = (b / d)[:, None] * v[None, :] + (tx - b / d * ty)[:, None]
    t1 = _resample_last(img, det / d, off_x, wo)           # (N, C, H, Wo)
    # Y pass over the Wo output columns: scale d, offset c x + ty
    xs = torch.arange(wo, dtype=torch.float32, device=img.device)
    off_y = cc[:, None] * xs[None, :] + ty[:, None]
    out = _resample_last(t1.transpose(2, 3), d, off_y, ho)
    return out.transpose(2, 3)
