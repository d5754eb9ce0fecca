"""Device-side chromatic augmentation (NCHW).

Counterpart of ``maskflownet_tpu/augment/color.py:24-113``
(``ColorAugConfig``, ``_sh_matrix``, ``_eigen_matrix``,
``color_augmentation``), split into :func:`draw_color`, the random draws
from a ``torch.Generator``, and :func:`color_augmentation`, the
deterministic transform. Per batch element, with the same parameters for
both images except the additive noise field, drawn per image: hue and
saturation rotation by a YIQ-derived 3x3 matrix, gaussian noise with one
sigma for the whole batch, mean-preserving contrast and per-channel gain,
a brightness shift, a clip to [0, 1], then the optional gamma
``x ** exp(g)``. The optional eigen-rotation mixes the channels after the
contrast. The per-pixel passes run in the input dtype (bf16 on the train
path) and the per-image means in f32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ColorAugConfig:
    contrast_range: tuple[float, float] = (-0.4, 0.8)
    brightness_sigma: float = 0.1
    channel_range: tuple[float, float] = (0.8, 1.4)
    noise_range: tuple[float, float] = (0.0, 0.04)
    saturation: float = 0.5
    hue: float = 0.5
    gamma_range: tuple[float, float] | None = None
    eigen_aug: bool = False


def _sh_matrix(alpha: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Hue/saturation mixing matrix (augmentation.py:196-200); (B,3,3)."""
    su = alpha * torch.cos(theta)
    sw = alpha * torch.sin(theta)
    rows = [
        [0.299 + 0.701 * su + 0.168 * sw, 0.587 - 0.587 * su + 0.330 * sw,
         0.114 - 0.114 * su - 0.497 * sw],
        [0.299 - 0.299 * su - 0.328 * sw, 0.587 + 0.413 * su + 0.035 * sw,
         0.114 - 0.114 * su + 0.292 * sw],
        [0.299 - 0.300 * su + 1.250 * sw, 0.587 - 0.588 * su - 1.050 * sw,
         0.114 + 0.886 * su - 0.203 * sw],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _eigen_matrix(ang: torch.Tensor) -> torch.Tensor:
    """Channel-space rotation by the angles ``ang`` (B, 3)
    (augmentation.py:203-208); (B,3,3)."""
    c = torch.cos(ang)
    s = torch.sin(ang)
    rows = [
        [c[:, 0] * c[:, 1], s[:, 1] * c[:, 2] + s[:, 0] * c[:, 1] * s[:, 2],
         s[:, 1] * s[:, 2] - s[:, 0] * c[:, 1] * c[:, 2]],
        [-c[:, 0] * s[:, 1], c[:, 1] * c[:, 2] - s[:, 0] * s[:, 1] * s[:, 2],
         c[:, 1] * s[:, 2] + s[:, 0] * s[:, 1] * c[:, 2]],
        [s[:, 0], -c[:, 0] * s[:, 2], c[:, 0] * c[:, 2]],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def draw_color(gen: torch.Generator, b: int, hw: tuple[int, int],
               dtype: torch.dtype, cfg: ColorAugConfig, device
               ) -> dict[str, torch.Tensor | None]:
    """The random draws of one batch of ``b`` image pairs of size ``hw``,
    on ``device``: ``contrast`` (the factor, 1 + a uniform), ``brightness``
    and ``alpha``, ``theta`` (of the hue/saturation matrix), each (b,) f32;
    ``channel`` (b, 3) f32; ``noise_sigma`` () f32, one for the batch;
    ``gamma`` (b,) f32 or None without ``gamma_range``; ``eigen`` (b, 3)
    f32 angles or None without ``eigen_aug``; and ``noise1``/``noise2``,
    one standard normal field (b, 3, h, w) per image in ``dtype``, the
    dtype the transform runs in."""
    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    h, w = hw
    d = {"contrast": uniform(*cfg.contrast_range, (b,)) + 1.0,
         "brightness": cfg.brightness_sigma * torch.randn(
             (b,), generator=gen, device=device),
         "channel": uniform(*cfg.channel_range, (b, 3)),
         "noise_sigma": uniform(*cfg.noise_range, ()),
         "alpha": 1.0 + uniform(-cfg.saturation, cfg.saturation, (b,)),
         "theta": uniform(-cfg.hue * math.pi, cfg.hue * math.pi, (b,)),
         "gamma": (None if cfg.gamma_range is None
                   else uniform(*cfg.gamma_range, (b,))),
         "eigen": (uniform(-math.pi, math.pi, (b, 3)) if cfg.eigen_aug
                   else None)}
    for k in ("noise1", "noise2"):
        d[k] = torch.randn((b, 3, h, w), generator=gen, dtype=dtype,
                           device=device)
    return d


def _mix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per-image channel mix ``y[:, k] = sum_c m[:, k, c] x[:, c]`` in x's
    dtype."""
    return torch.einsum("bchw,bkc->bkhw", x, m.to(x.dtype))


def color_augmentation(img1: torch.Tensor, img2: torch.Tensor,
                       draws: dict[str, torch.Tensor | None],
                       cfg: ColorAugConfig):
    """img1/img2: (B, 3, H, W) in [0, 1], any float dtype; ``draws`` from
    :func:`draw_color` for that size and dtype. Returns the augmented pair
    in the input dtype."""
    d = draws
    sh = _sh_matrix(d["alpha"], d["theta"])
    eig = None if d["eigen"] is None else _eigen_matrix(d["eigen"])
    gain = (d["contrast"][:, None] * d["channel"])[:, :, None, None]
    channel = d["channel"][:, :, None, None]
    brightness = d["brightness"][:, None, None, None]
    out = []
    for x, noise in ((img1, d["noise1"]), (img2, d["noise2"])):
        dt = x.dtype
        x = _mix(x, sh)
        x = x + noise * d["noise_sigma"].to(dt)
        mean = x.mean((2, 3), keepdim=True, dtype=torch.float32).to(dt)
        x = (x - mean) * gain.to(dt)
        if eig is not None:
            x = _mix(x, eig)
        x = x + (mean.float() * channel + brightness).to(dt)
        x = x.clamp(0.0, 1.0)
        if d["gamma"] is not None:
            x = x ** torch.exp(d["gamma"]).to(dt)[:, None, None, None]
        out.append(x)
    return out[0], out[1]
