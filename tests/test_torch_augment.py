"""The port's augmentation against the JAX package's, on the CPU.

The JAX functions draw from a ``jax.random`` key; the port splits each
augmentation into a draw from a ``torch.Generator`` and a deterministic
transform. Each test replays the JAX draws of one key, computed exactly as
``augment/geometry.py:221-281`` and ``augment/color.py:74-100`` compute
them, into the port's transform, and holds the result against the JAX
function on that key. Off the TPU the JAX geometry samples through
``grid_sample_normalized`` (its gather path), which the port's
``affine_sample_plain`` repeats.

Tolerances: f32 geometry 1e-5 on images and mask (sampling coordinates
that differ in the last bit of a pixel coordinate move a sample by ~1e-6
of the local image slope) and 1e-4 px on the flow where the mask is
solidly inside (the flow is the difference of two pixel coordinates of up
to ~100, each with an f32 ulp of ~8e-6); f32 colour 1e-6; bf16 colour two
bf16 ulps (rtol 8e-3, and atol 2^-7, two ulps of values in [0.5, 1)).
The windowed Pallas sampler rounds image channels to bf16 (6e-3) and holds
its precise channels to 1e-4.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskflownet_tpu.augment import ColorAugConfig as JaxColorCfg
from maskflownet_tpu.augment import GeometryAugConfig as JaxGeoCfg
from maskflownet_tpu.augment import color_augmentation as jax_color
from maskflownet_tpu.augment import geometry_augmentation as jax_geometry
from maskflownet_tpu.augment.geometry import _pick_sampler
from maskflownet_tpu.augment.geometry import \
    _twopass_bounds as jax_twopass_bounds
from maskflownet_tpu.config import presets as jax_presets
from maskflownet_tpu.ops.affine2pass import \
    affine_sample_twopass as jax_twopass
from maskflownet_tpu.ops.warp import affine_grid as jax_affine_grid
from maskflownet_tpu.ops.warp import \
    grid_sample_normalized as jax_grid_sample
from maskflownet_tpu.training.engine import centralize as jax_centralize
from maskflownet_torch.augment import (ColorAugConfig, GeometryAugConfig,
                                       color_augmentation, draw_color,
                                       draw_geometry, geometry_augmentation)
from maskflownet_torch.augment.geometry import (_TWOPASS_MAX_ANGLE_RAD,
                                                _maps, _twopass_fits,
                                                _twopass_total_angle,
                                                sample_grids)
from maskflownet_torch.config import presets
from maskflownet_torch.ops.affine import affine_sample, affine_sample_plain
from maskflownet_torch.ops.affine2pass import affine_sample_twopass
from maskflownet_torch.ops.warp import (affine_grid, backwarp,
                                        normalized_to_pixels)
from maskflownet_torch.training import TrainSettings, Trainer

BF16_TOL = dict(rtol=8e-3, atol=2 ** -7)


def _nchw(x):
    return torch.tensor(np.asarray(jnp.asarray(x, jnp.float32)).transpose(
        0, 3, 1, 2))


def _nhwc(x: torch.Tensor):
    return jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1))


def _smooth(rng, shape, lo=0.0, hi=1.0, factor=8):
    """An NHWC f32 field with the slopes of a photograph rather than of
    white noise: a random field ``factor`` times coarser, upsampled
    bilinearly, spanning about [lo, hi]."""
    b, h, w, c = shape
    coarse = torch.from_numpy(rng.rand(b, c, h // factor + 2,
                                       w // factor + 2).astype(np.float32))
    up = torch.nn.functional.interpolate(
        coarse, size=(h + 2 * factor, w + 2 * factor), mode="bilinear",
        align_corners=False)[:, :, factor:factor + h, factor:factor + w]
    return np.ascontiguousarray(
        (lo + (hi - lo) * up).numpy().transpose(0, 2, 3, 1))


def _port_cfg(cls, jax_cfg):
    return cls(**dataclasses.asdict(jax_cfg))


def _jax_geometry_draws(key, b, cfg):
    """The draws of ``geometry.py:221-281`` for ``key``, in the port's
    names."""
    ks = jax.random.split(key, 10)
    deg = math.pi / 180.0

    def u(k, lo, hi, shape=(b,)):
        return jax.random.uniform(k, shape, jnp.float32, lo, hi)

    tr2 = (-2 * cfg.translation_range, 2 * cfg.translation_range)
    d = dict(rot=u(ks[0], cfg.angle_range[0] * deg, cfg.angle_range[1] * deg),
             aspect=(u(ks[1], *cfg.aspect_range) if cfg.aspect_range
                     else jnp.ones((b,))),
             scale=u(ks[2], *cfg.zoom_range),
             tx_unit=u(ks[3], -1, 1), tx_shift=u(ks[4], *tr2),
             ty_unit=u(ks[5], -1, 1), ty_shift=u(ks[6], *tr2))
    if cfg.relative_angle is not None:
        d["rrot"] = u(ks[7], cfg.angle_range[0] * deg * cfg.relative_angle,
                      cfg.angle_range[1] * deg * cfg.relative_angle)
        d["rscale"] = u(ks[8], *cfg.relative_scale)
    else:
        d["rrot"], d["rscale"] = jnp.zeros((b,)), jnp.ones((b,))
    if cfg.relative_translation is not None:
        rt = 2 * cfg.translation_range * cfg.relative_translation
        d["rel_t"] = u(ks[9], -rt, rt, (b, 2))
    else:
        d["rel_t"] = jnp.zeros((b, 2))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in
            d.items()}


def _jax_color_draws(key, b, hw, dtype, cfg):
    """The draws of ``color.py:74-100`` for ``key``, in the port's names;
    the noise fields in ``dtype``, NCHW."""
    ks = jax.random.split(key, 9)

    def u(k, shape, lo, hi):
        return jax.random.uniform(k, shape, jnp.float32, lo, hi)

    d = dict(contrast=u(ks[0], (b,), *cfg.contrast_range) + 1.0,
             brightness=jax.random.normal(ks[1], (b,), jnp.float32)
             * cfg.brightness_sigma,
             channel=u(ks[2], (b, 3), *cfg.channel_range),
             noise_sigma=u(ks[3], (), *cfg.noise_range),
             alpha=1.0 + u(ks[4], (b,), -cfg.saturation, cfg.saturation),
             theta=u(ks[5], (b,), -cfg.hue * math.pi, cfg.hue * math.pi),
             gamma=(u(ks[6], (b,), *cfg.gamma_range)
                    if cfg.gamma_range is not None else None),
             eigen=u(ks[7], (b, 3), -math.pi, math.pi) if cfg.eigen_aug
             else None)
    d = {k: None if v is None else torch.tensor(np.asarray(v))
         for k, v in d.items()}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for name, nk in zip(("noise1", "noise2"), jax.random.split(ks[8], 2)):
        noise = jax.random.normal(nk, (b,) + tuple(hw) + (3,), jdt)
        d[name] = _nchw(noise).to(dtype)
    return d


def _assert_geometry_close(got, ref, image_tol):
    """got: the port's NCHW tuple; ref: the JAX NHWC tuple."""
    for name, g, r in (("img1", got[0], ref[0]), ("img2", got[1], ref[1]),
                       ("mask", got[3], ref[3])):
        np.testing.assert_allclose(g.float().numpy(), _nchw(r).numpy(),
                                   err_msg=name, **image_tol)
    m = np.asarray(ref[3])[..., 0] > 0.99
    assert m.mean() > 0.3
    err = np.abs(got[2].numpy() - _nchw(ref[2]).numpy()).transpose(
        0, 2, 3, 1)[m]
    assert err.max() < 1e-4, err.max()


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaves_image", [False, True])
def test_affine_grid_and_grid_sample_match_jax(leaves_image):
    """``affine_grid`` against JAX's, and ``affine_sample_plain`` at its
    pixel coordinates against JAX's ``grid_sample_normalized`` on the same
    grid: one grid inside the image, one with points outside it, which
    sample zero padding."""
    rng = np.random.RandomState(0)
    if leaves_image:
        theta = rng.uniform(-1.5, 1.5, (2, 6)).astype(np.float32)
    else:            # |a| + |b| + |t| <= 1 keeps every point inside
        theta = rng.uniform(-0.45, 0.45, (2, 6)).astype(np.float32)
        theta[:, [2, 5]] *= 0.2
    img = rng.rand(2, 3, 12, 20).astype(np.float32)
    gx, gy = affine_grid(torch.from_numpy(theta), 9, 13)
    jgx, jgy = jax_affine_grid(jnp.asarray(theta), 9, 13)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), atol=1e-6)
    outside = torch.maximum(gx.abs(), gy.abs()) > 1
    if leaves_image:
        assert outside.float().mean() > 0.2
    else:
        assert not outside.any()
    # both samplers on the same grid
    got = affine_sample_plain(torch.from_numpy(img), *normalized_to_pixels(
        torch.from_numpy(np.array(jgx)), torch.from_numpy(np.array(jgy)),
        12, 20))
    ref = jax_grid_sample(_nhwc(torch.from_numpy(img)), jgx, jgy)
    np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), atol=1e-6)


@pytest.mark.parametrize("precise_ch", [3, 0])
def test_affine_sample_plain_matches_windowed_pallas(monkeypatch, precise_ch):
    """``affine_sample_plain`` against the TPU kernel run in interpret mode,
    through the window ``_pick_sampler`` derives for the config: the packed
    img1 + labels launch (``precise_ch=3``) and the img2 launch."""
    b, oh, ow, th, tw = 2, 48, 64, 40, 48
    jcfg = JaxGeoCfg(target_shape=(th, tw), orig_shape=(oh, ow))
    monkeypatch.setenv("MFN_AUG_SAMPLER", "pallas")
    sampler = _pick_sampler(jcfg, (oh, ow), (th, tw))
    assert sampler is not None
    rng = np.random.RandomState(11)
    c = 3 + precise_ch
    img = rng.rand(b, c, oh, ow).astype(np.float32)
    if precise_ch:
        img[:, 4:] = 3 * rng.randn(b, 2, oh, ow)             # flow * mask
    draws = draw_geometry(torch.Generator().manual_seed(5), b,
                          _port_cfg(GeometryAugConfig, jcfg), "cpu")
    grids = sample_grids(draws, _port_cfg(GeometryAugConfig, jcfg))
    gx, gy = grids[0] if precise_ch else grids[1]
    got = affine_sample_plain(torch.from_numpy(img),
                              *normalized_to_pixels(gx, gy, oh, ow)).numpy()
    ref = _nchw(sampler(_nhwc(torch.from_numpy(img)), jnp.asarray(gx.numpy()),
                        jnp.asarray(gy.numpy()), precise_ch)).numpy()
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=6e-3)
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], atol=1e-4)


def test_affine_sample_on_the_cpu_takes_the_plain_version():
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.rand(1, 2, 5, 9).astype(np.float32))
    sy = torch.from_numpy(rng.uniform(-2, 7, (1, 4, 6)).astype(np.float32))
    sx = torch.from_numpy(rng.uniform(-2, 11, (1, 4, 6)).astype(np.float32))
    before = affine_sample.launches
    got = affine_sample(img.bfloat16(), sy, sx)
    assert affine_sample.launches == before
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, affine_sample_plain(img.bfloat16(), sy,
                                                        sx), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sy/sx"):
        affine_sample(img, sy, sx[:, :3])
    with pytest.raises(ValueError, match="NCHW"):
        affine_sample(img[0], sy, sx)
    with pytest.raises(ValueError, match="no path"):
        affine_sample(img.to("meta"), sy.to("meta"), sx.to("meta"))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

B, OH, OW, TH, TW = 2, 96, 128, 64, 64


@pytest.mark.parametrize("relative", [False, True])
def test_geometry_matches_jax(monkeypatch, relative):
    monkeypatch.delenv("MFN_AUG_SAMPLER", raising=False)
    rng = np.random.RandomState(7)
    jcfg = JaxGeoCfg(target_shape=(TH, TW), orig_shape=(OH, OW))
    if not relative:
        jcfg = dataclasses.replace(jcfg, relative_angle=None,
                                   relative_translation=None)
    img1 = _smooth(rng, (B, OH, OW, 3))
    img2 = _smooth(rng, (B, OH, OW, 3))
    flow = _smooth(rng, (B, OH, OW, 2), -10, 10)
    mask = np.clip(_smooth(rng, (B, OH, OW, 1), -0.5, 2.5), 0, 1)
    key = jax.random.PRNGKey(3)
    ref = jax_geometry(key, *map(jnp.asarray, (img1, img2, flow, mask)), jcfg)
    got = geometry_augmentation(
        *(_nchw(x) for x in (img1, img2, flow, mask)),
        _jax_geometry_draws(key, B, jcfg), _port_cfg(GeometryAugConfig, jcfg))
    assert [tuple(t.shape) for t in got] == [
        (B, 3, TH, TW), (B, 3, TH, TW), (B, 2, TH, TW), (B, 1, TH, TW)]
    _assert_geometry_close(got, ref, dict(atol=1e-5, rtol=0))


def _affine_pair(rng, oh, ow, max_disp=6.0):
    """img2 is img1 moved by a constant fractional flow (dy, dx), on a
    smooth image (``tests/test_augment.py``'s construction); NHWC."""
    yy_, xx_ = np.mgrid[0:oh + 40, 0:ow + 40].astype(np.float32)
    base = np.zeros((oh + 40, ow + 40, 3), np.float32)
    for c in range(3):
        for _ in range(6):
            ky, kx = rng.uniform(-1 / 24, 1 / 24, 2)
            base[..., c] += rng.uniform(0.05, 0.15) * np.sin(
                2 * np.pi * (ky * yy_ + kx * xx_) + rng.uniform(0, 2 * np.pi))
    base = (base - base.min()) / (base.max() - base.min())
    dy, dx = rng.uniform(-max_disp, max_disp, 2)
    y0 = np.floor(np.arange(oh) + 20 - dy).astype(int)
    x0 = np.floor(np.arange(ow) + 20 - dx).astype(int)
    ay = (np.arange(oh) + 20 - dy - y0)[:, None, None]
    ax = (np.arange(ow) + 20 - dx - x0)[None, :, None]
    img2 = ((1 - ay) * (1 - ax) * base[y0][:, x0]
            + (1 - ay) * ax * base[y0][:, x0 + 1]
            + ay * (1 - ax) * base[y0 + 1][:, x0]
            + ay * ax * base[y0 + 1][:, x0 + 1])
    flow = np.broadcast_to(np.float32([dy, dx]), (oh, ow, 2))
    return base[20:20 + oh, 20:20 + ow], img2.astype(np.float32), flow


def test_geometry_consistency_property():
    """On the port's own draws: warping the augmented img2 by the augmented
    flow reproduces the augmented img1 on valid pixels
    (``tests/test_augment.py:49-79``)."""
    rng = np.random.RandomState(42)
    th, tw = 64, 96
    imgs1, imgs2, flows = zip(*[_affine_pair(rng, OH, OW) for _ in range(4)])
    cfg = GeometryAugConfig(target_shape=(th, tw), orig_shape=(OH, OW))
    draws = draw_geometry(torch.Generator().manual_seed(3), 4, cfg, "cpu")
    i1a, i2a, fa, ma = geometry_augmentation(
        _nchw(np.stack(imgs1)), _nchw(np.stack(imgs2)),
        _nchw(np.stack(flows)), torch.ones((4, 1, 1, 1)), draws, cfg)
    rewarped = backwarp(i2a, fa).numpy()
    i1a, fa, ma = i1a.numpy(), fa.numpy(), ma.numpy()
    py, px = np.mgrid[0:th, 0:tw]
    ty, tx = py[None] + fa[:, 0], px[None] + fa[:, 1]
    inb = (ty >= 1) & (ty <= th - 2) & (tx >= 1) & (tx <= tw - 2)
    valid = (ma[:, 0] > 0.999) & inb
    valid[:, :2] = valid[:, -2:] = valid[:, :, :2] = valid[:, :, -2:] = False
    assert valid.mean() > 0.4
    err = np.abs(rewarped - i1a).transpose(0, 2, 3, 1)[valid]
    assert err.mean() < 0.02, err.mean()
    assert np.quantile(err, 0.95) < 0.06


def test_draws_follow_the_config():
    """The port's own draws: ranges, the moments of a uniform, and the
    identity where a range is off."""
    cfg = presets.geometry_aug_config("chairs", (320, 448), (384, 512))
    gen = torch.Generator().manual_seed(0)
    d = draw_geometry(gen, 20000, cfg, "cpu")
    deg = math.pi / 180
    for name, (lo, hi) in (("rot", (-17 * deg, 17 * deg)),
                           ("scale", cfg.zoom_range),
                           ("tx_shift", (-0.2, 0.2)), ("rscale",
                                                       cfg.relative_scale)):
        v = d[name]
        assert lo <= v.min() and v.max() <= hi, name
        assert abs(v.mean() - (lo + hi) / 2) < 0.02 * (hi - lo), name
        assert abs(v.var() - (hi - lo) ** 2 / 12) < 0.03 * (hi - lo) ** 2 / 12
    assert d["rel_t"].shape == (20000, 2) and d["rel_t"].abs().max() <= 0.05
    off = draw_geometry(gen, 3, dataclasses.replace(
        cfg, aspect_range=None, relative_angle=None,
        relative_translation=None), "cpu")
    assert (off["aspect"] == 1).all() and (off["rscale"] == 1).all()
    assert (off["rrot"] == 0).all() and (off["rel_t"] == 0).all()
    c = draw_color(gen, 20000, (2, 3), torch.bfloat16,
                   presets.color_aug_config("kitti"), "cpu")
    assert c["noise_sigma"].shape == () and c["noise1"].dtype == torch.bfloat16
    assert c["noise1"].shape == (20000, 3, 2, 3) and c["eigen"] is None
    assert abs(c["brightness"].std() - 0.05) < 0.002
    assert -0.5 <= c["gamma"].min() and c["gamma"].max() <= 0.5


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset,dtype,eigen", [
    ("chairs", torch.float32, False), ("chairs", torch.bfloat16, False),
    ("kitti", torch.float32, True), ("kitti", torch.bfloat16, True)])
def test_color_matches_jax(dataset, dtype, eigen):
    rng = np.random.RandomState(1)
    jcfg = dataclasses.replace(jax_presets.color_aug_config(dataset),
                               eigen_aug=eigen)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    img1 = rng.rand(B, TH, TW, 3).astype(np.float32)
    img2 = rng.rand(B, TH, TW, 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jax_color(key, jnp.asarray(img1, jdt), jnp.asarray(img2, jdt), jcfg)
    draws = _jax_color_draws(key, B, (TH, TW), dtype, jcfg)
    got = color_augmentation(_nchw(img1).to(dtype), _nchw(img2).to(dtype),
                             draws, _port_cfg(ColorAugConfig, jcfg))
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        g, r = g.float(), _nchw(r)
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(g.numpy(), r.numpy(), **BF16_TOL)
            continue
        if draws["gamma"] is not None:
            # x ** p with p = exp(gamma) in [0.61, 1.65] multiplies the
            # relative error of x by p, without bound as x -> 0: compare
            # where the rest of the chain ends, before the power
            inv = torch.exp(-draws["gamma"])[:, None, None, None]
            g, r = g ** inv, r ** inv
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dataset", ["chairs", "sintel", "kitti", "things3d"])
def test_presets_match_jax(dataset):
    assert presets.BATCH_SIZE == jax_presets.BATCH_SIZE
    assert presets.ORIG_SHAPE == jax_presets.ORIG_SHAPE
    assert dataclasses.asdict(presets.color_aug_config(dataset)) == \
        dataclasses.asdict(jax_presets.color_aug_config(dataset))
    shapes = ((320, 448), presets.ORIG_SHAPE[dataset])
    assert dataclasses.asdict(presets.geometry_aug_config(dataset, *shapes)) \
        == dataclasses.asdict(jax_presets.geometry_aug_config(dataset,
                                                              *shapes))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the two-pass sampler (the JAX package's TPU default)
# ---------------------------------------------------------------------------

def _twopass_case(seed, relative=True):
    """Smooth f32 inputs at (OH, OW), the JAX config and a key."""
    rng = np.random.RandomState(seed)
    jcfg = JaxGeoCfg(target_shape=(TH, TW), orig_shape=(OH, OW))
    if not relative:
        jcfg = dataclasses.replace(jcfg, relative_angle=None,
                                   relative_translation=None)
    inputs = (_smooth(rng, (B, OH, OW, 3)), _smooth(rng, (B, OH, OW, 3)),
              _smooth(rng, (B, OH, OW, 2), -10, 10),
              np.clip(_smooth(rng, (B, OH, OW, 1), -0.5, 2.5), 0, 1))
    return inputs, jcfg, jax.random.PRNGKey(seed)


# the jitted JAX function keeps its half-precision intermediates in f32,
# the port rounds each op: two ulps of values in [0.5, 1)
TWOPASS_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7, "float16": 2 ** -10}


@pytest.mark.parametrize("dtype", list(TWOPASS_TOL))
def test_affine_sample_twopass_matches_jax(dtype):
    """At the pixel maps of a draw of the chairs-like config, the JAX
    function run inside the bounds its ``_twopass_bounds`` gives the config
    (its domain; the port's function takes none), on images in [0, 1): f32 within 1e-5 of the largest value, half precision
    within two ulps (``TWOPASS_TOL``)."""
    (img1, _, _, _), jcfg, key = _twopass_case(21)
    cfg = _port_cfg(GeometryAugConfig, jcfg)
    _, (m1, t1, m2, t2) = _maps(_jax_geometry_draws(key, B, jcfg), cfg)
    m, t = torch.cat([m1, m2]), torch.cat([t1, t2])
    img = np.concatenate([img1, img1[:, ::-1]]).astype(np.float32)
    sx_max, sy_max, shear_max = jax_twopass_bounds(jcfg)
    kw = dict(sx_max=sx_max, sy_max=sy_max, shear_max=shear_max)
    got = affine_sample_twopass(_nchw(img).to(getattr(torch, dtype)), m, t,
                                TH, TW)
    want = jax.jit(functools.partial(jax_twopass, ho=TH, wo=TW, **kw))(
        jnp.asarray(img).astype(getattr(jnp, dtype)),
        jnp.asarray(m.numpy()), jnp.asarray(t.numpy()))
    assert got.dtype == getattr(torch, dtype)
    want = _nchw(want).numpy()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TWOPASS_TOL[dtype])


@pytest.mark.parametrize("label_dtype", ["float32", "float16"])
def test_geometry_twopass_matches_jax(monkeypatch, label_dtype):
    """``geometry_augmentation(sampler="twopass")`` against the JAX one,
    jitted as its train step runs it, under ``MFN_AUG_SAMPLER=twopass``
    on the same draws, f32 inputs. The images are sampled in bf16 on both
    sides: two bf16 ulps of values in [0.5, 1) (the jitted function's f32
    intermediates, and the pixel maps' last bits). Labels in f32: mask
    1e-5, flow 1e-4 px where the mask is solidly inside; in f16, two f16
    ulps of the mask (2^-10) and of flow * mask (2^-6 at |flow * mask| <
    16), divided by the mask."""
    inputs, jcfg, key = _twopass_case(22)
    monkeypatch.setenv("MFN_AUG_SAMPLER", "twopass")
    if label_dtype == "float32":
        monkeypatch.setenv("MFN_AUG_LABEL_DTYPE", "float32")
    else:
        monkeypatch.delenv("MFN_AUG_LABEL_DTYPE", raising=False)
    # a new jitted function, traced under this environment
    ref = jax.jit(functools.partial(jax_geometry, cfg=jcfg))(
        key, *map(jnp.asarray, inputs))
    got = geometry_augmentation(
        *(_nchw(x) for x in inputs), _jax_geometry_draws(key, B, jcfg),
        _port_cfg(GeometryAugConfig, jcfg), sampler="twopass",
        label_dtype=getattr(torch, label_dtype))
    assert [t.dtype for t in got] == [torch.float32] * 4
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), _nchw(r).numpy(), rtol=0,
                                   atol=2 ** -7)
    mask_tol, flow_tol = (1e-5, 1e-4) if label_dtype == "float32" else (
        2 ** -10, 2 ** -6 / 0.99)
    np.testing.assert_allclose(got[3].numpy(), _nchw(ref[3]).numpy(),
                               rtol=0, atol=mask_tol)
    m = np.asarray(ref[3])[..., 0] > 0.99
    assert m.mean() > 0.3
    err = np.abs(got[2].numpy() - _nchw(ref[2]).numpy()).transpose(
        0, 2, 3, 1)[m]
    assert err.max() <= flow_tol, err.max()


@pytest.mark.parametrize("dataset", ["chairs", "sintel", "kitti"])
def test_twopass_fits_the_presets_as_jax(dataset):
    """The presets run two-pass in both packages."""
    target = (320, 448) if dataset == "chairs" else (320, 768)
    orig = presets.ORIG_SHAPE[dataset]
    assert _twopass_fits(presets.geometry_aug_config(dataset, target, orig))
    assert jax_twopass_bounds(jax_presets.geometry_aug_config(
        dataset, target, orig)) is not None


def test_twopass_falls_back_past_the_angle_limit():
    """Past ``_TWOPASS_MAX_ANGLE_RAD`` the config does not fit, as the JAX
    package's bounds are None, and ``sampler="twopass"`` takes the affine
    sampler: the same tuple, bitwise."""
    wild = GeometryAugConfig(angle_range=(-80.0, 80.0),
                             target_shape=(TH, TW), orig_shape=(OH, OW))
    assert not _twopass_fits(wild)
    assert jax_twopass_bounds(JaxGeoCfg(**dataclasses.asdict(wild))) is None
    assert _twopass_total_angle(wild) > _TWOPASS_MAX_ANGLE_RAD
    inputs, _, _ = _twopass_case(23)
    draws = draw_geometry(torch.Generator().manual_seed(2), B, wild, "cpu")
    tensors = [_nchw(x) for x in inputs]
    got = geometry_augmentation(*tensors, draws, wild, sampler="twopass")
    want = geometry_augmentation(*tensors, draws, wild)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="sampler"):
        geometry_augmentation(*tensors, draws, wild, sampler="xla")


def test_trainer_passes_the_sampler_settings(monkeypatch):
    import maskflownet_torch.training.engine as engine
    seen = []
    real = engine.geometry_augmentation

    def spy(*args, **kwargs):
        seen.append((kwargs["sampler"], kwargs["label_dtype"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "geometry_augmentation", spy)
    batch = [torch.zeros(1, 3, OH, OW), torch.zeros(1, 3, OH, OW),
             torch.zeros(1, 2, OH, OW)]
    for sampler, label in (("affine", "float16"), ("twopass", "float32")):
        s = dataclasses.replace(_aug_settings("float32"), aug_sampler=sampler,
                                aug_label_dtype=label)
        Trainer(s, device="cpu").prepare(*batch)
    assert seen == [("affine", torch.float16), ("twopass", torch.float32)]


def _aug_settings(dtype: str):
    return TrainSettings(
        compute_dtype=dtype, target_shape=(TH, TW), orig_shape=(OH, OW),
        geo=presets.geometry_aug_config("chairs", (TH, TW), (OH, OW)),
        color=presets.color_aug_config("chairs"))


@pytest.fixture(scope="module")
def step_chain():
    """A FlyingChairs-like uint8-range batch, the step's key, and the JAX
    step body (``engine.py:115-134``) run eagerly up to colour: ``/255``,
    geometry and the mask's broadcast. The geometry runs in f32 for every
    compute dtype and only casts its images at the end (``geometry.py:
    381-383``), so both dtypes' cases share it and cast it."""
    rng = np.random.RandomState(4)
    img1 = _smooth(rng, (B, OH, OW, 3), 0, 255)
    img2 = _smooth(rng, (B, OH, OW, 3), 0, 255)
    flow = _smooth(rng, (B, OH, OW, 2), -10, 10)
    mask = 255 * np.clip(_smooth(rng, (B, OH, OW, 1), -0.5, 2.5), 0, 1)
    key = jax.random.PRNGKey(6)
    kg, _ = jax.random.split(key)
    geo = JaxGeoCfg(**dataclasses.asdict(_aug_settings("float32").geo))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MFN_AUG_SAMPLER", raising=False)
        j1, j2, jflow, jmask = jax_geometry(
            kg, jnp.asarray(img1) / 255.0, jnp.asarray(img2) / 255.0,
            jnp.asarray(flow), jnp.asarray(mask) / 255.0, geo)
    jmask = jnp.broadcast_to(jmask, jflow.shape[:3] + (1,))
    return (img1, img2, flow, mask), key, (j1, j2, jflow, jmask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_input_chain_matches_jax(step_chain, dtype):
    batch, key, (j1, j2, jflow, jmask) = step_chain
    s = _aug_settings(dtype)
    jgeo = JaxGeoCfg(**dataclasses.asdict(s.geo))
    jcolor = JaxColorCfg(**dataclasses.asdict(s.color))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kg, kc = jax.random.split(key)
    j1, j2 = jax_color(kc, j1.astype(jdt), j2.astype(jdt), jcolor)
    j1, j2, _ = jax_centralize(j1, j2)
    draws = (_jax_geometry_draws(kg, B, jgeo),
             _jax_color_draws(kc, B, (TH, TW), s.dtype(), jcolor))
    trainer = Trainer(s, device="cpu")
    got = trainer.prepare(*(_nchw(x) for x in batch), draws=draws)
    assert got[0].dtype == got[1].dtype == s.dtype()
    assert got[2].dtype == got[3].dtype == torch.float32
    image_tol = BF16_TOL if dtype == "bfloat16" else dict(rtol=0, atol=1e-5)
    _assert_geometry_close(got, (j1, j2, jflow, jmask), image_tol)


def test_aug_train_steps_are_finite_and_follow_the_seed():
    """Two augmented steps on the CPU draw their own augmentation: finite
    losses, equal from equal seeds, and a new draw at every step."""
    rng = np.random.RandomState(5)
    batch = [(255 * rng.rand(B, 3, OH, OW)).astype(np.float32),
             (255 * rng.rand(B, 3, OH, OW)).astype(np.float32),
             (3 * rng.randn(B, 2, OH, OW)).astype(np.float32)]
    runs = []
    for _ in range(2):
        trainer = Trainer(_aug_settings("float32"), device="cpu", seed=1)
        runs.append([trainer.train_batch(*batch, sync=True)["loss"]
                     for _ in range(2)])
    assert all(math.isfinite(v) for v in runs[0])
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]
