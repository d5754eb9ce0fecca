"""Port ops (NCHW) against their JAX counterparts (NHWC) on the same numpy
inputs: upsample, downsample, resize_bilinear, backwarp, the flow-guided
deformable conv and deconv, forward and (for the ops the train step
differentiates) gradient against ``jax.vjp``. All f32; tolerance 1e-5
(summation order only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskflownet_tpu import nn as jnn
from maskflownet_tpu.ops import deform as jdeform
from maskflownet_tpu.ops import resample as jresample
from maskflownet_tpu.ops import warp as jwarp
from maskflownet_torch import nn as tnn
from maskflownet_torch.interop import (hwio_to_oihw, nchw_to_nhwc,
                                       nhwc_to_nchw)
from maskflownet_torch.ops import deform as tdeform
from maskflownet_torch.ops import resample as tresample
from maskflownet_torch.ops import warp as twarp

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a_nhwc):
    return torch.from_numpy(np.ascontiguousarray(nhwc_to_nchw(a_nhwc)))


def _back(t_nchw):
    return nchw_to_nhwc(t_nchw.detach().numpy())


@pytest.mark.parametrize("f", [2, 4])
def test_upsample_matches_jax(f):
    x = _rand(2, 5, 7, 3, seed=f)
    want = np.asarray(jresample.upsample(jnp.asarray(x), f))
    got = _back(tresample.upsample(_t(x), f))
    np.testing.assert_allclose(got, want, **TOL)
    # the bottom/right edge rows repeat the last input row/column
    np.testing.assert_allclose(got[:, -f:, -1], np.repeat(x[:, -1:, -1], f, 1),
                               **TOL)


@pytest.mark.parametrize("size", [(8, 12), (3, 20), (1, 5)])
def test_resize_bilinear_matches_jax(size):
    x = _rand(2, 6, 9, 3, seed=7)
    want = np.asarray(jresample.resize_bilinear(jnp.asarray(x), *size))
    got = _back(tresample.resize_bilinear(_t(x), *size))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("clamp", [False, True])
def test_backwarp_matches_jax(clamp):
    img = _rand(2, 7, 9, 3, seed=1)
    flow = _rand(2, 7, 9, 2, seed=2, scale=4.0)   # many samples leave the image
    want = np.asarray(jwarp.backwarp(jnp.asarray(img), jnp.asarray(flow),
                                     clamp=clamp, method="gather"))
    got = _back(twarp.backwarp(_t(img), _t(flow), clamp=clamp))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("flow_scale", [0.0, 1.5, 6.0])
@pytest.mark.parametrize("method", ["warpconv", "gather"])
def test_deform_matches_jax_gather(method, flow_scale):
    x = _rand(2, 6, 8, 5, seed=3)
    flow = _rand(2, 6, 8, 2, seed=4, scale=flow_scale)
    w = _rand(3, 3, 5, 4, seed=5, scale=0.3)
    b = _rand(4, seed=6)
    want = np.asarray(jdeform.flow_guided_deform_conv3x3(
        jnp.asarray(x), jnp.asarray(flow), jnp.asarray(w), jnp.asarray(b),
        method="gather"))
    got = _back(tdeform.flow_guided_deform_conv3x3(
        _t(x), _t(flow), torch.from_numpy(hwio_to_oihw(w).copy()),
        torch.from_numpy(b), method=method))
    np.testing.assert_allclose(got, want, **TOL)


def test_deform_zero_flow_is_conv3x3():
    x = _rand(1, 5, 6, 3, seed=8)
    w = torch.from_numpy(_rand(4, 3, 3, 3, seed=9))
    got = tdeform.flow_guided_deform_conv3x3(_t(x), torch.zeros(1, 2, 5, 6), w)
    torch.testing.assert_close(got, torch.nn.functional.conv2d(_t(x), w,
                                                               padding=1),
                               **TOL)


def test_deform_rejects_unknown_method():
    x = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="deform method"):
        tdeform.flow_guided_deform_conv3x3(x, torch.zeros(1, 2, 3, 3),
                                           torch.zeros(1, 2, 3, 3),
                                           method="onehot")


@pytest.mark.parametrize("act", [False, True])
def test_deconv_matches_jax(act):
    """nn.deconv keeps its HWIO kernel unflipped; the port's OIHW copy of
    it must give the same output (a plain ConvTranspose2d would not)."""
    x = _rand(2, 5, 6, 7, seed=10)
    w = _rand(4, 4, 7, 3, seed=11, scale=0.3)
    b = _rand(3, seed=12)
    jctx = jnn.apply_ctx({"up/w": jnp.asarray(w), "up/b": jnp.asarray(b)})
    want = np.asarray(jnn.deconv(jctx, "up", jnp.asarray(x), 3, act=act))
    tctx = tnn.apply_ctx({"up/w": torch.from_numpy(hwio_to_oihw(w).copy()),
                          "up/b": torch.from_numpy(b)})
    got = _back(tnn.deconv(tctx, "up", _t(x), 3, act=act))
    assert got.shape == (2, 10, 12, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 4)])
def test_conv_matches_jax(stride, dilation):
    x = _rand(1, 9, 10, 5, seed=13)
    w = _rand(3, 3, 5, 6, seed=14, scale=0.3)
    b = _rand(6, seed=15)
    jctx = jnn.apply_ctx({"c/w": jnp.asarray(w), "c/b": jnp.asarray(b)})
    want = np.asarray(jnn.conv(jctx, "c", jnp.asarray(x), 6, stride=stride,
                               dilation=dilation))
    tctx = tnn.apply_ctx({"c/w": torch.from_numpy(hwio_to_oihw(w).copy()),
                          "c/b": torch.from_numpy(b)})
    got = _back(tnn.conv(tctx, "c", _t(x), 6, stride=stride,
                         dilation=dilation))
    np.testing.assert_allclose(got, want, **TOL)


def test_msra_prelu_std_matches_formula():
    rng = np.random.default_rng(0)
    w = tnn.msra_prelu()(rng, (64, 32, 3, 3))
    fan = 9 * (32 + 64) / 2
    np.testing.assert_allclose(w.std(), np.sqrt(2 / 1.01 / fan), rtol=0.02)
    assert w.dtype == np.float32


def _vjp_matches(jax_fn, torch_fn, inputs, seed):
    """jax.vjp of ``jax_fn`` (NHWC arrays) and autograd of ``torch_fn`` (NCHW
    tensors; weights as given) at the same inputs and cotangent: values and
    every input's gradient within TOL. ``inputs``: (array, is_image)
    pairs; an image is NHWC on the JAX side and NCHW on the port's."""
    jx = [jnp.asarray(a) for a, _ in inputs]
    want, vjp = jax.vjp(jax_fn, *jx)
    g = _rand(*want.shape, seed=seed)
    want_grads = vjp(jnp.asarray(g))
    tx = [(_t(a) if img else torch.from_numpy(a.copy())).requires_grad_()
          for a, img in inputs]
    got = torch_fn(*tx)
    np.testing.assert_allclose(_back(got), np.asarray(want), **TOL)
    got_grads = torch.autograd.grad(got, tx, _t(g))
    for (a, img), gg, wg in zip(inputs, got_grads, want_grads):
        gg = _back(gg) if img else gg.numpy()
        np.testing.assert_allclose(gg, np.asarray(wg), **TOL)


@pytest.mark.parametrize("f", [2, 4, 8])
def test_downsample_matches_jax(f):
    x = _rand(2, 16, 24, 3, seed=20 + f)
    _vjp_matches(lambda a: jresample.downsample(a, f),
                 lambda a: tresample.downsample(a, f), [(x, True)], seed=f)


@pytest.mark.parametrize("f", [2, 4])
def test_upsample_grad_matches_jax(f):
    x = _rand(2, 5, 7, 3, seed=30 + f)
    _vjp_matches(lambda a: jresample.upsample(a, f),
                 lambda a: tresample.upsample(a, f), [(x, True)], seed=f)


@pytest.mark.parametrize("clamp", [False, True])
def test_backwarp_grad_matches_jax(clamp):
    """Gradients of the image and of the flow; many samples leave the
    image, so the zero border and the clamp are both crossed."""
    img = _rand(2, 7, 9, 3, seed=31)
    flow = _rand(2, 7, 9, 2, seed=32, scale=4.0)
    _vjp_matches(
        lambda a, b: jwarp.backwarp(a, b, clamp=clamp, method="gather"),
        lambda a, b: twarp.backwarp(a, b, clamp=clamp),
        [(img, True), (flow, True)], seed=33)


@pytest.mark.parametrize("flow_scale", [1.5, 6.0])
def test_warpconv_grad_matches_jax_gather(flow_scale):
    """The main path's deform (warpconv) against the JAX gather form:
    gradients of x, flow, weight and bias."""
    x = _rand(2, 6, 8, 5, seed=34)
    flow = _rand(2, 6, 8, 2, seed=35, scale=flow_scale)
    w = _rand(3, 3, 5, 4, seed=36, scale=0.3)
    b = _rand(4, seed=37)
    _vjp_matches(
        lambda xx, ff, ww, bb: jdeform.flow_guided_deform_conv3x3(
            xx, ff, ww, bb, method="gather"),
        lambda xx, ff, ww, bb: tdeform.flow_guided_deform_conv3x3(
            xx, ff, ww.permute(3, 2, 0, 1), bb, method="warpconv"),
        [(x, True), (flow, True), (w, False), (b, False)], seed=38)
