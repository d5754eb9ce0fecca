"""Port losses (NCHW) against ``maskflownet_tpu/losses.py`` (NHWC) on the same
numpy inputs. All f32 reductions over a few thousand pixels in another
order: rtol = atol = 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskflownet_tpu import losses as jlosses
from maskflownet_torch import losses as tlosses
from maskflownet_torch.interop import nhwc_to_nchw

TOL = dict(rtol=1e-6, atol=1e-6)
H = W = 64


def _batch(seed):
    """Label flow, a mask with holes (values in [0, 1]) and five
    predictions at strides 64..4, all NHWC."""
    rng = np.random.default_rng(seed)
    flow = (5 * rng.standard_normal((2, H, W, 2))).astype(np.float32)
    mask = (rng.random((2, H, W, 1)) > 0.2).astype(np.float32)
    preds = [(5 * rng.standard_normal((2, H // s, W // s, 2))).astype(
        np.float32) for s in (64, 32, 16, 8, 4)]
    return flow, mask, preds


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(nhwc_to_nchw(a)))


@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_epe_loss_matches_jax(eps):
    flow, _, preds = _batch(0)
    pred = np.repeat(np.repeat(preds[-1], 4, 1), 4, 2)
    want = np.asarray(jlosses.epe_loss(jnp.asarray(pred), jnp.asarray(flow),
                                       eps))
    got = tlosses.epe_loss(_t(pred), _t(flow), eps).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("q", [None, 0.4])
def test_epe_loss_with_mask_matches_jax(q):
    flow, mask, preds = _batch(1)
    pred = np.repeat(np.repeat(preds[-1], 4, 1), 4, 2)
    want = np.asarray(jlosses.epe_loss_with_mask(
        jnp.asarray(pred), jnp.asarray(flow), jnp.asarray(mask), q=q))
    got = tlosses.epe_loss_with_mask(_t(pred), _t(flow), _t(mask), q=q)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("q", [None, 0.4])
@pytest.mark.parametrize("match", ["upsampling", "downsampling"])
def test_multiscale_epe_matches_jax(match, q):
    flow, mask, preds = _batch(2)
    # one compiled program: op-by-op dispatch compiles each of the
    # resampling ops on its own and takes several times longer
    want = np.asarray(jax.jit(lambda f, m, p: jlosses.multiscale_epe(
        f, m, p, match=match, q=q))(flow, mask, preds))
    got = tlosses.multiscale_epe(_t(flow), _t(mask), [_t(p) for p in preds],
                                 match=match, q=q)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_multiscale_epe_rejects_unknown_match():
    flow, mask, preds = _batch(3)
    with pytest.raises(NotImplementedError):
        tlosses.multiscale_epe(_t(flow), _t(mask), [_t(p) for p in preds],
                               match="nearest")


def test_kitti_outlier_rate_matches_jax():
    flow, mask, _ = _batch(4)
    rng = np.random.default_rng(5)
    # a mix of inliers, small and large errors
    pred = flow + (rng.standard_normal(flow.shape) * np.where(
        rng.random(flow.shape[:3] + (1,)) > 0.5, 6.0, 0.5)).astype(np.float32)
    want = np.asarray(jlosses.kitti_outlier_rate(
        jnp.asarray(pred), jnp.asarray(flow), jnp.asarray(mask)))
    got = tlosses.kitti_outlier_rate(_t(pred), _t(flow), _t(mask)).numpy()
    assert 0.1 < got.min() and got.max() < 0.9
    np.testing.assert_allclose(got, want, **TOL)
