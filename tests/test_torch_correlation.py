"""Port correlation (NCHW) against the JAX package's three paths, forward
and gradient.

``correlation_plain`` and ``correlation_bwd_plain`` are the CPU path and
the reference of the CUDA kernels; here they, and the gradient that
``CorrelationFunction`` gives on the CPU, are held against
``correlation_xla`` (and ``jax.vjp`` of it) and both Pallas families in
interpret mode (their ``custom_vjp``), on the same numpy inputs.
rtol = atol = 1e-5: all sides are f32 and differ only in summation order.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskflownet_tpu.ops.correlation import correlation_xla
from maskflownet_tpu.ops.pallas.correlation import (correlation_pallas,
                                                    correlation_pallas_cmajor)
from maskflownet_torch.interop import nchw_to_nhwc, nhwc_to_nchw
from maskflownet_torch.ops.correlation import (CorrelationFunction,
                                               corr_bwd_f1, corr_bwd_f2,
                                               corr_fwd, correlation,
                                               correlation_bwd_plain,
                                               correlation_plain)

TOL = dict(rtol=1e-5, atol=1e-5)

# (md, NHWC shape): the cases of tests/test_pallas.py plus an odd H/W
CASES = [
    (4, (2, 8, 12, 16)),
    (2, (1, 6, 10, 8)),
    (4, (1, 10, 14, 196)),
    (4, (1, 9, 13, 8)),
    (2, (1, 9, 13, 8)),
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port(a, b, md, leaky):
    out = correlation_plain(torch.from_numpy(nhwc_to_nchw(a).copy()),
                            torch.from_numpy(nhwc_to_nchw(b).copy()), md,
                            leaky)
    return nchw_to_nhwc(out.numpy())


def _leaky(x, slope):
    return x if slope is None else np.where(x >= 0, x, slope * x)


@pytest.mark.parametrize("leaky", [None, 0.1])
@pytest.mark.parametrize("md,shape", CASES)
def test_plain_matches_xla(md, shape, leaky):
    a, b = _inputs(shape, 0)
    want = _leaky(np.asarray(correlation_xla(jnp.asarray(a), jnp.asarray(b),
                                             md)), leaky)
    np.testing.assert_allclose(_port(a, b, md, leaky), want, **TOL)


@pytest.mark.parametrize("family", ["nhwc", "cmajor"])
@pytest.mark.parametrize("md,shape", CASES[:4])
def test_plain_matches_pallas(md, shape, family):
    a, b = _inputs(shape, 1)
    fn = correlation_pallas if family == "nhwc" else correlation_pallas_cmajor
    want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), md, True, 0.1))
    np.testing.assert_allclose(_port(a, b, md, 0.1), want, **TOL)


def test_cpu_dispatch_takes_plain_and_launches_nothing():
    a, b = (torch.from_numpy(nhwc_to_nchw(x).copy()).requires_grad_()
            for x in _inputs((2, 6, 7, 5), 2))
    kernels = (corr_fwd, corr_bwd_f1, corr_bwd_f2)
    before = [k.launches for k in kernels]
    got = correlation(a, b, 2, leaky=0.1)
    got.sum().backward()
    assert [k.launches for k in kernels] == before
    torch.testing.assert_close(got, correlation_plain(a, b, 2, 0.1),
                               rtol=0, atol=0)
    assert got.shape == (2, 25, 6, 7)
    assert a.grad is not None and b.grad is not None


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros(1, 4, 5, 6)
    g = torch.zeros(1, 81, 5, 6)
    with pytest.raises(ValueError, match="CUDA"):
        corr_fwd(a, a, 4)
    with pytest.raises(ValueError, match="CUDA"):
        corr_bwd_f1(g, a, g, 4, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        corr_bwd_f2(g, a, None, 4)
    with pytest.raises(ValueError, match="saved output"):
        corr_bwd_f1(g, a, None, 4, 0.1)


def test_kernel_wrapper_refuses_an_input_that_requires_grad():
    """corr_fwd's output has no grad_fn, so an input that asks for a
    gradient raises rather than lose it; without grad mode it may pass."""
    a = torch.zeros(1, 4, 5, 6, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        corr_fwd(a, a.detach(), 4)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        corr_fwd(a, a, 4)


# (md, NHWC shape) of the gradient cases: even and odd H/W, md 2 and 4
BWD_CASES = [
    (4, (2, 8, 10, 8)),
    (2, (1, 9, 13, 8)),
    (4, (1, 9, 13, 8)),
]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(nhwc_to_nchw(x)))


def _bwd_inputs(md, shape):
    a, b = _inputs(shape, 4)
    g = np.random.default_rng(5).standard_normal(
        shape[:3] + ((2 * md + 1) ** 2,)).astype(np.float32)
    return a, b, g


@functools.cache
def _jax_grads(family, md, shape, leaky):
    """jax.vjp of the JAX path applied to the case's cotangent (cached: two
    tests read each XLA case)."""
    def xla(x, y):
        c = correlation_xla(x, y, md)
        return c if leaky is None else jnp.where(c >= 0, c, leaky * c)
    fn = {"xla": xla,
          "nhwc": lambda x, y: correlation_pallas(x, y, md, True, leaky),
          "cmajor": lambda x, y: correlation_pallas_cmajor(x, y, md, True,
                                                           leaky)}[family]
    a, b, g = _bwd_inputs(md, shape)
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_bwd(md, shape, leaky):
    f1, f2, g = (_t(x) for x in _bwd_inputs(md, shape))
    out = correlation_plain(f1, f2, md, leaky)
    if leaky is not None:   # the rule under test reads both signs of out
        assert (out < 0).any() and (out > 0).any()
    df1, df2 = correlation_bwd_plain(g, f1, f2,
                                     None if leaky is None else out, md,
                                     leaky)
    return [nchw_to_nhwc(x.numpy()) for x in (df1, df2)]


@pytest.mark.parametrize("leaky", [None, 0.1])
@pytest.mark.parametrize("md,shape", BWD_CASES)
def test_bwd_plain_matches_xla_vjp(md, shape, leaky):
    want = _jax_grads("xla", md, shape, leaky)
    for got, w in zip(_port_bwd(md, shape, leaky), want):
        np.testing.assert_allclose(got, w, **TOL)


@pytest.mark.parametrize("leaky", [None, 0.1])
@pytest.mark.parametrize("md,shape", BWD_CASES)
def test_function_grad_matches_xla_vjp(md, shape, leaky):
    """The CPU CorrelationFunction's autograd gradient (what the model's
    backward runs), in f32."""
    a, b, g = _bwd_inputs(md, shape)
    f1, f2 = _t(a).requires_grad_(), _t(b).requires_grad_()
    out = correlation(f1, f2, md, leaky)
    got = torch.autograd.grad(out, (f1, f2), _t(g))
    for x, w in zip(got, _jax_grads("xla", md, shape, leaky)):
        np.testing.assert_allclose(nchw_to_nhwc(x.numpy()), w, **TOL)


# each Pallas family in interpret mode at md 4 and 2 (a case of each family
# costs seconds on the CPU)
@pytest.mark.parametrize("family,md,shape,leaky", [
    ("nhwc", 4, (1, 8, 10, 8), 0.1),
    ("cmajor", 2, (1, 6, 10, 8), 0.1),
    ("nhwc", 2, (1, 6, 10, 8), None),
])
def test_bwd_plain_matches_pallas_vjp(family, md, shape, leaky):
    want = _jax_grads(family, md, shape, leaky)
    for got, w in zip(_port_bwd(md, shape, leaky), want):
        np.testing.assert_allclose(got, w, **TOL)


@pytest.mark.parametrize("leaky", [None, 0.1])
def test_function_saves_the_output_only_with_leaky(leaky):
    f1, f2 = (_t(x).requires_grad_() for x in _inputs((1, 5, 6, 4), 7))
    out = CorrelationFunction.apply(f1, f2, 1, leaky)
    saved = out.grad_fn.saved_tensors
    assert saved[0] is f1 and saved[1] is f2
    if leaky is None:
        assert saved[2] is None
    else:
        torch.testing.assert_close(saved[2], out, rtol=0, atol=0)


def test_bwd_plain_bf16_is_f32_math_cast_once():
    a, b, g = (_t(x).bfloat16() for x in _bwd_inputs(2, (1, 8, 8, 32)))
    out = correlation_plain(a, b, 2, 0.1)
    got = correlation_bwd_plain(g, a, b, out, 2, 0.1)
    want = correlation_bwd_plain(g.float(), a.float(), b.float(),
                                 out.float(), 2, 0.1)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, w.bfloat16(), rtol=0, atol=0)


def test_plain_bf16_is_f32_math_cast_once():
    a, b = (torch.from_numpy(nhwc_to_nchw(x).copy()).bfloat16()
            for x in _inputs((1, 8, 8, 32), 3))
    got = correlation_plain(a, b, 2, 0.1)
    assert got.dtype == torch.bfloat16
    want = correlation_plain(a.float(), b.float(), 2, 0.1).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)

