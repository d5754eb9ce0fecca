"""Port correlation (NCHW) against the JAX package's three forward paths.

``correlation_plain`` is the CPU path and the reference of the CUDA kernel;
here it is held against ``correlation_xla`` and both Pallas forward
families in interpret mode, on the same numpy inputs. rtol = atol = 1e-5:
all sides are f32 and differ only in summation order over C.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskflownet_tpu.ops.correlation import correlation_xla
from maskflownet_tpu.ops.pallas.correlation import (correlation_pallas,
                                                    correlation_pallas_cmajor)
from maskflownet_torch.interop import nchw_to_nhwc, nhwc_to_nchw
from maskflownet_torch.ops.correlation import (corr_fwd, correlation,
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
    a, b = (torch.from_numpy(nhwc_to_nchw(x).copy())
            for x in _inputs((2, 6, 7, 5), 2))
    before = corr_fwd.launches
    got = correlation(a, b, 2, leaky=0.1)
    assert corr_fwd.launches == before
    torch.testing.assert_close(got, correlation_plain(a, b, 2, 0.1),
                               rtol=0, atol=0)
    assert got.shape == (2, 25, 6, 7)


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros(1, 4, 5, 6)
    with pytest.raises(ValueError, match="CUDA"):
        corr_fwd(a, a, 4)


def test_plain_bf16_is_f32_math_cast_once():
    a, b = (torch.from_numpy(nhwc_to_nchw(x).copy()).bfloat16()
            for x in _inputs((1, 8, 8, 32), 3))
    got = correlation_plain(a, b, 2, 0.1)
    assert got.dtype == torch.bfloat16
    want = correlation_plain(a.float(), b.float(), 2, 0.1).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)

