"""The port's deformable-conv method ``kernel`` on the CPU: the plain pair
``deform_fwd_plain``/``deform_bwd_plain`` behind ``DeformFunction``, against
the JAX package's Pallas kernel (``deform_conv3x3_pallas``, run in
interpret mode as ``tests/test_pallas.py`` runs it) and its ``gather``
form, on the same numpy inputs (NHWC there, NCHW here).

Tolerances: f32 on both sides. The Pallas kernel interpolates rows with
one-hot matmuls and sums taps and channels in another order than the plain
pair: values and gradients within 1e-5 absolute and relative (measured
~1e-6 on values of order 1-50). bf16 input: both sides round their inputs
to bf16, the Pallas kernel also its rows and taps, so 5e-2 as
``tests/test_pallas.py`` allows; against the port's own f32 arithmetic on
the same bf16 values the forward is one bf16 rounding (8e-3 relative).

At integer sample coordinates the port follows the floor-based gradient of
``gather`` and ``warpconv``; the Pallas backward's slope ``-sign(0) = 0``
drops the flow gradient there (ROADMAP queue 3), which one test pins.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskflownet_tpu.ops.deform import flow_guided_deform_conv3x3 as jax_deform
from maskflownet_tpu.ops.pallas.deform import deform_conv3x3_pallas
from maskflownet_torch.interop import hwio_to_oihw, nchw_to_nhwc, nhwc_to_nchw
from maskflownet_torch.ops import deform as tdeform
from maskflownet_torch.ops.warp import base_grid

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(shape, cout, seed, flow=None, flow_scale=2.5):
    """x, flow (NHWC), weight (HWIO) and a cotangent g (NHWC), f32."""
    n, h, w, cin = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if flow is None:
        flow = (flow_scale * rng.standard_normal((n, h, w, 2))).astype(
            np.float32)
    wgt = (0.2 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    g = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return x, np.asarray(flow, np.float32), wgt, g


def _jax_vjp(fn, x, flow, wgt, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(flow),
                       jnp.asarray(wgt))
    return [np.asarray(out)] + [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _pallas(x, flow, wgt, g):
    return _jax_vjp(lambda a, b, c: deform_conv3x3_pallas(a, b, c, True),
                    x, flow, wgt, g)


def _gather(x, flow, wgt, g):
    return _jax_vjp(lambda a, b, c: jax_deform(a, b, c, None,
                                               method="gather"),
                    x, flow, wgt, g)


def _port(x, flow, wgt, g, dtype=torch.float32):
    """DeformFunction on the CPU: the output and (dx, dflow, dweight), back
    in the JAX layouts, f32."""
    tx = torch.from_numpy(nhwc_to_nchw(x).copy()).to(dtype).requires_grad_()
    tf = torch.from_numpy(nhwc_to_nchw(flow).copy()).requires_grad_()
    tw = torch.from_numpy(hwio_to_oihw(wgt).copy()).to(dtype).requires_grad_()
    out = tdeform.DeformFunction.apply(tx, tf, tw)
    grads = torch.autograd.grad(
        out, (tx, tf, tw), torch.from_numpy(nhwc_to_nchw(g).copy()).to(dtype))
    dx, dflow, dw = (d.float() for d in grads)
    return [nchw_to_nhwc(out.detach().float().numpy()),
            nchw_to_nhwc(dx.numpy()), nchw_to_nhwc(dflow.numpy()),
            dw.permute(2, 3, 1, 0).numpy()]


def _assert_all(got, want, tol, what=("out", "dx", "dflow", "dweight")):
    for a, b, name in zip(got, want, what):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("shape,cout", [((2, 8, 12, 16), 16),
                                        ((1, 10, 14, 8), 24),
                                        ((1, 5, 7, 12), 12)])
def test_plain_pair_matches_pallas(shape, cout):
    """tests/test_pallas.py's shapes, at flows of ~2.5 px: never integer."""
    case = _case(shape, cout, seed=sum(shape) + cout)
    _assert_all(_port(*case), _pallas(*case), TOL)


@pytest.mark.parametrize("mag", [50.0, -50.0, 7.5, -3.2])
def test_windows_outside_the_image(mag):
    """Windows pushed fully (+-50 px) or partly outside the image: zero
    corners, forward and gradients as the Pallas kernel's."""
    shape = (1, 8, 8, 8)
    case = _case(shape, 8, seed=1, flow=np.full(shape[:3] + (2,), mag))
    got = _port(*case)
    _assert_all(got, _pallas(*case), TOL)
    if abs(mag) == 50.0:
        assert all(not np.any(a) for a in got)


def test_integer_flows_follow_gather():
    """At integer flows (zero included) the gradients are gather's, which
    the Pallas backward's zero slope misses in the flow."""
    rng = np.random.default_rng(2)
    shape = (2, 6, 9, 5)
    flow = rng.integers(-3, 4, shape[:3] + (2,)).astype(np.float32)
    flow[0] = 0.0
    case = _case(shape, 7, seed=3, flow=flow)
    got = _port(*case)
    want = _gather(*case)
    _assert_all(got, want, TOL)
    pallas_dflow = _pallas(*case)[2]
    assert np.abs(pallas_dflow - want[2]).max() > 1.0


@pytest.mark.parametrize("needs", [n for n in itertools.product(
    (False, True), repeat=3) if any(n)], ids=str)
def test_gradient_subsets_equal_the_full_backward(needs, monkeypatch):
    """DeformFunction asks the plain backward only for the gradients whose
    inputs require them, and each equals the full backward's."""
    x, flow, wgt, g = _case((1, 5, 6, 4), 5, seed=4)
    x, flow, g = (torch.from_numpy(nhwc_to_nchw(a).copy())
                  for a in (x, flow, g))
    weight = torch.from_numpy(hwio_to_oihw(wgt).copy())
    ins = [t.clone().requires_grad_() for t in (x, flow, weight)]
    full = torch.autograd.grad(tdeform.DeformFunction.apply(*ins), ins, g)
    asked = []
    plain = tdeform.deform_bwd_plain

    def spy(*args):
        asked.append(tuple(args[-1]))
        return plain(*args)

    monkeypatch.setattr(tdeform, "deform_bwd_plain", spy)
    ins = [t.clone().requires_grad_(need) for t, need in
           zip((x, flow, weight), needs)]
    out = tdeform.DeformFunction.apply(*ins)
    wanted = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, g))
    assert asked == [needs]
    for need, f in zip(needs, full):
        if need:
            torch.testing.assert_close(next(got), f, rtol=0, atol=0)


def test_bf16_input():
    shape, cout = (1, 8, 12, 16), 16
    x, flow, wgt, g = _case(shape, cout, seed=5, flow_scale=2.0)
    got = _port(x, flow, wgt, g, torch.bfloat16)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
          for a in (x, wgt, g)]
    # against the Pallas kernel in bf16 (rows and taps rounded there too)
    want = np.asarray(deform_conv3x3_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(flow),
        jnp.asarray(wgt, jnp.bfloat16), True)).astype(np.float32)
    np.testing.assert_allclose(got[0], want, rtol=5e-2, atol=5e-2)
    # against the port's f32 arithmetic on the same bf16 values: the
    # forward is one bf16 rounding of it, the gradients the same f32 sums
    want32 = _port(bf[0], flow, bf[1], bf[2])
    np.testing.assert_allclose(got[0], want32[0], rtol=8e-3, atol=1e-6)
    _assert_all(got[1:], want32[1:], dict(rtol=8e-3, atol=1e-5),
                ("dx", "dflow", "dweight"))


@pytest.mark.parametrize("flow_scale", [0.0, 2.0, 6.0])
def test_kernel_method_equals_warpconv(flow_scale):
    """On the CPU ``method="kernel"`` is the same function as ``warpconv``,
    the main path's default, gradient (bias included) and all."""
    x, flow, wgt, g = _case((2, 6, 8, 5), 4, seed=6, flow_scale=flow_scale)
    bias = np.random.default_rng(7).standard_normal(4).astype(np.float32)
    res = {}
    for method in ("kernel", "warpconv"):
        ins = [torch.from_numpy(nhwc_to_nchw(x).copy()),
               torch.from_numpy(nhwc_to_nchw(flow).copy()),
               torch.from_numpy(hwio_to_oihw(wgt).copy()),
               torch.from_numpy(bias)]
        ins = [t.requires_grad_() for t in ins]
        out = tdeform.flow_guided_deform_conv3x3(*ins, method=method)
        res[method] = [out] + list(torch.autograd.grad(
            out, ins, torch.from_numpy(nhwc_to_nchw(g).copy())))
    for a, b in zip(res["kernel"], res["warpconv"]):
        torch.testing.assert_close(a, b, **TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: a CPU tensor reaches
    the plain pair through DeformFunction, never through them."""
    x = torch.zeros(1, 3, 4, 5)
    sy, sx = base_grid(torch.zeros(1, 2, 4, 5))
    w9 = tdeform.weight_to_w9(torch.zeros(2, 3, 3, 3), torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        tdeform.deform_fwd(x, sy, sx, w9)
    with pytest.raises(ValueError, match="CUDA device"):
        tdeform.deform_bwd(x, sy, sx, w9, torch.zeros(1, 2, 4, 5))
