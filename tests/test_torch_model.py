"""MaskFlownet_S in the port against the JAX model, at the published widths.

Weights are drawn with numpy in the JAX layout (HWIO) at the shapes the
JAX ``Ctx`` collects under ``jax.eval_shape`` -- exactly as ``nn.init``
does, minus its per-parameter ``jax.random`` draws, which take tens of
seconds on the CPU -- and carried across by ``params_from_jax`` or by a v1
``.npz``. Tolerance: atol 5e-4 px, rtol 1e-4 in f32. The network is ~30
convs deep from the images to flow2 (13 of them between a cost volume and
the prediction), every one summing in another order in XLA than in
PyTorch's CPU convs, and the flow is scaled by 20 at the end; measured
differences are ~5e-5 px on flows of ~20 px.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from maskflownet_tpu import nn as jnn
from maskflownet_tpu.models.maskflownet import ModelConfig as JaxConfig
from maskflownet_tpu.models.maskflownet import maskflownet_s as jax_model
from maskflownet_tpu.ops import backwarp, resize_bilinear, upsample
from maskflownet_tpu.training.engine import Trainer, centralize
from maskflownet_torch import nn as tnn
from maskflownet_torch.inference import Predictor, predict_image_pair_flow
from maskflownet_torch.interop import (load_npz, nchw_to_nhwc, nhwc_to_nchw,
                                       params_from_jax)
from maskflownet_torch.models import maskflownet_s, param_shapes

TOL = dict(rtol=1e-4, atol=5e-4)
# the JAX model off the TPU: no space-to-depth, concat dense blocks
JCFG = JaxConfig(s2d=False, s2d_l2=False, dense="concat")


def _jax_shapes():
    shapes = {}
    dummy = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    jax.eval_shape(lambda a, b: jax_model(
        jnn.Ctx(mode="shape", shapes=shapes), a, b, JCFG), dummy, dummy)
    return {k: v[0] for k, v in shapes.items()}


def _jax_do_batch(params, img1, img2):
    """engine.py:236-253 composed step by step (Trainer._infer_fn body)."""
    h, w = img1.shape[1:3]
    wh, ww = h + (-h) % 64, w + (-w) % 64
    i1, i2, _ = centralize(img1, img2)
    i1 = resize_bilinear(i1, wh, ww)
    i2 = resize_bilinear(i2, wh, ww)
    preds, occs, _ = jax_model(jnn.apply_ctx(params), i1, i2, JCFG)
    flow = upsample(preds[-1], 4)
    occ = upsample(occs[0], 4)
    scale = jnp.asarray([h / wh, w / ww], jnp.float32)
    flow = resize_bilinear(flow, h, w) * scale
    occ = resize_bilinear(occ, h, w)
    return (flow, occ, backwarp(img2, flow, clamp=True, method="gather"),
            i1, i2, preds, occs)


@pytest.fixture(scope="module")
def jax_side():
    shapes = _jax_shapes()
    rng = np.random.default_rng(0)
    flat = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if len(shape) == 4:
            fan = shape[0] * shape[1] * (shape[2] + shape[3]) / 2
            flat[name] = (np.sqrt(2 / 1.01 / fan)
                          * rng.standard_normal(shape)).astype(np.float32)
        else:   # biases: small nonzero values, so a lost bias shows
            flat[name] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    img = np.random.default_rng(1).random((4, 64, 96, 3), np.float32)
    fwd = jax.jit(lambda p, a, b: jax_model(jnn.apply_ctx(p), a, b, JCFG))
    im64 = img[:2, :, :64] - 0.5
    out64 = jax.tree_util.tree_map(np.asarray, fwd(jparams, im64[:1],
                                                   im64[1:]))
    infer = jax.tree_util.tree_map(np.asarray, jax.jit(_jax_do_batch)(
        jparams, img[2:3], img[3:4]))
    return dict(shapes=shapes, flat=flat, im64=im64, out64=out64, img=img,
                infer=infer)


def _port_forward(params, im1_nhwc, im2_nhwc):
    preds, occs, srcs = maskflownet_s(tnn.apply_ctx(params),
                                      torch.tensor(nhwc_to_nchw(im1_nhwc)),
                                      torch.tensor(nhwc_to_nchw(im2_nhwc)))
    return ([nchw_to_nhwc(p.numpy()) for p in preds],
            nchw_to_nhwc(occs[0].numpy()), srcs)


def _assert_preds(got_preds, got_occ, want_preds, want_occ):
    assert len(got_preds) == 5
    for g, w in zip(got_preds, want_preds):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got_occ, want_occ, **TOL)


def test_param_names_and_shapes_match_jax(jax_side):
    want = {k: (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
            for k, s in jax_side["shapes"].items()}
    assert param_shapes() == want


def test_forward_64x64_matches_jax(jax_side):
    params = params_from_jax(jax_side["flat"])
    im = jax_side["im64"]
    preds, occ, srcs = _port_forward(params, im[:1], im[1:])
    want_preds, want_occs, want_srcs = jax_side["out64"]
    _assert_preds(preds, occ, want_preds, want_occs[0])
    # cascade sources: c2s keeps the reference quirk (c12, c13 at 1, 2)
    c1s, c2s, _, c30, c40 = srcs
    for got, want in zip(c2s, want_srcs[1]):
        np.testing.assert_allclose(nchw_to_nhwc(got.numpy()), want, **TOL)
    torch.testing.assert_close(c2s[1], c1s[1], rtol=0, atol=0)
    np.testing.assert_allclose(nchw_to_nhwc(c30.numpy()), want_srcs[3], **TOL)
    np.testing.assert_allclose(nchw_to_nhwc(c40.numpy()), want_srcs[4], **TOL)


def test_forward_64x128_matches_jax(jax_side):
    """The working-size forward inside do_batch, on JAX's own inputs."""
    _, _, _, i1, i2, want_preds, want_occs = jax_side["infer"]
    preds, occ, _ = _port_forward(params_from_jax(jax_side["flat"]), i1, i2)
    _assert_preds(preds, occ, want_preds, want_occs[0])


def test_do_batch_matches_jax(jax_side):
    """64x96 input: resized to 64x128 and back, flow values rescaled."""
    pred = Predictor(params_from_jax(jax_side["flat"]), device="cpu",
                     dtype=torch.float32)
    img = jax_side["img"]
    flow, occ, warped = pred.do_batch(nhwc_to_nchw(img[2:3]),
                                      nhwc_to_nchw(img[3:4]))
    want_flow, want_occ, want_warped = jax_side["infer"][:3]
    assert flow.shape == (1, 2, 64, 96) and occ.shape == (1, 1, 64, 96)
    np.testing.assert_allclose(nchw_to_nhwc(flow.numpy()), want_flow, **TOL)
    np.testing.assert_allclose(nchw_to_nhwc(occ.numpy()), want_occ, **TOL)
    np.testing.assert_allclose(nchw_to_nhwc(warped.numpy()), want_warped,
                               **TOL)
    # the uint8 image-pair entry point runs the same batch of one
    u8 = [np.round(img[i] * 255).astype(np.uint8) for i in (2, 3)]
    f, o, w = predict_image_pair_flow(pred, *u8)
    assert f.shape == (64, 96, 2) and o.shape == (64, 96, 1)
    assert w.shape == (64, 96, 3) and np.isfinite(f).all()


@pytest.fixture(scope="module")
def v1_npz(jax_side, tmp_path_factory):
    """A v1 checkpoint written by the JAX package's own Trainer.save. The
    Trainer's __init__ (which draws fresh weights and builds the train
    step) is bypassed; save reads only params, opt_state and steps."""
    trainer = Trainer.__new__(Trainer)
    trainer.params = {k: jnp.asarray(v) for k, v in jax_side["flat"].items()}
    trainer.opt_state = optax.scale_by_adam().init(trainer.params)
    trainer.steps = 7
    prefix = str(tmp_path_factory.mktemp("ckpt") / "MaskFlownet_S")
    trainer.save(prefix)
    return prefix + ".npz"


def test_load_npz_gives_the_same_forward(jax_side, v1_npz):
    params = load_npz(v1_npz)
    im = jax_side["im64"]
    preds, occ, _ = _port_forward(params, im[:1], im[1:])
    want_preds, want_occs, _ = jax_side["out64"]
    _assert_preds(preds, occ, want_preds, want_occs[0])


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing"), ("unknown", "unknown"), ("shape", "shape"),
    ("schema", "newer")])
def test_load_npz_rejects_bad_checkpoints(v1_npz, tmp_path, fault, match):
    with np.load(v1_npz) as z:
        entries = dict(z)
    if fault == "missing":
        del entries["p:conv1a/w"]
    elif fault == "unknown":
        entries["p:extra/w"] = np.zeros((3, 3, 1, 1), np.float32)
    elif fault == "shape":
        entries["p:conv1a/b"] = np.zeros((5,), np.float32)
    else:
        entries["schema"] = np.asarray(2)
    np.savez(tmp_path / "bad.npz", **entries)
    with pytest.raises(ValueError, match=match):
        load_npz(str(tmp_path / "bad.npz"))
