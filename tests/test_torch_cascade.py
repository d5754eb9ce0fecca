"""The MaskFlownet cascade in the port against the JAX package, at 64x64,
batch 1, f32, at the published widths: the forward, the frozen-head train
step (``fix_head``) and ``load_head``.

The JAX side is the cascade's step body of
``maskflownet_tpu/training/engine.py:114-153`` with augmentation off and
``fix_head`` (the head's gradients zeroed before Adam), composed from the
JAX package's own pieces; building the JAX ``Trainer`` takes minutes on the
CPU. Its ``jax.value_and_grad`` is compiled once, in a module fixture, and
serves the forward, the gradient check and the two-step Adam state.
Weights are drawn with numpy at the JAX ``Ctx``'s shapes and carried
across by ``params_from_jax``.

The JAX side computes in f64 (``jax.enable_x64``, compute dtype f64; the
model keeps its flows and losses in f32 by its own casts): in f32 the JAX
gradients of the stage-2 pyramid's first two levels (``conv1x`` ..
``conv2z``) lie up to 6.6e-3 of their norm from an f64 evaluation of
either package, where the port's f32 lies within 1e-5 (ROADMAP queue 3).

Tolerances, as ``tests/test_torch_model.py`` and
``tests/test_torch_training.py`` state them for MaskFlownet_S: predictions
within rtol 1e-4, atol 5e-4 px (~45 convs deep from the images to the
cascade's flow2, each summing in another order); the loss within rtol
1e-5; each parameter's gradient within 1e-3 of its norm; Adam's moments
after two steps within 2e-3 of their norm (the second step's gradients are
taken at parameters that moved by ~lr, differently where a gradient is
near zero).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from maskflownet_tpu import nn as jnn
from maskflownet_tpu.losses import multiscale_epe as jax_multiscale_epe
from maskflownet_tpu.models.maskflownet import HEAD_SCOPE as JAX_HEAD
from maskflownet_tpu.models.maskflownet import ModelConfig as JaxConfig
from maskflownet_tpu.models.maskflownet import maskflownet as jax_cascade
from maskflownet_tpu.training.engine import centralize as jax_centralize
from maskflownet_torch import nn as tnn
from maskflownet_torch.inference import Predictor
from maskflownet_torch.interop import (nchw_to_nhwc, nhwc_to_nchw,
                                       npz_entries, params_from_jax,
                                       params_to_jax)
from maskflownet_torch.models import HEAD_SCOPE, ModelConfig, param_shapes
from maskflownet_torch.models.maskflownet import build_model, maskflownet
from maskflownet_torch.ops.resample import upsample
from maskflownet_torch.training import TrainSettings, Trainer

JCFG = JaxConfig(s2d=False, s2d_l2=False, dense="concat")
FROZEN = TrainSettings(model="MaskFlownet", fix_head=True,
                       compute_dtype="float32")
LR = 1e-4
ADAM = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
PRED_TOL = dict(rtol=1e-4, atol=5e-4)


def _jax_shapes():
    shapes = {}
    dummy = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    jax.eval_shape(lambda a, b: jax_cascade(
        jnn.Ctx(mode="shape", shapes=shapes), a, b, JCFG), dummy, dummy)
    return {k: v[0] for k, v in shapes.items()}


def _jax_weights(shapes, seed):
    rng = np.random.default_rng(seed)
    flat = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if len(shape) == 4:
            fan = shape[0] * shape[1] * (shape[2] + shape[3]) / 2
            flat[name] = (np.sqrt(2 / 1.01 / fan)
                          * rng.standard_normal(shape)).astype(np.float32)
        else:   # biases: small nonzero values, so a lost bias shows
            flat[name] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    return flat


def _jax_loss_fn(params, img1, img2, flow, mask):
    """engine.py:115-145 with geo = color = None, f64 compute; the aux
    carries the predictions and visuals."""
    img1, img2, _ = jax_centralize(img1 / 255.0, img2 / 255.0)
    mask = jnp.broadcast_to(mask / 255.0, flow.shape[:3] + (1,))
    preds, visuals, _ = jax_cascade(jnn.apply_ctx(params, jnp.float64),
                                    img1, img2, JCFG)
    loss = jax_multiscale_epe(flow, mask, preds)
    return jnp.mean(loss), (preds, visuals)


def _frozen(grads):
    """engine.py:147-150: the head's gradients zeroed."""
    return {k: jnp.zeros_like(v) if k.startswith(JAX_HEAD + "/") else v
            for k, v in grads.items()}


@jax.jit
def _jax_adam_step(grads, state, params):
    updates, state = ADAM.update(grads, state, params)
    return jax.tree_util.tree_map(lambda p, u: p - LR * u, params,
                                  updates), state


@pytest.fixture(scope="module")
def case():
    """Weights, a batch of one (NHWC), and the JAX frozen-head step: the
    loss, predictions, visuals and gradients at the weights, then Adam's
    state after two steps."""
    shapes = _jax_shapes()
    flat = _jax_weights(shapes, 0)
    rng = np.random.default_rng(1)
    batch = dict(
        img1=(255 * rng.random((1, 64, 64, 3))).astype(np.float32),
        img2=(255 * rng.random((1, 64, 64, 3))).astype(np.float32),
        flow=(3 * rng.standard_normal((1, 64, 64, 2))).astype(np.float32),
        mask=(255 * (rng.random((1, 64, 64, 1)) > 0.1)).astype(np.float32))
    with jax.enable_x64():
        vg = jax.jit(jax.value_and_grad(_jax_loss_fn, has_aux=True))
        params = {k: jnp.asarray(v, jnp.float64) for k, v in flat.items()}
        state = ADAM.init(params)
        first = None
        for _ in range(2):
            (loss, aux), grads = vg(params, *(jnp.asarray(v, jnp.float64)
                                              for v in batch.values()))
            grads = _frozen(grads)
            first = first or (float(loss), aux, grads)
            params, state = _jax_adam_step(grads, state, params)
        loss, (preds, visuals), grads = first
        return dict(shapes=shapes, flat=flat, batch=batch, loss=loss,
                    preds=[np.asarray(p) for p in preds],
                    visual=np.asarray(visuals[0]),
                    grads={k: np.asarray(v) for k, v in grads.items()},
                    count=int(state.count),
                    mu={k: np.asarray(v) for k, v in state.mu.items()},
                    nu={k: np.asarray(v) for k, v in state.nu.items()})


def _port_batch(batch):
    return [nhwc_to_nchw(batch[k]).copy()
            for k in ("img1", "img2", "flow", "mask")]


def _near(got, want, rel):
    """|got - want| <= rel |want| in the Frobenius norm."""
    return np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


def test_models_package_keeps_its_submodule():
    """``import maskflownet_torch.models.maskflownet as m`` gives the module
    (whose ``correlation`` chip_smoke.py patches), not the cascade's
    forward function of the same name."""
    import maskflownet_torch.models.maskflownet as module
    assert hasattr(module, "correlation") and module.maskflownet is maskflownet
    assert build_model("MaskFlownet") is maskflownet
    with pytest.raises(NotImplementedError, match="unknown model"):
        build_model("MaskFlownet_X")


def test_param_names_and_shapes_match_jax(case):
    want = {k: (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
            for k, s in case["shapes"].items()}
    assert param_shapes(model="MaskFlownet") == want
    assert HEAD_SCOPE == JAX_HEAD
    head = {k[len(HEAD_SCOPE) + 1:]: v for k, v in want.items()
            if k.startswith(HEAD_SCOPE + "/")}
    assert head == param_shapes()


@pytest.mark.parametrize("deform", ["warpconv", "kernel"])
def test_forward_matches_jax(case, deform):
    """All five predictions and the visual (flow2's channel 0, not a
    mask), with either deformable-conv method."""
    trainer = Trainer(FROZEN, device="cpu",
                      params=params_from_jax(case["flat"]))
    img1, img2, _, _ = trainer.prepare(*_port_batch(case["batch"]))
    with torch.no_grad():
        preds, visuals, rest = maskflownet(
            tnn.apply_ctx(trainer.params), img1, img2,
            ModelConfig(deform=deform))
    assert len(preds) == 5 and len(visuals) == 1 and rest == ()
    for got, want in zip(preds, case["preds"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(nchw_to_nhwc(got.numpy()), want,
                                   **PRED_TOL)
    np.testing.assert_allclose(nchw_to_nhwc(visuals[0].numpy()),
                               case["visual"], rtol=1e-4, atol=5e-4 / 20)


def test_frozen_head_loss_and_gradients_match_jax(case):
    trainer = Trainer(FROZEN, device="cpu",
                      params=params_from_jax(case["flat"]))
    loss, _ = trainer.loss(*_port_batch(case["batch"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    stage2 = [k for k in trainer.params if not k.startswith(HEAD_SCOPE)]
    assert {k for k in trainer.params if k not in stage2} == trainer.frozen
    assert all(trainer.params[k].grad is None for k in trainer.frozen)
    got = params_to_jax({k: trainer.params[k].grad for k in stage2})
    for k in stage2:
        want = case["grads"][k]
        assert np.any(want), k
        assert _near(got[k], want, 1e-3), k


def test_two_frozen_steps_write_jax_adam_state(case):
    """After two fix_head steps the head is bitwise unchanged, and the
    checkpoint's count, mu: and nu: are those of the JAX step: count 2,
    the head's moments zero, stage 2's as JAX's."""
    params = params_from_jax(case["flat"])
    trainer = Trainer(FROZEN, device="cpu", params=params)
    for _ in range(2):
        trainer.train_batch(*_port_batch(case["batch"]), lr=LR)
    for k in trainer.frozen:
        torch.testing.assert_close(trainer.params[k].detach(), params[k],
                                   rtol=0, atol=0)
    sd = trainer.state_dict()
    assert int(sd["count"]) == case["count"] == 2
    assert sd["count"].dtype == np.int32 and int(sd["step"]) == 2
    for k in case["mu"]:
        if k.startswith(HEAD_SCOPE + "/"):
            assert not np.any(sd["mu:" + k]) and not np.any(sd["nu:" + k])
            assert not np.any(case["mu"][k]) and not np.any(case["nu"][k])
        else:
            assert _near(sd["mu:" + k], case["mu"][k], 2e-3), k
            assert _near(sd["nu:" + k], case["nu"][k], 2e-3), k


def test_cascade_predictor_occlusion_is_flow2_channel_0(case):
    """The cascade's "occlusion" output is the upsampled visual, flow2's
    channel 0 in internal units (flow / 20), not a sigmoid."""
    pred = Predictor(params_from_jax(case["flat"]), device="cpu",
                     dtype=torch.float32, model="MaskFlownet")
    img = case["batch"]
    i1, i2 = (nhwc_to_nchw(img[k]).copy() / 255.0 for k in ("img1", "img2"))
    flow, occ, warped = pred.do_batch(i1, i2)
    assert occ.shape == (1, 1, 64, 64) and warped.shape == (1, 3, 64, 64)
    scale = pred.cfg.scale
    torch.testing.assert_close(occ * scale, flow[:, 0:1], rtol=1e-5,
                               atol=1e-5)
    want = upsample(torch.from_numpy(nhwc_to_nchw(case["preds"][-1]).copy()),
                    4)
    np.testing.assert_allclose(flow.numpy(), want.numpy(), **PRED_TOL)
    assert occ.min() < 0 or occ.max() > 1     # not a mask


@pytest.fixture(scope="module")
def s_checkpoint(case, tmp_path_factory):
    """A standalone MaskFlownet_S checkpoint: the case's head weights,
    without their scope."""
    head = {k[len(HEAD_SCOPE) + 1:]: v for k, v in
            params_from_jax(case["flat"]).items()
            if k.startswith(HEAD_SCOPE + "/")}
    path = tmp_path_factory.mktemp("head") / "MaskFlownet_S.npz"
    np.savez(path, **npz_entries(head))
    return str(path)


def test_load_head_fills_the_head(case, s_checkpoint):
    trainer = Trainer(FROZEN, device="cpu", seed=3)
    stage2 = {k: v.detach().clone() for k, v in trainer.params.items()
              if not k.startswith(HEAD_SCOPE)}
    trainer.load_head(s_checkpoint)
    want = params_from_jax(case["flat"])
    for k, p in trainer.params.items():
        torch.testing.assert_close(p.detach(), stage2.get(k, want[k]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fault,match", [
    ("unknown", "not in model"), ("missing", "does not cover the head"),
    ("shape", "shape")])
def test_load_head_rejects_bad_checkpoints(s_checkpoint, tmp_path, fault,
                                           match):
    with np.load(s_checkpoint) as z:
        entries = dict(z)
    if fault == "unknown":
        entries["p:extra/w"] = np.zeros((3, 3, 1, 1), np.float32)
    elif fault == "missing":
        del entries["p:conv1a/w"]
    else:
        entries["p:conv1a/b"] = np.zeros((5,), np.float32)
    np.savez(tmp_path / "bad.npz", **entries)
    trainer = Trainer(FROZEN, device="cpu", seed=3)
    with pytest.raises(ValueError, match=match):
        trainer.load_head(str(tmp_path / "bad.npz"))


def test_branch_replay_pins_the_leaky_sides():
    """``tools/grad_parity.py``'s replay, which chip_smoke uses to compare
    two steps at the same side of every kink: a step replaying its own
    branches flips none and gives its loss and gradients again (within
    1e-7: the CPU's threads sum in varying order); one replaying LeakyReLU
    inputs pushed just across 0 (by at most 1e-6 of their tensor's rms)
    counts them as flipped and moves a gradient by more than 1e-4 of its
    norm (here one input, 1.5e-2 at ``deform2/b``) while the loss stays
    within 1e-6."""
    from maskflownet_torch.models import init_params
    from maskflownet_torch.tools import grad_parity

    trainer = Trainer(FROZEN, device="cpu",
                      params=init_params(2, model="MaskFlownet"))
    batch = grad_parity.shifted_batch(2, (64, 64))
    loss, grads, seen = grad_parity.step(trainer, batch)
    again, same, seen_again = grad_parity.step(trainer, batch, seen)
    assert not any(grad_parity.flips(seen_again, seen).values())
    assert abs(again - loss) <= 1e-7 * abs(loss)
    assert grad_parity.worst(same, grads)[0] <= 1e-7

    def across(x):
        rms = x.pow(2).mean().sqrt()
        return torch.where((x.abs() < 1e-6 * rms) & (x != 0), -x, x)

    pushed = dict(seen, leaky=[across(x) for x in seen["leaky"]])
    moved_loss, moved, _ = grad_parity.step(trainer, batch, pushed)
    assert grad_parity.flips(pushed, seen)["leaky"] > 0
    assert abs(moved_loss - loss) <= 1e-6 * abs(loss)
    assert grad_parity.worst(moved, grads)[0] > 1e-4
