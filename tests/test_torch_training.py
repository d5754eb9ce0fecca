"""The port's train step against the JAX package's, at 64x64, batch 2, f32.

The JAX side is the step body of ``maskflownet_tpu/training/engine.py:
114-153`` with augmentation off, composed from the JAX package's own pieces
(``centralize``, ``maskflownet_s``, ``multiscale_epe``,
``epe_loss_with_mask``, ``optax.scale_by_adam``): building the JAX
``Trainer`` itself draws its weights with ``jax.random`` and compiles the
step for the 8-device CPU mesh, which takes minutes. Its
``jax.value_and_grad`` is compiled once, in a module fixture, and serves
the gradient check and the three-step loss trace. Weights are drawn with
numpy at the JAX ``Ctx``'s shapes and carried across by
``params_from_jax``.

Tolerances: the loss within rtol 1e-5 and each parameter's gradient within
``|g - g_jax| <= 1e-3 |g_jax|`` (f32 on both sides, ~30 convs deep, each
summing in another order). Adam is the same arithmetic on the same
gradients: 1e-6. Over three steps the gradients differ by those ~1e-5, and
Adam's first updates are about ``lr * sign(g)``, so a parameter whose
gradient is near zero may move by up to ``2 lr`` per step differently; the
loss trace is held to rtol 1e-3 and the parameters to ``6 lr``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from maskflownet_tpu import nn as jnn
from maskflownet_tpu.losses import epe_loss_with_mask as jax_epe
from maskflownet_tpu.losses import multiscale_epe as jax_multiscale_epe
from maskflownet_tpu.models.maskflownet import ModelConfig as JaxConfig
from maskflownet_tpu.models.maskflownet import maskflownet_s as jax_model
from maskflownet_tpu.ops import upsample as jax_upsample
from maskflownet_tpu.training import schedule as jax_schedule
from maskflownet_tpu.training.engine import Trainer as JaxTrainer
from maskflownet_tpu.training.engine import centralize as jax_centralize
from maskflownet_torch.interop import (hwio_to_oihw, nhwc_to_nchw,
                                       npz_entries, params_from_jax,
                                       params_to_jax, read_npz)
from maskflownet_torch.training import (TrainSettings, Trainer, lr_at_step,
                                        total_steps)

JCFG = JaxConfig(s2d=False, s2d_l2=False, dense="concat")
F32 = TrainSettings(compute_dtype="float32")
LR = 1e-4
STEPS = 3
ADAM = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)


@jax.jit
def _jax_adam_step(grads, state, params, lr):
    """engine.py:151-153: Adam's update applied as -lr * u (one compiled
    program: op by op, each of the ~200 parameter shapes compiles its own
    elementwise ops)."""
    updates, state = ADAM.update(grads, state, params)
    return jax.tree_util.tree_map(lambda p, u: p - lr * u, params,
                                  updates), state


def _jax_shapes():
    shapes = {}
    dummy = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    jax.eval_shape(lambda a, b: jax_model(
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
    """engine.py:115-145 with geo = color = None, f32 compute."""
    img1 = img1 / 255.0
    img2 = img2 / 255.0
    mask = jnp.broadcast_to(mask / 255.0, flow.shape[:3] + (1,))
    img1, img2, _ = jax_centralize(img1, img2)
    preds, _, _ = jax_model(jnn.apply_ctx(params), img1, img2, JCFG)
    loss = jax_multiscale_epe(flow, mask, preds)
    epe = jax_epe(jax_upsample(preds[-1], 4), flow, mask)
    return jnp.mean(loss), jnp.mean(epe)


@pytest.fixture(scope="module")
def case():
    """Weights, a batch (NHWC), and the JAX step: loss, epe and gradients
    at the weights, then the loss trace of STEPS Adam steps."""
    shapes = _jax_shapes()
    flat = _jax_weights(shapes, 0)
    rng = np.random.default_rng(1)
    batch = dict(
        img1=(255 * rng.random((2, 64, 64, 3))).astype(np.float32),
        img2=(255 * rng.random((2, 64, 64, 3))).astype(np.float32),
        flow=(3 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32),
        mask=(255 * (rng.random((2, 64, 64, 1)) > 0.1)).astype(np.float32))
    vg = jax.jit(jax.value_and_grad(_jax_loss_fn, has_aux=True))
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    state = jax.jit(ADAM.init)(params)
    trace, grads0 = [], None
    for _ in range(STEPS):
        (loss, epe), grads = vg(params, *batch.values())
        trace.append((float(loss), float(epe)))
        grads0 = grads if grads0 is None else grads0
        params, state = _jax_adam_step(grads, state, params, LR)
    return dict(shapes=shapes, flat=flat, batch=batch, trace=trace,
                grads0={k: np.asarray(v) for k, v in grads0.items()},
                params_after={k: np.asarray(v) for k, v in params.items()})


def _port_batch(batch):
    return [nhwc_to_nchw(batch[k]).copy()
            for k in ("img1", "img2", "flow", "mask")]


@pytest.fixture(scope="module")
def trained(case):
    """A port Trainer on the CPU after STEPS steps on the case's batch,
    with the metrics each step returned."""
    trainer = Trainer(F32, device="cpu", params=params_from_jax(case["flat"]))
    metrics = [trainer.train_batch(*_port_batch(case["batch"]), lr=LR,
                                   sync=True) for _ in range(STEPS)]
    return trainer, metrics


def test_loss_and_gradient_match_jax(case):
    trainer = Trainer(F32, device="cpu", params=params_from_jax(case["flat"]))
    loss, epe = trainer.loss(*_port_batch(case["batch"]))
    loss.backward()
    want_loss, want_epe = case["trace"][0]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(epe), want_epe, rtol=1e-5)
    got = params_to_jax({k: p.grad for k, p in trainer.params.items()})
    assert set(got) == set(case["grads0"])
    for k, want in case["grads0"].items():
        err = np.linalg.norm(got[k] - want)
        assert err <= 1e-3 * np.linalg.norm(want), (k, err)


def test_three_step_loss_trace_matches_jax(case, trained):
    trainer, metrics = trained
    for got, (want_loss, want_epe) in zip(metrics, case["trace"]):
        assert isinstance(got["loss"], float)
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-3)
        np.testing.assert_allclose(got["epe"], want_epe, rtol=1e-3)
    assert trainer.steps == STEPS
    got = params_to_jax(trainer.params)
    for k, want in case["params_after"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2 * STEPS * LR)


def test_train_batch_returns_device_tensors_unless_synced(case):
    trainer = Trainer(F32, device="cpu", params=params_from_jax(case["flat"]))
    img1, img2, flow, _ = _port_batch(case["batch"])
    m = trainer.train_batch(img1, img2, flow)   # no mask: all valid
    assert set(m) == {"loss", "epe"}
    assert all(torch.is_tensor(v) and v.dim() == 0 and not v.requires_grad
               for v in m.values())


@pytest.mark.parametrize("lrs", [(1e-4,), (1e-4, 5e-5, 2e-4)])
def test_adam_update_matches_optax(case, lrs):
    """The Trainer's optimizer on given gradients against
    optax.scale_by_adam followed by -lr * u, after each step."""
    trainer = Trainer(F32, device="cpu", params=params_from_jax(case["flat"]))
    params = {k: jnp.asarray(v) for k, v in case["flat"].items()}
    state = jax.jit(ADAM.init)(params)
    rng = np.random.default_rng(2)
    for lr in lrs:
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
            -9, 0)).astype(np.float32) for k, v in case["flat"].items()}
        for k, p in trainer.params.items():
            g = grads[k]
            p.grad = torch.from_numpy(hwio_to_oihw(g).copy() if g.ndim == 4
                                      else g)
        trainer.apply_gradients(lr)
        params, state = _jax_adam_step(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, params, lr)
        got = params_to_jax(trainer.params)
        for k, want in params.items():
            np.testing.assert_allclose(got[k], np.asarray(want), rtol=0,
                                       atol=1e-6)
        assert all(p.grad is None for p in trainer.params.values())


@pytest.mark.parametrize("steps", [0, 1, 1000, 1001, 2500, 3000, 3001])
def test_schedule_matches_jax(steps):
    sched = [(1000, 1e-4), (2000, 5e-5), (3000, 2.5e-5)]
    assert lr_at_step(sched, steps) == jax_schedule.lr_at_step(sched, steps)
    assert total_steps(sched) == jax_schedule.total_steps(sched) == 3000
    assert total_steps([]) == jax_schedule.total_steps([]) == 0


def _jax_trainer(params, mu=None, nu=None, count=0, steps=0):
    """A JAX Trainer holding the given state; ``__init__`` (fresh weights
    and a compiled step) is bypassed: save/load read only these fields."""
    t = JaxTrainer.__new__(JaxTrainer)
    t.params = {k: jnp.asarray(v) for k, v in params.items()}
    zeros = {k: jnp.asarray(np.zeros(v.shape, np.float32))
             for k, v in params.items()}
    t.opt_state = optax.ScaleByAdamState(
        count=jnp.asarray(count, jnp.int32),
        mu=zeros if mu is None else {k: jnp.asarray(v) for k, v in mu.items()},
        nu=zeros if nu is None else {k: jnp.asarray(v) for k, v in nu.items()})
    t.steps = steps
    return t


def _port_moments(trainer):
    state = {k: trainer.opt.state[p] for k, p in trainer.params.items()}
    mu = {k: st["exp_avg"] for k, st in state.items()}
    nu = {k: st["exp_avg_sq"] for k, st in state.items()}
    return params_to_jax(mu), params_to_jax(nu)


@pytest.fixture(scope="module")
def port_ckpt(trained, tmp_path_factory):
    """The trained port Trainer's checkpoint (written once: ~130 MB)."""
    prefix = tmp_path_factory.mktemp("ckpt") / "port"
    trained[0].save(str(prefix))
    return str(prefix) + ".npz"


def test_checkpoint_schema_matches_jax(case, trained, port_ckpt, tmp_path):
    """Key set, HWIO shapes, dtypes and count/step as the JAX Trainer.save
    writes them; then port save -> port load restores the whole state."""
    trainer, _ = trained
    _jax_trainer(case["flat"], count=STEPS, steps=STEPS).save(
        str(tmp_path / "jax"))
    with np.load(port_ckpt) as zp, np.load(tmp_path / "jax.npz") as zj:
        assert set(zp.files) == set(zj.files)
        for k in zj.files:
            assert zp[k].shape == zj[k].shape and zp[k].dtype == zj[k].dtype, k
        assert int(zp["count"]) == int(zp["step"]) == STEPS
        assert int(zp["schema"]) == int(zj["schema"]) == 1
    other = Trainer(F32, device="cpu", seed=1)
    other.load(port_ckpt)
    assert other.steps == STEPS
    for k, p in trainer.params.items():
        torch.testing.assert_close(other.params[k], p, rtol=0, atol=0)
        st, so = trainer.opt.state[p], other.opt.state[other.params[k]]
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(so[key], st[key], rtol=0, atol=0)
        assert int(so["step"]) == int(st["step"]) == STEPS


def test_port_checkpoint_loads_in_jax_trainer(trained, port_ckpt):
    trainer, _ = trained
    jt = _jax_trainer({k: np.zeros(v.shape, np.float32) for k, v in
                       params_to_jax(trainer.params).items()})
    jt.load(port_ckpt)
    assert jt.steps == STEPS and int(jt.opt_state.count) == STEPS
    mu, nu = _port_moments(trainer)
    for k, v in params_to_jax(trainer.params).items():
        np.testing.assert_array_equal(np.asarray(jt.params[k]), v)
        np.testing.assert_array_equal(np.asarray(jt.opt_state.mu[k]), mu[k])
        np.testing.assert_array_equal(np.asarray(jt.opt_state.nu[k]), nu[k])


def test_jax_checkpoint_loads_in_port_trainer(case, tmp_path):
    """Moments, Adam's count and the schedule's step come across, and the
    two counts stay separate."""
    rng = np.random.default_rng(3)
    mu = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in case["flat"].items()}
    nu = {k: rng.random(v.shape).astype(np.float32)
          for k, v in case["flat"].items()}
    _jax_trainer(case["flat"], mu, nu, count=7, steps=40).save(
        str(tmp_path / "jax"))
    trainer = Trainer(F32, device="cpu", seed=1)
    trainer.load(str(tmp_path / "jax.npz"))
    assert trainer.steps == 40
    assert all(int(trainer.opt.state[p]["step"]) == 7
               for p in trainer.params.values())
    got_mu, got_nu = _port_moments(trainer)
    for k in case["flat"]:
        np.testing.assert_array_equal(params_to_jax(
            {k: trainer.params[k]})[k], case["flat"][k])
        np.testing.assert_array_equal(got_mu[k], mu[k])
        np.testing.assert_array_equal(got_nu[k], nu[k])
    # without states only the parameters load
    fresh = Trainer(F32, device="cpu", seed=1)
    fresh.load(str(tmp_path / "jax.npz"), load_states=False)
    assert fresh.steps == 0 and not fresh.opt.state


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing mu"), ("unknown", "unknown"), ("shape", "shape"),
    ("schema", "newer")])
def test_read_npz_rejects_bad_moments(tmp_path, fault, match):
    """The rules Trainer.load applies to parameters hold for the moments
    (on a two-parameter checkpoint: the rules do not depend on the model)."""
    params = {"a/w": torch.zeros(4, 3, 3, 3), "a/b": torch.zeros(4)}
    entries = npz_entries(params, params, params, count=1, step=1)
    if fault == "missing":
        del entries["mu:a/w"]
    elif fault == "unknown":
        entries["nu:extra/b"] = np.zeros((3,), np.float32)
    elif fault == "shape":
        entries["nu:a/b"] = np.zeros((5,), np.float32)
    else:
        entries["schema"] = np.asarray(2)
    np.savez(tmp_path / "bad.npz", **entries)
    with pytest.raises(ValueError, match=match):
        read_npz(str(tmp_path / "bad.npz"),
                 {k: tuple(v.shape) for k, v in params.items()})


def test_validate_pads_the_last_batch_and_reports_both(case):
    """Three pairs in batches of two: the padded sample is not counted,
    and 'both' gives the two metrics of separate sweeps."""
    trainer = Trainer(F32, device="cpu", params=params_from_jax(case["flat"]))
    b = case["batch"]
    imgs1 = [b["img1"][i % 2].astype(np.uint8) for i in range(3)]
    imgs2 = [b["img2"][(i + 1) % 2].astype(np.uint8) for i in range(3)]
    flows = [b["flow"][i % 2] for i in range(3)]
    epe, fl = trainer.validate(imgs1, imgs2, flows, batch_size=2,
                               return_type="both")
    assert epe == pytest.approx(trainer.validate(imgs1, imgs2, flows,
                                                 batch_size=2))
    assert fl == pytest.approx(trainer.validate(imgs1, imgs2, flows,
                                                batch_size=3,
                                                return_type="kitti"))
    assert np.isfinite(epe) and 0.0 <= fl <= 1.0
