"""Why the JAX cascade's f32 gradients lie far from its f64 ones.

    JAX_PLATFORMS=cpu python tests/probe_cascade_f32_kinks.py

Not a test (pytest does not collect it): a probe behind the f64 reference
of ``tests/test_torch_cascade.py``. At that test's weights and batch
(64x64, batch 1), it takes the JAX cascade's frozen-head loss gradient in
f32 and in f64 and prints the stage-2 parameters whose f32 gradient lies
furthest from the f64 one (``|dgrad| / |grad|``): first as the model is,
then with every LeakyReLU -- the separate ones and the one fused into each
cost volume -- replaced, in both precisions alike, by the smooth
``0.55 x + 0.45 sqrt(x^2 + 1e-8)`` (slope 0.1 below and 1 above a width of
~1e-4). A LeakyReLU input within rounding of 0 falls on either side in
the two precisions, and the gradient behind it jumps by 0.9 of its value;
the smooth stand-in has no such jump. Takes a few minutes on the CPU
(four compiles of the cascade's gradient).
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import maskflownet_tpu.nn as jnn  # noqa: E402
import test_torch_cascade as case  # noqa: E402
# the module, not the package's ``maskflownet`` function of the same name
model = sys.modules["maskflownet_tpu.models.maskflownet"]
REAL = (jnn.leaky_relu, model.correlation)


def smooth(x, slope=0.1):
    return 0.55 * x + 0.45 * jnp.sqrt(x * x + 1e-8)


def smooth_correlation(f1, f2, md, leaky=None):
    out = REAL[1](f1, f2, md)
    return out if leaky is None else smooth(out)


def loss_fn(dtype):
    def f(params, img1, img2, flow, mask):
        img1, img2, _ = case.jax_centralize(img1 / 255.0, img2 / 255.0)
        mask = jnp.broadcast_to(mask / 255.0, flow.shape[:3] + (1,))
        preds, _, _ = case.jax_cascade(jnn.apply_ctx(params, dtype), img1,
                                       img2, case.JCFG)
        return jnp.mean(case.jax_multiscale_epe(flow, mask, preds))
    return f


def grads(flat, batch, dtype):
    params = {k: jnp.asarray(v, dtype) for k, v in flat.items()}
    g = jax.jit(jax.grad(loss_fn(dtype)))(
        params, *(jnp.asarray(v, dtype) for v in batch))
    return {k: np.asarray(v, np.float64) for k, v in g.items()}


def main():
    flat = case._jax_weights(case._jax_shapes(), 0)
    rng = np.random.default_rng(1)       # the test's batch
    batch = [(255 * rng.random((1, 64, 64, 3))).astype(np.float32),
             (255 * rng.random((1, 64, 64, 3))).astype(np.float32),
             (3 * rng.standard_normal((1, 64, 64, 2))).astype(np.float32),
             (255 * (rng.random((1, 64, 64, 1)) > 0.1)).astype(np.float32)]
    for smoothed in (False, True):
        jnn.leaky_relu = smooth if smoothed else REAL[0]
        model.correlation = smooth_correlation if smoothed else REAL[1]
        with jax.enable_x64():
            g64 = grads(flat, batch, jnp.float64)
        g32 = grads(flat, batch, jnp.float32)
        errs = sorted(((np.linalg.norm(g32[k] - g64[k])
                        / np.linalg.norm(g64[k]), k) for k in g64
                       if not k.startswith(case.JAX_HEAD + "/")
                       and np.linalg.norm(g64[k]) > 0), reverse=True)
        print(f"{'smooth stand-in' if smoothed else 'LeakyReLU'}: worst "
              f"stage-2 |dgrad|/|grad|, f32 vs f64: "
              + ", ".join(f"{k} {e:.3e}" for e, k in errs[:5]), flush=True)


if __name__ == "__main__":
    main()
