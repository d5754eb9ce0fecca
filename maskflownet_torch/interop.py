"""The boundary with the JAX package: layouts and checkpoints.

The JAX package keeps activations NHWC and conv weights HWIO; the port keeps
NCHW and OIHW. This module is the one place that converts, so a checkpoint
written by either package loads in the other. ``load_npz`` reads the v1
``.npz`` schema of ``maskflownet_tpu/training/engine.py:327-392``
(``p:<name>`` parameters, ``mu:``/``nu:`` Adam moments, ``step``,
``count``, ``schema``); inference reads only the ``p:`` entries.
"""

from __future__ import annotations

import numpy as np
import torch

CKPT_SCHEMA = 1


def nhwc_to_nchw(a):
    return a.permute(0, 3, 1, 2) if torch.is_tensor(a) else \
        np.transpose(a, (0, 3, 1, 2))


def nchw_to_nhwc(a):
    return a.permute(0, 2, 3, 1) if torch.is_tensor(a) else \
        np.transpose(a, (0, 2, 3, 1))


def hwio_to_oihw(w):
    return w.permute(3, 2, 0, 1) if torch.is_tensor(w) else \
        np.transpose(w, (3, 2, 0, 1))


def params_from_jax(flat: dict[str, np.ndarray],
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """JAX flat params -> port params: 4-D kernels HWIO -> OIHW (deconv
    kernels too: ``nn.deconv`` stores the forward-conv kernel of its
    input-dilated form, see ``maskflownet_torch.nn.deconv``); biases as
    they are."""
    out = {}
    for name, v in flat.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = hwio_to_oihw(a)
        out[name] = torch.tensor(np.ascontiguousarray(a), dtype=dtype)
    return out


def load_npz(path: str, expected: dict[str, tuple[int, ...]] | None = None,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Load the ``p:`` parameters of a v1 checkpoint as port params.

    ``expected`` maps each parameter name to its OIHW shape (default: the
    MaskFlownet_S parameters, ``models.param_shapes()``). Missing, unknown
    and mis-shaped entries raise, as ``Trainer.load`` does."""
    if expected is None:
        from maskflownet_torch.models import param_shapes
        expected = param_shapes()
    with np.load(path) as z:
        if "schema" in z and int(z["schema"]) > CKPT_SCHEMA:
            raise ValueError(
                f"checkpoint schema v{int(z['schema'])} is newer than this "
                f"build supports (v{CKPT_SCHEMA}): {path}")
        flat = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    missing = set(expected) - set(flat)
    if missing:
        raise ValueError(f"checkpoint missing params: {sorted(missing)[:5]}")
    unknown = set(flat) - set(expected)
    if unknown:
        raise ValueError(f"checkpoint has {len(unknown)} params unknown to "
                         f"the model: {sorted(unknown)[:5]}")
    params = params_from_jax(flat, dtype)
    for k, v in params.items():
        if tuple(v.shape) != tuple(expected[k]):
            raise ValueError(f"checkpoint param {k!r} shape {tuple(v.shape)} "
                             f"(OIHW) != model shape {tuple(expected[k])}")
    return params
