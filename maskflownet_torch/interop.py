"""The boundary with the JAX package: layouts and checkpoints.

The JAX package keeps activations NHWC and conv weights HWIO; the port keeps
NCHW and OIHW. This module is the one place that converts, so a checkpoint
written by either package loads in the other. The v1 ``.npz`` schema of
``maskflownet_tpu/training/engine.py:327-392`` holds ``p:<name>``
parameters, ``mu:``/``nu:`` Adam moments (in the parameters' layout),
``step`` (the schedule's), ``count`` (Adam's) and ``schema``.
``npz_entries`` writes it, ``read_npz`` reads all of it and ``load_npz``
only the ``p:`` entries, which is what inference needs.
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


def oihw_to_hwio(w):
    return w.permute(2, 3, 1, 0) if torch.is_tensor(w) else \
        np.transpose(w, (2, 3, 1, 0))


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


def params_to_jax(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port params (or Adam moments of the same layout) -> JAX flat f32
    numpy arrays: 4-D kernels OIHW -> HWIO, the inverse of
    :func:`params_from_jax`."""
    out = {}
    for name, v in params.items():
        a = v.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = oihw_to_hwio(a)
        out[name] = np.ascontiguousarray(a)
    return out


def npz_entries(params: dict[str, torch.Tensor],
                mu: dict[str, torch.Tensor] | None = None,
                nu: dict[str, torch.Tensor] | None = None,
                count: int = 0, step: int = 0) -> dict[str, np.ndarray]:
    """The v1 checkpoint entries, as ``Trainer.state_dict`` of the JAX
    package writes them (``engine.py:332-350``), for ``np.savez``. Moments
    that are None are written as zeros (an optimizer that has not
    stepped)."""
    out = {"step": np.asarray(step), "schema": np.asarray(CKPT_SCHEMA)}
    p = params_to_jax(params)
    for k, v in p.items():
        out["p:" + k] = v
    for prefix, moments in (("mu:", mu), ("nu:", nu)):
        m = (params_to_jax(moments) if moments is not None
             else {k: np.zeros_like(v) for k, v in p.items()})
        for k, v in m.items():
            out[prefix + k] = v
    out["count"] = np.asarray(count, np.int32)     # optax keeps an int32
    return out


def _check_names(what: str, got: dict, expected: dict) -> None:
    missing = set(expected) - set(got)
    if missing:
        raise ValueError(f"checkpoint missing {what}: {sorted(missing)[:5]}")
    unknown = set(got) - set(expected)
    if unknown:
        raise ValueError(f"checkpoint has {len(unknown)} {what} unknown to "
                         f"the model: {sorted(unknown)[:5]}")


def read_npz(path: str, expected: dict[str, tuple[int, ...]] | None = None,
             dtype: torch.dtype = torch.float32) -> dict:
    """Read a v1 checkpoint into port layout.

    Returns ``{"params", "mu", "nu", "count", "step"}``: dicts of OIHW
    tensors (``mu``/``nu`` None when the file holds no moments) and ints
    (``count`` and ``step`` None when absent). ``expected`` maps each
    parameter name to its OIHW shape (default: the MaskFlownet_S
    parameters, ``models.param_shapes()``). A newer schema, and missing,
    unknown and mis-shaped parameters raise, as ``Trainer.load`` does; the
    moments are held to the same rules."""
    if expected is None:
        from maskflownet_torch.models import param_shapes
        expected = param_shapes()
    with np.load(path) as z:
        if "schema" in z and int(z["schema"]) > CKPT_SCHEMA:
            raise ValueError(
                f"checkpoint schema v{int(z['schema'])} is newer than this "
                f"build supports (v{CKPT_SCHEMA}): {path}")
        flat = {p: {k[len(p):]: z[k] for k in z.files if k.startswith(p)}
                for p in ("p:", "mu:", "nu:")}
        count = int(z["count"]) if "count" in z else None
        step = int(z["step"]) if "step" in z else None
    out = {"count": count, "step": step}
    for prefix, key in (("p:", "params"), ("mu:", "mu"), ("nu:", "nu")):
        what = "param" if prefix == "p:" else f"{prefix[:-1]} moment"
        if prefix != "p:" and not flat[prefix]:
            out[key] = None
            continue
        _check_names(what + "s", flat[prefix], expected)
        tensors = params_from_jax(flat[prefix], dtype)
        for k, v in tensors.items():
            if tuple(v.shape) != tuple(expected[k]):
                raise ValueError(
                    f"checkpoint {what} {k!r} shape {tuple(v.shape)} (OIHW) "
                    f"!= model shape {tuple(expected[k])}")
        out[key] = tensors
    return out


def load_npz(path: str, expected: dict[str, tuple[int, ...]] | None = None,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Load the ``p:`` parameters of a v1 checkpoint as port params (see
    :func:`read_npz`)."""
    return read_npz(path, expected, dtype)["params"]
