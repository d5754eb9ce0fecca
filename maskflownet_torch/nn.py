"""Functional NN core of the port (NCHW activations, OIHW weights).

Counterpart of ``maskflownet_tpu/nn.py``. Parameters live in a flat
``dict[str, Tensor]`` keyed by the same slash-separated names the JAX
package's ``Ctx`` gives them (``conv1a/w``, ``MaskFlownet_S/conv1a/w``, ...),
so the two packages share one checkpoint schema; only the weight layout
differs (HWIO there, OIHW here, converted in ``interop.py``). A forward
function takes a :class:`Ctx` and requests its parameters by name; the same
function collects the parameter shapes (``mode="shape"``, run on the
``meta`` device so no arithmetic happens) and applies the network.

Initial values come from a ``numpy.random.Generator``: the JAX package
draws from ``jax.random``, whose numbers no other library reproduces, so
weights made from a seed agree in distribution, not in value. Tests that
compare the two packages carry the JAX weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]
InitFn = Callable[[np.random.Generator, tuple[int, ...]], np.ndarray]


def msra_prelu(slope: float = 0.1) -> InitFn:
    """MSRA/He init for PReLU-family activations with the 'avg' fan (MXNet
    ``MSRAPrelu(slope=0.1)``, as ``maskflownet_tpu/nn.py:39-62``): gaussian
    with ``std = sqrt(2 / ((1 + slope^2) * (fan_in + fan_out) / 2))``. For an
    OIHW kernel ``fan_in = kh*kw*I`` and ``fan_out = kh*kw*O``."""
    magnitude = 2.0 / (1.0 + slope ** 2)

    def init(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
        if len(shape) == 4:
            rf = shape[2] * shape[3]
            fan_in, fan_out = rf * shape[1], rf * shape[0]
        elif len(shape) == 2:
            fan_in, fan_out = shape
        else:
            fan_in = fan_out = int(math.prod(shape))
        std = math.sqrt(magnitude / ((fan_in + fan_out) / 2.0))
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return init


def zeros_init(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    del rng
    return np.zeros(shape, np.float32)


@dataclasses.dataclass
class Ctx:
    """Parameter store/accessor threaded through forward functions."""

    mode: str  # 'shape' | 'apply'
    params: Params | None = None
    shapes: dict[str, tuple[tuple[int, ...], InitFn]] | None = None
    prefix: str = ""
    dtype: torch.dtype = torch.float32
    # the rank's row shard of a spatially sharded forward
    # (``parallel/spatial.py::RowShard``); None runs the ops whole
    rows: object | None = None

    def scope(self, name: str) -> "Ctx":
        return dataclasses.replace(self, prefix=self.prefix + name + "/")

    def param(self, name: str, shape: tuple[int, ...],
              init_fn: InitFn) -> torch.Tensor:
        full = self.prefix + name
        shape = tuple(shape)
        if self.mode == "shape":
            known = self.shapes.get(full)
            if known is not None and known[0] != shape:
                raise ValueError(f"param {full} requested with inconsistent "
                                 f"shapes {known[0]} vs {shape}")
            self.shapes[full] = (shape, init_fn)
            return torch.zeros(shape, dtype=self.dtype, device="meta")
        p = self.params[full]
        if tuple(p.shape) != shape:
            raise ValueError(f"param {full}: stored shape {tuple(p.shape)} "
                             f"!= requested {shape}")
        return p.to(self.dtype)


def collect_shapes(forward: Callable, *example_shapes: tuple[int, ...],
                   **kwargs) -> dict[str, tuple[tuple[int, ...], InitFn]]:
    """Run ``forward(ctx, *inputs, **kwargs)`` on ``meta`` tensors of the
    given shapes and return every parameter it requests."""
    shapes: dict[str, tuple[tuple[int, ...], InitFn]] = {}
    ctx = Ctx(mode="shape", shapes=shapes)
    forward(ctx, *[torch.zeros(s, device="meta") for s in example_shapes],
            **kwargs)
    return shapes


def init(shapes: dict[str, tuple[tuple[int, ...], InitFn]],
         seed: int) -> Params:
    """Materialize parameters in sorted-name order from one numpy seed."""
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(shapes[n][1](rng, shapes[n][0]))
            for n in sorted(shapes)}


def apply_ctx(params: Params, dtype: torch.dtype = torch.float32) -> Ctx:
    return Ctx(mode="apply", params=params, dtype=dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def conv2d(ctx: Ctx, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """``F.conv2d`` with zero padding ``padding`` on both axes, or its
    row-sharded form under ``ctx.rows``."""
    if ctx.rows is not None:
        return ctx.rows.conv2d(x, w, b, stride, padding, dilation)
    return F.conv2d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation)


def conv(ctx: Ctx, name: str, x: torch.Tensor, cout: int, *, k: int = 3,
         stride: int = 1, dilation: int = 1, act: bool = True,
         bias: bool = True) -> torch.Tensor:
    """Conv + optional LeakyReLU(0.1) (``maskflownet_tpu/nn.py:147-162``)."""
    w = ctx.param(f"{name}/w", (cout, x.shape[1], k, k), msra_prelu())
    b = ctx.param(f"{name}/b", (cout,), zeros_init) if bias else None
    y = conv2d(ctx, x, w, b, stride=stride, padding=dilation * (k - 1) // 2,
               dilation=dilation)
    return leaky_relu(y) if act else y


def deconv(ctx: Ctx, name: str, x: torch.Tensor, cout: int, *, k: int = 4,
           stride: int = 2, pad: int = 1, act: bool = True) -> torch.Tensor:
    """The JAX package's transposed conv (``maskflownet_tpu/nn.py:191-212``).

    There it is a forward conv over the input dilated by ``stride``, padded
    by ``k - 1 - pad``, with the stored kernel applied unflipped. The stored
    weight here is that kernel in OIHW (the same HWIO->OIHW rule as every
    conv); ``conv_transpose2d`` flips its kernel and swaps in/out, so it gets
    the flipped, swapped view -- the same function without multiplying the
    inserted zeros."""
    if not 0 <= pad <= k - 1:
        raise ValueError(f"deconv pad={pad} out of range for k={k}")
    w = ctx.param(f"{name}/w", (cout, x.shape[1], k, k), msra_prelu())
    b = ctx.param(f"{name}/b", (cout,), zeros_init)
    wt = w.flip(2, 3).transpose(0, 1)
    if ctx.rows is not None:
        y = ctx.rows.conv_transpose2d(x, wt, b, stride, pad)
    else:
        y = F.conv_transpose2d(x, wt, b, stride=stride, padding=pad)
    return leaky_relu(y) if act else y
