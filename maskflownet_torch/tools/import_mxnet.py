"""MXNet ``.params`` checkpoint importer: the port of
``maskflownet_tpu/tools/import_mxnet.py``.

The published MaskFlownet checkpoints are Gluon ``.params`` files. This
module reads them and converts them into the port's parameters (OIHW
tensors, ready for ``Predictor(params=...)`` or ``Trainer(params=...)``)
and into the v1 ``.npz`` checkpoint that both packages load:

    python -m maskflownet_torch.tools.import_mxnet \\
        dbbSep30-1206_1000000.params out.npz --network MaskFlownet_S

Two layers, numpy only (nothing here runs on a device):

1. A reader and writer of the MXNet NDArray list file (``mx.nd.save``,
   what Gluon 1.5's ``save_parameters`` emits). Little-endian throughout:

   * container: uint64 magic ``0x112``, uint64 reserved, uint64 array
     count, the NDArray records, uint64 name count, names as (uint64
     length, bytes);
   * dense NDArray record: uint32 version magic -- 0xF993FAC8 (V1),
     0xF993FAC9 (V2, adds an int32 storage type), 0xF993FACA (V3, V2's
     dense layout) -- then the shape (uint32 ndim + int64 dims; the legacy
     record before V1 has no magic and uint32 dims), int32 dev_type, int32
     dev_id, int32 type_flag, the raw data. Only dense records (storage
     type 0) are read.

2. The Gluon -> port name map and layouts. Gluon keys are attribute paths
   (``conv1a.0.weight``; the cascade's head under ``MaskFlownet_S.``;
   ``deform5.weight``; ``upfeat5.0.weight``); ``arg:``/``aux:`` prefixes
   of ``export``-style files are stripped. Transforms:

   * conv and deformable-conv weights: MXNet's (Cout, Cin, kh, kw) is
     already OIHW, kept as it is (tap order row-major, as the port's
     deformable conv reads it);
   * deconv (``Conv2DTranspose``, ``upfeat*``) weights: MXNet stores
     (Cin, Cout, kh, kw). The JAX import stores the spatially flipped HWIO
     kernel of the forward conv over the stride-dilated input, and the
     port's ``nn.deconv`` keeps that kernel in OIHW: (Cout, Cin, kh, kw),
     flipped in kh and kw. ``nn.deconv`` flips it back and swaps its
     first two axes for ``conv_transpose2d``, which therefore receives
     MXNet's own array: the port's deconv is MXNet's Deconvolution;
   * biases: as they are. Every array becomes f32 (half-precision and f64
     records included).

Channel order: the reference decodes KITTI/HD1K/Things3D frames with cv2
(BGR) and FlyingChairs/Sintel as RGB; the port is RGB-only.
``input_channel_order='bgr'`` (``--input_channel_order bgr``) adapts a
checkpoint trained on BGR frames to RGB inputs by reversing the image
input channels of ``conv1a`` (both networks) and of the cascade's
``conv1x`` (its channels 0-2; channel 3, the mask, stays). Checkpoints
fine-tuned on mixed RGB and BGR batches saw inconsistent channel order in
the reference itself; pick the dominant one.
"""

from __future__ import annotations

import argparse
import struct

import numpy as np
import torch

from maskflownet_torch import interop
from maskflownet_torch.models import HEAD_SCOPE, ModelConfig, param_shapes

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

# MXNet type_flag -> numpy dtype (mshadow base.h)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated .params file")
        self.pos += n
        return out


def _read_ndarray(r: _Reader) -> np.ndarray:
    first = r.read("I")
    if first in (_V2_MAGIC, _V3_MAGIC):
        stype = r.read("i")
        if stype != 0:  # kDefaultStorage
            raise NotImplementedError(
                f"sparse NDArray (storage type {stype}) not supported")
        ndim = r.read("I")
        shape = tuple(r.read("q") for _ in range(ndim))
    elif first == _V1_MAGIC:
        ndim = r.read("I")
        shape = tuple(r.read("q") for _ in range(ndim))
    else:
        # legacy: ``first`` was the shape's ndim, dims are uint32
        ndim = first
        if ndim > 32:
            raise ValueError(f"unrecognized .params record (magic {first:#x})")
        shape = tuple(r.read("I") for _ in range(ndim))
    r.read("ii")  # dev_type, dev_id
    type_flag = r.read("i")
    if type_flag not in _DTYPES:
        raise ValueError(f"unknown MXNet type_flag {type_flag}")
    dtype = np.dtype(_DTYPES[type_flag])
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    raw = r.read_bytes(count * dtype.itemsize)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def read_mxnet_params(path: str) -> dict[str, np.ndarray]:
    """Parse an MXNet NDArray-list file -> {name: array}, ``arg:``/``aux:``
    prefixes stripped."""
    with open(path, "rb") as fp:
        r = _Reader(fp.read())
    if r.read("Q") != _LIST_MAGIC:
        raise ValueError(f"{path}: not an MXNet NDArray file")
    r.read("Q")  # reserved
    n = r.read("Q")
    arrays = [_read_ndarray(r) for _ in range(n)]
    n_names = r.read("Q")
    if n_names != n:
        raise ValueError(f"{path}: {n} arrays but {n_names} names")
    names = [r.read_bytes(r.read("Q")).decode() for _ in range(n_names)]
    out = {}
    for name, arr in zip(names, arrays):
        if name.startswith(("arg:", "aux:")):
            name = name[4:]
        out[name] = arr
    return out


def write_mxnet_params(path: str, params: dict[str, np.ndarray]) -> None:
    """Write ``{name: array}`` as V2 dense records (synthetic checkpoints
    and round trips)."""
    chunks = [struct.pack("<QQQ", _LIST_MAGIC, 0, len(params))]
    names = list(params)
    for name in names:
        arr = np.ascontiguousarray(params[name])
        flag = _DTYPE_FLAGS.get(arr.dtype)
        if flag is None:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        chunks.append(struct.pack("<IiI", _V2_MAGIC, 0, arr.ndim))
        chunks.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        chunks.append(struct.pack("<iii", 1, 0, flag))  # cpu(0) context
        chunks.append(arr.tobytes())
    chunks.append(struct.pack("<Q", len(names)))
    for name in names:
        enc = name.encode()
        chunks.append(struct.pack("<Q", len(enc)) + enc)
    with open(path, "wb") as fp:
        fp.write(b"".join(chunks))


# ---------------------------------------------------------------------------
# Gluon -> port names and layouts
# ---------------------------------------------------------------------------

def map_key(mx_key: str) -> tuple[str, str]:
    """Gluon key -> (the port's parameter name, kind); kind is ``conv``
    (a conv or deformable-conv weight), ``deconv`` (a Conv2DTranspose
    weight) or ``bias``."""
    parts = [p for p in mx_key.split(".") if not p.isdigit()]
    scope = ""
    if parts and parts[0] == HEAD_SCOPE:
        scope = HEAD_SCOPE + "/"
        parts = parts[1:]
    if len(parts) != 2 or parts[1] not in ("weight", "bias"):
        raise ValueError(f"unrecognized Gluon parameter key {mx_key!r}")
    block, leaf = parts
    if leaf == "bias":
        return f"{scope}{block}/b", "bias"
    kind = "deconv" if block.startswith("upfeat") else "conv"
    return f"{scope}{block}/w", kind


def convert_array(arr: np.ndarray, kind: str) -> np.ndarray:
    """One MXNet array -> the port's layout (OIHW for weights), f32."""
    if kind == "bias":
        return arr.astype(np.float32)
    if arr.ndim != 4:
        raise ValueError(f"{kind} weight must be 4-D, got {arr.shape}")
    if kind == "conv":        # (Cout, Cin, kh, kw): OIHW already
        return np.ascontiguousarray(arr, dtype=np.float32)
    if kind == "deconv":      # (Cin, Cout, kh, kw) -> flipped (Cout, Cin, ...)
        w = np.transpose(arr, (1, 0, 2, 3))[:, :, ::-1, ::-1]
        return np.ascontiguousarray(w, dtype=np.float32)
    raise ValueError(kind)


def convert_params(mx_params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Gluon dict -> the port's flat dict of f32 numpy arrays (no shape
    validation)."""
    out = {}
    for key, arr in mx_params.items():
        name, kind = map_key(key)
        out[name] = convert_array(arr, kind)
    return out


def permute_input_channels(params: dict[str, np.ndarray]
                           ) -> dict[str, np.ndarray]:
    """Reverse the image input channels (OIHW axis 1) of ``conv1a`` (the S
    network and the cascade's head) and of the cascade's ``conv1x``
    (channels 0-2; its mask channel 3 stays), so that a checkpoint trained
    on BGR frames computes the same function on RGB inputs."""
    out = dict(params)
    for key, arr in params.items():
        block = key.split("/")[-2]
        if key.endswith("/w") and block in ("conv1a", "conv1x"):
            w = arr.copy()                       # (cout, cin, kh, kw)
            w[:, 0:3] = arr[:, 2::-1]
            out[key] = w
    return out


def expected_param_shapes(network: str, deform_bias: bool = True
                          ) -> dict[str, tuple[int, ...]]:
    """Name -> OIHW shape of every parameter of ``network``."""
    return param_shapes(ModelConfig(deform_bias=deform_bias), network)


def import_checkpoint(params_path: str, network: str = "MaskFlownet_S",
                      strict: bool = True, input_channel_order: str = "rgb"
                      ) -> dict[str, torch.Tensor]:
    """Read, convert and validate an MXNet checkpoint against ``network``.

    Returns the port's parameters: OIHW f32 tensors on the CPU. ``strict``
    requires exact coverage: every model parameter present, no unknown
    one, equal shapes. ``input_channel_order='bgr'`` adapts a checkpoint
    trained on BGR frames to RGB inputs (see the module docstring)."""
    converted = convert_params(read_mxnet_params(params_path))
    if input_channel_order == "bgr":
        converted = permute_input_channels(converted)
    elif input_channel_order != "rgb":
        raise ValueError(f"input_channel_order {input_channel_order!r}")
    expected = expected_param_shapes(network)
    missing = sorted(set(expected) - set(converted))
    extra = sorted(set(converted) - set(expected))
    bad = sorted(k for k in set(expected) & set(converted)
                 if tuple(converted[k].shape) != tuple(expected[k]))
    if strict and (missing or extra or bad):
        msgs = []
        if missing:
            msgs.append(f"missing {len(missing)}: {missing[:5]}")
        if extra:
            msgs.append(f"unknown {len(extra)}: {extra[:5]}")
        if bad:
            msgs.append("shape mismatches (OIHW): " + ", ".join(
                f"{k} {tuple(converted[k].shape)}!={tuple(expected[k])}"
                for k in bad[:5]))
        raise ValueError(f"{params_path} vs {network}: " + "; ".join(msgs))
    return {k: torch.from_numpy(v) for k, v in converted.items()}


def save_as_npz(params: dict[str, torch.Tensor], out_path: str,
                step: int = 0) -> None:
    """Write the v1 ``.npz`` that the JAX tool writes: ``step`` and the
    ``p:`` parameters in HWIO (``interop.params_to_jax``), no optimizer
    moments -- a fresh Adam state is right for a fine-tune from an import,
    and ``Trainer.load`` of either package skips absent moments."""
    out = {"step": np.asarray(step)}
    for k, v in interop.params_to_jax(params).items():
        out["p:" + k] = v
    np.savez(out_path, **out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("params", help="MXNet .params checkpoint")
    p.add_argument("out", help="output .npz checkpoint")
    p.add_argument("--network", default="MaskFlownet_S",
                   choices=["MaskFlownet_S", "MaskFlownet"])
    p.add_argument("--step", type=int, default=0)
    p.add_argument("--lenient", action="store_true",
                   help="allow partial coverage (still converts layouts)")
    p.add_argument("--input_channel_order", default="rgb",
                   choices=["rgb", "bgr"],
                   help="channel order the checkpoint was trained on; 'bgr' "
                        "permutes first-layer weights so the imported model "
                        "takes RGB input (reference KITTI/HD1K/Things3D "
                        "training data was cv2-BGR)")
    args = p.parse_args(argv)
    params = import_checkpoint(args.params, args.network,
                               strict=not args.lenient,
                               input_channel_order=args.input_channel_order)
    save_as_npz(params, args.out, step=args.step)
    print(f"wrote {len(params)} params to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
