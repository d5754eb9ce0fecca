"""File-format codecs for the optical-flow datasets: the port's copy of
``maskflownet_tpu/data/codecs.py``, byte for byte the same results on the
same files.

  * Middlebury ``.flo`` (magic 202021.25, little-endian) -- load & save.
  * FlyingChairs ``.ppm`` (fixed ``P6 512 384 255`` header) plus a general
    P6 parser.
  * 16-bit RGB PNG flow maps (KITTI/HD1K ground truth and submission
    format): a minimal PNG16 codec of its own (zlib chunks + scanline
    filters, unfiltered in numpy), since neither this package nor the
    machines it runs on may rely on a 16-bit-capable PNG library.

The JAX package's ``image_load`` (8-bit images through PIL) has no copy
here yet: it comes with the Sintel/KITTI readers that call it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_FLO_MAGIC = 202021.25


def flo_load(path: str, expect_shape: tuple[int, int] | None = None) -> np.ndarray:
    """Load a .flo file -> (H, W, 2) float32 in (u, v) = (dx, dy) file order.

    NOTE: callers in this package convert to (dy, dx); use
    :func:`read_flo_dydx` for that.
    """
    with open(path, "rb") as fp:
        magic, w, h = struct.unpack("<fii", fp.read(12))
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"Bad flow header: {path}")
        if expect_shape is not None and (h, w) != tuple(expect_shape):
            raise ValueError(f"{path}: expected {expect_shape}, got {(h, w)}")
        data = np.frombuffer(fp.read(h * w * 8), dtype="<f4")
        return data.reshape(h, w, 2).copy()


def flo_save(arr: np.ndarray, path: str) -> None:
    """Save (H, W, 2) float32 (u, v) file-order flow as .flo."""
    h, w, c = arr.shape
    if c != 2:
        raise ValueError(f"flo_save: expected (H, W, 2), got {arr.shape}")
    with open(path, "wb") as fp:
        fp.write(struct.pack("<fii", _FLO_MAGIC, w, h))
        fp.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())


def read_flo_dydx(path: str, expect_shape=None) -> np.ndarray:
    """Load .flo and convert (u, v) -> (dy, dx), the package's convention."""
    return flo_load(path, expect_shape)[..., ::-1].copy()


def ppm_load(path: str) -> np.ndarray:
    """Load a binary P6 PPM -> (H, W, 3) uint8 RGB. Accepts the fixed
    FlyingChairs header and general P6 headers."""
    with open(path, "rb") as fp:
        data = fp.read()
    if not data.startswith(b"P6"):
        raise ValueError(f"Bad ppm header: {path}")
    # parse up to 3 whitespace-separated ints after P6, skipping comments
    pos, vals = 2, []
    while len(vals) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        vals.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = vals
    if maxval != 255:
        raise ValueError(f"{path}: only 8-bit PPM supported")
    return np.frombuffer(data, np.uint8, h * w * 3, pos).reshape(h, w, 3).copy()


# ---------------------------------------------------------------------------
# Minimal 16-bit PNG codec
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        yield typ, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if typ == b"IEND":
            break


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """PNG unfilter (per scanline; Sub vectorized via cumulative sums,
    Average/Paeth per pixel)."""
    h, stride = raw.shape
    out = np.zeros_like(raw)
    for y in range(h):
        ft = int(filters[y])
        row = raw[y].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = row.astype(np.uint8)
        elif ft == 1:
            px = row.reshape(-1, bpp)
            out[y] = (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ft == 2:
            out[y] = ((row + prev) % 256).astype(np.uint8)
        elif ft == 3:
            o = np.zeros(stride, np.int32)
            for i in range(stride):
                left = o[i - bpp] if i >= bpp else 0
                o[i] = (row[i] + ((left + prev[i]) >> 1)) % 256
            out[y] = o.astype(np.uint8)
        elif ft == 4:
            o = np.zeros(stride, np.int32)
            for i in range(stride):
                a = o[i - bpp] if i >= bpp else 0
                b = prev[i]
                cc = prev[i - bpp] if i >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                o[i] = (row[i] + pred) % 256
            out[y] = o.astype(np.uint8)
        else:
            raise ValueError(f"unknown PNG filter {ft}")
    return out


def png16_load(path: str) -> np.ndarray:
    """Load a 16-bit PNG -> (H, W, C) uint16 (C = 1 gray or 3 RGB)."""
    with open(path, "rb") as fp:
        data = fp.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"not a PNG: {path}")
    w = h = depth = ctype = None
    idat = []
    for typ, payload in _png_chunks(data):
        if typ == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace:
                raise ValueError(f"{path}: interlaced PNG unsupported")
        elif typ == b"IDAT":
            idat.append(payload)
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported bit depth {depth}")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    arr = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = np.ascontiguousarray(arr[:, 0])
    body = _unfilter(np.ascontiguousarray(arr[:, 1:]), filters, bpp)
    if depth == 16:
        img = body.reshape(h, stride).view(">u2").astype(np.uint16)
    else:
        img = body.reshape(h, stride).astype(np.uint16)
    return img.reshape(h, w, channels)


def png16_save(arr: np.ndarray, path: str) -> None:
    """Save (H, W, 3) uint16 (or (H, W, 1)/(H, W) gray) as 16-bit PNG."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + np.ascontiguousarray(arr[y], dtype=">u2").tobytes()
                   for y in range(h))

    def chunk(typ: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + typ + payload
                + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(_PNG_SIG)
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0, 0)))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))


def kitti_flow_decode(flow_occ: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode a KITTI flow_occ PNG array -> (flow (H,W,2) (dy,dx), occ uint8).

    KITTI 16-bit RGB channels are (u, v, valid) scaled by 64 with +2^15 bias
    (devkit ``flow_read``); this codec reads RGB directly.
    """
    u = (flow_occ[..., 0].astype(np.float32) - 32768.0) / 64.0
    v = (flow_occ[..., 1].astype(np.float32) - 32768.0) / 64.0
    occ = (flow_occ[..., 2:3] > 0).astype(np.uint8)
    return np.stack([v, u], axis=-1), occ


def kitti_flow_encode(flow_dydx: np.ndarray) -> np.ndarray:
    """Encode (H,W,2) (dy,dx) flow into KITTI 16-bit submission format
    (``64 * f + 2^15`` with valid = 1)."""
    h, w, _ = flow_dydx.shape
    out = np.ones((h, w, 3), np.float64)
    out[..., 0] = flow_dydx[..., 1] * 64.0 + 32768.0  # u
    out[..., 1] = flow_dydx[..., 0] * 64.0 + 32768.0  # v
    return np.clip(out, 0, 65535).astype(np.uint16)
