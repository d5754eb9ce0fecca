"""File-format codecs for the optical-flow datasets: the port's copy of
``maskflownet_tpu/data/codecs.py``, byte for byte the same results on the
same files.

  * Middlebury ``.flo`` (magic 202021.25, little-endian) -- load & save.
  * FlyingChairs ``.ppm`` (fixed ``P6 512 384 255`` header) plus a general
    P6 parser.
  * 16-bit RGB PNG flow maps (KITTI/HD1K ground truth and submission
    format): a minimal PNG16 codec of its own (zlib chunks + scanline
    filters, unfiltered by the port's C++ runtime, ``native/``, as the
    JAX package's are), since neither this package nor the machines it
    runs on may rely on a 16-bit-capable PNG library.

  * 8-bit PNG images (``image_load``): the JAX package decodes them
    through PIL; this decoder is zlib and the same native unfilter (the
    same arrays for every type it accepts, and an error for the rest).
    ``png8_save`` writes gray and RGB ones (the JAX tools write them
    through PIL).

``_unfilter`` is the unfilter's plain numpy version, which the tests hold
the native one against; no reader calls it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from maskflownet_torch import native

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
    """Plain numpy version of ``native.png_unfilter``: the PNG unfilter of
    (h, stride) filtered bytes, each row by its own filter type (None,
    Sub, Up, Average, Paeth), ``bpp`` bytes a pixel (1 for bit depths
    below 8).

    A pixel's bytes depend only on its left, upper and upper-left
    neighbours, so the rows are swept as anti-diagonals: pixel (y, x) is
    decoded at step x + y, with every row's pixel of that step at once.
    The image is held skewed (row y shifted right by y) so that each step
    reads and writes whole slices."""
    h, stride = raw.shape
    w = stride // bpp
    steps = w + h - 1
    px = raw.reshape(h, w, bpp).astype(np.int16)
    # skewed[t, y] is pixel (y, t - y); out_s has two leading zero steps
    # and a leading zero row, so that neighbours outside the image read 0
    skewed = np.zeros((steps, h, bpp), np.int16)
    valid = np.zeros((steps, h, 1), bool)
    for y in range(h):
        skewed[y:y + w, y] = px[y]
        valid[y:y + w, y] = True
    out_s = np.zeros((steps + 2, h + 1, bpp), np.int16)
    ft = np.asarray(filters, np.int64).reshape(h, 1)
    if ((ft < 0) | (ft > 4)).any():
        raise ValueError(f"unknown PNG filter {int(ft[(ft < 0) | (ft > 4)][0])}")
    sub, up, avg, paeth = (ft == 1), (ft == 2), (ft == 3), (ft == 4)
    for t in range(steps):
        a = out_s[t + 1, 1:]        # left: (y, x - 1), step t - 1
        b = out_s[t + 1, :-1]       # up: (y - 1, x), step t - 1
        c = out_s[t, :-1]           # up-left: (y - 1, x - 1), step t - 2
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth, pred, np.where(avg, (a + b) >> 1, np.where(
            up, b, np.where(sub, a, 0))))
        out_s[t + 2, 1:] = np.where(valid[t], (skewed[t] + pred) & 255, 0)
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = out_s[y + 2:y + 2 + w, y + 1]
    return out.reshape(h, stride)


def _png_read(path: str):
    """(width, height, bit depth, channels, unfiltered rows (h, stride)
    uint8) of a non-interlaced PNG; every IDAT chunk, in order, unfiltered
    by ``native.png_unfilter``."""
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
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: unsupported PNG colour type {ctype} "
                         f"(palette)")
    bpp = max(1, channels * depth // 8)
    stride = (w * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    arr = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    body = arr[:, 1:].copy()
    native.png_unfilter(body, arr[:, 0], bpp)
    return w, h, depth, channels, body


def image_load(path: str) -> np.ndarray:
    """8-bit PNG -> uint8 array, what the JAX package's ``image_load``
    (PIL, ``np.asarray``) returns for it: gray (bit depth 8, or 1 with
    values 0 and 1) stacked to (H, W, 3); gray + alpha as (H, W, 2); RGB
    as (H, W, 3); RGBA's first three channels. Decoded here with zlib and
    the native unfilter. Every other PNG raises: 16-bit (the JAX function
    wraps its values to uint8), palette (it returns the indices),
    interlaced, and bit depths 2 and 4; so does a file that is not a PNG
    (``ppm_load`` reads FlyingChairs' PPMs)."""
    w, h, depth, channels, body = _png_read(path)
    if not (depth == 8 or (depth == 1 and channels == 1)):
        raise ValueError(f"{path}: unsupported PNG bit depth {depth} with "
                         f"{channels} channels (8-bit, or 1-bit gray, only)")
    if depth == 1:
        img = np.unpackbits(body, axis=1)[:, :w].reshape(h, w, 1)
    else:
        img = body.reshape(h, w, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=2)
    elif channels == 4:
        img = img[..., :3]
    return np.ascontiguousarray(img, dtype=np.uint8)


def png16_load(path: str) -> np.ndarray:
    """Load a 16-bit PNG -> (H, W, C) uint16 (C = 1 gray or 3 RGB)."""
    w, h, depth, channels, body = _png_read(path)
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported bit depth {depth}")
    stride = body.shape[1]
    if depth == 16:
        img = body.reshape(h, stride).view(">u2").astype(np.uint16)
    else:
        img = body.reshape(h, stride).astype(np.uint16)
    return img.reshape(h, w, channels)


def _png_write(path: str, arr: np.ndarray, dtype: str, depth: int) -> None:
    """(H, W) gray or (H, W, 1 | 3) gray/RGB as a PNG of ``depth`` bits: every
    row filter 0 (None), one zlib IDAT chunk."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 3: 2}[c]
    rows = np.ascontiguousarray(arr, dtype=dtype).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(typ: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + typ + payload
                + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(_PNG_SIG)
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, 0)))
        fp.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fp.write(chunk(b"IEND", b""))


def png16_save(arr: np.ndarray, path: str) -> None:
    """Save (H, W, 3) uint16 (or (H, W, 1)/(H, W) gray) as 16-bit PNG."""
    _png_write(path, arr, ">u2", 16)


def png8_save(arr: np.ndarray, path: str) -> None:
    """Save (H, W) gray or (H, W, 3) RGB uint8 as an 8-bit PNG: what the JAX
    tools write through PIL, which the card's machine does not have."""
    if arr.dtype != np.uint8:
        raise ValueError(f"png8_save: expected uint8, got {arr.dtype}")
    _png_write(path, arr, np.uint8, 8)


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
