"""FlyingChairs reader: the port's copy of ``maskflownet_tpu/data/chairs.py``
(reference ``reader/chairs/``).

Sample i (1-based) lives at ``{dir}/{i:05d}_img{1,2}.ppm`` +
``{i:05d}_flow.flo``. The train/val split file has one 1/2 digit per line
(``trainval.py``). The packed binary bulk format of ``binary_reader.py``
(concatenated img1/img2/flow records, NaN-filtered) is also supported.
"""

from __future__ import annotations

import os
import re

import numpy as np

from maskflownet_torch.data import codecs, paths

SHAPE = (384, 512)


def read_trainval(split_path: str | None = None) -> tuple[list[int], list[int]]:
    """1-based sample ids -> (train, validation) (reference
    ``reader/chairs/trainval.py:1-10``; 22872 samples)."""
    split_path = split_path or paths.chairs_split_file()
    train, val = [], []
    with open(split_path) as fp:
        for i in range(1, 22873):
            line = fp.readline()
            if not line.strip():
                break  # tolerate truncated split files (subset datasets)
            (train if line[:1] == "1" else val).append(i)
    return train, val


def load_sample(index: int, data_dir: str | None = None):
    """-> (img1 u8 RGB, img2, flow f32 (dy,dx)), each (384, 512, ...)."""
    data_dir = data_dir or paths.chairs_dir()
    img1 = codecs.ppm_load(os.path.join(data_dir, "%05d_img1.ppm" % index))
    img2 = codecs.ppm_load(os.path.join(data_dir, "%05d_img2.ppm" % index))
    flow = codecs.read_flo_dydx(
        os.path.join(data_dir, "%05d_flow.flo" % index), SHAPE)
    return img1, img2, flow


def load_set(indices, data_dir=None, samples: int = -1):
    """Bulk load a list of sample ids -> (img1s, img2s, flows) lists."""
    if samples != -1:
        indices = indices[:samples]
    triples = [load_sample(i, data_dir) for i in indices]
    if not triples:
        return [], [], []
    a, b, c = zip(*triples)
    return list(a), list(b), list(c)


def load_binary(prefix: str, subset: str, shape=SHAPE, samples: int = -1,
                dtype_bytes: int = 4):
    """Packed-binary bulk reader (reference ``binary_reader.py:6-38``):
    files ``{subset}{index}_{n}.bin`` hold n records of
    [img1 u8 HW3][img2 u8 HW3][flow f HW2]; records containing NaN flow are
    dropped. Returns (img1s, img2s, flows) with flow converted to (dy, dx)."""
    pattern = re.compile(r"{}(\d+)_(\d+).bin".format(subset))
    files = sorted((int(pattern.match(f).group(1)), f)
                   for f in os.listdir(prefix) if pattern.match(f))
    h, w = shape
    img_bytes = h * w * 3
    flow_dtype = np.float32 if dtype_bytes == 4 else np.float16
    flow_bytes = h * w * 2 * dtype_bytes
    ret = []
    for _, f in files:
        n = int(pattern.match(f).group(2))
        with open(os.path.join(prefix, f), "rb") as fp:
            buf = fp.read()
        off = 0
        for _ in range(n):
            i1 = np.frombuffer(buf, np.uint8, img_bytes, off).reshape(h, w, 3)
            off += img_bytes
            i2 = np.frombuffer(buf, np.uint8, img_bytes, off).reshape(h, w, 3)
            off += img_bytes
            fl = np.frombuffer(buf, flow_dtype, h * w * 2, off).reshape(h, w, 2)
            off += flow_bytes
            if not np.any(np.isnan(fl)):
                ret.append((i1.copy(), i2.copy(),
                            fl[..., ::-1].astype(np.float32)))
            if samples != -1 and len(ret) >= samples:
                break
        if samples != -1 and len(ret) >= samples:
            break
    if not ret:
        return [], [], []
    a, b, c = zip(*ret)
    return list(a), list(b), list(c)
