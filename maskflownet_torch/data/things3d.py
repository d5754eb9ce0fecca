"""FlyingThings3D-subset reader: the port's copy of
``maskflownet_tpu/data/things3d.py`` (reference ``reader/things3d.py``).

Path-only listing over {clean,final} x {left,right} x {into_future,into_past}
with the +/-1 frame pairing; flow is loaded lazily (optionally float16, the
dataset is ~400 GB in f16 -- reference ``main.py:278-284``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from maskflownet_torch.data import codecs, paths

SHAPE = (540, 960)


def list_data(root: str | None = None, sub_type: str = "clean") -> dict:
    root = root or paths.things3d_root()
    sub_types = ("clean", "final") if sub_type == "mixed" else (sub_type,)
    dataset = {"image_0": [], "image_1": [], "flow": []}
    for part in ("train",):
        for st in sub_types:
            for camera in ("left", "right"):
                for orient in ("into_future", "into_past"):
                    flow_ind = 1 if orient == "into_future" else -1
                    path_image = os.path.join(root, part, "image_" + st, camera)
                    path_flow = os.path.join(root, part, "flow", camera, orient)
                    if not os.path.isdir(path_flow):
                        continue
                    for f in sorted(os.listdir(path_flow)):
                        dataset["flow"].append(os.path.join(path_flow, f))
                        img = f.replace("flo", "png")
                        dataset["image_0"].append(os.path.join(path_image, img))
                        ind = int(f[-11:-4])
                        dataset["image_1"].append(os.path.join(
                            path_image,
                            img.replace("%07d" % ind, "%07d" % (ind + flow_ind))))
    return dataset


def _cache_size() -> int:
    """Decoded-sample LRU bound (entries). ~3.5 MB/sample mean (uint8 image
    / f16 flow), so the default 1024 holds ~3.5 GB -- a working set for the
    loader threads, NOT a bulk load. The reference decodes the entire shard
    into RAM up front (``main.py:280-296``, ~400 GB for the full set with
    its own warning); here the full schedule streams from disk. Tune with
    MFN_THINGS3D_CACHE (0 disables caching)."""
    return int(os.environ.get("MFN_THINGS3D_CACHE", "1024"))


@lru_cache(maxsize=1)
def _loader():
    @lru_cache(maxsize=_cache_size())
    def load(fname: str) -> np.ndarray:
        if fname.endswith("flo"):
            # f16 at decode: halves cache bytes; the train loader upcasts
            # (same conversion the reference applies at load, main.py:297)
            return codecs.read_flo_dydx(fname, SHAPE).astype(np.float16)
        return codecs.image_load(fname)
    return load


def load(fname: str) -> np.ndarray:
    return _loader()(fname)
