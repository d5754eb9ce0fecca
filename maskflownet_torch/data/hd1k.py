"""HD1K reader: the port's copy of ``maskflownet_tpu/data/hd1k.py``
(reference ``reader/hd1k.py``).

Same 16-bit flow PNG codec as KITTI, plus: fixed (50, 100) border crop,
optional pair brightness normalization to [0, 255], skipping of sequence
boundaries (first frame of each sequence has no predecessor,
``hd1k.py:38-49``), flow pre-multiplied by the validity mask before resize
(``hd1k.py:59``), and the same occlusion renormalization.
"""

from __future__ import annotations

import os

import numpy as np

from maskflownet_torch.data import codecs, paths
from maskflownet_torch.data.resize import resize_bilinear_np

VALIDATE_INDICES = [5]


def default_paths(root: str | None = None) -> dict:
    root = root or paths.hd1k_root()
    return {
        "image": os.path.join(root, "hd1k_input", "image_2"),
        "flow_occ": os.path.join(root, "hd1k_flow_gt", "flow_occ"),
    }


def read_dataset(path: dict | None = None, parts: str = "mixed", resize=None,
                 samples: int = -1, normalize: bool = True,
                 crop=(50, 100)) -> dict:
    path = path or default_paths()
    dataset = {"image_0": [], "image_1": [], "flow": [], "occ": []}
    path_images = path["image"]
    path_flows = path["flow_occ"]
    list_files = sorted(os.listdir(path_flows))
    num_files = len(list_files) - 1
    if samples != -1:
        num_files = min(num_files, samples)
    ind = 0
    i_pre = -1
    for k in range(num_files):
        if ind < len(VALIDATE_INDICES) and VALIDATE_INDICES[ind] == k:
            ind += 1
            if parts == "train":
                continue
        elif parts == "valid":
            continue
        i_cur = int(list_files[k][-15:-9])
        j_cur = int(list_files[k][-8:-4])
        first_of_seq = i_cur != i_pre
        i_pre = i_cur
        if first_of_seq:
            continue
        sl = (slice(crop[0], -crop[0]), slice(crop[1], -crop[1]))
        img0 = codecs.image_load(os.path.join(
            path_images, "%06d_%04d.png" % (i_cur, j_cur - 1)))[sl]
        img1 = codecs.image_load(os.path.join(
            path_images, "%06d_%04d.png" % (i_cur, j_cur)))[sl]
        flow_occ = codecs.png16_load(os.path.join(
            path_flows, "%06d_%04d.png" % (i_cur, j_cur - 1)))[sl]
        if normalize:
            lo = min(img0.min(), img1.min())
            hi = max(img0.max(), img1.max())
            img0, img1 = [((im.astype(np.float32) - lo) * (255.0 / (hi - lo))
                           ).astype(np.uint8) for im in (img0, img1)]
        flow, occ = codecs.kitti_flow_decode(flow_occ)
        flow = flow * occ  # zero out invalid before any resampling
        if resize is not None:
            w, h = resize
            img0 = resize_bilinear_np(img0, h, w).astype(np.uint8)
            img1 = resize_bilinear_np(img1, h, w).astype(np.uint8)
            fh, fw = flow.shape[:2]
            factor = np.asarray([(h - 1.0) / (fh - 1.0),
                                 (w - 1.0) / (fw - 1.0)], np.float32)
            flow = resize_bilinear_np(flow, h, w) * factor
            occf = resize_bilinear_np(occ.astype(np.float32), h, w)
            flow = flow / (occf + (occf == 0))
            occ = (occf * 255).astype(np.uint8)
        else:
            occ = occ * 255
        dataset["image_0"].append(img0)
        dataset["image_1"].append(img1)
        dataset["flow"].append(flow)
        dataset["occ"].append(occ)
    return dataset
