"""KITTI 2012/2015 reader: the port's copy of
``maskflownet_tpu/data/kitti.py`` (reference ``reader/kitti.py``).

Fixed validation indices split, 16-bit flow_occ PNG decode
``(v - 2^15) / 64``, optional crop (bottom-left anchored) and resize with
flow-magnitude rescale + occlusion renormalization -- semantics matched to
``reader/kitti.py:27-110``; images RGB, flow (dy, dx).
"""

from __future__ import annotations

import os

import numpy as np

from maskflownet_torch.data import codecs, paths
from maskflownet_torch.data.resize import resize_bilinear_np

VALIDATE_INDICES = {
    "2012": [0, 12, 15, 16, 17, 18, 24, 30, 38, 39, 42, 50, 54, 59, 60, 61,
             77, 78, 81, 89, 97, 101, 107, 121, 124, 142, 145, 146, 152, 154,
             155, 158, 159, 160, 164, 182, 183, 184, 190],
    "2015": [10, 11, 12, 25, 26, 30, 31, 40, 41, 42, 46, 52, 53, 72, 73, 74,
             75, 76, 80, 81, 85, 86, 95, 96, 97, 98, 104, 116, 117, 120, 121,
             126, 127, 153, 172, 175, 183, 184, 190, 199],
}


def default_paths(root: str | None = None) -> dict:
    root = root or paths.kitti_root()
    return {
        "2012image": os.path.join(root, "2012", "training", "colored_0"),
        "2012flow_occ": os.path.join(root, "2012", "training", "flow_occ"),
        "2015image": os.path.join(root, "2015", "training", "image_2"),
        "2015flow_occ": os.path.join(root, "2015", "training", "flow_occ"),
        "2012testing": os.path.join(root, "2012", "testing", "colored_0"),
        "2015testing": os.path.join(root, "2015", "testing", "image_2"),
    }


def read_dataset(path: dict | None = None, editions: str = "mixed",
                 parts: str = "mixed", crop=None, resize=None,
                 samples: int | None = None) -> dict:
    """resize is (width, height) like the reference's cv2 convention."""
    path = path or default_paths()
    dataset = {"image_0": [], "image_1": [], "flow": [], "occ": []}
    for edition in (("2012", "2015") if editions == "mixed" else (editions,)):
        path_images = path[edition + "image"]
        path_flows = path[edition + "flow_occ"]
        num_files = len(os.listdir(path_flows)) - 1
        ind_valids = VALIDATE_INDICES[edition]
        if samples is not None:
            num_files = min(num_files, samples)
        ind = 0
        for k in range(num_files):
            if ind < len(ind_valids) and ind_valids[ind] == k:
                ind += 1
                if parts == "train":
                    continue
            elif parts == "valid":
                continue
            img0 = codecs.image_load(os.path.join(path_images, "%06d_10.png" % k))
            img1 = codecs.image_load(os.path.join(path_images, "%06d_11.png" % k))
            flow_occ = codecs.png16_load(
                os.path.join(path_flows, "%06d_10.png" % k))
            if crop is not None:
                img0 = img0[-crop[0]:, :crop[1]]
                img1 = img1[-crop[0]:, :crop[1]]
                flow_occ = flow_occ[-crop[0]:, :crop[1]]
            flow, occ = codecs.kitti_flow_decode(flow_occ)
            if resize is not None:
                w, h = resize
                img0 = resize_bilinear_np(img0, h, w).astype(np.uint8)
                img1 = resize_bilinear_np(img1, h, w).astype(np.uint8)
                fh, fw = flow.shape[:2]
                # (dy, dx): scale per axis by (new-1)/(old-1)
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


def read_dataset_testing(path: dict | None = None, editions: str = "mixed",
                         resize=None, samples: int | None = None) -> dict:
    """Test images for benchmark submission (reference
    ``reader/kitti.py:86-112``)."""
    path = path or default_paths()
    dataset = {e: {"image_0": [], "image_1": []} for e in ("2012", "2015")}
    for edition in (("2012", "2015") if editions == "mixed" else (editions,)):
        path_testing = path[edition + "testing"]
        num_files = (len(os.listdir(path_testing)) - 1) // 2
        if samples is not None:
            num_files = min(num_files, samples)
        for k in range(num_files):
            img0 = codecs.image_load(os.path.join(path_testing, "%06d_10.png" % k))
            img1 = codecs.image_load(os.path.join(path_testing, "%06d_11.png" % k))
            if resize is not None:
                w, h = resize
                img0 = resize_bilinear_np(img0, h, w).astype(np.uint8)
                img1 = resize_bilinear_np(img1, h, w).astype(np.uint8)
            dataset[edition]["image_0"].append(img0)
            dataset[edition]["image_1"].append(img1)
    return dataset
