"""Benchmark submission writers: the port's copy of
``maskflownet_tpu/tools/submission.py`` (reference ``predict.py``).

Sintel test (final pass only, working resolution 448x1024) -> per-sequence
``.flo`` files; KITTI 2012/2015 test (working resolution 512x1152) -> 16-bit
submission PNGs. Flow leaves the framework's (dy, dx) convention at this
boundary: ``.flo`` and KITTI PNGs store (u, v) = (dx, dy). ``trainer`` is
anything with the ``Trainer.predict`` signature.
"""

from __future__ import annotations

import os

import numpy as np

from maskflownet_torch.data import codecs, kitti, sintel


def predict_sintel(trainer, prefix: str, batch_size: int = 4, resize=None):
    """reference ``predict.py:9-41``: test 'final' pass only."""
    resize = resize or (448, 1024)
    dataset = sintel.list_data()
    for k, ds in dataset["test"].items():
        if k != "final":
            continue
        output_folder = os.path.join(prefix, k)
        os.makedirs(output_folder, exist_ok=True)
        img1 = [sintel.load(p) for p, _ in ds]
        img2 = [sintel.load(p) for _, p in ds]
        for entry, (flow, _occ, _warp) in zip(
                ds, trainer.predict(img1, img2, batch_size=batch_size,
                                    resize=resize)):
            img1_path = entry[0]
            seq = os.path.basename(os.path.dirname(img1_path))
            fname = os.path.basename(img1_path).replace(".png", ".flo")
            seq_dir = os.path.join(output_folder, seq)
            os.makedirs(seq_dir, exist_ok=True)
            codecs.flo_save(flow[..., ::-1], os.path.join(seq_dir, fname))


def predict_kitti(trainer, prefix: str, batch_size: int = 4, resize=None):
    """reference ``predict.py:44-66``."""
    resize = resize or (512, 1152)
    dataset = kitti.read_dataset_testing()
    for edition in ("2012", "2015"):
        out_dir = os.path.join(prefix, "kitti_" + edition)
        os.makedirs(out_dir, exist_ok=True)
        img1 = dataset[edition]["image_0"]
        img2 = dataset[edition]["image_1"]
        for k, (flow, _occ, _warp) in enumerate(
                trainer.predict(img1, img2, batch_size=batch_size,
                                resize=resize)):
            codecs.png16_save(codecs.kitti_flow_encode(flow),
                              os.path.join(out_dir, "%06d_10.png" % k))


def predict_all(trainer, prefix: str, batch_size: int = 4, resize=None):
    predict_sintel(trainer, prefix, batch_size, resize)
    predict_kitti(trainer, prefix, batch_size,
                  resize if resize else None)
