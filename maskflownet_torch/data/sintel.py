"""MPI-Sintel reader: the port's copy of ``maskflownet_tpu/data/sintel.py``
(reference ``reader/sintel.py``).

``list_data`` walks ``{root}/{training,test}/{clean,final}/{seq}`` and builds
consecutive-frame entries ``[img1, img2, flow, invalid]``; training entries
are additionally assigned to ``training1``/``training2`` by the split file
(one 1/2 per training pair, in enumeration order -- reference
``sintel.py:16,42-43``).

Enumeration-order note: the reference walks sequences in raw ``os.listdir``
order while we sort; the official ``Sintel_train_val_maskflownet.txt`` was
verified to be generated under lexicographic order -- its 1/2 runs
(98,20,81,19,98,49,147,49,98,39,245,49,49) land exactly on sorted-order
sequence-pair boundaries (ambush_2=20, ambush_6=19, market_6=39 are
irregular), giving whole-sequence validation = {ambush_2, ambush_6,
bamboo_2, cave_4, market_6, temple_2}. ``list_data`` guards this: every
sequence must receive a constant split label, else the enumeration order
does not match the split file and we raise rather than silently train on
validation frames.

``load`` decodes by extension with an LRU cache: frames -> uint8 RGB;
``invalid/*.png`` -> inverted to a VALID mask (255 = valid, reference
``sintel.py:79-81``); ``.flo`` -> (dy, dx) float32.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

import numpy as np

from maskflownet_torch.data import codecs, paths

SHAPE = (436, 1024)

# Pair count of the full official training enumeration (clean or final);
# split files at least this long are treated as official-scale and a mixed
# per-sequence label hard-fails instead of warning (see list_data).
OFFICIAL_SINTEL_PAIRS = 1041


def list_data(root: str | None = None, split_file: str | None = None) -> dict:
    root = root or paths.sintel_root()
    split_file = split_file or paths.sintel_split_file()
    pattern = re.compile(r"frame_(\d+).png")
    split = np.loadtxt(split_file).astype("i4") if os.path.exists(split_file) else None
    dataset: dict = {}
    for part in ("training", "test"):
        dataset[part] = {}
        if part == "training":
            dataset["training1"] = {}
            dataset["training2"] = {}
        for subset in ("clean", "final"):
            dataset[part][subset] = []
            if part == "training":
                c = 0
                dataset["training1"][subset] = []
                dataset["training2"][subset] = []
            subset_dir = os.path.join(root, part, subset)
            if not os.path.isdir(subset_dir):
                continue
            for seq in sorted(os.listdir(subset_dir)):
                frames = sorted(
                    int(pattern.match(s).group(1))
                    for s in os.listdir(os.path.join(subset_dir, seq))
                    if pattern.match(s))
                seq_labels = set()
                for i in frames[:-1]:
                    entry = [
                        os.path.join(subset_dir, seq, f"frame_{i:04d}.png"),
                        os.path.join(subset_dir, seq, f"frame_{i + 1:04d}.png"),
                    ]
                    if part == "training":
                        entry.append(os.path.join(
                            root, part, "flow", seq, f"frame_{i:04d}.flo"))
                        entry.append(os.path.join(
                            root, part, "invalid", seq, f"frame_{i:04d}.png"))
                    dataset[part][subset].append(entry)
                    if part == "training" and split is not None:
                        if c >= len(split):
                            raise ValueError(
                                f"Sintel split file has {len(split)} lines but "
                                f"the tree enumerates more training pairs -- "
                                f"split/tree mismatch at {seq}")
                        seq_labels.add(int(split[c]))
                        dataset[part + str(split[c])][subset].append(entry)
                        c += 1
                if part == "training" and split is not None and len(seq_labels) > 1:
                    # The OFFICIAL split assigns whole sequences, so a mixed
                    # label there means our (sorted) enumeration order
                    # disagrees with the order the split file was generated
                    # under -- silently training on validation frames.
                    # Custom/synthetic split files may legitimately mix
                    # labels within a sequence (the reference semantics are
                    # line-per-pair, sintel.py:42-43), so only official-scale
                    # files (the full 1041-pair enumeration) hard-fail.
                    msg = (
                        f"Sintel sequence {seq!r} received mixed train/val "
                        f"split labels {sorted(seq_labels)}: enumeration "
                        f"order does not match the split file (see module "
                        f"docstring)")
                    if len(split) >= OFFICIAL_SINTEL_PAIRS:
                        raise ValueError(msg)
                    import warnings
                    warnings.warn(msg + " -- assuming an intentional "
                                  "custom per-pair split", stacklevel=2)
    return dataset


@lru_cache(maxsize=None)
def load(fname: str) -> np.ndarray:
    if fname.endswith("png"):
        data = codecs.image_load(fname)
        if "invalid" in fname.replace("\\", "/").split("/"):
            # invalid-mask png: grayscale 255=invalid -> VALID mask 255=valid
            return (255 - data[..., :1]).astype(np.uint8)
        return data
    if fname.endswith("flo"):
        return codecs.read_flo_dydx(fname, SHAPE)
    raise ValueError(fname)
