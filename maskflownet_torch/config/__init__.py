"""The port's config system: the copy of ``maskflownet_tpu/config``.

Nested attribute access over a YAML dict, ``.get(default)`` printing the
default it applies, ``.value`` for required fields; the 13 stock
network/dataset YAMLs lie beside this module, byte for byte the JAX
package's. The YAML is read by :mod:`maskflownet_torch.config.yaml_subset`
(the subset those files use, scalars resolved as ``yaml.safe_load`` does),
since the port's machines may lack PyYAML. ``presets`` holds the
per-dataset training presets.
"""

from __future__ import annotations

import os

from maskflownet_torch.config import yaml_subset
from maskflownet_torch.config.presets import (BATCH_SIZE, ORIG_SHAPE,
                                              color_aug_config,
                                              geometry_aug_config)

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


class Reader:
    def __init__(self, obj, full_attr: str = ""):
        self._object = obj
        self._full_attr = full_attr

    def __getattr__(self, name: str) -> "Reader":
        if name.startswith("_"):
            raise AttributeError(name)
        ret = None if self._object is None else self._object.get(name, None)
        return Reader(ret, self._full_attr + "." + name)

    def __getitem__(self, name: str) -> "Reader":
        return getattr(self, name)

    def get(self, default=None):
        if self._object is None:
            print(f"Default FLAGS{self._full_attr} to {default}")
            return default
        return self._object

    @property
    def value(self):
        return self._object


def load_config(name_or_path: str) -> Reader:
    """Load a YAML by path, or by name from the bundled config directory."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, name_or_path)
    with open(path) as fp:
        return Reader(yaml_subset.load(fp.read()))


__all__ = ["BATCH_SIZE", "CONFIG_DIR", "ORIG_SHAPE", "Reader",
           "color_aug_config", "geometry_aug_config", "load_config"]
