"""Training presets of the port (``config/presets.py``); the YAML config
reader of ``maskflownet_tpu/config`` is not ported yet."""

from maskflownet_torch.config.presets import (BATCH_SIZE, ORIG_SHAPE,
                                              color_aug_config,
                                              geometry_aug_config)

__all__ = ["BATCH_SIZE", "ORIG_SHAPE", "color_aug_config",
           "geometry_aug_config"]
