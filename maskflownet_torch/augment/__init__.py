"""Device-side augmentation of the port: colour and geometry, each split
into a draw from a ``torch.Generator`` and a deterministic transform."""

from maskflownet_torch.augment.color import (ColorAugConfig,
                                             color_augmentation, draw_color)
from maskflownet_torch.augment.geometry import (GeometryAugConfig,
                                                draw_geometry,
                                                geometry_augmentation)

__all__ = ["ColorAugConfig", "GeometryAugConfig", "color_augmentation",
           "draw_color", "draw_geometry", "geometry_augmentation"]
