"""Per-dataset training presets: batch sizes, native shapes and the
augmentation settings, re-homed from ``maskflownet_tpu/config/presets.py``
(the per-dataset branches of the reference training script, ``main.py:
197-365`` and ``:386-419``)."""

from __future__ import annotations

from maskflownet_torch.augment import ColorAugConfig, GeometryAugConfig

BATCH_SIZE = {"chairs": 8, "things3d": 4, "sintel": 4, "kitti": 4}

ORIG_SHAPE = {
    "chairs": (384, 512),
    "things3d": (540, 960),
    "sintel": (436, 1024),
    "kitti": (370, 1224),
}


def color_aug_config(dataset: str) -> ColorAugConfig:
    """main.py:390-399."""
    if dataset == "sintel":
        return ColorAugConfig(contrast_range=(-0.4, 0.8), brightness_sigma=0.1,
                              channel_range=(0.8, 1.4), noise_range=(0, 0),
                              saturation=0.5, hue=0.5)
    if dataset == "kitti":
        return ColorAugConfig(contrast_range=(-0.2, 0.4), brightness_sigma=0.05,
                              channel_range=(0.9, 1.2), noise_range=(0, 0.02),
                              saturation=0.25, hue=0.1,
                              gamma_range=(-0.5, 0.5))
    return ColorAugConfig(contrast_range=(-0.4, 0.8), brightness_sigma=0.1,
                          channel_range=(0.8, 1.4), noise_range=(0, 0.04),
                          saturation=0.5, hue=0.5)


def geometry_aug_config(dataset: str, target_shape, orig_shape
                        ) -> GeometryAugConfig:
    """main.py:403-419."""
    common = dict(target_shape=tuple(target_shape),
                  orig_shape=tuple(orig_shape))
    if dataset == "sintel":
        return GeometryAugConfig(
            angle_range=(-17, 17), zoom_range=(1 / 1.5, 1 / 0.9),
            aspect_range=(0.9, 1 / 0.9), translation_range=0.1,
            relative_angle=0.25, relative_scale=(0.96, 1 / 0.96),
            relative_translation=0.25, **common)
    if dataset == "kitti":
        return GeometryAugConfig(
            angle_range=(-5, 5), zoom_range=(1 / 1.25, 1 / 0.95),
            aspect_range=(0.95, 1 / 0.95), translation_range=0.05,
            relative_angle=0.25, relative_scale=(0.98, 1 / 0.98),
            relative_translation=0.25, **common)
    return GeometryAugConfig(
        angle_range=(-17, 17), zoom_range=(0.5, 1 / 0.9),
        aspect_range=(0.9, 1 / 0.9), translation_range=0.1,
        relative_angle=0.25, relative_scale=(0.96, 1 / 0.96),
        relative_translation=0.25, **common)
