"""Host-side image transforms of the eval path (PIL).

The parts of `os2d_tpu/data/transforms.py` that the eval dataloader calls:
flips and the deterministic bilinear resize of an image. The box transforms
and the random augmentations (crop, color distortion, random interpolation)
wait for training.
"""

from __future__ import annotations

from PIL import Image

from ..structures.feature_map import FeatureMapSize


def transpose(img, hflip=False, vflip=False):
    if hflip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if vflip:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    return img


def resize(img, target_size: FeatureMapSize):
    """Bilinear resize to target_size."""
    return img.resize((target_size.w, target_size.h), Image.BILINEAR)
