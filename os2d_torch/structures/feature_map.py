"""Image / feature-map size records and static shape arithmetic.

The reference (os2d/structures/feature_map.py:5-44) carries a (w, h) record
everywhere to prevent width/height confusion, and computes feature-map sizes by
running a dummy image through the backbone (os2d/modeling/model.py:98-120).
Here the dummy-forward probe is replaced by closed-form stride arithmetic so
shapes are known before the backbone runs.

A copy of `os2d_tpu/structures/feature_map.py`: the PyTorch port keeps its
own copy of the pure-Python modules it needs.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class FeatureMapSize(NamedTuple):
    """Immutable (w, h) size record. Hashable -> usable as a cache key."""

    w: int
    h: int

    @staticmethod
    def from_image(img) -> "FeatureMapSize":
        """Build from a PIL image (has .size = (w, h))."""
        w, h = img.size
        return FeatureMapSize(w=int(w), h=int(h))

    @staticmethod
    def from_array_hw(arr) -> "FeatureMapSize":
        """Build from an array whose LAST TWO dims are (h, w) (NCHW-style)."""
        return FeatureMapSize(w=int(arr.shape[-1]), h=int(arr.shape[-2]))

    @staticmethod
    def from_array_nhwc(arr) -> "FeatureMapSize":
        """Build from an NHWC array: dims (..., h, w, c)."""
        return FeatureMapSize(w=int(arr.shape[-2]), h=int(arr.shape[-3]))


def _half_ceil(x: int) -> int:
    # conv k s2 with "same-ish" padding used by the resnet stem/blocks:
    # out = floor((x - 1) / 2) + 1 = ceil(x / 2)
    return (x + 1) // 2


def resnet_c4_feature_map_size(img_size: FeatureMapSize) -> FeatureMapSize:
    """Spatial size of the ResNet50/101-C4 feature map for a given image size.

    Four halvings (conv1 s2, maxpool s2, layer2 s2, layer3 s2), each of the
    form out = floor((x-1)/2)+1.  Verified against the reference dummy-forward
    probe (os2d/modeling/model.py:98-120): 1280 -> 80, 600 -> 38, 400 -> 25.
    """
    w, h = img_size.w, img_size.h
    for _ in range(4):
        w, h = _half_ceil(w), _half_ceil(h)
    return FeatureMapSize(w=w, h=h)


# Default backbone geometry (os2d/modeling/feature_extractor.py:115-117).
FEATURE_MAP_STRIDE = FeatureMapSize(w=16, h=16)
FEATURE_MAP_RECEPTIVE_FIELD = FeatureMapSize(w=16, h=16)

# Aligner (TransformationNet) geometry (os2d/modeling/head.py:66-69).
ALIGNER_GRID_SIZE = FeatureMapSize(w=15, h=15)
ALIGNER_STRIDE = FeatureMapSize(w=1, h=1)
ALIGNER_RECEPTIVE_FIELD = FeatureMapSize(w=15, h=15)


def compose_receptive_field(
    rf_a: FeatureMapSize, s_a: FeatureMapSize, rf_b: FeatureMapSize, s_b: FeatureMapSize
):
    """Receptive field / stride of net(x) = netB(netA(x)).

    rf = s_A * (rf_B - 1) + rf_A,  s = s_A * s_B
    (os2d/modeling/head.py:222-238). With the default geometry this yields the
    240x240 image-level anchor box with stride 16.
    """
    rf = FeatureMapSize(w=s_a.w * (rf_b.w - 1) + rf_a.w, h=s_a.h * (rf_b.h - 1) + rf_a.h)
    s = FeatureMapSize(w=s_a.w * s_b.w, h=s_a.h * s_b.h)
    return rf, s


def feature_map_size_for_image(img_size: FeatureMapSize) -> FeatureMapSize:
    """Alias used across the framework (backbone is always C4 here)."""
    return resnet_c4_feature_map_size(img_size)


def exact_resize_area(w: int, h: int, target_area_side: int) -> FeatureMapSize:
    """Resize preserving aspect so that w*h ~= target_area_side**2.

    Port of get_image_size_after_resize_preserving_aspect_ratio
    (os2d/utils/utils.py:32-37): int() truncation on the sqrt scale factor.
    """
    aspect_ratio_h_to_w = float(h) / w
    w_new = int(target_area_side / math.sqrt(aspect_ratio_h_to_w))
    h_new = int(target_area_side * math.sqrt(aspect_ratio_h_to_w))
    return FeatureMapSize(w=max(w_new, 1), h=max(h_new, 1))
