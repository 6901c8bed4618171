"""Dataloader, eval part: class images and the raw image iterator.

Counterpart of the eval path of `DataloaderOneShotDetection` in
`os2d_tpu/data/dataloader.py` (the reference's os2d/data/dataloader.py:
146-616):
  - class images are resized to a small SHAPE PALETTE by default (area ~=
    class_image_size^2, nearest aspect; the JAX package's choice, which
    bounds its compiled label-branch shapes) or, with palette=None, exactly
    as the reference does; they come out as [h, w, 3] float32 arrays,
    mean/std-normalized;
  - scene images come out as uint8 base images plus per-level target sizes
    (`make_raw_iterator_for_all_images`): the pyramid is built on the device.
Training batches, augmentation and mining wait for the training slice.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from ..structures.feature_map import FeatureMapSize, exact_resize_area
from . import transforms as T
from .dataset import DatasetOneShotDetection

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


def make_class_shape_palette(class_image_size: int = 240, num_aspects: int = 25,
                             max_aspect: float = 3.0):
    """Shapes with area ~= class_image_size^2 across log-spaced aspect ratios."""
    aspects = np.geomspace(1.0 / max_aspect, max_aspect, num_aspects)
    shapes = []
    for r in aspects:  # r = h / w
        s = exact_resize_area(w=1000, h=int(1000 * r), target_area_side=class_image_size)
        if (s.w, s.h) not in shapes:
            shapes.append((s.w, s.h))
    return shapes


def snap_to_palette(w: int, h: int, palette) -> FeatureMapSize:
    """Nearest palette shape by log-aspect."""
    target = math.log(h / w)
    best = min(palette, key=lambda s: abs(math.log(s[1] / s[0]) - target))
    return FeatureMapSize(w=best[0], h=best[1])


def image_to_normalized_array(img, img_normalization=None) -> np.ndarray:
    """PIL -> [H, W, 3] float32, scaled to [0,1] and mean/std normalized."""
    arr = np.asarray(img, np.float32) / 255.0
    if img_normalization is not None:
        mean = np.asarray(img_normalization["mean"], np.float32)
        std = np.asarray(img_normalization["std"], np.float32)
        arr = (arr - mean) / std
    return arr


class DataloaderOneShotDetection:
    """Eval-side loader over a DatasetOneShotDetection."""

    def __init__(self, dataset: DatasetOneShotDetection, batch_size=4,
                 img_normalization=None, gt_image_size=240,
                 pyramid_scales_eval=(1,),
                 class_shape_palette="default",  # "default" | None (exact) | list
                 logger_prefix="OS2D"):
        self.logger = logging.getLogger(f"{logger_prefix}.dataloader")
        self.dataset = dataset
        self.img_normalization = img_normalization or {"mean": IMG_MEAN, "std": IMG_STD}
        self.gt_image_size = gt_image_size
        self.pyramid_scales_eval = list(pyramid_scales_eval)
        self.num_pyramid_levels = len(self.pyramid_scales_eval)
        if class_shape_palette == "default":
            self.class_shape_palette = make_class_shape_palette(gt_image_size)
        else:
            self.class_shape_palette = class_shape_palette  # None -> exact resize
        self.batch_size = batch_size

    def get_name(self):
        return self.dataset.get_name()

    # ---- class images ----
    def get_class_images_and_sizes(self, class_ids):
        class_images = [self.dataset.gt_images_per_classid[c] for c in class_ids]
        sizes = [FeatureMapSize.from_image(img) for img in class_images]
        return class_images, sizes

    def _transform_image_gt(self, img, hflip=False, vflip=False):
        img = T.transpose(img, hflip=hflip, vflip=vflip)
        size_old = FeatureMapSize.from_image(img)
        if self.class_shape_palette is not None:
            size_new = snap_to_palette(size_old.w, size_old.h, self.class_shape_palette)
        else:
            size_new = exact_resize_area(
                w=size_old.w, h=size_old.h, target_area_side=self.gt_image_size
            )
        img = T.resize(img, target_size=size_new)
        return image_to_normalized_array(img, self.img_normalization)

    def get_all_class_images(self):
        """(normalized [h, w, 3] arrays, original sizes, sorted class ids)."""
        class_ids = sorted(list(self.dataset.get_class_ids()))
        class_images, class_image_sizes = self.get_class_images_and_sizes(class_ids)
        arrays = [self._transform_image_gt(img) for img in class_images]
        return arrays, class_image_sizes, class_ids

    # ---- eval iteration ----
    def make_raw_iterator_for_all_images(self, batch_size=None):
        """Yields (batch_ids, base_images, level_sizes, inverse_scales,
        initial_sizes) per batch of one size bucket: the BASE images as uint8
        [H, W, 3] host arrays, the per-level target sizes of the pyramid that
        the device builds, and per image the per-level (sx, sy) back to the
        original coordinates."""
        buckets_ids = self.dataset.split_images_into_buckets_by_size()
        batch_size = (
            max(len(ids) for ids in buckets_ids) if batch_size is None else batch_size
        )
        for ids_b in buckets_ids:
            for batch_start in range(0, len(ids_b), batch_size):
                batch_ids = ids_b[batch_start: batch_start + batch_size]
                base_images = []
                initial_sizes = []
                for image_id in batch_ids:
                    img = self.dataset._get_dataset_image_by_id(image_id)
                    base_images.append(np.asarray(img, np.uint8))
                    initial_sizes.append(
                        self.dataset.get_image_size_for_image_id(image_id)
                    )
                base = initial_sizes[0]
                level_sizes = [
                    FeatureMapSize(w=int(base.w * s), h=int(base.h * s))
                    for s in self.pyramid_scales_eval
                ]
                inverse_scales = [
                    [
                        (init.w / float(lv.w), init.h / float(lv.h))
                        for lv in level_sizes
                    ]
                    for init in initial_sizes
                ]
                yield batch_ids, base_images, level_sizes, inverse_scales, initial_sizes
