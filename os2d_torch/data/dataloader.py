"""Dataloader: bucketed batching, the train augmentation pipeline, class
images and the eval image iterator.

Counterpart of `DataloaderOneShotDetection` in `os2d_tpu/data/dataloader.py`
(the reference's os2d/data/dataloader.py:146-616):
  - class images are resized to a small SHAPE PALETTE by default (area ~=
    class_image_size^2, nearest aspect; the JAX package's choice, which
    bounds its compiled label-branch shapes) or, with palette=None, exactly
    as the reference does; training uses a one-entry square palette;
  - train batches (`get_batch`) come out as numpy arrays: uint8 images (the
    step normalizes on the device), class images, and the GT PADDED to a
    static [B, G] with validity masks, so that targets are encoded on the
    device;
  - scene images for evaluation come out as uint8 base images plus per-level
    target sizes (`make_raw_iterator_for_all_images`, the pyramid is built
    on the device), or as normalized host-built pyramids
    (`make_iterator_for_all_images`, optionally at random scales, which hard
    patch mining scores);
  - after `set_hard_negative_data` each train image is cropped at one of its
    mined records (half the batch a hard negative, half a hard positive) and
    the mined labels join the batch's classes;
  - with a device class cache attached (`attach_device_class_cache`, see
    data/class_cache.py) a batch carries the indices of its class images
    (`class_gather`) in place of the images.
The random draws come from generators the loader owns, seeded once (from
`seed`, else from the global `random` stream): batch composition, flips,
label sampling, mined records and random pyramid scales from one, the image
augmentations from another (`aug_rng`; the JAX package draws those from the
global `random`; the calls and their order are the same).
"""

from __future__ import annotations

import copy
import logging
import math
import random

import numpy as np
from PIL import Image

from ..structures.feature_map import FeatureMapSize, exact_resize_area
from ..structures.host_boxes import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM, HostBoxes, TransformList
from . import transforms as T
from .dataset import DatasetOneShotDetection

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
GT_PAD_MULTIPLE = 8


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


class DataAugmentationParams:
    """Parameter bundle (os2d/engine/augmentation.py:6-87); the draws come
    from `rng`."""

    def __init__(self, rng: random.Random, random_flip_batches, random_crop_size,
                 random_crop_scale, jitter_aspect_ratio, scale_jitter,
                 random_color_distortion, random_crop_label_images, min_box_coverage):
        self.rng = rng
        self.batch_random_hflip = random_flip_batches
        self.batch_random_vflip = random_flip_batches
        self.do_random_color = random_color_distortion
        self.scale_jitter = scale_jitter
        self.jitter_aspect_ratio = jitter_aspect_ratio
        self.do_random_crop = random_crop_size is not None
        self.random_crop_size = random_crop_size
        self.random_crop_scale = random_crop_scale
        self.random_interpolation = True
        self.coverage_keep_threshold = 0.7
        self.coverage_remove_threshold = 0.3
        self.max_trial = 100
        self.min_box_coverage = min_box_coverage
        self.do_random_crop_label_images = random_crop_label_images

    def random_distort(self, img):
        return T.random_distort(img, self.rng) if self.do_random_color else img

    def random_crop(self, img, boxes=None, transform_list=None, random_crop_size=None):
        return T.crop(
            img, self.rng, random_crop_size=random_crop_size or self.random_crop_size,
            random_crop_scale=self.random_crop_scale, scale_jitter=self.scale_jitter,
            jitter_aspect_ratio=self.jitter_aspect_ratio,
            coverage_keep_threshold=self.coverage_keep_threshold,
            coverage_remove_threshold=self.coverage_remove_threshold,
            max_trial=self.max_trial, min_box_coverage=self.min_box_coverage,
            boxes=boxes, transform_list=transform_list)

    def crop_image(self, img, crop_position, boxes=None, transform_list=None):
        """The crop at a given position (a mined crop box), zero-padding the
        image where the box exceeds it; no draw."""
        return T.crop(
            img, crop_position=crop_position,
            coverage_keep_threshold=self.coverage_keep_threshold,
            coverage_remove_threshold=self.coverage_remove_threshold,
            boxes=boxes, transform_list=transform_list)

    def random_crop_label_image(self, img):
        if self.do_random_crop_label_images:
            ar = img.size[0] / img.size[1]
            new_ar = self.rng.uniform(ar * self.jitter_aspect_ratio,
                                      ar / self.jitter_aspect_ratio)
            w = int(min(img.size[0], img.size[1] * new_ar))
            h = int(min(img.size[0] / new_ar, img.size[1]))
            img = self.random_crop(img, random_crop_size=FeatureMapSize(w=w, h=h))[0]
        return img


class DataloaderOneShotDetection:
    def __init__(self, dataset: DatasetOneShotDetection, batch_size=4,
                 class_batch_size=None, img_normalization=None, gt_image_size=240,
                 random_flip_batches=False, random_crop_size=None,
                 random_crop_scale=1.0, random_color_distortion=False,
                 jitter_aspect_ratio=1.0, scale_jitter=1.0,
                 random_crop_class_images=False, min_box_coverage=0.7,
                 pyramid_scales_eval=(1,), do_augmentation=False,
                 mine_extra_class_images=False,
                 class_shape_palette="default",  # "default" | None (exact) | list
                 images_uint8=False, seed=None, logger_prefix="OS2D"):
        self.logger = logging.getLogger(f"{logger_prefix}.dataloader")
        self.dataset = dataset
        # the augmentation stream, then the batch-level one seeded from it
        # (os2d_tpu draws the first from the global random, the second from
        # random.getrandbits(64) of it)
        self.aug_rng = random.Random(random.getrandbits(64) if seed is None else seed)
        self._rng = random.Random(self.aug_rng.getrandbits(64))
        self._np_rng = np.random.RandomState(self._rng.getrandbits(32))
        self.img_normalization = img_normalization or {"mean": IMG_MEAN, "std": IMG_STD}
        self.gt_image_size = gt_image_size
        self.mine_extra_class_images = mine_extra_class_images
        self.images_uint8 = images_uint8
        self.hardnegdata_per_imageid = None  # set_hard_negative_data
        self.device_class_cache = None  # attach_device_class_cache
        self.pyramid_scales_eval = list(pyramid_scales_eval)
        self.num_pyramid_levels = len(self.pyramid_scales_eval)
        if class_shape_palette == "default":
            self.class_shape_palette = make_class_shape_palette(gt_image_size)
        else:
            self.class_shape_palette = class_shape_palette  # None -> exact resize

        if do_augmentation:
            self.data_augmentation = DataAugmentationParams(
                self.aug_rng, random_flip_batches=random_flip_batches,
                random_crop_size=random_crop_size, random_crop_scale=random_crop_scale,
                jitter_aspect_ratio=jitter_aspect_ratio, scale_jitter=scale_jitter,
                random_color_distortion=random_color_distortion,
                random_crop_label_images=random_crop_class_images,
                min_box_coverage=min_box_coverage)
            self.use_buckets = random_crop_size is None
        else:
            self.data_augmentation = None
            self.use_buckets = True
        self.batch_size = batch_size
        self.max_batch_labels = class_batch_size
        self._create_buckets(merge_one_bucket=not self.use_buckets)
        if self.mine_extra_class_images:
            self._mine_extra_class_images()

    def attach_device_class_cache(self, cache):
        """Serve class images from a device-resident (class, method) stack
        (data/class_cache.py) in place of per-batch host PIL work and upload.
        Each class's resample-method draw is still made from `aug_rng` where
        T.resize would make it, so batch composition and the later draws
        stay those of the host path. None detaches the cache."""
        if cache is not None:
            cache.validate_loader(self)
        self.device_class_cache = cache

    def get_name(self):
        return self.dataset.get_name()

    # ---- buckets ----
    def _create_buckets(self, merge_one_bucket=False):
        if not merge_one_bucket:
            self.buckets = self.dataset.split_images_into_buckets_by_size()
        else:
            self.buckets = [list(self.dataset.image_size_per_image_id.keys())]
        self.num_batches_per_bucket = [math.ceil(len(b) / self.batch_size) for b in self.buckets]
        self.num_batches = sum(self.num_batches_per_bucket)
        self.bucket_order = [(i_bucket, i_batch)
                             for i_bucket, n in enumerate(self.num_batches_per_bucket)
                             for i_batch in range(n)]

    def shuffle(self, shuffle_buckets=True):
        self._rng.shuffle(self.bucket_order)
        if shuffle_buckets:
            for bucket in self.buckets:
                self._rng.shuffle(bucket)

    def __len__(self):
        return self.num_batches

    # ---- class images ----
    def _mine_extra_class_images(self):
        """Crop every non-difficult GT box as an extra view of its class
        (os2d/data/dataloader.py:210-229)."""
        self.label_image_collection = {}
        for ids_b in self.buckets:
            for image_id in ids_b:
                img = self.dataset._get_dataset_image_by_id(image_id)
                boxes = self.dataset.get_image_annotation_for_imageid(image_id)
                difficult = boxes.get_field("difficult")
                labels = boxes.get_field("labels")
                for i in range(len(boxes)):
                    if not bool(difficult[i]):
                        img_cropped = T.crop(img, crop_position=boxes[i:i + 1])[0]
                        self.label_image_collection.setdefault(int(labels[i]), []).append(
                            img_cropped)

    def get_class_images_and_sizes(self, class_ids, do_augmentation=False):
        if self.mine_extra_class_images and do_augmentation:
            class_images = []
            for class_id in class_ids:
                collection = self.label_image_collection.get(class_id)
                img = self.dataset.gt_images_per_classid[class_id]
                if collection:
                    pick = self._rng.randint(0, len(collection))
                    img = img if pick == 0 else collection[pick - 1]
                class_images.append(img)
        else:
            class_images = [self.dataset.gt_images_per_classid[c] for c in class_ids]
        return class_images, [FeatureMapSize.from_image(img) for img in class_images]

    def _transform_image_gt(self, img, do_augmentation=True, hflip=False, vflip=False,
                            as_uint8=False):
        do_augmentation = do_augmentation and self.data_augmentation is not None
        img, _ = T.transpose(img, hflip=hflip, vflip=vflip)
        if do_augmentation:
            img = self.data_augmentation.random_distort(img)
            img = self.data_augmentation.random_crop_label_image(img)
        size_old = FeatureMapSize.from_image(img)
        if self.class_shape_palette is not None:
            size_new = snap_to_palette(size_old.w, size_old.h, self.class_shape_palette)
        else:
            size_new = exact_resize_area(w=size_old.w, h=size_old.h,
                                         target_area_side=self.gt_image_size)
        img, _ = T.resize(img, target_size=size_new,
                          rng=self.aug_rng if do_augmentation else None)
        if as_uint8:
            return np.asarray(img, np.uint8)
        return image_to_normalized_array(img, self.img_normalization)

    def get_all_class_images(self):
        """(normalized [h, w, 3] arrays, original sizes, sorted class ids)."""
        class_ids = sorted(list(self.dataset.get_class_ids()))
        class_images, class_image_sizes = self.get_class_images_and_sizes(class_ids)
        arrays = [self._transform_image_gt(img, do_augmentation=False) for img in class_images]
        return arrays, class_image_sizes, class_ids

    # ---- data images ----
    def _transform_image_to_pyramid(self, image_id, boxes=None, do_augmentation=True,
                                    hflip=False, vflip=False, pyramid_scales=(1,),
                                    mined_data=None, as_uint8=False):
        """Flip, crop (random, or at a mined record's crop box), resize to the
        crop size and color distortion of one image with its boxes, then one
        resize per pyramid scale (os2d_tpu/data/dataloader.py:309-380).
        Returns (per-level images, per-level boxes, mask_cutoff,
        mask_difficult, per-level inverse transforms)."""
        img = self.dataset._get_dataset_image_by_id(image_id)
        img_size = FeatureMapSize.from_image(img)
        aug = self.data_augmentation if do_augmentation else None
        if boxes is None:
            boxes = HostBoxes.create_empty(img_size)
        mask_cutoff = np.zeros(len(boxes), bool)
        mask_difficult = np.zeros(len(boxes), bool)
        inverse = TransformList()
        img, boxes = T.transpose(img, hflip=hflip, vflip=vflip, boxes=boxes,
                                 transform_list=inverse)
        crop_position = None
        if mined_data is not None:
            # the mined box is in the unflipped image: flip it with the batch
            crop_position = HostBoxes(
                np.asarray(mined_data["crop_position_xyxy"], np.float32).reshape(1, 4), img_size)
            if hflip:
                crop_position = crop_position.transpose(FLIP_LEFT_RIGHT)
            if vflip:
                crop_position = crop_position.transpose(FLIP_TOP_BOTTOM)
        if aug is not None and aug.do_random_crop:
            if crop_position is None:
                img, boxes, mask_cutoff, mask_difficult = aug.random_crop(
                    img, boxes=boxes, transform_list=inverse)
            else:
                img, boxes, mask_cutoff, mask_difficult = aug.crop_image(
                    img, crop_position, boxes=boxes, transform_list=inverse)
            img, boxes = T.resize(img, target_size=aug.random_crop_size, rng=aug.rng,
                                  boxes=boxes, transform_list=inverse)
        if aug is not None:
            img = aug.random_distort(img)
        size = FeatureMapSize.from_image(img)
        images, level_boxes, inverses = [], [], []
        for s in pyramid_scales:
            level_inverse = copy.deepcopy(inverse)
            level, b = T.resize(img, target_size=FeatureMapSize(w=int(size.w * s), h=int(size.h * s)),
                                rng=aug.rng if aug is not None else None, boxes=boxes,
                                transform_list=level_inverse)
            images.append(np.asarray(level, np.uint8) if as_uint8
                          else image_to_normalized_array(level, self.img_normalization))
            level_boxes.append(b)
            inverses.append(level_inverse)
        return images, level_boxes, mask_cutoff, mask_difficult, inverses

    def _transform_image(self, image_id, boxes, hflip=False, vflip=False, mined_data=None,
                         as_uint8=False):
        """One train image at pyramid scale 1, with its boxes (its final
        resize and draw included, as the JAX package's)."""
        images, level_boxes, mask_cutoff, mask_difficult, inverses = \
            self._transform_image_to_pyramid(image_id, boxes, hflip=hflip, vflip=vflip,
                                             mined_data=mined_data, as_uint8=as_uint8)
        return images[0], level_boxes[0], mask_cutoff, mask_difficult, inverses[0]

    def set_hard_negative_data(self, hardnegdata_per_imageid):
        """Mined records per image id (engine.mining.mine_hard_patches): from
        now on every train batch is cropped at them."""
        self.hardnegdata_per_imageid = copy.deepcopy(hardnegdata_per_imageid)

    @staticmethod
    def convert_label_ids_global_to_local(label_ids_global, class_ids):
        return np.asarray([class_ids.index(int(lid)) if int(lid) in class_ids else -1
                           for lid in label_ids_global], np.int64)

    # ---- batching ----
    def get_image_ids_for_batch_index(self, index):
        if not 0 <= index < self.num_batches:
            raise IndexError(f"batch {index} of {self.num_batches}")
        i_bucket, i_batch = self.bucket_order[index]
        return self.buckets[i_bucket][i_batch * self.batch_size: (i_batch + 1) * self.batch_size]

    def get_batch(self, index):
        return self._prepare_batch(self.get_image_ids_for_batch_index(index))

    def _prepare_batch(self, image_ids):
        """One training batch (os2d/data/dataloader.py:497-613;
        os2d_tpu/data/dataloader.py:418-578).

        Returns a dict of numpy arrays: images [B, H, W, 3], class_images (a
        list of [h, w, 3]; None with a device class cache, whose indices are
        then in class_gather), the padded GT (gt_boxes [B, G, 4], gt_labels /
        gt_difficult / gt_valid [B, G]), class_ids, plus the host-side
        inverse transforms and HostBoxes.
        """
        mined_data = {}
        if self.hardnegdata_per_imageid is not None:
            # half the batch crops at a hard negative, half at a hard positive
            # ("pos" also picks "pos_loc"); one record drawn per image
            num_neg = len(image_ids) // 2
            roles = ["neg"] * num_neg + ["pos"] * (len(image_ids) - num_neg)
            for image_id, role in zip(image_ids, roles):
                cands = self.hardnegdata_per_imageid[image_id]
                filtered = [d for d in cands if d["role"][:len(role)] == role] or cands
                mined_data[image_id] = filtered[self._rng.randrange(len(filtered))]
        mined_labels = [d["label_global"] for d in mined_data.values()]

        class_ids = self.dataset.get_dataframe_for_image_ids(image_ids)["classid"].unique()
        max_batch_labels = (self.max_batch_labels if self.max_batch_labels is not None
                            else class_ids.size + len(mined_labels) + 1)
        class_ids = np.unique(class_ids)
        self._np_rng.shuffle(class_ids)
        class_ids = class_ids[:max_batch_labels - len(mined_labels)]
        class_ids = np.unique(np.concatenate((class_ids, np.asarray(mined_labels,
                                                                    class_ids.dtype))))
        class_ids = sorted(int(c) for c in class_ids)

        aug = self.data_augmentation
        batch_vflip = aug is not None and aug.batch_random_vflip and self._rng.random() < 0.5
        batch_hflip = aug is not None and aug.batch_random_hflip and self._rng.random() < 0.5

        class_gather = None
        if self.device_class_cache is not None:
            # the class images are resolved on the device from the cache; the
            # one per-class draw left is the resample method T.resize would
            # draw (only when augmentation asks for random interpolation, as
            # there), so that the augmentation stream stays aligned
            random_interp = aug is not None and aug.random_interpolation
            class_gather = {
                "cache": self.device_class_cache,
                "class_ids": class_ids,
                "method_idx": [T.RESAMPLE_CHOICES.index(
                    self.aug_rng.choice(T.RESAMPLE_CHOICES) if random_interp
                    else Image.BILINEAR) for _ in class_ids],
                "hflip": batch_hflip,
                "vflip": batch_vflip,
            }
            class_images = None
            class_image_sizes = [self.device_class_cache.sizes[c] for c in class_ids]
        else:
            # class images ship uint8 when images_uint8 (the step normalizes
            # on the device)
            class_images_pil, _ = self.get_class_images_and_sizes(class_ids, do_augmentation=True)
            class_images = [self._transform_image_gt(img, hflip=batch_hflip, vflip=batch_vflip,
                                                     as_uint8=self.images_uint8)
                            for img in class_images_pil]
            class_image_sizes = [FeatureMapSize(w=a.shape[1], h=a.shape[0])
                                 for a in class_images]

        batch_images, batch_inverse_transform, batch_boxes = [], [], []
        img_size = None
        for image_id in image_ids:
            boxes = self.dataset.get_image_annotation_for_imageid(image_id)
            boxes.add_field("labels", self.convert_label_ids_global_to_local(
                boxes.get_field("labels"), class_ids))
            img, boxes, mask_cutoff, mask_difficult, inv_t = self._transform_image(
                image_id, boxes, hflip=batch_hflip, vflip=batch_vflip,
                mined_data=mined_data.get(image_id), as_uint8=self.images_uint8)
            boxes.add_field("difficult", boxes.get_field("difficult") | mask_difficult)
            labels = boxes.get_field("labels")
            labels[mask_cutoff] = -2
            boxes.add_field("labels", labels)
            cur_size = FeatureMapSize(w=img.shape[1], h=img.shape[0])
            if img_size is None:
                img_size = cur_size
            elif img_size != cur_size:
                raise ValueError("images in a batch must be of one size")
            batch_images.append(img)
            batch_inverse_transform.append(inv_t)
            batch_boxes.append(boxes)

        max_gt = max((len(b) for b in batch_boxes), default=0)
        g_pad = max(GT_PAD_MULTIPLE, math.ceil(max(max_gt, 1) / GT_PAD_MULTIPLE) * GT_PAD_MULTIPLE)
        b = len(image_ids)
        gt_boxes = np.zeros((b, g_pad, 4), np.float32)
        gt_labels = np.full((b, g_pad), -1, np.int32)
        gt_difficult = np.zeros((b, g_pad), bool)
        gt_valid = np.zeros((b, g_pad), bool)
        for i, boxes in enumerate(batch_boxes):
            n = len(boxes)
            if n:
                gt_boxes[i, :n] = boxes.bbox_xyxy
                gt_labels[i, :n] = boxes.get_field("labels")
                gt_difficult[i, :n] = boxes.get_field("difficult")
                gt_valid[i, :n] = True
        return {
            "images": np.stack(batch_images, 0),
            "class_images": class_images,
            "class_gather": class_gather,
            "class_ids": class_ids,
            "class_image_sizes": class_image_sizes,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_difficult": gt_difficult,
            "gt_valid": gt_valid,
            "img_size": img_size,
            "batch_box_inverse_transform": batch_inverse_transform,
            "batch_boxes": batch_boxes,
        }

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

    def make_iterator_for_all_images(self, batch_size=None, num_random_pyramid_scales=0):
        """Yields (batch_ids, pyramids, inverse_scales, transforms,
        initial_sizes) per batch of one size bucket, the pyramid built on the
        host (PIL bilinear, os2d/data/dataloader.py:432-476): pyramids per
        level [B, h_l, w_l, 3] normalized float32 arrays; inverse_scales per
        image the per-level (sx, sy) back to the original coordinates. With
        num_random_pyramid_scales, each batch takes that many scales drawn
        uniformly between the smallest and the largest eval scale (mining)."""
        buckets_ids = self.dataset.split_images_into_buckets_by_size()
        batch_size = (
            max(len(ids) for ids in buckets_ids) if batch_size is None else batch_size
        )
        for ids_b in buckets_ids:
            for batch_start in range(0, len(ids_b), batch_size):
                batch_ids = ids_b[batch_start: batch_start + batch_size]
                pyramid_scales = self.pyramid_scales_eval
                if num_random_pyramid_scales:
                    lo, hi = min(pyramid_scales), max(pyramid_scales)
                    pyramid_scales = [self._rng.uniform(lo, hi)
                                      for _ in range(num_random_pyramid_scales)]
                per_image, transforms, initial_sizes = [], [], []
                for image_id in batch_ids:
                    images, _, _, _, inverses = self._transform_image_to_pyramid(
                        image_id, do_augmentation=False, pyramid_scales=pyramid_scales)
                    per_image.append(images)
                    transforms.append(inverses)
                    initial_sizes.append(self.dataset.get_image_size_for_image_id(image_id))
                pyramids = [np.stack([p[i] for p in per_image], 0)
                            for i in range(len(pyramid_scales))]
                inverse_scales = [[t.as_scale_xy() for t in inverses] for inverses in transforms]
                yield batch_ids, pyramids, inverse_scales, transforms, initial_sizes


def build_train_dataloader_from_config(cfg, dataset_train, img_normalization=None, seed=None,
                                       logger_prefix="OS2D.train"):
    """Mirror of os2d/data/dataloader.py:87-143 (os2d_tpu/data/dataloader.py:
    714-762) over a given dataset (the builders by dataset name need dataset
    files). Train batches carry one square class-image shape and uint8
    images. Returns (dataloader, [a subset of the train set for eval])."""
    random_crop_size = FeatureMapSize(w=cfg.train.augment.train_patch_width,
                                      h=cfg.train.augment.train_patch_height)
    evaluation_scale = dataset_train.eval_scale / dataset_train.image_size
    pyramid = [p * evaluation_scale for p in cfg.eval.scales_of_image_pyramid]
    square = (cfg.model.class_image_size, cfg.model.class_image_size)
    dataloader = DataloaderOneShotDetection(
        dataset=dataset_train, batch_size=cfg.train.batch_size,
        class_batch_size=cfg.train.class_batch_size, class_shape_palette=[square],
        images_uint8=True, img_normalization=img_normalization,
        random_flip_batches=cfg.train.augment.random_flip_batches,
        random_crop_size=random_crop_size, random_crop_scale=evaluation_scale,
        jitter_aspect_ratio=cfg.train.augment.jitter_aspect_ratio,
        scale_jitter=cfg.train.augment.scale_jitter,
        min_box_coverage=cfg.train.augment.min_box_coverage,
        random_color_distortion=cfg.train.augment.random_color_distortion,
        random_crop_class_images=cfg.train.augment.random_crop_class_images,
        gt_image_size=cfg.model.class_image_size, pyramid_scales_eval=pyramid,
        do_augmentation=True,
        mine_extra_class_images=cfg.train.augment.mine_extra_class_images,
        seed=seed, logger_prefix=logger_prefix,
    )
    subsets = ([dataset_train.copy_subset(cfg.eval.train_subset_for_eval_size)]
               if cfg.eval.train_subset_for_eval_size > 0 else [])
    return dataloader, subsets
