"""Host-side image/box transforms (PIL + numpy).

Counterpart of `os2d_tpu/data/transforms.py` (the reference's
os2d/structures/transforms.py:36-248): flips, (random-interpolation) resize,
the padding-aware crop with box-coverage masks, and the SSD-style color
distortion. Every transform can record its inverse into a TransformList.

The random draws come from an explicit `random.Random` passed as `rng`,
where the JAX package draws from the global `random` module: the draws are
the same calls in the same order, so a generator in the state of the global
stream gives the same batches.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from ..structures.feature_map import FeatureMapSize
from ..structures.host_boxes import (
    FLIP_LEFT_RIGHT,
    FLIP_TOP_BOTTOM,
    HostBoxes,
    TransformList,
    host_box_intersection_over_reference,
)

RESAMPLE_CHOICES = [
    Image.BOX,
    Image.NEAREST,
    Image.HAMMING,
    Image.BICUBIC,
    Image.LANCZOS,
    Image.BILINEAR,
]


def transpose(img, hflip=False, vflip=False, boxes: Optional[HostBoxes] = None,
              transform_list: Optional[TransformList] = None):
    if hflip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if boxes is not None:
            boxes = boxes.transpose(FLIP_LEFT_RIGHT)
            if transform_list is not None:
                transform_list.append(lambda b: b.transpose(FLIP_LEFT_RIGHT))
    if vflip:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
        if boxes is not None:
            boxes = boxes.transpose(FLIP_TOP_BOTTOM)
            if transform_list is not None:
                transform_list.append(lambda b: b.transpose(FLIP_TOP_BOTTOM))
    return img, boxes


def resize(img, target_size, rng: Optional[random.Random] = None,
           boxes: Optional[HostBoxes] = None,
           transform_list: Optional[TransformList] = None):
    """Resize to target_size (a FeatureMapSize, or the longer side's length),
    bilinear, or with an interpolation drawn from `rng` when one is given."""
    image_size = FeatureMapSize.from_image(img)
    if not isinstance(target_size, FeatureMapSize):
        scale = float(target_size) / max(image_size.w, image_size.h)
        target_size = FeatureMapSize(w=int(image_size.w * scale + 0.5),
                                     h=int(image_size.h * scale + 0.5))
    method = rng.choice(RESAMPLE_CHOICES) if rng is not None else Image.BILINEAR
    img = img.resize((target_size.w, target_size.h), method)
    if boxes is not None:
        boxes = boxes.resize(target_size)
        if transform_list is not None:
            transform_list.append(
                lambda b, s=image_size: b.resize(s),
                scale_xy=(image_size.w / float(target_size.w),
                          image_size.h / float(target_size.h)))
    return img, boxes


def crop(img, rng: Optional[random.Random] = None,
         crop_position: Optional[HostBoxes] = None,
         random_crop_size: Optional[FeatureMapSize] = None,
         random_crop_scale=1.0, scale_jitter=1.0, jitter_aspect_ratio=1.0,
         coverage_keep_threshold=0.7, coverage_remove_threshold=0.3,
         max_trial=100, min_box_coverage=0.7,
         boxes: Optional[HostBoxes] = None,
         transform_list: Optional[TransformList] = None):
    """The crop workhorse (os2d/structures/transforms.py:83-197): either a
    given crop_position (zero-padding the image where the crop exceeds it)
    or a random crop drawn from `rng` with aspect and scale jitter that
    covers >= min_box_coverage of at least one GT box. Returns (img, boxes,
    mask_cutoff, mask_difficult)."""
    use_boxes = boxes is not None
    image_size = FeatureMapSize.from_image(img)

    def good_crop(xyxy, size=image_size):
        return (max(int(xyxy[0]), 0), max(int(xyxy[1]), 0),
                min(int(xyxy[2]), size.w), min(int(xyxy[3]), size.h))

    padding = [0, 0, 0, 0]
    imh, imw = image_size.h, image_size.w
    if crop_position is not None:
        if len(crop_position) != 1:
            raise ValueError("a crop position holds one box")
        pos = crop_position.bbox_xyxy[0].copy()
        if int(pos[0]) < 0:
            padding[0] = -int(pos[0])
            pos[0] += padding[0]
            pos[2] += padding[0]
            imw += padding[0]
        if int(pos[1]) < 0:
            padding[1] = -int(pos[1])
            pos[1] += padding[1]
            pos[3] += padding[1]
            imh += padding[1]
        if int(pos[2]) > imw:
            padding[2] = int(pos[2]) - imw
            imw += padding[2]
        if int(pos[3]) > imh:
            padding[3] = int(pos[3]) - imh
            imh += padding[3]
        img = ImageOps.expand(img, border=tuple(padding), fill=0)
        img_size = FeatureMapSize.from_image(img)
        if use_boxes and any(padding):
            boxes = boxes.crop((-padding[0], -padding[1],
                                img_size.w - padding[0], img_size.h - padding[1]))
        image_size = img_size
        crop_xyxy = good_crop(pos, size=img_size)
    else:
        crop_width, crop_height = random_crop_size.w, random_crop_size.h
        crop_ar = crop_width / crop_height
        crop_xyxy = good_crop((0, 0, crop_width / random_crop_scale,
                               crop_height / random_crop_scale))
        for _ in range(max_trial):
            aspect_ratio = rng.uniform(crop_ar * jitter_aspect_ratio,
                                       crop_ar / jitter_aspect_ratio)
            scale = rng.uniform(random_crop_scale * scale_jitter,
                                random_crop_scale / scale_jitter)
            w = min(crop_width / scale, imw)
            h = min(w / aspect_ratio, imh)
            w, h = int(w), int(h)
            x = rng.randrange(imw - w) if imw - w > 0 else 0
            y = rng.randrange(imh - h) if imh - h > 0 else 0
            cur = good_crop((x, y, x + w, y + h))
            if not use_boxes:
                crop_xyxy = cur
                break
            cur_box = HostBoxes(np.array([cur], np.float32), image_size)
            coverage = host_box_intersection_over_reference(boxes, cur_box)
            if len(boxes) == 0 or coverage.max() >= min_box_coverage:
                crop_xyxy = cur
                break

    img = img.crop(crop_xyxy)
    if use_boxes:
        crop_box = HostBoxes(np.array([crop_xyxy], np.float32), image_size)
        coverage = host_box_intersection_over_reference(boxes, crop_box).reshape(-1)
        boxes = boxes.crop(crop_xyxy)
        mask_cutoff = coverage < coverage_remove_threshold
        mask_difficult = coverage < coverage_keep_threshold
        if transform_list is not None:
            uncrop = (-crop_xyxy[0], -crop_xyxy[1],
                      -crop_xyxy[0] + image_size.w, -crop_xyxy[1] + image_size.h)
            transform_list.append(lambda b, u=uncrop: b.crop(u), scale_xy=None)
        return img, boxes, mask_cutoff, mask_difficult
    return img, None, None, None


def _jitter_factor(rng, delta):
    return rng.uniform(max(0.0, 1.0 - delta), 1.0 + delta)


def _hue_shift(img, rng, delta):
    """ColorJitter(hue=delta)-style uniform hue rotation."""
    shift = rng.uniform(-delta, delta)
    hsv = np.array(img.convert("HSV"), np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(round(shift * 255))) % 256
    return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")


def random_distort(img, rng: random.Random, brightness_delta=32 / 255.0,
                   contrast_delta=0.5, saturation_delta=0.5, hue_delta=0.1):
    """SSD color augmentation (os2d/structures/transforms.py:200-248)."""

    def brightness(im):
        if rng.random() < 0.5:
            im = ImageEnhance.Brightness(im).enhance(_jitter_factor(rng, brightness_delta))
        return im

    def contrast(im):
        if rng.random() < 0.5:
            im = ImageEnhance.Contrast(im).enhance(_jitter_factor(rng, contrast_delta))
        return im

    def saturation(im):
        if rng.random() < 0.5:
            im = ImageEnhance.Color(im).enhance(_jitter_factor(rng, saturation_delta))
        return im

    def hue(im):
        if rng.random() < 0.5:
            im = _hue_shift(im, rng, hue_delta)
        return im

    img = brightness(img)
    if rng.random() < 0.5:
        img = hue(saturation(contrast(img)))
    else:
        img = contrast(hue(saturation(img)))
    return img
