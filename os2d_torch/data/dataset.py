"""Dataset for one-shot detection, eval part (host side).

Counterpart of `DatasetOneShotDetection` in `os2d_tpu/data/dataset.py`
(the reference's os2d/data/dataset.py:558-734): scene images and GT class
images from a CSV-schema dataframe (relative box coordinates scaled at load),
the aspect-preserving resize to the dataset's image_size, optional in-RAM
caching, buckets of equal image size, and the per-image annotations. The
builders by dataset name (GroZi-3.2k, retail, INSTRE, ImageNet-RepMet) wait:
they need dataset files that are not in the repo.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict

import numpy as np
from PIL import Image

from ..structures.feature_map import FeatureMapSize, exact_resize_area
from ..structures.host_boxes import HostBoxes

REQUIRED_COLUMNS = {
    "imageid", "imagefilename", "classid", "classfilename",
    "gtbboxid", "difficult", "lx", "ty", "rx", "by",
}


def read_image(path):
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.load()
    return img


class DatasetOneShotDetection:
    """Images + GT class images + box annotations from a CSV dataframe
    (os2d/data/dataset.py:558-734)."""

    def __init__(self, gtboxframe, gt_path, image_path, name, image_size,
                 eval_scale, cache_images=False, image_ids=None,
                 image_file_names=None, logger_prefix="OS2D"):
        self.logger = logging.getLogger(f"{logger_prefix}.dataset")
        self.name = name
        self.image_size = image_size
        self.eval_scale = eval_scale
        self.cache_images = cache_images
        missing = REQUIRED_COLUMNS - set(gtboxframe.columns)
        if missing:
            raise ValueError(f"Missing columns in gtboxframe: {sorted(missing)}")
        self.gtboxframe = gtboxframe
        self.gt_path = gt_path
        self.image_path = image_path

        if image_ids is not None and image_file_names is not None:
            self.image_ids = image_ids
            self.image_file_names = image_file_names
        else:
            unique_images = gtboxframe[["imageid", "imagefilename"]].drop_duplicates()
            self.image_ids = list(unique_images["imageid"])
            self.image_file_names = list(unique_images["imagefilename"])

        self._read_dataset_gt_images()
        self._read_dataset_images()
        self._annotation_cache = {}

        self.num_images = len(self.image_ids)
        self.num_boxes = len(self.gtboxframe)
        self.num_classes = len(self.gtboxframe["classfilename"].unique())
        self.logger.info(
            f"Loaded dataset {self.name} with {self.num_images} images, "
            f"{self.num_boxes} boxes, {self.num_classes} classes"
        )

    def get_name(self):
        return self.name

    def get_class_ids(self):
        return self.gtboxframe["classid"].unique()

    def get_image_size_for_image_id(self, image_id):
        return self.image_size_per_image_id[image_id]

    def _read_dataset_images(self):
        self.image_path_per_image_id = OrderedDict()
        self.image_size_per_image_id = OrderedDict()
        self.image_per_image_id = OrderedDict()
        for image_id, image_file in zip(self.image_ids, self.image_file_names):
            if image_id not in self.image_path_per_image_id:
                self.image_path_per_image_id[image_id] = os.path.join(
                    self.image_path, image_file
                )
                img = self._get_dataset_image_by_id(image_id)
                self.image_size_per_image_id[image_id] = FeatureMapSize.from_image(img)
        self.logger.info(
            f"{'Read' if self.cache_images else 'Found'} "
            f"{len(self.image_path_per_image_id)} data images"
        )

    def _read_dataset_gt_images(self):
        self.gt_images_per_classid = OrderedDict()
        if self.gt_path is not None:
            for _, row in self.gtboxframe.iterrows():
                class_id = row["classid"]
                if class_id not in self.gt_images_per_classid:
                    self.gt_images_per_classid[class_id] = read_image(
                        os.path.join(self.gt_path, row["classfilename"])
                    )
            self.logger.info(f"Read {len(self.gt_images_per_classid)} GT images")
        else:
            self.logger.info("GT images are not provided")

    def split_images_into_buckets_by_size(self):
        buckets = []
        bucket_sizes = []
        for image_id, s in self.image_size_per_image_id.items():
            if s not in bucket_sizes:
                bucket_sizes.append(s)
                buckets.append([])
            buckets[bucket_sizes.index(s)].append(image_id)
        return buckets

    def _get_dataset_image_by_id(self, image_id):
        if image_id not in self.image_path_per_image_id:
            raise KeyError(f"unknown image id {image_id!r}")
        if image_id not in self.image_per_image_id:
            img = read_image(self.image_path_per_image_id[image_id])
            sz = FeatureMapSize.from_image(img)
            if max(sz.w, sz.h) != self.image_size:
                # note the reference triggers on the LONGER SIDE but resizes by
                # AREA ~= image_size**2 (os2d/data/dataset.py:669-671)
                new = exact_resize_area(w=sz.w, h=sz.h, target_area_side=self.image_size)
                # the reference's Image.ANTIALIAS, an alias of LANCZOS
                img = img.resize((new.w, new.h), resample=Image.LANCZOS)
            if self.cache_images:
                self.image_per_image_id[image_id] = img
        else:
            img = self.image_per_image_id[image_id]
        return img

    def get_boxes_from_image_dataframe(self, image_data, image_size):
        if not image_data.empty:
            labels = np.asarray(list(image_data["classid"]), np.int64)
            difficult = np.asarray(list(image_data["difficult"] == 1), bool)
            boxes = image_data[["lx", "ty", "rx", "by"]].to_numpy().astype(np.float32)
            boxes[:, 0] *= image_size.w
            boxes[:, 2] *= image_size.w
            boxes[:, 1] *= image_size.h
            boxes[:, 3] *= image_size.h
            out = HostBoxes(boxes, image_size)
        else:
            out = HostBoxes.create_empty(image_size)
            labels = np.zeros((0,), np.int64)
            difficult = np.zeros((0,), bool)
        out.add_field("labels", labels)
        out.add_field("difficult", difficult)
        out.add_field("labels_original", labels.copy())
        out.add_field("difficult_original", difficult.copy())
        return out

    def get_image_annotation_for_imageid(self, image_id):
        # the GT is static: parse each image's rows once; callers may mutate
        # the returned HostBoxes fields, so each call gets a fresh copy
        cached = self._annotation_cache.get(image_id)
        if cached is None:
            image_data = self.gtboxframe[self.gtboxframe["imageid"] == image_id]
            img_size = self.image_size_per_image_id[image_id]
            cached = self.get_boxes_from_image_dataframe(image_data, img_size)
            self._annotation_cache[image_id] = cached
        return cached.copy()
