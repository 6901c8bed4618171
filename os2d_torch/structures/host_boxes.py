"""Host-side (numpy) box container + invertible transform list.

Numpy analogue of the reference BoxList/TransformList
(os2d/structures/bounding_box.py:15-304, transforms.py:12-27) used ONLY in the
host data layer (datasets, augmentation, mining bookkeeping). On-device code
never sees this type — it works on padded arrays (see structures/boxes.py).

A copy of `os2d_tpu/structures/host_boxes.py`: the PyTorch port keeps its own
copy of the pure-Python modules it needs.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional

import numpy as np

from .feature_map import FeatureMapSize

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1


class HostBoxes:
    """N x 4 xyxy float32 boxes + image size + extra fields (numpy arrays)."""

    def __init__(self, bbox_xyxy, image_size: FeatureMapSize):
        self.bbox_xyxy = np.asarray(bbox_xyxy, np.float32).reshape(-1, 4)
        self.image_size = image_size
        self.extra_fields = {}

    @staticmethod
    def create_empty(image_size: FeatureMapSize):
        return HostBoxes(np.zeros((0, 4), np.float32), image_size)

    def __len__(self):
        return self.bbox_xyxy.shape[0]

    def add_field(self, name, data):
        self.extra_fields[name] = data

    def get_field(self, name):
        return self.extra_fields[name]

    def has_field(self, name):
        return name in self.extra_fields

    def fields(self):
        return list(self.extra_fields.keys())

    def copy(self):
        out = HostBoxes(self.bbox_xyxy.copy(), self.image_size)
        for k, v in self.extra_fields.items():
            out.add_field(k, copy.copy(v))
        return out

    def __getitem__(self, item):
        out = HostBoxes(self.bbox_xyxy[item].reshape(-1, 4), self.image_size)
        for k, v in self.extra_fields.items():
            out.add_field(k, np.asarray(v)[item])
        return out

    def resize(self, target_size: FeatureMapSize):
        rw = float(target_size.w) / self.image_size.w
        rh = float(target_size.h) / self.image_size.h
        scaled = self.bbox_xyxy * np.array([rw, rh, rw, rh], np.float32)
        out = HostBoxes(scaled, target_size)
        for k, v in self.extra_fields.items():
            out.add_field(k, v)
        return out

    def transpose(self, method):
        w, h = self.image_size.w, self.image_size.h
        x1, y1, x2, y2 = self.bbox_xyxy.T
        if method == FLIP_LEFT_RIGHT:
            boxes = np.stack([w - x2, y1, w - x1, y2], axis=1)
        elif method == FLIP_TOP_BOTTOM:
            boxes = np.stack([x1, h - y2, x2, h - y1], axis=1)
        else:
            raise NotImplementedError(method)
        out = HostBoxes(boxes, self.image_size)
        for k, v in self.extra_fields.items():
            if isinstance(v, HostBoxes):
                v = v.transpose(method)
            out.add_field(k, v)
        return out

    def crop(self, box):
        """box = (left, top, right, bottom); no clipping (as reference)."""
        w, h = box[2] - box[0], box[3] - box[1]
        shifted = self.bbox_xyxy - np.array(
            [box[0], box[1], box[0], box[1]], np.float32
        )
        out = HostBoxes(shifted, FeatureMapSize(w=int(w), h=int(h)))
        for k, v in self.extra_fields.items():
            if isinstance(v, HostBoxes):
                v = v.crop(box)
            out.add_field(k, v)
        return out

    def area(self):
        return (self.bbox_xyxy[:, 2] - self.bbox_xyxy[:, 0]) * (
            self.bbox_xyxy[:, 3] - self.bbox_xyxy[:, 1]
        )

    def clip_to_image(self):
        b = self.bbox_xyxy
        b[:, 0] = np.clip(b[:, 0], 0, self.image_size.w)
        b[:, 1] = np.clip(b[:, 1], 0, self.image_size.h)
        b[:, 2] = np.clip(b[:, 2], 0, self.image_size.w)
        b[:, 3] = np.clip(b[:, 3], 0, self.image_size.h)
        return self

    def __repr__(self):
        return f"HostBoxes(num_boxes={len(self)}, image_size={self.image_size})"


def host_box_intersection_over_reference(boxes_reference: HostBoxes, boxes: HostBoxes):
    area_ref = boxes_reference.area()
    b1, b2 = boxes_reference.bbox_xyxy, boxes.bbox_xyxy
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, :, 0] * wh[:, :, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / area_ref[:, None]


class TransformList:
    """Records box-space transforms and applies them in REVERSE
    (os2d/structures/transforms.py:12-27); also tracks whether the composed
    inverse is a pure (sx, sy) scaling so the eval fast-path can run the
    inverse on device."""

    def __init__(self):
        self._transforms: List[Callable] = []
        self._scales: List[Optional[tuple]] = []

    def append(self, t: Callable, scale_xy: Optional[tuple] = None):
        self._transforms.append(t)
        self._scales.append(scale_xy)

    def __call__(self, x):
        for t in reversed(self._transforms):
            x = t(x)
        return x

    def as_scale_xy(self) -> Optional[tuple]:
        """(sx, sy) if every recorded inverse is a scaling, else None."""
        sx, sy = 1.0, 1.0
        for s in reversed(self._scales):
            if s is None:
                return None
            sx *= s[0]
            sy *= s[1]
        return (sx, sy)
