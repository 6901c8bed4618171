"""Device-resident class-image cache for training.

Counterpart of `os2d_tpu/data/class_cache.py`. Without it, every train batch
builds its class images on the host (PIL: flip, resize with a drawn method)
and uploads them, ~2.6 MB per step at the default recipe (15 classes of
240x240 uint8). When the augmentation recipe leaves a class image a function
of (class id, resample-method draw, batch flips) alone (no color distortion,
no class-image crops, no extra class images), every (class, method) resize
is computed once on the host and kept as one [C, M, S, S, 3] uint8 tensor on
the model's device; a batch's class tensor is then picked by index and
flipped there (`gather`), and only the index vectors cross.

Against the host path, from the same draws: the HAMMING, BICUBIC, LANCZOS
and BILINEAR resizes commute with mirror flips in PIL, so those draws give
the host path's pixels exactly; BOX and NEAREST under a flipped batch differ
from it by a sub-pixel sampling phase (resize-then-flip here, flip-then-resize
there), as the JAX package's cache does. Unflipped batches are equal for all
six methods.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..structures.feature_map import FeatureMapSize, exact_resize_area
from .dataloader import snap_to_palette
from .transforms import RESAMPLE_CHOICES

logger = logging.getLogger("OS2D.class_cache")


class DeviceClassCache:
    """Precomputed (class, resample method) resizes on one device.

    Attrs:
      class_ids: the sorted class ids covered (the loader's dataset's)
      index_of:  {class_id: row in the stack}
      sizes:     {class_id: FeatureMapSize after the resize}
      stack:     uint8 tensor [C, M, S_h, S_w, 3], M = len(RESAMPLE_CHOICES)
                 in that order
      nbytes:    the stack's size in bytes
    """

    def __init__(self, class_ids, index_of, sizes, stack: torch.Tensor):
        self.class_ids = class_ids
        self.index_of = index_of
        self.sizes = sizes
        self.stack = stack
        self.nbytes = stack.numel() * stack.element_size()

    @staticmethod
    def validate_loader(loader):
        """The cache equals the host path only when class-image pixels depend
        on nothing but (class id, method draw, batch flips); raises
        ValueError naming the options that break that."""
        aug = loader.data_augmentation
        problems = []
        if loader.mine_extra_class_images:
            problems.append("train.augment.mine_extra_class_images")
        if aug is not None and aug.do_random_color:
            problems.append("train.augment.random_color_distortion")
        if aug is not None and aug.do_random_crop_label_images:
            problems.append("train.augment.random_crop_class_images")
        if problems:
            raise ValueError("tpu.device_class_cache requires per-step-static class images; "
                             f"disable {', '.join(problems)}")

    @classmethod
    def build(cls, loader, device, budget_mb=None):
        """Compute the stack on the host from the loader's class images (the
        resize of its `_transform_image_gt` without flips and draws) and put
        it on `device`. The stack's size is projected from the first class's
        shape and refused over budget_mb before the per-class resizes run;
        classes of another shape are refused too."""
        cls.validate_loader(loader)
        dataset = loader.dataset
        class_ids = sorted(int(c) for c in dataset.get_class_ids())
        n_methods = len(RESAMPLE_CHOICES)
        sizes, index_of, per_class = {}, {}, []
        target_shape = None
        for row, cid in enumerate(class_ids):
            img = dataset.gt_images_per_classid[cid]
            size_old = FeatureMapSize.from_image(img)
            if loader.class_shape_palette is not None:
                size_new = snap_to_palette(size_old.w, size_old.h, loader.class_shape_palette)
            else:
                size_new = exact_resize_area(w=size_old.w, h=size_old.h,
                                             target_area_side=loader.gt_image_size)
            if target_shape is None:
                target_shape = (size_new.h, size_new.w)
                projected = len(class_ids) * n_methods * size_new.h * size_new.w * 3
                if budget_mb is not None and projected > budget_mb * (1 << 20):
                    raise ValueError(
                        f"tpu.device_class_cache needs {projected / 2**20:.0f} MB for "
                        f"{len(class_ids)} classes x {n_methods} methods, over the {budget_mb} MB "
                        "budget (tpu.device_class_cache_budget_mb)")
            elif target_shape != (size_new.h, size_new.w):
                raise ValueError(
                    "tpu.device_class_cache needs a single class-image shape (got "
                    f"{target_shape} and {(size_new.h, size_new.w)}); configure a one-entry "
                    "class shape palette as the train loader does")
            index_of[cid] = row
            sizes[cid] = size_new
            per_class.append(np.stack([np.asarray(img.resize((size_new.w, size_new.h), m),
                                                  np.uint8) for m in RESAMPLE_CHOICES]))
        stack = torch.from_numpy(np.stack(per_class)).to(device)
        logger.info("device class cache: %d classes x %d methods @ %s = %.0f MB on %s",
                    len(class_ids), n_methods, target_shape, stack.numel() / 2**20, device)
        return cls(class_ids, index_of, sizes, stack)

    def gather(self, class_ids, method_idx, hflip, vflip, c_pad):
        """A batch's class tensor on the stack's device: uint8 [c_pad, S_h,
        S_w, 3], row i the stack's (class_ids[i], method_idx[i]) flipped with
        the batch; the rows past the batch's classes hold the stack's first row
        at the first method, as the JAX package pads them (the step's
        class_valid masks them)."""
        rows = torch.zeros(c_pad, dtype=torch.long)
        methods = torch.zeros(c_pad, dtype=torch.long)
        rows[:len(class_ids)] = torch.tensor([self.index_of[int(c)] for c in class_ids])
        methods[:len(class_ids)] = torch.tensor(list(method_idx), dtype=torch.long)
        out = self.stack[rows.to(self.stack.device), methods.to(self.stack.device)]
        dims = [d for d, flip in ((2, hflip), (1, vflip)) if flip]
        return torch.flip(out, dims) if dims else out
