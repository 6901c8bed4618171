"""Evaluation engine, single device: counterpart of the eval path of
`os2d_tpu/engine/evaluate.py` (the reference's os2d/engine/evaluate.py).

`Evaluator.detect_images` takes a uint8 image batch through the normalized
antialiased pyramid, the backbone at every level, the head over class chunks
and the pyramid decode + NMS, and returns one packed [B, G, K, 6] tensor.
Not ported yet: test-time class augmentation, the loss metrics, the
prescreened path, meshes, int8 class banks and `evaluate()` to VOC mAP.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models.head import ClassHead
from ..ops.sampling import resize_bilinear_antialias
from .decode import decode_pyramid


def unpack_detections(packed) -> Dict[str, np.ndarray]:
    """Unpack a packed [..., G, K, 6] array (x1, y1, x2, y2, score, valid)
    into {boxes, scores, valid} numpy arrays."""
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    return {
        "boxes": arr[..., :4],
        "scores": arr[..., 4],
        "valid": arr[..., 5] > 0.5,
    }


def _pad_classes(x, c_pad: int):
    if x.shape[0] == c_pad:
        return x
    return torch.cat([x, x.new_zeros((c_pad - x.shape[0],) + tuple(x.shape[1:]))])


def _decode_and_pack(loc_p, cls_p, sizes, scales, cfg):
    """Batched pyramid decode -> ONE packed [B, G, K, 6] tensor."""
    out = decode_pyramid(
        loc_p, cls_p, sizes, scales,
        nms_iou_threshold=float(cfg.eval.nms_iou_threshold),
        score_threshold=float(cfg.eval.nms_score_threshold),
        pre_top_k=int(cfg.tpu.eval_pre_top_k),
        top_k=int(cfg.tpu.eval_top_k),
        nms_across_classes=bool(cfg.eval.nms_across_classes),
    )
    return torch.cat(
        [out["boxes"], out["scores"][..., None], out["valid"][..., None].float()], dim=-1)


class Evaluator:
    """Multiscale one-shot detection with a model on one device."""

    def __init__(self, model, cfg):
        self.model = model
        self.cfg = cfg

    def build_class_heads(self, class_images: List, class_image_augmentation: str = ""):
        """Class images (normalized [h, w, 3]) -> (ClassHead, num_views)."""
        if class_image_augmentation:
            raise NotImplementedError("test-time class augmentation is not ported")
        return self.model.build_class_head_from_images(class_images), 1

    @torch.no_grad()
    def detect_images(self, images_u8, class_head: ClassHead, level_sizes,
                      inverse_scales, img_normalization, num_views: int = 1):
        """uint8 image batch [B, H, W, 3] in -> top-K detections out as a
        packed [B, G, K, 6] tensor (x1, y1, x2, y2, score, valid) on the
        model's device; unpack on the host with `unpack_detections`.

        Args:
          level_sizes: FeatureMapSize (w, h) of each pyramid level.
          inverse_scales: per level (sx, sy) back to the input image.
          img_normalization: {"mean": 3 floats, "std": 3 floats}.
        """
        if num_views != 1:
            raise NotImplementedError("test-time class augmentation is not ported")
        model, cfg = self.model, self.cfg
        device = model.device
        images = torch.as_tensor(images_u8, device=device)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be uint8 [B, H, W, 3], got "
                             f"{images.dtype} {tuple(images.shape)}")
        mean = torch.tensor(img_normalization["mean"], dtype=torch.float32, device=device)
        std = torch.tensor(img_normalization["std"], dtype=torch.float32, device=device)
        img = (images.float() / 255.0 - mean) / std

        # class chunks bound the [B, chunk, H, W, 225] correlation tensor at
        # the largest level; the last chunk is zero-padded to the full size
        chunk = int(cfg.tpu.eval_class_chunk)
        c_total = class_head.class_feats.shape[0]
        c_pad = -(-c_total // chunk) * chunk
        feats = _pad_classes(class_head.class_feats, c_pad)
        mask = _pad_classes(class_head.pool_mask, c_pad)

        loc_p, cls_p = [], []
        for sz in level_sizes:
            if (sz.h, sz.w) == tuple(img.shape[1:3]):
                level = img
            else:
                level = resize_bilinear_antialias(img, sz.h, sz.w)
            fm = model.extract_features(level)
            locs, clss = [], []
            for start in range(0, c_pad, chunk):
                out = model.apply_head(
                    fm, ClassHead(feats[start:start + chunk], mask[start:start + chunk]))
                locs.append(out["loc"])
                clss.append(out["cls"])
            loc_p.append(torch.cat(locs, dim=1)[:, :c_total])
            cls_p.append(torch.cat(clss, dim=1)[:, :c_total])

        return _decode_and_pack(loc_p, cls_p, list(level_sizes),
                                [tuple(s) for s in inverse_scales], cfg)
