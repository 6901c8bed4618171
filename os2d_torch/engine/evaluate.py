"""Evaluation engine, single device: counterpart of the eval path of
`os2d_tpu/engine/evaluate.py` (the reference's os2d/engine/evaluate.py).

- `Evaluator.detect_images` takes a uint8 image batch through the normalized
  antialiased pyramid, the backbone at every level, the head over class
  chunks and the pyramid decode + NMS, and returns one packed [B, G, K, 6]
  tensor. With test-time class augmentation (TTA) the V views of a class are
  contiguous rows of the class bank; each view is decoded as an extra
  pyramid level, which gives the reference's joint per-class NMS over views.
- `Evaluator.detect_images_prescreened` is the no-miss class prescreen: the
  backbone once, per-class correlation ceilings, then the head and decode on
  the surviving classes only.
- `evaluate` runs a dataloader to VOC mAP, and with a `criterion` also to
  the training objective's loss terms per image (the prescreen is bypassed
  then: negatives count).
- With cfg.tpu.fold_bn, `evaluate` runs a copy of the model with its
  BatchNorms folded (`models.os2d.fold_inference_params`).
- `Evaluator.score_pyramid` scores a host-built pyramid level by level and
  returns the raw per-level outputs (corners too on request): the
  host-pyramid path of `evaluate` (cfg.tpu.device_side_pyramid=False) and
  hard-patch mining (engine/mining.py) run on it.
- Over a mesh (parallel/mesh.py) the work shards over the ranks as
  cfg.tpu.eval_shard_axis says, classes (each rank scores its slice of every
  class chunk) or images (each rank detects its rows of the batch), and
  every rank ends with the unsharded run's detections and mAP.
- With cfg.tpu.quantize_class_feats, `evaluate` quantizes the class bank to
  int8 (`models.head.quantize_class_head`); it stays int8 on the device and
  each class chunk is dequantized when the head runs. `detect_images` and
  `score_pyramid` take a QuantizedClassHead (dequantized up front over a
  mesh); the prescreen does not apply to it.
- Without a mesh, `detect_images` runs larger class chunks on smaller
  pyramid levels (cfg.tpu.eval_class_chunk_per_level, `level_class_chunks`):
  eval_class_chunk bounds the correlation tensor at the largest level.
- `evaluate` prepares and uploads batch i+1 on a producer thread while batch
  i computes (cfg.tpu.eval_prefetch_depth batches ahead; 0 runs the serial
  loop), through pinned host memory on a card (utils/upload.py), as rgb8 or,
  with cfg.tpu.upload_pixel_format "yuv420", as JAX's 4:2:0 wire
  (ops/pixel_format.py), and draws the figures of cfg.visualization.eval
  (utils/visualization.py).
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.voc_eval import do_voc_evaluation
from ..models.head import (
    ClassHead,
    QuantizedClassHead,
    correlation_gemm,
    dequantize_class_head,
    quantize_class_head,
)
from ..models.os2d import fold_inference_params
from ..ops.geometry import l2_normalize_channels
from ..ops.pixel_format import (
    PackedYuv420,
    decode_to_float_rgb,
    decode_wire_to_u8,
    resolve_pixel_format,
    upload_images,
)
from ..ops.sampling import resize_bilinear_antialias
from ..parallel.mesh import all_gather_cat, all_gather_chunked, local_rows, primary_host
from ..structures.feature_map import FeatureMapSize, feature_map_size_for_image
from ..utils.profiling import annotate, host_constant
from ..utils.upload import uploader_for
from .decode import decode_pyramid, default_boxes_for_image_size
from .objective import compute_objective
from .targets import encode_targets, remap_targets


def prescreen_margin(resample_precision: str, compute_dtype: str = "float32") -> float:
    """Safety margin of the class prescreen: a class survives phase 1 iff its
    correlation ceiling > eval.nms_score_threshold - margin.

    The ceiling bounds every score exactly in real arithmetic (see
    `Evaluator.detect_images_prescreened`); the margin absorbs the worst-case
    rounding difference between the phase-1 ceiling and the phase-2 scores
    (os2d_tpu/engine/evaluate.py:37-63, margins unchanged):
    - "highest"/"high": the fp32 gather; only summation-order ulps remain
      -> 1e-4.
    - "default": the hat kernel rounds corr*mask and the hat rows to bf16
      (2^-9 relative each); for cosine scores |corr| <= 1 the combined
      absolute error is <= ~2^-8 ~= 4e-3.
    - "int8": corr is quantized to 1/127 steps (~4e-3 absolute) on top of
      the fixed-point hat-weight rounding -> 1.5e-2.
    - compute_dtype "bfloat16" also rounds the phase-1 correlation's inputs
      (feature maps, class features): another 4e-3.
    A larger margin only admits extra classes (slower, never wrong)."""
    margins = {"highest": 1e-4, "high": 1e-4, "default": 4e-3, "int8": 1.5e-2}
    if resample_precision not in margins:
        raise ValueError(f"no prescreen margin for resample_precision {resample_precision!r}")
    return margins[resample_precision] + (4e-3 if compute_dtype == "bfloat16" else 0.0)


def unpack_detections(packed) -> Dict[str, np.ndarray]:
    """Unpack a packed [..., G, K, 6] array (x1, y1, x2, y2, score, valid)
    into {boxes, scores, valid} numpy arrays. Reading a device tensor back
    is the request's last host wait (span `os2d.wait.unpack`)."""
    if isinstance(packed, torch.Tensor):
        with annotate("os2d.wait.unpack"):
            arr = packed.cpu().numpy()
    else:
        arr = np.asarray(packed)
    return {
        "boxes": arr[..., :4],
        "scores": arr[..., 4],
        "valid": arr[..., 5] > 0.5,
    }


def augment_class_images(class_images: List, mode: str):
    """Expand class images with TTA views; returns (views, num_views_per_class).

    View layout matches the reference (evaluate.py:241-269): per class,
    contiguous [orig, rot90, rot180, rot270] / [orig, flip] / all 8.
    Images are [h, w, 3] arrays (or CPU tensors); rot90 rotates in the (h, w)
    plane like torch rot90(1, [H, W]); horflip flips the width axis.
    """
    if not mode:
        return list(class_images), 1
    views = []
    for im in class_images:
        im = np.asarray(im)
        if mode == "rotation90":
            im90 = np.rot90(im, 1, axes=(0, 1))
            views += [im, im90, np.rot90(im90, 1, axes=(0, 1)),
                      np.rot90(im90, 2, axes=(0, 1))]
        elif mode == "horflip":
            views += [im, im[:, ::-1]]
        elif mode == "horflip_rotation90":
            im90 = np.rot90(im, 1, axes=(0, 1))
            im180 = np.rot90(im90, 1, axes=(0, 1))
            im270 = np.rot90(im180, 1, axes=(0, 1))
            views += [im, im90, im180, im270,
                      im[:, ::-1], im90[:, ::-1], im180[:, ::-1], im270[:, ::-1]]
        else:
            raise RuntimeError(f"Unknown class_image_augmentation: {mode}")
    num_views = {"rotation90": 4, "horflip": 2, "horflip_rotation90": 8}[mode]
    return [np.ascontiguousarray(v) for v in views], num_views


def _on_device(x, device):
    """`x` as a tensor on `device`. From host memory that is a pageable copy,
    which on a card waits for the stream to drain (span `os2d.wait.upload`)."""
    if isinstance(x, torch.Tensor) and x.device.type == torch.device(device).type:
        return torch.as_tensor(x, device=device)
    with annotate("os2d.wait.upload"):
        return torch.as_tensor(x, device=device)


def _pad_classes(x, c_pad: int):
    if x.shape[0] == c_pad:
        return x
    return torch.cat([x, x.new_zeros((c_pad - x.shape[0],) + tuple(x.shape[1:]))])


def level_class_chunks(level_sizes, chunk: int, c_total: int) -> List[int]:
    """Per-level class chunks (os2d_tpu/engine/evaluate.py:530-553): `chunk`
    bounds the [B, chunk, H, W, 225] correlation tensor at the level with the
    largest feature map (area a_max); a level of area a_l runs
    min(max(chunk, (chunk * a_max // a_l) // 8 * 8), ceil8(c_total)) classes
    per head call. Chunking only batches classes, so the scores are those of
    uniform chunks. level_sizes: the pyramid levels' image sizes."""
    areas = []
    for sz in level_sizes:
        fm = feature_map_size_for_image(FeatureMapSize(w=sz.w, h=sz.h))
        areas.append(fm.h * fm.w)
    a_max = max(areas)
    cap = -(-c_total // 8) * 8
    return [min(max(chunk, (chunk * a_max // a) // 8 * 8), cap) for a in areas]


def _decode_and_pack(loc_p, cls_p, sizes, scales, num_views, cfg):
    """View split + batched pyramid decode -> ONE packed [B, G, K, 6] tensor.

    loc_p/cls_p rows must be a multiple of num_views (views of one class are
    contiguous); the v::num_views split decodes each view as an extra
    pyramid level, for joint per-class NMS over views. Runs in span
    `os2d.eval.decode`."""
    with annotate("os2d.eval.decode"):
        if num_views > 1:
            if loc_p[0].shape[1] % num_views:
                raise ValueError(f"{loc_p[0].shape[1]} class rows do not split into "
                                 f"{num_views} views")
            loc_p = [lp[:, v::num_views] for lp in loc_p for v in range(num_views)]
            cls_p = [cp[:, v::num_views] for cp in cls_p for v in range(num_views)]
            sizes = [s for s in sizes for _ in range(num_views)]
            scales = [s for s in scales for _ in range(num_views)]
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


def padded_gt_for_image(dataloader, image_id, class_ids, num_views: int, g_pad: int):
    """Padded GT arrays of one image in original coordinates
    (os2d_tpu/engine/evaluate.py:201-227): boxes [g_pad, 4], labels [g_pad]
    (the class's view-0 row; -1 pads), difficult and valid [g_pad]."""
    ann = dataloader.dataset.get_image_annotation_for_imageid(image_id)
    local = dataloader.convert_label_ids_global_to_local(ann.get_field("labels"), class_ids)
    gt_boxes = np.zeros((g_pad, 4), np.float32)
    gt_labels = np.full((g_pad,), -1, np.int64)
    gt_difficult = np.zeros((g_pad,), bool)
    gt_valid = np.zeros((g_pad,), bool)
    k = len(ann)
    if k:
        gt_boxes[:k] = ann.bbox_xyxy
        # GT positives land on each class's view-0 row; the other views act
        # as extra negative labels (reference evaluate.py:293)
        gt_labels[:k] = local * num_views
        gt_difficult[:k] = ann.get_field("difficult")
        gt_valid[:k] = True
    return gt_boxes, gt_labels, gt_difficult, gt_valid


def eval_losses(objective_cfg, cfg, loc_p, cls_p, sizes, scales, gt):
    """The objective's loss terms per image of a batch
    (os2d_tpu/engine/evaluate.py:230-290): per level, GT encoded against the
    anchors in original coordinates and remapped with the predicted locs;
    the levels concatenated along the anchors; the objective per image.

    Args: loc_p / cls_p per level [B, C_rows, 4, A_l] / [B, C_rows, A_l]
    (views not merged); sizes / scales per level (level size, (sx, sy) back
    to the original image); gt: boxes [B, G, 4], labels, difficult, valid.
    Returns {loss name: [B] tensor}.
    """
    obj = cfg.train.objective
    num_labels = loc_p[0].shape[1]
    device = loc_p[0].device
    gt = [_on_device(gt[k], device) for k in ("boxes", "labels", "difficult", "valid")]
    loc_t, cls_t, cls_r = [], [], []
    for lp, sz, (sx, sy) in zip(loc_p, sizes, scales):
        d_boxes = default_boxes_for_image_size(sz, device=device) * host_constant(
            [sx, sy, sx, sy], dtype=torch.float32, device=device)
        lt, ct = encode_targets(*gt, d_boxes, num_labels, float(obj.positive_iou_threshold),
                                float(obj.negative_iou_threshold))
        cr, _, _ = remap_targets(lp, *gt, d_boxes,
                                 float(obj.remap_classification_targets_iou_pos),
                                 float(obj.remap_classification_targets_iou_neg))
        loc_t.append(lt)
        cls_t.append(ct)
        cls_r.append(cr)
    loc_p, loc_t = torch.cat(loc_p, dim=3), torch.cat(loc_t, dim=3)
    cls_p, cls_t, cls_r = torch.cat(cls_p, dim=2), torch.cat(cls_t, dim=2), torch.cat(cls_r, 2)
    per_image = [compute_objective(objective_cfg, loc_p[i:i + 1], loc_t[i:i + 1],
                                   cls_p[i:i + 1], cls_t[i:i + 1],
                                   cls_targets_remapped=cls_r[i:i + 1])
                 for i in range(loc_p.shape[0])]
    return {k: torch.stack([losses[k] for losses in per_image]) for k in per_image[0]}


class Evaluator:
    """Multiscale one-shot detection with a model on one device.

    `prescreen_pruned` counts the (batch, class) pairs that the prescreen
    skipped since the Evaluator was made.

    With a `mesh` every rank calls each method with the same arguments and
    gets the same result, computed in shards (os2d_tpu/engine/evaluate.py:
    293-343, 479-540). cfg.tpu.eval_shard_axis "classes": the class chunk is
    rounded up to a multiple of the mesh size, each rank runs the head on its
    slice of every chunk, and the per-class outputs are gathered before the
    decode, so that the decode and a cross-class NMS see every class; the
    prescreen shards both of its phases so. "images": each rank detects its
    rows of the batch (a multiple of the mesh size) and the packed
    detections are gathered; the prescreen does not apply (its surviving
    classes are chosen for the whole batch). `score_pyramid` shards classes
    under either axis, as JAX's does."""

    def __init__(self, model, cfg, logger_prefix="OS2D.eval", mesh=None):
        self.model = model
        self.cfg = cfg
        self.logger = logging.getLogger(logger_prefix)
        self.mesh = mesh
        self.prescreen_pruned = 0
        self.shard_axis = str(cfg.tpu.eval_shard_axis)
        if self.shard_axis not in ("classes", "images"):
            raise ValueError(f"unknown cfg.tpu.eval_shard_axis {self.shard_axis!r}: "
                             "expected 'classes' or 'images'")

    def _class_chunk(self, shard_classes: bool) -> int:
        """cfg.tpu.eval_class_chunk; when the classes shard, rounded up to a
        multiple of the mesh size, so that every rank scores an equal slice
        of every chunk (os2d_tpu/engine/evaluate.py:373-376, 733-738)."""
        chunk = int(self.cfg.tpu.eval_class_chunk)
        if shard_classes:
            n = self.mesh.size
            chunk = -(-max(chunk, n) // n) * n
        return chunk

    def check_image_batch(self, n_images: int) -> None:
        """Under image sharding the batch must divide over the ranks."""
        if self.mesh is not None and self.shard_axis == "images" and n_images % self.mesh.size:
            raise ValueError(
                f"eval_shard_axis='images' needs the image batch ({n_images}) to be a "
                f"multiple of the mesh size ({self.mesh.size}); set eval.batch_size accordingly")

    def build_class_heads(self, class_images: List, class_image_augmentation: str = ""):
        """Class images (normalized [h, w, 3]) -> (ClassHead, num_views), the
        views of each class in contiguous rows."""
        views, num_views = augment_class_images(class_images, class_image_augmentation)
        return self.model.build_class_head_from_images(views), num_views

    def pyramid_levels(self, images_u8, level_sizes, img_normalization):
        """uint8 [B, H, W, 3], or a PackedYuv420 wire, -> the normalized
        antialiased pyramid on the model's device, one [B, h_l, w_l, 3]
        tensor per level (JAX's engine/pyramid.py: device_pyramid, batched).
        A wire decodes here, straight to float (os2d_tpu/engine/
        evaluate.py:576-577). Runs in span `os2d.eval.pyramid`."""
        device = self.model.device
        with annotate("os2d.eval.pyramid"):
            if isinstance(images_u8, PackedYuv420):
                images = PackedYuv420(_on_device(images_u8.data, device), images_u8.shape)
            else:
                images = _on_device(images_u8, device)
                if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
                    raise ValueError(f"images must be uint8 [B, H, W, 3], got "
                                     f"{images.dtype} {tuple(images.shape)}")
            mean = host_constant(img_normalization["mean"], dtype=torch.float32, device=device)
            std = host_constant(img_normalization["std"], dtype=torch.float32, device=device)
            img = (decode_to_float_rgb(images) / 255.0 - mean) / std
            return [img if (sz.h, sz.w) == tuple(img.shape[1:3])
                    else resize_bilinear_antialias(img, sz.h, sz.w) for sz in level_sizes]

    def _pyramid_features(self, images_u8, level_sizes, img_normalization):
        """uint8 [B, H, W, 3] or a wire -> backbone feature maps, one per level."""
        return [self.model.extract_features(level)
                for level in self.pyramid_levels(images_u8, level_sizes, img_normalization)]

    def level_chunks(self, level_sizes, c_total: int):
        """The class chunk of each level for `detect_images`
        (`level_class_chunks`) without a mesh, with more than one chunk and
        with cfg.tpu.eval_class_chunk_per_level; else None, one chunk for
        every level (a mesh's class shards keep one chunk, as JAX's do)."""
        chunk = int(self.cfg.tpu.eval_class_chunk)
        if (self.mesh is None and c_total > chunk
                and bool(self.cfg.tpu.eval_class_chunk_per_level)):
            return level_class_chunks(level_sizes, chunk, c_total)
        return None

    def _bank(self, class_head):
        """The bank the head runs on: a QuantizedClassHead stays int8 on one
        device; over a mesh it is dequantized up front, as JAX's
        class-sharded chunks move fp32 (os2d_tpu/engine/evaluate.py:363-372)."""
        if isinstance(class_head, QuantizedClassHead) and self.mesh is not None:
            return dequantize_class_head(class_head)
        return class_head

    def _score_levels(self, fms, class_head, keys=("loc", "cls"), shard_classes=False,
                      level_chunks=None):
        """Head over class chunks at every level -> {key: [per level]} for the
        head outputs in `keys`: loc [B, C, 4, A_l], cls [B, C, A_l], corners
        [B, C, 8, A_l]. Chunks of cfg.tpu.eval_class_chunk (or of
        level_chunks[l] at level l) bound the [B, chunk, H, W, 225]
        correlation tensor; the last chunk is zero-padded to the full size
        and the padding trimmed. A QuantizedClassHead's chunks are
        dequantized as the head runs (zero rows pad to zero features). With
        shard_classes each rank of the mesh runs the head on its slice of
        every chunk, and each output is gathered whole. Runs in span
        `os2d.eval.scores` (each head call in its own `os2d.head`)."""
        mesh = self.mesh if shard_classes else None
        c_total = class_head.pool_mask.shape[0]
        if level_chunks is None:
            level_chunks = [self._class_chunk(mesh is not None)] * len(fms)
        with annotate("os2d.eval.scores"):
            banks = {}
            scores = {k: [] for k in keys}
            for fm, chunk in zip(fms, level_chunks):
                n_chunks = -(-c_total // chunk)
                if chunk not in banks:
                    banks[chunk] = [_pad_classes(x, n_chunks * chunk) for x in class_head]
                bank = banks[chunk]
                own = slice(0, chunk) if mesh is None else local_rows(mesh, chunk)
                parts = {k: [] for k in keys}
                for start in range(0, n_chunks * chunk, chunk):
                    rows = slice(start + own.start, start + own.stop)
                    out = self.model.apply_head(fm, type(class_head)(*(x[rows] for x in bank)))
                    for k in keys:
                        parts[k].append(out[k])
                for k in keys:
                    level = torch.cat(parts[k], dim=1)
                    if mesh is not None:
                        level = all_gather_chunked(mesh, level, n_chunks, dim=1)
                    scores[k].append(level[:, :c_total])
            return scores

    @torch.no_grad()
    def score_pyramid(self, pyramid_images, class_head: ClassHead, want_corners: bool = False):
        """Backbone and head over every level of a host-built pyramid and
        every class (os2d_tpu/engine/evaluate.py:354-430), with no graph
        recorded whatever the model's training state.

        Args: pyramid_images, per level [B, h_l, w_l, 3] normalized images
        (arrays or tensors). Returns per level a dict of tensors on the
        model's device: loc [B, C, 4, A_l], cls [B, C, A_l] and, with
        want_corners, corners [B, C, 8, A_l]. Over a mesh the classes shard."""
        keys = ("loc", "cls", "corners") if want_corners else ("loc", "cls")
        fms = [self.model.extract_features(_on_device(level, self.model.device))
               for level in pyramid_images]
        scores = self._score_levels(fms, self._bank(class_head), keys,
                                    shard_classes=self.mesh is not None)
        return [{k: scores[k][i] for k in keys} for i in range(len(fms))]

    @torch.no_grad()
    def detect_images(self, images_u8, class_head: ClassHead, level_sizes,
                      inverse_scales, img_normalization, num_views: int = 1,
                      objective_cfg=None, gt=None):
        """uint8 image batch [B, H, W, 3] (or its PackedYuv420 wire) in ->
        top-K detections out as a packed [B, G, K, 6] tensor (x1, y1, x2,
        y2, score, valid) on the model's device, G = classes / num_views;
        unpack on the host with `unpack_detections`. Smaller levels may run
        larger class chunks (`level_chunks`). Under image sharding a wire
        decodes to uint8 before the rows are split, as JAX's mesh paths
        decode up front.

        Args:
          level_sizes: FeatureMapSize (w, h) of each pyramid level.
          inverse_scales: per level (sx, sy) back to the input image.
          img_normalization: {"mean": 3 floats, "std": 3 floats}.
          num_views: TTA views per class (contiguous rows of class_head).
          objective_cfg, gt: with both (gt: padded boxes [B, G, 4] in
            original coordinates, labels as view-0 rows, difficult, valid),
            returns (packed, {loss name: [B] tensor}) from the same scores
            (`eval_losses`).
        """
        by_images = self.mesh is not None and self.shard_axis == "images"
        if by_images:
            self.check_image_batch(images_u8.shape[0])
            rows = local_rows(self.mesh, images_u8.shape[0])
            if isinstance(images_u8, PackedYuv420):
                images_u8 = decode_wire_to_u8(
                    PackedYuv420(_on_device(images_u8.data, self.model.device),
                                 images_u8.shape))
            images_u8 = images_u8[rows]
            if gt is not None:
                gt = {k: v[rows] for k, v in gt.items()}
        fms = self._pyramid_features(images_u8, level_sizes, img_normalization)
        bank = self._bank(class_head)
        scores = self._score_levels(fms, bank,
                                    shard_classes=self.mesh is not None and not by_images,
                                    level_chunks=self.level_chunks(level_sizes,
                                                                   bank.pool_mask.shape[0]))
        loc_p, cls_p = scores["loc"], scores["cls"]
        scales = [tuple(s) for s in inverse_scales]
        packed = _decode_and_pack(loc_p, cls_p, list(level_sizes), scales, num_views, self.cfg)
        losses = None if objective_cfg is None else eval_losses(
            objective_cfg, self.cfg, loc_p, cls_p, list(level_sizes), scales, gt)
        if by_images:
            packed = all_gather_cat(self.mesh, packed)
            if losses is not None:
                losses = {k: all_gather_cat(self.mesh, v) for k, v in losses.items()}
        return packed if losses is None else (packed, losses)

    def prescreen_applicable(self, class_head=None) -> bool:
        """The no-miss class prescreen is available when the decode threshold is
        finite (scores are mask-weighted averages of correlations, so the
        per-class correlation ceiling bounds every decodable score),
        cfg.tpu.eval_class_prescreen is on and the bank is not an int8
        QuantizedClassHead. Under nms_across_classes the
        padded duplicate rows are score-masked to -inf in phase 2 so they
        cannot suppress real detections; pruned classes cannot suppress
        anything either (they have no detections above the threshold).
        Under image sharding it does not apply (os2d_tpu/engine/evaluate.py:
        684-700)."""
        return (bool(self.cfg.tpu.eval_class_prescreen)
                and bool(np.isfinite(float(self.cfg.eval.nms_score_threshold)))
                and not isinstance(class_head, QuantizedClassHead)
                and (self.mesh is None or self.shard_axis == "classes"))

    @torch.no_grad()
    def detect_images_prescreened(self, images_u8, class_head: ClassHead, level_sizes,
                                  inverse_scales, img_normalization, num_views: int = 1):
        """Two-phase detection (no-miss prescreen: no detection above the
        threshold is dropped, up to the rounding margin of `prescreen_margin`).

        Phase 1: pyramid + backbone once, then per-class correlation ceilings
        max over (image, anchor, template cell) of corr[c]. The resampled
        recognition score is a convex combination of correlation values
        (bilinear or hat weights and the pool mask are non-negative and sum
        to 1; the border clamp only repeats values), so a class whose
        ceiling is <= eval.nms_score_threshold cannot produce a valid
        detection: decode drops scores <= threshold. The ceiling's GEMM and
        max are plain torch.matmul/amax (JAX computes them outside any Pallas
        kernel), the GEMM on operands rounded to the compute dtype with an
        fp32 result, as the head's (os2d_tpu/engine/evaluate.py:789-798).
        Phase 2: alignment + resample + decode on ONLY the surviving classes'
        rows, padded to a power-of-two number of class chunks with duplicates
        of row 0 whose scores are masked to -inf; the feature maps stay on the
        device between the phases. Returns the same packed [B, G, K, 6] tensor
        as detect_images, with pruned classes all-invalid. Over a mesh (class
        sharding) each rank takes its slice of every chunk in both phases,
        and the ceilings are gathered, so every rank keeps the same classes.
        """
        cfg = self.cfg
        if isinstance(class_head, QuantizedClassHead):
            raise ValueError("the class prescreen takes an fp32 bank, not a QuantizedClassHead "
                             "(see prescreen_applicable)")
        feats_bank, pool_mask = class_head.class_feats, class_head.pool_mask
        c_total, f = feats_bank.shape[0], feats_bank.shape[-1]
        n_groups = c_total // num_views
        threshold = float(cfg.eval.nms_score_threshold)
        top_k = int(cfg.tpu.eval_top_k)
        mesh = self.mesh
        if mesh is not None and self.shard_axis != "classes":
            raise ValueError("the class prescreen shards classes; it does not apply under "
                             "eval_shard_axis='images'")
        chunk = self._class_chunk(mesh is not None)
        device = self.model.device
        compute_dtype = self.model.compute_dtype

        fms = self._pyramid_features(images_u8, level_sizes, img_normalization)
        n_img = fms[0].shape[0]
        n_chunks1 = -(-c_total // chunk)
        if mesh is None:
            bank, own = feats_bank, slice(0, chunk)
        else:  # this rank's slice of every chunk; the zero rows padded in are trimmed
            bank, own = _pad_classes(feats_bank, n_chunks1 * chunk), local_rows(mesh, chunk)
        ceil = None
        for fm in fms:
            fmn = l2_normalize_channels(fm, eps=1e-5, dim=-1).reshape(-1, f)
            tops = []
            for start in range(0, n_chunks1 * chunk, chunk):
                feats = bank[start + own.start:start + own.stop]
                # [B*A, n*225]
                corr = correlation_gemm(fmn, feats.reshape(-1, f), compute_dtype)
                tops.append(corr.reshape(corr.shape[0], feats.shape[0], -1).amax(dim=(0, 2)))
            top = torch.cat(tops)
            ceil = top if ceil is None else torch.maximum(ceil, top)
        if mesh is not None:
            ceil = all_gather_chunked(mesh, ceil[None], n_chunks1, dim=1)[0, :c_total]
        # group ceilings over TTA views; the margin absorbs the rounding
        # difference between the phases
        margin = prescreen_margin(self.model.config.resample_precision,
                                  self.model.config.compute_dtype)
        with annotate("os2d.wait.prescreen"):
            ceil_groups = ceil.cpu().numpy().reshape(n_groups, num_views).max(1)
        sel = np.nonzero(ceil_groups > threshold - margin)[0]
        self.prescreen_pruned += n_groups - int(sel.size)
        full = torch.zeros((n_img, n_groups, top_k, 6), dtype=torch.float32, device=device)
        if sel.size == 0:
            return full

        # the surviving rows, padded to a power-of-two chunk count (as the
        # JAX package pads them to bound its compiled programs)
        n_sel_rows = int(sel.size) * num_views
        n_chunks_total = -(-c_total // chunk)
        n_chunks2 = max(1, -(-n_sel_rows // chunk))
        n_chunks2 = min(1 << (n_chunks2 - 1).bit_length(), n_chunks_total)
        c_sel_pad = n_chunks2 * chunk
        row_idx = (sel[:, None] * num_views + np.arange(num_views)).reshape(-1)
        row_idx = np.concatenate([row_idx, np.zeros((c_sel_pad - n_sel_rows,), np.int64)])
        rows = _on_device(row_idx, device)
        scores = self._score_levels(fms, ClassHead(feats_bank[rows], pool_mask[rows]),
                                    shard_classes=mesh is not None)
        loc_p, cls_p = scores["loc"], scores["cls"]
        # c_sel_pad need not divide into views: trim to the largest
        # view-aligned row count (the real rows are within it)
        g_rows = (c_sel_pad // num_views) * num_views
        row_valid = torch.arange(g_rows, device=device) < n_sel_rows
        loc_p = [lp[:, :g_rows] for lp in loc_p]
        # padded duplicate rows must not suppress real ones in a joint
        # (nms_across_classes) NMS: decode drops their -inf scores
        cls_p = [torch.where(row_valid[None, :, None], cp[:, :g_rows], float("-inf"))
                 for cp in cls_p]
        packed = _decode_and_pack(loc_p, cls_p, list(level_sizes),
                                  [tuple(s) for s in inverse_scales], num_views, cfg)
        full[:, _on_device(sel, device)] = packed[:, :sel.size]
        return full


class _ProducerError:
    def __init__(self, error):
        self.error = error


_END = object()


def _uploaded_batches(dataloader, batch_size, uploader, pixel_format="rgb8", logger=None):
    """(batch_ids, images on the device, level_sizes, inv_scales,
    initial_sizes) per batch of the raw iterator. A partial tail batch
    repeats its last image (a bucket's images share one size); only the
    genuine rows are recorded. The images go up as rgb8 or as a yuv420 wire
    (`ops.pixel_format.upload_images`)."""
    for (batch_ids, base_images, level_sizes, inv_scales,
         initial_sizes) in dataloader.make_raw_iterator_for_all_images(batch_size):
        stacked = np.stack(base_images + [base_images[-1]] * (batch_size - len(base_images)))
        yield (batch_ids, upload_images(uploader, stacked, pixel_format, logger), level_sizes,
               inv_scales, initial_sizes)


def _prefetched(items, depth: int):
    """The items of the iterator `items`, produced on a thread up to `depth`
    ahead of the consumer (os2d_tpu/engine/evaluate.py:1127-1207); depth 0
    produces them in the caller's loop. An exception of the producer is
    raised in the consumer; a consumer that stops early stops the producer."""
    if depth <= 0:
        yield from items
        return
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in items:
                if not put(item):
                    return
        except Exception as e:  # raised again in the consumer
            put(_ProducerError(e))
            return
        put(_END)

    thread = threading.Thread(target=producer, name="os2d-eval-producer", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _ProducerError):
                raise item.error
            yield item
    finally:
        stop.set()
        thread.join()


def evaluate(dataloader, model, cfg, criterion=None, print_per_class_results=False,
             logger_prefix="OS2D.eval", mesh=None):
    """Full-dataset evaluation -> {mAP@iou: value, ...}
    (os2d/engine/evaluate.py:21-174; os2d_tpu/engine/evaluate.py:1003-1421).

    The model owns its weights (an `Os2dModel`). Two paths, as in JAX:
    - fused: batches of one size bucket are uploaded as uint8 RGB, or with
      cfg.tpu.upload_pixel_format "yuv420" as JAX's 4:2:0 wire (1.5 B/px,
      lossy in chroma; decoded on the device as the dispatch starts; a batch
      of odd H or W goes up as rgb8), and detected with TTA views when
      cfg.eval.class_image_augmentation is set, through the class prescreen
      when cfg.eval.nms_score_threshold is finite. A producer thread stacks
      and uploads batch i+1 while batch i computes
      (cfg.tpu.eval_prefetch_depth batches ahead, default 1; 0 runs the
      serial loop; uploads as in utils/upload.py). The host unpacks batch i
      after batch i+1 was issued.
    - chunked per level: with cfg.tpu.device_side_pyramid=False the pyramid
      is built on the host (the dataloader's `make_iterator_for_all_images`);
      with cfg.visualization.eval.show_class_heatmaps, which needs the raw
      level scores, on the device from the raw batches. Either is scored by
      `Evaluator.score_pyramid` and decoded image by image, without the
      prescreen.
    With the prescreen, results also hold "prescreen_pruned": the (batch,
    class) pairs it skipped. With a `criterion` (an ObjectiveConfig) the
    results also hold the mean over images of each loss term of the
    objective, from the same scores (the prescreen is bypassed then: every
    class row counts as a negative). With cfg.tpu.fold_bn the BatchNorms are
    folded into a copy of the model before the class heads are built
    (os2d_tpu/engine/evaluate.py:1017-1020); the caller's model is left as it
    was. With a `mesh` every rank runs this with its own model (the same
    weights) and the same loader, the work shards as cfg.tpu.eval_shard_axis
    says (`Evaluator`), and every rank returns the same results
    (os2d_tpu/engine/evaluate.py:1003-1022); only rank 0 writes the
    detections file. With cfg.tpu.quantize_class_feats the class bank is
    quantized to int8 (os2d_tpu/engine/evaluate.py:1028-1032) and the
    prescreen does not run. cfg.visualization.eval's show_detections,
    show_gt_boxes and show_class_heatmaps draw their figures under
    <cfg.output.path>/viz_<dataset> (os2d_tpu/engine/evaluate.py:1058-1118).
    upload_pixel_format "auto" means rgb8 here, where JAX's means yuv420 on
    an accelerator (os2d_tpu/engine/evaluate.py:1172-1175): the wire halves
    uploads over a TPU's host tunnel, which a card's host link does not
    need; both packages upload rgb8 on the CPU.
    """
    pixel_format = resolve_pixel_format(cfg.tpu.upload_pixel_format)
    logger = logging.getLogger(f"{logger_prefix}.evaluate")
    dataset_name = dataloader.get_name()
    logger.info(f"Starting evaluation on {dataset_name}")
    t_start = time.time()

    if bool(cfg.tpu.fold_bn):
        model = fold_inference_params(model)
    evaluator = Evaluator(model, cfg, mesh=mesh)
    batch_size = max(1, int(cfg.eval.batch_size))
    evaluator.check_image_batch(batch_size)
    class_images, _, class_ids = dataloader.get_all_class_images()
    class_head, num_views = evaluator.build_class_heads(
        class_images, cfg.eval.class_image_augmentation)
    if bool(cfg.tpu.quantize_class_feats):
        class_head = quantize_class_head(class_head)
    img_norm = dataloader.img_normalization
    device_pyramid = bool(cfg.tpu.device_side_pyramid)
    viz_cfg = cfg.visualization.eval
    fused_blockers = []
    if not device_pyramid:
        fused_blockers.append("cfg.tpu.device_side_pyramid=False")
    if viz_cfg.show_class_heatmaps:
        fused_blockers.append("show_class_heatmaps needs raw level scores")
    use_fused = not fused_blockers
    use_prescreen = (use_fused and criterion is None
                     and evaluator.prescreen_applicable(class_head))
    detect = evaluator.detect_images_prescreened if use_prescreen else evaluator.detect_images
    if use_fused:
        logger.info("eval path: fused single-dispatch")
    else:
        logger.info("eval path: chunked per-level (fused blocked by: "
                    + "; ".join(fused_blockers) + ")")
    if use_prescreen:
        logger.info("eval path: fused two-phase (no-miss class prescreen at score threshold "
                    f"{float(cfg.eval.nms_score_threshold)})")
    viz_dir = ""
    if (viz_cfg.show_detections or viz_cfg.show_gt_boxes
            or viz_cfg.show_class_heatmaps) and cfg.output.path:
        viz_dir = os.path.join(cfg.output.path, f"viz_{dataset_name}")
        os.makedirs(viz_dir, exist_ok=True)

    def _image(image_id):
        return np.asarray(dataloader.dataset._get_dataset_image_by_id(image_id),
                          np.float32) / 255.0

    def _visualize(image_id, det_boxes, det_scores, det_labels):
        """The configured figures of one image (os2d/config.py:230-245)."""
        if not viz_dir:
            return
        from ..utils.visualization import show_detections, show_gt_boxes

        if viz_cfg.show_detections:
            show_detections(_image(image_id), det_boxes, det_scores, det_labels,
                            max_detections=viz_cfg.max_detections,
                            score_threshold=viz_cfg.score_threshold,
                            save_path=f"{viz_dir}/detections_{image_id}.png")
        if viz_cfg.show_gt_boxes:
            ann = dataloader.dataset.get_image_annotation_for_imageid(image_id)
            show_gt_boxes(_image(image_id), ann.bbox_xyxy, ann.get_field("labels"),
                          ann.get_field("difficult"), save_path=f"{viz_dir}/gt_{image_id}.png")

    def _heatmaps(image_id, level_outputs, i_image, img_sizes):
        """Per-class score heatmaps per pyramid level (reference
        evaluate.py:122-124; files instead of visdom)."""
        if not (viz_dir and viz_cfg.show_class_heatmaps and num_views == 1):
            return
        want_imgs = list(viz_cfg.images_for_heatmaps)
        if want_imgs and image_id not in want_imgs:
            return
        from ..utils.visualization import show_class_heatmap

        img = _image(image_id)
        want_labels = [int(g) for g in viz_cfg.labels_for_heatmaps] or [
            int(c) for c in class_ids[:4]]
        for i_p, out in enumerate(level_outputs):
            fm = feature_map_size_for_image(img_sizes[i_p])
            cls = out["cls"][i_image].cpu().numpy()  # [C, A]
            for gid in want_labels:
                if gid not in class_ids:
                    continue
                row = class_ids.index(gid)
                show_class_heatmap(img, cls[row].reshape(fm.h, fm.w),
                                   save_path=f"{viz_dir}/heatmap_{image_id}_cls{gid}_lvl{i_p}.png")

    predictions, gts, all_image_ids = [], [], []
    loss_sums, num_loss_images = {}, 0
    g_pad = 8
    if criterion is not None:
        # one padded GT size for the whole dataset
        for iid in dataloader.dataset.image_ids:
            g_pad = max(g_pad, len(dataloader.dataset.get_image_annotation_for_imageid(iid)))
        g_pad = -(-g_pad // 8) * 8

    def _gt_batch(batch_ids_b, rows_total):
        rows = [padded_gt_for_image(dataloader, i, class_ids, num_views, g_pad)
                for i in batch_ids_b]
        rows += [(np.zeros((g_pad, 4), np.float32), np.full((g_pad,), -1, np.int64),
                  np.zeros((g_pad,), bool), np.zeros((g_pad,), bool))] * (rows_total - len(rows))
        return {k: np.stack([r[j] for r in rows])
                for j, k in enumerate(("boxes", "labels", "difficult", "valid"))}

    def _finalize(batch_ids_b, initial_sizes_b, packed):
        """Unpacks a batch's packed detections (one device -> host copy) and
        records every genuine image row (padded tail rows are skipped); with
        a criterion, adds the genuine rows' losses."""
        nonlocal num_loss_images
        if criterion is not None:
            packed, losses = packed
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v[:len(batch_ids_b)].sum())
            num_loss_images += len(batch_ids_b)
        out = unpack_detections(packed)
        for i_image, image_id in enumerate(batch_ids_b):
            valid = out["valid"][i_image]
            labels = np.repeat(np.asarray(class_ids, np.int64), valid.sum(1))
            init_size = initial_sizes_b[i_image]
            pred = {
                "boxes": out["boxes"][i_image][valid],
                "scores": out["scores"][i_image][valid],
                "labels": labels,
                "image_size": (init_size.w, init_size.h),
            }
            predictions.append(pred)
            all_image_ids.append(image_id)
            _visualize(image_id, pred["boxes"], pred["scores"], pred["labels"])
            ann = dataloader.dataset.get_image_annotation_for_imageid(image_id)
            gts.append({
                "boxes": ann.bbox_xyxy,
                "labels": ann.get_field("labels"),
                "difficult": ann.get_field("difficult"),
                "image_size": (ann.image_size.w, ann.image_size.h),
            })

    if use_fused:
        uploader = uploader_for(model.device)
        pending = None
        for batch_ids, images, level_sizes, inv_scales, initial_sizes in _prefetched(
                _uploaded_batches(dataloader, batch_size, uploader, pixel_format, logger),
                int(cfg.tpu.eval_prefetch_depth)):
            if criterion is None:
                packed = detect(images, class_head, level_sizes, inv_scales[0], img_norm,
                                num_views=num_views)
            else:
                packed = detect(images, class_head, level_sizes, inv_scales[0], img_norm,
                                num_views=num_views, objective_cfg=criterion,
                                gt=_gt_batch(batch_ids, batch_size))
            if pending is not None:
                _finalize(*pending)
            pending = (batch_ids, initial_sizes, packed)
        if pending is not None:
            _finalize(*pending)
    else:
        if device_pyramid:
            def batches():
                # the pyramid of the raw batch built on the device (JAX's
                # per-image device_pyramid), no tail padding
                for (batch_ids, base_images, level_sizes, inv_scales,
                     initial_sizes) in dataloader.make_raw_iterator_for_all_images(batch_size):
                    yield (batch_ids, evaluator.pyramid_levels(np.stack(base_images),
                                                               level_sizes, img_norm),
                           inv_scales, initial_sizes)
        else:
            def batches():
                for (batch_ids, pyramids, inv_scales, _,
                     initial_sizes) in dataloader.make_iterator_for_all_images(batch_size):
                    yield batch_ids, pyramids, inv_scales, initial_sizes
        # every level scored against every class (os2d_tpu/engine/
        # evaluate.py:1343-1400), then each image decoded, and its losses
        # taken, at its own inverse scales
        for batch_ids, pyramids, inv_scales, initial_sizes in batches():
            level_outputs = evaluator.score_pyramid(pyramids, class_head)
            sizes = [FeatureMapSize(w=p.shape[2], h=p.shape[1]) for p in pyramids]
            for i_image, image_id in enumerate(batch_ids):
                loc_p = [o["loc"][i_image:i_image + 1] for o in level_outputs]
                cls_p = [o["cls"][i_image:i_image + 1] for o in level_outputs]
                scales = [tuple(s) for s in inv_scales[i_image]]
                packed = _decode_and_pack(loc_p, cls_p, sizes, scales, num_views, cfg)
                if criterion is not None:
                    packed = (packed, eval_losses(criterion, cfg, loc_p, cls_p, sizes, scales,
                                                  _gt_batch([image_id], 1)))
                _finalize([image_id], initial_sizes[i_image:i_image + 1], packed)
                _heatmaps(image_id, level_outputs, i_image, sizes)

    results = _finish_evaluation(predictions, gts, cfg, class_ids, dataset_name, t_start,
                                 print_per_class_results, logger, image_ids=all_image_ids)
    for k, v in loss_sums.items():
        results[k] = v / num_loss_images
    if use_prescreen:
        results["prescreen_pruned"] = evaluator.prescreen_pruned
    return results


def _finish_evaluation(predictions, gts, cfg, class_ids, dataset_name, t_start,
                       print_per_class_results, logger, image_ids):
    results = {}

    # optional raw-detection dump (reference evaluate.py:136-149; pickle
    # instead of torch.save: everything here is plain numpy)
    save_dir = str(cfg.visualization.eval.path_to_save_detections)
    if save_dir and primary_host():
        data = {
            "image_ids": list(image_ids),
            "boxes_xyxy": [p["boxes"] for p in predictions],
            "labels": [p["labels"] for p in predictions],
            "scores": [p["scores"] for p in predictions],
            "gt_boxes_xyxy": [np.asarray(g["boxes"]) for g in gts],
            "gt_labels": [np.asarray(g["labels"]) for g in gts],
            "gt_difficults": [np.asarray(g["difficult"]) for g in gts],
        }
        os.makedirs(save_dir, exist_ok=True)
        save_path = os.path.join(save_dir, f"{dataset_name}_detections.pkl")
        with open(save_path, "wb") as f:
            pickle.dump(data, f)
        logger.info(f"Saved detections to {save_path}")
    for iou_thresh in cfg.eval.mAP_iou_thresholds:
        res = do_voc_evaluation(predictions, gts, iou_thresh=iou_thresh)
        results[f"mAP@{iou_thresh:0.2f}"] = res["map"]
        results[f"mAPw@{iou_thresh:0.2f}"] = res["map_weighted"]
        results[f"recall@{iou_thresh:0.2f}"] = res["recall"]
        results[f"AP_joint_classes@{iou_thresh:0.2f}"] = res["ap_joint_classes"]
        if print_per_class_results:
            for cid in sorted(set(int(c) for c in class_ids)):
                if cid < len(res["ap_per_class"]):
                    results[f"mAP@{iou_thresh:0.2f}_class_{cid}"] = float(
                        res["ap_per_class"][cid])
        logger.info(
            f"{dataset_name} mAP@{iou_thresh:0.2f}: {res['map']:0.4f} "
            f"(weighted {res['map_weighted']:0.4f}, recall {res['recall']:0.4f})"
        )

    results["eval_time"] = time.time() - t_start
    logger.info(f"Evaluation on {dataset_name} took {results['eval_time']:0.2f}s")
    return results
