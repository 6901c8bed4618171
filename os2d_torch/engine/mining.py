"""Hard-patch mining: hard negatives, hard positives and localization errors.

Counterpart of `os2d_tpu/engine/mining.py` (the reference's
mine_hard_patches, os2d/engine/train.py:142-370, and the crop boxes of
BoxGridGenerator.get_box_to_cut_anchor, os2d/modeling/box_coder.py:78-166).
Every train image is scored through the host-built pyramid at random scales
against a random subset of negative classes plus the batch's own classes
(`Evaluator.score_pyramid`); targets are encoded at each level against the
anchors in original coordinates, and the objective's patch-mining mode gives
per-anchor losses. Per image and role, a greedy NMS over the anchors' crop
boxes keeps the hardest crops as records that the train dataloader replays
(`DataloaderOneShotDetection.set_hard_negative_data`). With
cfg.visualization.mining.show_mined_patches each image's records are drawn
under <cfg.output.path>/viz_mining.
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from ..models.head import ANCHOR_BOX, ANCHOR_STRIDE, ClassHead
from ..structures.feature_map import FeatureMapSize, feature_map_size_for_image
from ..utils.logger import time_since
from .decode import default_boxes_for_image_size
from .evaluate import Evaluator
from .objective import compute_objective
from .targets import encode_targets, remap_targets

# the per-anchor maps of one image cross to the host as one [L, 14, A] tensor
# of these rows: the five objective maps, the scores, then the 8 corner
# coordinates
_MAPS = ("cls_loss", "loc_loss", "pos_mask", "neg_mask", "pos_for_regression")


def get_box_to_cut_anchor(img_size: FeatureMapSize, crop_size: FeatureMapSize,
                          fm_size: FeatureMapSize, stride_w=None, stride_h=None,
                          box_w=None, box_h=None):
    """For each anchor, a crop_size box roughly centered on it and aligned to
    the anchor stride, shifted inside the image where it fits (numpy, as
    os2d_tpu/engine/mining.py:32-95).

    Returns (crop_boxes [A, 4], anchor_boxes [A, 4], anchor_index [A]).
    """
    stride_w = float(ANCHOR_STRIDE.w if stride_w is None else stride_w)
    stride_h = float(ANCHOR_STRIDE.h if stride_h is None else stride_h)
    box_w = float(ANCHOR_BOX.w if box_w is None else box_w)
    box_h = float(ANCHOR_BOX.h if box_h is None else box_h)

    anchor_index = np.arange(fm_size.h * fm_size.w)
    cx = (anchor_index % fm_size.w + 0.5) * stride_w
    cy = (anchor_index // fm_size.w + 0.5) * stride_h
    anchor_boxes = np.stack(
        [cx - box_w / 2, cy - box_h / 2, cx + box_w / 2, cy + box_h / 2], axis=1
    ).astype(np.float32)

    def floor_to_stride(pos, stride):
        return (np.floor(pos) // stride) * stride

    def ceil_to_stride(pos, stride):
        return np.floor(np.ceil(np.floor(pos) / stride)) * stride

    def fit(start, crop, image, stride):
        """Stride-aligned start of the crop, moved back inside the image
        where it sticks out past the end; at 0 where it cannot fit."""
        start = np.where(start > 0, floor_to_stride(start, stride), 0.0)
        end = start + crop
        over = end > image
        shift = ceil_to_stride(end - image, stride)
        good = (start - shift) >= 0
        start = np.where(over & good, start - shift, np.where(over, 0.0, start))
        end = np.where(over & good, end - shift, np.where(over, float(crop), end))
        return start, end

    left, right = fit(cx - crop_size.w / 2, crop_size.w, img_size.w, stride_w)
    top, bottom = fit(cy - crop_size.h / 2, crop_size.h, img_size.h, stride_h)
    crop_boxes = np.stack([left, top, right, bottom], axis=1).astype(np.float32)
    return crop_boxes, anchor_boxes, anchor_index


def _nms_topk_host(boxes, scores, iou_threshold, top_k):
    """Greedy NMS on the host over a small candidate set, highest score
    first (a stable sort: ties keep their order), up to top_k kept."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        b = boxes[i]
        x1 = np.maximum(b[0], boxes[:, 0])
        y1 = np.maximum(b[1], boxes[:, 1])
        x2 = np.minimum(b[2], boxes[:, 2])
        y2 = np.minimum(b[3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        iou = inter / np.maximum(area[i] + area - inter, 1e-12)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
        if len(keep) >= top_k:
            break
    return np.asarray(keep, np.int64)


def _image_maps(level_outputs, i_image, ann, batch_class_ids, level_sizes, scales,
                objective_cfg, obj, device):
    """One image's per-anchor maps, levels concatenated along the anchors, as
    one host array [L, 14, A_total] (rows: _MAPS, the scores, the corners in
    original coordinates): the one device -> host copy of the image."""
    num_labels = len(batch_class_ids)
    local = np.asarray([batch_class_ids.index(int(g)) if int(g) in batch_class_ids else -1
                        for g in ann.get_field("labels")], np.int64)
    g = max(8, len(ann))
    gt_boxes = np.zeros((1, g, 4), np.float32)
    gt_labels = np.full((1, g), -1, np.int64)
    gt_difficult = np.zeros((1, g), bool)
    gt_valid = np.zeros((1, g), bool)
    if len(ann):
        gt_boxes[0, :len(ann)] = ann.bbox_xyxy
        gt_labels[0, :len(ann)] = local
        gt_difficult[0, :len(ann)] = ann.get_field("difficult")
        gt_valid[0, :len(ann)] = True
    gt = [torch.as_tensor(x, device=device) for x in (gt_boxes, gt_labels, gt_difficult, gt_valid)]

    loc_p, cls_p, loc_t, cls_t, cls_r, corners = [], [], [], [], [], []
    for out, size, (sx, sy) in zip(level_outputs, level_sizes, scales):
        # targets against the anchors in original coordinates; decoding the
        # predictions against them equals decoding at the level and then
        # undoing the resize
        scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=device)
        d_boxes = default_boxes_for_image_size(size, device=device) * scale
        lp, cp = out["loc"][i_image:i_image + 1], out["cls"][i_image:i_image + 1]
        lt, ct = encode_targets(*gt, d_boxes, num_labels, float(obj.positive_iou_threshold),
                                float(obj.negative_iou_threshold))
        cr, _, _ = remap_targets(lp, *gt, d_boxes,
                                 float(obj.remap_classification_targets_iou_pos),
                                 float(obj.remap_classification_targets_iou_neg))
        loc_p.append(lp)
        cls_p.append(cp)
        loc_t.append(lt)
        cls_t.append(ct)
        cls_r.append(cr)
        corners.append(out["corners"][i_image] * scale[:2].repeat(4)[None, :, None])
    _, per_anchor = compute_objective(
        objective_cfg, torch.cat(loc_p, 3), torch.cat(loc_t, 3), torch.cat(cls_p, 2),
        torch.cat(cls_t, 2), cls_targets_remapped=torch.cat(cls_r, 2), patch_mining_mode=True)
    rows = [per_anchor[k][0].to(torch.float32) for k in _MAPS] + [torch.cat(cls_p, 2)[0]]
    return torch.cat([torch.stack(rows, 1), torch.cat(corners, 2)], 1).cpu().numpy()


@torch.no_grad()
def mine_hard_patches(dataloader, model, cfg, objective_cfg, rng=None):
    """Mine hard patches of every image of the train dataloader
    (os2d_tpu/engine/mining.py:123-348; the model owns its weights).

    Returns an OrderedDict {image_id: [record, ...]} for
    `dataloader.set_hard_negative_data`: per image, at most
    cfg.train.mining.num_hard_patches_per_image records of each role
    ("neg", then "pos", then "pos_loc"), each an OrderedDict with
    pyramid_level, label_local, anchor_index, role, crop_position_xyxy,
    anchor_position_xyxy, transform_corners (original coordinates),
    label_global, loss, loss_loc, score and image_id.

    The negative classes of each batch are drawn by `rng.shuffle`, by
    default from the dataloader's augmentation stream (`aug_rng`, where the
    JAX package draws from the global `random`); the random pyramid scales
    from the dataloader's batch stream. Scoring records no graph, whatever
    the model's training state, and leaves the model as it was.
    """
    if dataloader.data_augmentation is None:
        raise ValueError("hard patches are mined through the dataloader's data augmentation "
                         "(its random crop size)")
    logger = logging.getLogger("OS2D.mining_hard_patches")
    logger.info("Starting to mine hard patches")
    t_start = time.time()
    rng = dataloader.aug_rng if rng is None else rng
    device = model.device
    evaluator = Evaluator(model, cfg)
    class_images, _, class_ids = dataloader.get_all_class_images()
    class_head, _ = evaluator.build_class_heads(class_images)
    num_all = len(class_ids)
    crop_size = dataloader.data_augmentation.random_crop_size
    mining = cfg.train.mining
    num_random_negs = int(mining.num_random_negative_classes)
    nms_iou = float(mining.nms_iou_threshold_in_mining)
    top_k = int(mining.num_hard_patches_per_image)

    hardnegdata_per_imageid = OrderedDict()
    for batch_ids, pyramids, inverse_scales, _, _ in dataloader.make_iterator_for_all_images(
            cfg.eval.batch_size, num_random_pyramid_scales=mining.num_random_pyramid_scales):
        # the label subset: random negatives and this batch's positives
        if num_random_negs >= 0:
            neg = list(range(num_all))
            rng.shuffle(neg)
            pos_global = dataloader.dataset.get_dataframe_for_image_ids(batch_ids)[
                "classid"].unique()
            pos_local = [class_ids.index(int(g)) for g in pos_global if int(g) in class_ids]
            labels_local = sorted(set(neg[:num_random_negs]) | set(pos_local))
        else:
            labels_local = list(range(num_all))
        batch_class_ids = [class_ids[lab] for lab in labels_local]
        rows = torch.as_tensor(labels_local, device=device)
        level_outputs = evaluator.score_pyramid(
            pyramids, ClassHead(class_head.class_feats[rows], class_head.pool_mask[rows]),
            want_corners=True)
        level_sizes = [FeatureMapSize(w=p.shape[2], h=p.shape[1]) for p in pyramids]
        level_fm_sizes = [feature_map_size_for_image(s) for s in level_sizes]
        num_labels = len(labels_local)

        for i_image, image_id in enumerate(batch_ids):
            ann = dataloader.dataset.get_image_annotation_for_imageid(image_id)
            maps = _image_maps(level_outputs, i_image, ann, batch_class_ids, level_sizes,
                               inverse_scales[i_image], objective_cfg, cfg.train.objective,
                               device)
            # records are laid out level-major, then label-major, then anchor
            crops, anchors, labels, levels, anchor_idx, corners = [], [], [], [], [], []
            flat = {name: [] for name in _MAPS + ("score",)}
            offset = 0
            for i_p, (sx, sy) in enumerate(inverse_scales[i_image]):
                crop_boxes, anchor_boxes, anchor_index = get_box_to_cut_anchor(
                    level_sizes[i_p], crop_size, level_fm_sizes[i_p])
                a = len(crop_boxes)
                scale_vec = np.asarray([sx, sy, sx, sy], np.float32)
                crops.append(np.tile(crop_boxes * scale_vec, (num_labels, 1)))
                anchors.append(np.tile(anchor_boxes * scale_vec, (num_labels, 1)))
                labels.append(np.repeat(np.arange(num_labels), a))
                levels.append(np.full(num_labels * a, i_p))
                anchor_idx.append(np.tile(anchor_index, num_labels))
                level_maps = maps[:, :, offset:offset + a]  # [L, 14, a]
                for j, name in enumerate(flat):
                    flat[name].append(level_maps[:, j].reshape(-1))
                corners.append(level_maps[:, 6:].transpose(0, 2, 1).reshape(-1, 8))
                offset += a
            flat = {name: np.concatenate(v) for name, v in flat.items()}
            crops, anchors = np.concatenate(crops), np.concatenate(anchors)
            labels, levels = np.concatenate(labels), np.concatenate(levels)
            anchor_idx, corners = np.concatenate(anchor_idx), np.concatenate(corners)

            def mine(mask, scores):
                ids = np.nonzero(mask)[0]
                if len(ids) == 0:
                    return ids
                return ids[_nms_topk_host(crops[ids], scores[ids], nms_iou, top_k)]

            records = []
            for role, mask, scores in (("neg", "neg_mask", "cls_loss"),
                                       ("pos", "pos_mask", "cls_loss"),
                                       ("pos_loc", "pos_for_regression", "loc_loss")):
                for i in mine(flat[mask] > 0.5, flat[scores]):
                    records.append(OrderedDict(
                        pyramid_level=int(levels[i]),
                        label_local=int(labels[i]),
                        anchor_index=int(anchor_idx[i]),
                        role=role,
                        crop_position_xyxy=crops[i].copy(),
                        anchor_position_xyxy=anchors[i].copy(),
                        transform_corners=corners[i].copy(),
                        label_global=int(batch_class_ids[int(labels[i])]),
                        loss=float(flat["cls_loss"][i]),
                        loss_loc=float(flat["loc_loss"][i]),
                        score=float(flat["score"][i]),
                        image_id=image_id,
                    ))
            hardnegdata_per_imageid[image_id] = records
            if cfg.visualization.mining.show_mined_patches and cfg.output.path:
                # (reference train.py:365-366; saved to files)
                from ..utils.visualization import show_mined_patches

                viz_dir = os.path.join(cfg.output.path, "viz_mining")
                os.makedirs(viz_dir, exist_ok=True)
                image = np.asarray(dataloader.dataset._get_dataset_image_by_id(image_id),
                                   np.float32) / 255.0
                show_mined_patches(image, records,
                                   save_path=os.path.join(viz_dir, f"mined_{image_id}.png"))

    logger.info(f"Hard patch mining finished in {time_since(t_start)}")
    return hardnegdata_per_imageid
