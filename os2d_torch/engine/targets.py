"""Target assignment: anchor encoding and post-forward target remapping.

Counterpart of `os2d_tpu/engine/targets.py` (the reference's
Os2dBoxCoder.encode / remap_anchor_targets, os2d/modeling/box_coder.py:
234-422). GT arrives padded to a static [G, 4] with validity masks; where JAX
vmaps over images and labels, the port writes those axes out as batch
dimensions.

Class targets use the reference's value coding: 1 positive, 0 negative,
-1 ignore (difficult or between-threshold IoU).
"""

from __future__ import annotations

import torch

from ..structures.boxes import (
    box_iou,
    clip_to_min_size,
    decode_boxes,
    encode_boxes,
    match_anchors,
)


def _cls_from_index(index):
    return (1 + index.clamp(-2, 0)).to(torch.int32)


def encode_targets(gt_boxes, gt_labels, gt_difficult, gt_valid, default_boxes,
                   num_labels: int, positive_iou_threshold: float = 0.5,
                   negative_iou_threshold: float = 0.1):
    """Target encoding of a batch of images (os2d/modeling/box_coder.py:
    332-394; `encode_targets_single_image` per image in the JAX package).

    Args:
      gt_boxes [B, G, 4] xyxy (padded), gt_labels [B, G] local label ids
      (padded with -1), gt_difficult / gt_valid [B, G] bool, default_boxes
      [A, 4].
    Returns loc_targets [B, L, 4, A], cls_targets [B, L, A] int32.
    """
    labels = torch.arange(num_labels, device=gt_boxes.device)
    ious = box_iou(gt_boxes, default_boxes)[:, None]  # [B, 1, G, A]
    valid_l = gt_valid[:, None, :] & (gt_labels[:, None, :] == labels[None, :, None])  # [B, L, G]
    index, _ = match_anchors(ious, valid_l, gt_difficult[:, None, :].expand_as(valid_l),
                             positive_iou_threshold, negative_iou_threshold)  # [B, L, A]
    # unmatched anchors get a dummy box, the first box OF THIS LABEL
    # (box_coder.py:374): masked out of the localization loss, kept for parity
    first_of_label = valid_l.to(torch.int32).argmax(dim=-1, keepdim=True)  # [B, L, 1]
    rows = torch.where(index >= 0, index, first_of_label)
    matched = torch.gather(gt_boxes[:, None].expand(-1, num_labels, -1, -1), 2,
                           rows[..., None].expand(-1, -1, -1, 4))  # [B, L, A, 4]
    loc = encode_boxes(clip_to_min_size(matched, 1.0), clip_to_min_size(default_boxes, 1.0))
    has_gt = valid_l.any(-1)[..., None]  # [B, L, 1]
    loc = torch.where(has_gt[..., None], loc, 0.0)
    cls = torch.where(has_gt, _cls_from_index(index), 0)
    return loc.transpose(2, 3), cls


def remap_targets(loc_scores, gt_boxes, gt_labels, gt_difficult, gt_valid, default_boxes,
                  remap_iou_pos: float = 0.8, remap_iou_neg: float = 0.4):
    """Post-forward classification-target remapping
    (os2d/modeling/box_coder.py:234-303): decode the predicted boxes and
    re-match them to GT at stricter IoUs, so classification targets reflect
    where the aligned boxes land. The caller passes detached predictions.

    Args: loc_scores [B, L, 4, A]; GT as in `encode_targets`.
    Returns cls_targets_remapped [B, L, A] int32, ious_anchor [B, L, A]
    (anchor-vs-GT IoU), ious_anchor_corrected [B, L, A] (decoded-box-vs-GT).
    """
    num_labels = loc_scores.shape[1]
    labels = torch.arange(num_labels, device=loc_scores.device)
    valid_l = gt_valid[:, None, :] & (gt_labels[:, None, :] == labels[None, :, None])  # [B, L, G]
    ious_anchor_gt = box_iou(gt_boxes, default_boxes)[:, None]  # [B, 1, G, A]
    pred_boxes = decode_boxes(loc_scores.transpose(2, 3), default_boxes)  # [B, L, A, 4]
    ious_pred_gt = box_iou(gt_boxes[:, None], pred_boxes)  # [B, L, G, A]
    index, _ = match_anchors(ious_pred_gt, valid_l, gt_difficult[:, None, :].expand_as(valid_l),
                             remap_iou_pos, remap_iou_neg)
    iou_corr = torch.where(valid_l[..., None], ious_pred_gt, -1.0).amax(-2).clamp(min=0.0)
    iou_anch = torch.where(valid_l[..., None], ious_anchor_gt, -1.0).amax(-2).clamp(min=0.0)
    has_gt = valid_l.any(-1)[..., None]
    return (torch.where(has_gt, _cls_from_index(index), 0),
            torch.where(has_gt, iou_anch, 0.0),
            torch.where(has_gt, iou_corr, 0.0))
