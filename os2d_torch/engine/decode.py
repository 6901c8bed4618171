"""Pyramid decoding: loc/cls scores -> final detections. Counterpart of
`os2d_tpu/engine/decode.py` (the reference's Os2dBoxCoder.decode_pyramid,
os2d/modeling/box_coder.py:448-536).

Every label row decodes with static shapes, survivors are selected with a
per-label pre-top-K and greedy NMS. The inverse transforms back to the
original image are per-level (sx, sy) scalings: the eval pyramid is built with
pure resizes (os2d/data/dataloader.py:432-476), so the inverse is linear.

All functions take any leading batch dimensions before the label axis G.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.head import ANCHOR_BOX, ANCHOR_STRIDE
from ..ops.nms import nms_keep_mask, nms_topk, top_k_stable
from ..structures.boxes import (
    clip_boxes_to_image,
    decode_boxes,
    mask_empty_boxes,
    strided_anchor_grid,
)
from ..structures.feature_map import FeatureMapSize, feature_map_size_for_image
from ..utils.profiling import host_constant


def default_boxes_for_image_size(img_size: FeatureMapSize, device=None):
    """Anchor grid (240x240 @ stride 16) for an image size
    (os2d/modeling/box_coder.py:191-203)."""
    fm = feature_map_size_for_image(img_size)
    return strided_anchor_grid(
        fm.w, fm.h,
        float(ANCHOR_BOX.w), float(ANCHOR_BOX.h),
        float(ANCHOR_STRIDE.w), float(ANCHOR_STRIDE.h),
        device=device,
    )


def decode_single_level(loc_scores, cls_scores, default_boxes, img_size_wh,
                        inverse_scale_xy, score_threshold):
    """Decode one pyramid level for a batch of label rows.

    Args:
      loc_scores: [..., G, 4, A] localization outputs.
      cls_scores: [..., G, A] recognition scores.
      default_boxes: [A, 4] anchors at this level's image size.
      img_size_wh: (w, h) of this level.
      inverse_scale_xy: (sx, sy) scaling back to original image coordinates.
      score_threshold: drop boxes scoring <= threshold (reference default -inf).

    Returns (boxes [..., G, A, 4] in ORIGINAL coords, scores [..., G, A],
    valid [..., G, A]).
    """
    loc = loc_scores.transpose(-1, -2)  # [..., G, A, 4]
    boxes = decode_boxes(loc, default_boxes)
    boxes = clip_boxes_to_image(boxes, float(img_size_wh[0]), float(img_size_wh[1]))
    valid = (cls_scores > score_threshold) & ~mask_empty_boxes(boxes)
    sx, sy = inverse_scale_xy
    scale = host_constant([sx, sy, sx, sy], dtype=boxes.dtype, device=boxes.device)
    return boxes * scale, cls_scores, valid


def decode_pyramid(
    loc_pyramid: Sequence[torch.Tensor],
    cls_pyramid: Sequence[torch.Tensor],
    img_sizes: Sequence[FeatureMapSize],
    inverse_scales: Sequence[Tuple[float, float]],
    *,
    nms_iou_threshold: float = 0.3,
    score_threshold: float = float("-inf"),
    pre_top_k: int = 1024,
    top_k: int = 256,
    nms_across_classes: bool = False,
    corners_pyramid: Optional[Sequence[torch.Tensor]] = None,
):
    """Decode all pyramid levels and NMS per label row.

    Args:
      loc_pyramid: per level [..., G, 4, A_l]; cls_pyramid per level [..., G, A_l].
      img_sizes: per-level image sizes.
      inverse_scales: per-level (sx, sy) back to original coordinates.
      pre_top_k: per-label candidate cap before NMS.
      top_k: detections kept per label row after NMS.

    Returns dict with boxes [..., G, K, 4] (original coords), scores
    [..., G, K], valid [..., G, K]; with corners_pyramid (per level [..., G,
    8, A_l], the head's transformed grid corners) also corners [..., G, K, 8]
    in original coordinates. With nms_across_classes a second NMS joins all G
    rows of each batch entry (suppressed entries get valid=False).
    """
    all_boxes, all_scores, all_valid, all_corners = [], [], [], []
    for lvl, img_size in enumerate(img_sizes):
        d_boxes = default_boxes_for_image_size(img_size, loc_pyramid[lvl].device)
        boxes, scores, valid = decode_single_level(
            loc_pyramid[lvl], cls_pyramid[lvl], d_boxes,
            (img_size.w, img_size.h), inverse_scales[lvl], score_threshold,
        )
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_valid.append(valid)
        if corners_pyramid is not None:
            sx, sy = inverse_scales[lvl]
            corners = corners_pyramid[lvl].transpose(-1, -2)  # [..., G, A, 8]
            all_corners.append(corners * host_constant([sx, sy] * 4, dtype=corners.dtype,
                                                       device=corners.device))

    boxes = torch.cat(all_boxes, dim=-2)  # [..., G, A_tot, 4]
    scores = torch.cat(all_scores, dim=-1)
    valid = torch.cat(all_valid, dim=-1)

    # per-label candidate cap (scores of invalid candidates -> -inf)
    capped = torch.where(valid, scores, float("-inf"))
    k_pre = min(pre_top_k, capped.shape[-1])
    top_scores, top_idx = top_k_stable(capped, k_pre)
    idx4 = top_idx[..., None].expand(top_idx.shape + (4,))
    top_boxes = torch.gather(boxes, -2, idx4)
    top_valid = torch.gather(valid, -1, top_idx)

    nb, ns, nv, nidx = nms_topk(top_boxes, top_scores, top_valid, nms_iou_threshold, top_k)
    out = {"boxes": nb, "scores": ns, "valid": nv}
    if corners_pyramid is not None:
        # slots past the candidates (top_k > k_pre) are invalid; JAX's
        # gather clamps their index, so does this one
        corners = torch.gather(torch.cat(all_corners, dim=-2), -2,
                               top_idx[..., None].expand(top_idx.shape + (8,)))
        nidx = nidx.clamp(max=k_pre - 1)
        out["corners"] = torch.gather(corners, -2, nidx[..., None].expand(nidx.shape + (8,)))

    if nms_across_classes:
        g, k = nb.shape[-3], nb.shape[-2]
        lead = nb.shape[:-3]
        keep = nms_keep_mask(nb.reshape(lead + (g * k, 4)), ns.reshape(lead + (g * k,)),
                             nv.reshape(lead + (g * k,)), nms_iou_threshold)
        out["valid"] = keep.reshape(lead + (g, k))
    return out
