"""Box geometry on tensors: the part of `os2d_tpu/structures/boxes.py` that
the eval and training paths use.

Semantics match the kernels the reference imports from torchvision
(os2d/structures/bounding_box.py:4-5, os2d/modeling/box_coder.py:7):
box_iou / box_area / clip_boxes_to_image (torchvision.ops.boxes),
encode_boxes / BoxCoder.decode_single (torchvision detection _utils) and
Matcher(high, low, allow_low_quality_matches=False) (`match_anchors`).

Boxes are float32 [..., 4] in xyxy. Padded entries are handled with validity
masks rather than dynamic shapes.
"""

from __future__ import annotations

import math

import torch

# SSD-style encoding weights (os2d/modeling/box_coder.py:13).
BOX_ENCODING_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# torchvision BoxCoder bbox_xform_clip: clamp on dw/dh before exp in decode.
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes):
    """Area of xyxy boxes [..., 4] (no +1 convention, as torchvision)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """IoU matrix between boxes1 [..., N, 4] and boxes2 [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)


def clip_boxes_to_image(boxes, img_w: float, img_h: float):
    """Clamp xyxy boxes into [0, w] x [0, h] (torchvision clip_boxes_to_image)."""
    return torch.stack(
        [
            boxes[..., 0].clamp(0.0, img_w),
            boxes[..., 1].clamp(0.0, img_h),
            boxes[..., 2].clamp(0.0, img_w),
            boxes[..., 3].clamp(0.0, img_h),
        ],
        dim=-1,
    )


def mask_empty_boxes(boxes):
    """True for degenerate boxes (os2d/structures/bounding_box.py:279-281)."""
    return (boxes[..., 3] <= boxes[..., 1]) | (boxes[..., 2] <= boxes[..., 0])


def clip_to_min_size(boxes, min_size: float = 1.0):
    """Force every side >= min_size, keeping the top-left corner fixed
    (os2d/structures/bounding_box.py:267-277), with the gradient semantics
    of the JAX version (os2d_tpu/structures/boxes.py:73-88): in the clamped
    branch the gradient flows through neither coordinate (x1 is detached and
    x2 = x1 + min_size)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    need_w = (x1 + min_size) > x2
    need_h = (y1 + min_size) > y2
    x1d, y1d = x1.detach(), y1.detach()
    return torch.stack([
        torch.where(need_w, x1d, x1),
        torch.where(need_h, y1d, y1),
        torch.where(need_w, x1d + min_size, x2),
        torch.where(need_h, y1d + min_size, y2),
    ], dim=-1)


def encode_boxes(gt_boxes, anchors, weights=BOX_ENCODING_WEIGHTS):
    """torchvision encode_boxes: regression targets of gt w.r.t. anchors.

    Both inputs [..., 4] xyxy, broadcastable. Returns [..., 4] =
    (wx*(dcx)/aw, wy*(dcy)/ah, ww*log(gw/aw), wh*log(gh/ah)).
    """
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gcx = gt_boxes[..., 0] + 0.5 * gw
    gcy = gt_boxes[..., 1] + 0.5 * gh
    tx = wx * (gcx - acx) / aw
    ty = wy * (gcy - acy) / ah
    tw = ww * torch.log(gw / aw)
    th = wh * torch.log(gh / ah)
    return torch.stack(torch.broadcast_tensors(tx, ty, tw, th), dim=-1)


def decode_boxes(rel_codes, anchors, weights=BOX_ENCODING_WEIGHTS):
    """torchvision BoxCoder.decode_single: rel codes + anchors -> xyxy boxes.

    Includes the bbox_xform_clip=log(1000/16) clamp on dw/dh.
    """
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    dx = rel_codes[..., 0] / wx
    dy = rel_codes[..., 1] / wy
    dw = (rel_codes[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (rel_codes[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    pcx = dx * aw + acx
    pcy = dy * ah + acy
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1
    )


def match_anchors(ious, gt_valid, gt_difficult, high_threshold: float,
                  low_threshold: float):
    """torchvision Matcher + difficult handling, padded-GT aware
    (os2d_tpu/structures/boxes.py:136-162), batched over leading dims.

    Args:
      ious: [..., G, A] IoU of (padded) GT rows vs anchors.
      gt_valid, gt_difficult: [..., G] bool.
    Returns:
      index [..., A] int64: >= 0 the matched GT row; -1 below low (negative);
        -2 between the thresholds or matched to a difficult GT (ignore);
      max_iou [..., A]: IoU with the best valid GT, clipped at 0.
    """
    masked = torch.where(gt_valid[..., :, None], ious, -1.0)
    matched_vals = masked.amax(dim=-2)
    matches = masked.argmax(dim=-2)  # the first maximum, as jnp.argmax
    below = matched_vals < low_threshold
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    index = torch.where(below, -1, torch.where(between, -2, matches))
    matched_difficult = torch.gather(gt_difficult, -1, matches)
    index = torch.where((index >= 0) & matched_difficult, -2, index)
    return index, matched_vals.clamp(min=0.0)


def strided_anchor_grid(fm_w: int, fm_h: int, box_w: float, box_h: float,
                        stride_w: float, stride_h: float, device=None):
    """Anchor grid in xyxy, row-major over (h, w): anchor a = y*fm_w + x.

    Centers at ((x+0.5)*stride_w, (y+0.5)*stride_h) with a fixed box size.
    Port of create_strided_boxes_columnfirst (os2d/modeling/box_coder.py:16-60).
    Returns [fm_h*fm_w, 4] float32.
    """
    ys = (torch.arange(fm_h, dtype=torch.float32, device=device) + 0.5) * stride_h
    xs = (torch.arange(fm_w, dtype=torch.float32, device=device) + 0.5) * stride_w
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    cx = cx.reshape(-1)
    cy = cy.reshape(-1)
    half_w = box_w / 2.0
    half_h = box_h / 2.0
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=1)
