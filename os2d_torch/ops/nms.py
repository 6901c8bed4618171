"""Greedy non-maximum suppression with static shapes, batched over leading
dimensions: counterpart of `os2d_tpu/ops/nms.py`.

Boxes are score-sorted and a greedy keep mask is computed by iterating a
suppression relation to its fixpoint. The fixpoint equals exact greedy
(score-descending) NMS; each sweep finalizes at least one more prefix
position, so it ends in <= K sweeps (typically a handful).
"""

from __future__ import annotations

import torch

from ..structures.boxes import box_iou


def nms_keep_mask(boxes, scores, valid, iou_threshold: float,
                  dense_limit: int = 8192):
    """Greedy NMS keep mask over the last K boxes.

    Args:
      boxes: [..., K, 4] xyxy.
      scores: [..., K] (ties broken by input order: the sort is stable).
      valid: [..., K] bool; invalid boxes are never kept and never suppress.
      iou_threshold: suppress j if IoU(i, j) > threshold for a kept i with
        higher score (strict >, as torchvision).
      dense_limit: the [K, K] suppression relation is materialized up to this
        K; the block-sequential form above it is not ported yet.

    Returns keep [..., K] bool in the ORIGINAL box order.
    """
    k = boxes.shape[-2]
    if k > dense_limit:
        raise NotImplementedError(
            f"NMS over K={k} > dense_limit={dense_limit} needs the "
            f"block-sequential path, which is not ported yet")
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    svalid = torch.gather(valid, -1, order)

    iou = box_iou(sboxes, sboxes)
    higher = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)  # i < j
    suppress = (iou > iou_threshold) & higher & svalid[..., :, None] & svalid[..., None, :]

    keep = svalid
    for _ in range(k):
        new_keep = svalid & ~torch.any(suppress & keep[..., :, None], dim=-2)
        done = torch.equal(new_keep, keep)
        keep = new_keep
        if done:
            break
    return torch.zeros_like(keep).scatter(-1, order, keep)


def top_k_stable(x, k: int):
    """(values, indices) of the k largest along the last dim, ties in input
    order (the order of jax.lax.top_k; torch.topk leaves it unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def nms_topk(boxes, scores, valid, iou_threshold: float, top_k: int):
    """NMS then the top_k survivors sorted by descending score.

    Args are [..., K, 4], [..., K], [..., K]. Returns (boxes [..., top_k, 4],
    scores [..., top_k], valid [..., top_k], indices [..., top_k]). Padded
    slots have valid=False and score=-inf.
    """
    keep = nms_keep_mask(boxes, scores, valid, iou_threshold)
    neg_inf = float("-inf")
    kept_scores = torch.where(keep, scores, neg_inf)
    k = boxes.shape[-2]
    if top_k > k:
        pad = top_k - k
        lead = boxes.shape[:-2]
        boxes = torch.cat([boxes, boxes.new_zeros(lead + (pad, 4))], dim=-2)
        kept_scores = torch.cat([kept_scores, kept_scores.new_full(lead + (pad,), neg_inf)], dim=-1)
        keep = torch.cat([keep, keep.new_zeros(lead + (pad,))], dim=-1)
    top_scores, top_idx = top_k_stable(kept_scores, top_k)
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(top_idx.shape + (4,)))
    top_valid = torch.gather(keep, -1, top_idx)
    top_scores = torch.where(top_valid, top_scores, neg_inf)
    return top_boxes, top_scores, top_valid, top_idx
