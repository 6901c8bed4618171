"""Greedy non-maximum suppression with static shapes, batched over leading
dimensions: counterpart of `os2d_tpu/ops/nms.py`.

Boxes are score-sorted and a greedy keep mask is computed by iterating a
suppression relation to its fixpoint. The fixpoint equals exact greedy
(score-descending) NMS; each sweep finalizes at least one more prefix
position, so it ends in <= K sweeps (typically a handful). Each sweep waits
for the device once (the fixpoint test, span `os2d.wait.nms_sweep`);
`fixpoint_sweeps` counts them. `nms_keep_mask` runs in span `os2d.nms`.
"""

from __future__ import annotations

import torch

from ..structures.boxes import box_iou
from ..utils.profiling import annotate

# sweeps of the fixpoint since import (one host wait each); read and reset by
# whoever measures them
fixpoint_sweeps = 0

# IoU pairs per piece of the prior-block suppression: bounds the box_iou
# temporaries (each [..., rows, block] fp32) to ~256 MB
PRIOR_IOU_PAIRS = 1 << 26


def _dense_fixpoint(sboxes, svalid, iou_threshold: float):
    """Greedy keep mask of score-sorted boxes [..., K, 4] (svalid [..., K])
    from the [K, K] suppression relation, iterated to its fixpoint."""
    global fixpoint_sweeps
    k = sboxes.shape[-2]
    iou = box_iou(sboxes, sboxes)
    higher = torch.ones((k, k), dtype=torch.bool, device=sboxes.device).triu(1)  # i < j
    suppress = (iou > iou_threshold) & higher & svalid[..., :, None] & svalid[..., None, :]
    del iou
    keep = svalid
    for _ in range(k):
        new_keep = svalid & ~torch.any(suppress & keep[..., :, None], dim=-2)
        with annotate("os2d.wait.nms_sweep"):
            fixpoint_sweeps += 1
            done = torch.equal(new_keep, keep)
        keep = new_keep
        if done:
            break
    return keep


def _blocked_keep(sboxes, svalid, iou_threshold: float, block: int):
    """Greedy keep mask of score-sorted boxes in blocks of `block`, in order
    (os2d_tpu/ops/nms.py:70-117): the kept boxes of all earlier blocks (all
    ranked higher) suppress into the block, then the dense fixpoint resolves
    the block internally. Exactly sequential greedy; the prior suppression
    runs in pieces of at most PRIOR_IOU_PAIRS IoU pairs over the leading
    dims."""
    lead, k = sboxes.shape[:-2], sboxes.shape[-2]
    k_pad = -(-k // block) * block
    sboxes = torch.cat([sboxes, sboxes.new_zeros(lead + (k_pad - k, 4))], dim=-2)
    svalid = torch.cat([svalid, svalid.new_zeros(lead + (k_pad - k,))], dim=-1)
    keep = torch.zeros_like(svalid)
    n_lead = max(1, svalid[..., 0].numel())
    rows = max(block, PRIOR_IOU_PAIRS // (n_lead * block) // block * block)
    for start in range(0, k_pad, block):
        boxes_b = sboxes[..., start:start + block, :]
        suppressed = torch.zeros_like(svalid[..., :block])
        # keep is False from `start` on, so only the earlier rows can suppress
        for r in range(0, start, rows):
            r_end = min(r + rows, start)
            iou = box_iou(sboxes[..., r:r_end, :], boxes_b)
            suppressed |= torch.any((iou > iou_threshold) & keep[..., r:r_end, None], dim=-2)
            del iou
        valid_b = svalid[..., start:start + block] & ~suppressed
        keep[..., start:start + block] = _dense_fixpoint(boxes_b, valid_b, iou_threshold)
    return keep[..., :k]


def nms_keep_mask(boxes, scores, valid, iou_threshold: float,
                  dense_limit: int = 8192, block: int = 2048):
    """Greedy NMS keep mask over the last K boxes.

    Args:
      boxes: [..., K, 4] xyxy.
      scores: [..., K] (ties broken by input order: the sort is stable).
      valid: [..., K] bool; invalid boxes are never kept and never suppress.
      iou_threshold: suppress j if IoU(i, j) > threshold for a kept i with
        higher score (strict >, as torchvision).
      dense_limit: the [K, K] suppression relation is materialized up to this
        K; above it the score-sorted boxes finalize in blocks of `block`
        (one O(K^2) IoU pass in bounded pieces, a [block, block] fixpoint
        per block), with the same greedy result.

    Returns keep [..., K] bool in the ORIGINAL box order.
    """
    with annotate("os2d.nms"):
        k = boxes.shape[-2]
        masked = torch.where(valid, scores, float("-inf"))
        order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
        sboxes = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
        svalid = torch.gather(valid, -1, order)
        if k <= dense_limit:
            keep = _dense_fixpoint(sboxes, svalid, iou_threshold)
        else:
            keep = _blocked_keep(sboxes, svalid, iou_threshold, block)
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
