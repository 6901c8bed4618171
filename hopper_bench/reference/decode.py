"""Detections from the reference's scores, and the judge of the program's.

`candidates` decodes every anchor of every pyramid level into a box in the
original image's pixels with its score: the set a greedy NMS chooses from.
`nms_topk` is that NMS written out plainly (per row: the top `pre_top_k`
candidates by score, then greedily the highest one left, every other with
IoU above the threshold dropped, until `top_k` are kept); the control runs
it. `judge` holds the program's packed detections against the candidates.
"""

from __future__ import annotations

import torch

from .model import clip_to_min_size, decode, image_anchors


def box_iou(a, b):
    """IoU of boxes a [..., 4] with boxes b [..., 4], broadcast; 0 where the
    union is empty."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def candidates(levels, config):
    """levels: per pyramid level (loc [B, C, A, 4], cls [B, C, A], fm (h, w),
    level image size (w, h), scale back to the original (sx, sy)). Returns
    boxes [B, C, M, 4] in the original image's pixels and scores [B, C, M]
    (-inf where the box is empty), M the anchors of all levels."""
    boxes, scores = [], []
    for loc, cls, (fh, fw), (iw, ih), (sx, sy) in levels:
        anchors = clip_to_min_size(image_anchors(fh, fw, config, loc.device))
        bx = decode(loc.float(), anchors)
        bx = torch.stack([bx[..., 0].clamp(0, iw), bx[..., 1].clamp(0, ih),
                          bx[..., 2].clamp(0, iw), bx[..., 3].clamp(0, ih)], -1)
        empty = (bx[..., 3] <= bx[..., 1]) | (bx[..., 2] <= bx[..., 0])
        boxes.append(bx * torch.tensor([sx, sy, sx, sy], device=bx.device))
        scores.append(torch.where(empty, float("-inf"), cls.float()))
    return torch.cat(boxes, -2), torch.cat(scores, -1)


def nms_topk(boxes, scores, iou_threshold, pre_top_k, top_k):
    """Greedy NMS per row over the top pre_top_k candidates. boxes [N, M, 4],
    scores [N, M] -> (boxes [N, K, 4], scores [N, K], valid [N, K]) sorted
    by score, K = top_k."""
    n = scores.shape[0]
    k = min(pre_top_k, scores.shape[1])
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    s, idx = s[:, :k], idx[:, :k]
    b = torch.gather(boxes, 1, idx[..., None].expand(n, k, 4))
    alive = torch.isfinite(s)
    keep = torch.zeros_like(alive)
    rows = torch.arange(n, device=s.device)
    for _ in range(min(k, top_k)):
        if not bool(alive.any()):
            break
        first = torch.where(alive, torch.arange(k, device=s.device), k).amin(1)  # [N]
        has = first < k
        j = first.clamp(max=k - 1)
        keep[rows[has], j[has]] = True
        ious = box_iou(b, b[rows, j][:, None])
        alive &= ~((ious > iou_threshold) & has[:, None])
        alive[rows[has], j[has]] = False
    out_b = torch.zeros((n, top_k, 4), device=s.device)
    out_s = torch.full((n, top_k), float("-inf"), device=s.device)
    out_v = torch.zeros((n, top_k), dtype=torch.bool, device=s.device)
    kept_s = torch.where(keep, s, float("-inf"))
    order = torch.sort(kept_s, dim=1, descending=True, stable=True).indices[:, :top_k]
    m = order.shape[1]
    out_b[:, :m] = torch.gather(b, 1, order[..., None].expand(n, m, 4))
    out_v[:, :m] = torch.gather(keep, 1, order)
    out_s[:, :m] = torch.where(out_v[:, :m], torch.gather(kept_s, 1, order), float("-inf"))
    return out_b, out_s, out_v


def judge(cand_boxes, cand_scores, boxes, scores, valid, iou_threshold, pre_top_k):
    """How far the program's detections of each row stray from what a
    greedy NMS over the reference's candidates would give, rank by rank,
    with the program's own earlier choices taken as given (its history), so
    that near-ties between candidates are never counted against it.

    cand_boxes [N, M, 4], cand_scores [N, M]: the reference's candidates.
    boxes [N, K, 4], scores [N, K], valid [N, K]: the program's detections
    of the same rows, sorted by score. At each rank the program's detection
    is matched to the reference's candidate nearest to it, by the largest
    difference of a box coordinate (pixels) plus the score's difference
    (candidates clipped to the image's border can share a box); then
      box_gap_px   the largest coordinate difference of the boxes, pixels;
      score_gap    |the program's score - that candidate's|;
      rank_gap     how far the best candidate that the history leaves
                   available (in the reference's top pre_top_k, not within
                   IoU > iou_threshold of an earlier matched candidate)
                   lies above the matched one; where the program's list
                   ends early, how far the best one left lies above the
                   reference's pre_top_k-th score;
      iou_excess   how far the matched candidate's IoU with the candidates
                   matched at earlier ranks lies above iou_threshold: a
                   greedy NMS keeps no box that overlaps a kept one of a
                   higher score by more (a list that keeps what NMS drops
                   reads above 0 here, while its scores read at or above
                   the best available one and pass rank_gap).
    Returns the four maxima over rows and ranks as floats (inf for a
    detection that is not finite)."""
    n, m = cand_scores.shape
    k = min(pre_top_k, m)
    order = torch.sort(cand_scores, dim=1, descending=True, stable=True).indices
    in_cap = torch.zeros((n, m), dtype=torch.bool, device=cand_scores.device)
    in_cap.scatter_(1, order[:, :k], True)
    in_cap &= torch.isfinite(cand_scores)
    cap_score = torch.where(in_cap, cand_scores, float("inf")).amin(1)
    available = in_cap.clone()
    rows = torch.arange(n, device=cand_scores.device)
    zero = cand_scores.new_zeros(())
    worst = cand_scores.new_zeros(4)  # box, score, rank, overlap
    open_rows = torch.ones(n, dtype=torch.bool, device=cand_scores.device)
    matched = cand_boxes.new_zeros((n, boxes.shape[1], 4))
    for r in range(boxes.shape[1]):
        best = torch.where(available, cand_scores, float("-inf")).amax(1)
        ending = open_rows & ~valid[:, r]
        left = torch.where(ending & torch.isfinite(best), best - cap_score, zero)
        worst[2] = torch.maximum(worst[2], left.max())
        open_rows = open_rows & valid[:, r]
        if not bool(open_rows.any()):
            break
        dist = (cand_boxes - boxes[:, r, None]).abs().amax(-1)  # [N, M]
        ds_all = (cand_scores - scores[:, r, None]).abs()
        j = torch.where(torch.isfinite(ds_all), dist + ds_all, float("inf")).argmin(1)
        gap = torch.where(torch.isfinite(best), best - cand_scores[rows, j], zero)
        box_j = cand_boxes[rows, j]
        overlap = (box_iou(matched[:, :r], box_j[:, None]).amax(1) - iou_threshold).clamp(min=0) \
            if r else zero.expand(n)
        matched[:, r] = box_j
        got = torch.stack([dist[rows, j], ds_all[rows, j], gap, overlap],
                          1).nan_to_num(nan=float("inf"))
        worst = torch.maximum(worst, torch.where(open_rows[:, None], got, zero).amax(0))
        suppress = box_iou(cand_boxes, box_j[:, None]) > iou_threshold
        available &= ~(suppress & open_rows[:, None])
        available[rows[open_rows], j[open_rows]] = False
    box_gap, score_gap, rank_gap, iou_excess = worst.tolist()
    return {"score_gap": score_gap, "box_gap_px": box_gap, "rank_gap": rank_gap,
            "iou_excess": iou_excess}
