"""VOC-style detection mAP evaluation (host-side numpy).

Port of os2d/data/voc_eval.py:14-253 (itself derived from maskrcnn-benchmark /
chainercv), operating on plain arrays instead of BoxLists:
  - predictions are resized to the GT image size before matching
  - the +1-pixel integer-box convention is applied to both sets
  - difficult GT matches don't count as TP or FP
  - AP is area-under-PR (or the VOC07 11-point metric)
Outputs map / map_weighted / per-class AP & recall / ap_joint_classes.

A copy of `os2d_tpu/data/voc_eval.py`: the PyTorch port keeps its own copy of
the pure-Python modules it needs.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def _box_iou_np(a, b):
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, :, 0] * wh[:, :, 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def do_voc_evaluation(
    predictions: Sequence[Dict[str, np.ndarray]],
    gt: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
):
    """Args:
      predictions: per image dict with 'boxes' [N,4] xyxy, 'labels' [N] int,
        'scores' [N] float, and optional 'image_size' (w, h) of the coordinate
        frame the boxes live in.
      gt: per image dict with 'boxes', 'labels', optional 'difficult' [M] bool,
        and optional 'image_size' (w, h). When both image sizes are present and
        differ, prediction boxes are rescaled to the GT frame
        (os2d/data/voc_eval.py:27-30).
    """
    preds_resized = []
    for p, g in zip(predictions, gt):
        boxes = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
        psize = p.get("image_size")
        gsize = g.get("image_size")
        if psize is not None and gsize is not None and tuple(psize) != tuple(gsize):
            sx = float(gsize[0]) / psize[0]
            sy = float(gsize[1]) / psize[1]
            boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        preds_resized.append(dict(p, boxes=boxes))

    prec, rec, n_pos = _calc_prec_rec(preds_resized, gt, iou_thresh)
    ap = _calc_ap(prec, rec, use_07_metric)
    recall, recall_per_class, n_pos_arr = _calc_recall(rec, n_pos)

    prec1, rec1, _ = _calc_prec_rec(preds_resized, gt, iou_thresh, merge_classes=True)
    ap_one = _calc_ap(prec1, rec1, use_07_metric)

    return {
        "ap_per_class": ap,
        "map": float(np.nanmean(ap)) if len(ap) else float("nan"),
        "map_weighted": float(np.nansum(ap * n_pos_arr / n_pos_arr.sum()))
        if n_pos_arr.sum() > 0
        else float("nan"),
        "recall_per_class": recall_per_class,
        "recall": recall,
        "n_pos": n_pos_arr,
        "prec": prec,
        "rec": rec,
        "ap_joint_classes": float(ap_one[0]) if len(ap_one) else float("nan"),
    }


def _calc_prec_rec(predictions, gt, iou_thresh, merge_classes=False):
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)

    for p, g in zip(predictions, gt):
        pred_bbox = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
        pred_label = np.asarray(p["labels"]).astype(int).reshape(-1)
        pred_score = np.asarray(p["scores"], np.float32).reshape(-1)
        gt_bbox = np.asarray(g["boxes"], np.float32).reshape(-1, 4)
        gt_label = np.asarray(g["labels"]).astype(int).reshape(-1)
        gt_difficult = np.asarray(
            g.get("difficult", np.zeros_like(gt_label, bool))
        ).astype(bool)

        for l in np.unique(np.concatenate((pred_label, gt_label)).astype(int)):
            pred_mask_l = pred_label == l
            pred_bbox_l = pred_bbox[pred_mask_l]
            pred_score_l = pred_score[pred_mask_l]
            order = pred_score_l.argsort()[::-1]
            pred_bbox_l = pred_bbox_l[order]
            pred_score_l = pred_score_l[order]

            gt_mask_l = gt_label == l
            gt_bbox_l = gt_bbox[gt_mask_l]
            gt_difficult_l = gt_difficult[gt_mask_l]

            n_pos[l] += int(np.logical_not(gt_difficult_l).sum())
            score[l].extend(pred_score_l)

            if len(pred_bbox_l) == 0:
                continue
            if len(gt_bbox_l) == 0:
                match[l].extend((0,) * pred_bbox_l.shape[0])
                continue

            # VOC integer-box convention
            pred_bbox_l = pred_bbox_l.copy()
            pred_bbox_l[:, 2:] += 1
            gt_bbox_l = gt_bbox_l.copy()
            gt_bbox_l[:, 2:] += 1

            iou = _box_iou_np(pred_bbox_l, gt_bbox_l)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(gt_bbox_l.shape[0], dtype=bool)
            for gi in gt_index:
                if gi >= 0:
                    if gt_difficult_l[gi]:
                        match[l].append(-1)
                    else:
                        match[l].append(1 if not selec[gi] else 0)
                    selec[gi] = True
                else:
                    match[l].append(0)

    if merge_classes:
        n_pos = {0: sum(n_pos.values())}
        old_score = copy.deepcopy(score)
        score = {0: sum((old_score[i] for i in old_score), [])}
        old_match = copy.deepcopy(match)
        match = {0: sum((old_match[i] for i in old_match), [])}

    if not n_pos:
        return [], [], {}
    n_fg_class = max(n_pos.keys()) + 1
    prec: List[Optional[np.ndarray]] = [None] * n_fg_class
    rec: List[Optional[np.ndarray]] = [None] * n_fg_class

    for l in n_pos.keys():
        score_l = np.array(score[l])
        match_l = np.array(match[l], dtype=np.int8)
        order = score_l.argsort()[::-1]
        match_l = match_l[order]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[l] = tp / (fp + tp)
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec, n_pos


def _calc_ap(prec, rec, use_07_metric=False):
    n_fg_class = len(prec)
    ap = np.empty(n_fg_class)
    for l in range(n_fg_class):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            ap[l] = 0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                ap[l] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def _calc_recall(rec, n_pos):
    n_fg_class = len(rec)
    recall_per_class = np.empty(n_fg_class)
    n_pos_np = np.zeros(n_fg_class)
    n_pos_total = 0.0
    n_good_total = 0.0
    for l in range(n_fg_class):
        n_pos_np[l] = n_pos.get(l, 0)
        if rec[l] is None or n_pos.get(l, 0) == 0:
            recall_per_class[l] = np.nan
        else:
            recall_per_class[l] = rec[l][-1] if len(rec[l]) > 0 else 0.0
            n_pos_total += n_pos[l]
            n_good_total += n_pos[l] * recall_per_class[l]
    recall = float("nan") if n_pos_total == 0 else n_good_total / n_pos_total
    return recall, recall_per_class, n_pos_np
